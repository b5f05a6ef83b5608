"""Work counts of the timed calls (operations and bytes from shapes) and
the card's published peaks, for the roofline shares."""
