"""Queries answered in the window over the window's seconds (closed
loop: all calls, all of the window's time)."""


def read(ctx):
    w = ctx.window
    return w.queries / w.seconds if w and w.seconds > 0 else None
