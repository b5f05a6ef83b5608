"""The general parts of the benchmark: the cell's files found by name
(:mod:`spec`), seeded data and traffic (:mod:`data`, :mod:`traffic`), the
closed and open loops (:mod:`loops`), the profiler trace (:mod:`trace`),
the comparison with the reference (:mod:`judge`) and one run end to end
(:mod:`cell`)."""
