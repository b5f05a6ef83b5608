"""Seconds a ``build()`` of the cell's index takes in set-up,
synchronised, after the warm build has loaded every library: the mean of
the set-up's timed builds (``harness/cell.py`` ``BUILDS``)."""


def read(ctx):
    return ctx.build_s
