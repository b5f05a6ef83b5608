"""Seconds from the process's start to the window's: imports, CUDA
context, kernel libraries (built in a checkout's first run), data, the
builds and the warm-up."""


def read(ctx):
    return ctx.setup_s
