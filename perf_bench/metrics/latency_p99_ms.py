"""The 99th percentile, in ms, of every answered request of the window,
timed from its scheduled arrival to its answer on the host."""

import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s if ctx.window else None
    if lat is None or len(lat) == 0:
        return None
    return float(np.percentile(lat, 99)) * 1e3
