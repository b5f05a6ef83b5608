"""Share, in %, of the timed build's wall time in which work ran on the
device (the profiled build of a traced run)."""


def read(ctx):
    if not ctx.build_traces:
        return None
    tr = ctx.build_traces[0]
    if tr.n_device_events == 0 or tr.window_s <= 0:
        return None
    return 100.0 * tr.busy_s / tr.window_s
