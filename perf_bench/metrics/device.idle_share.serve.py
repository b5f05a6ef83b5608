"""Share, in %, of the traced stretch of an open-loop window in which no
work ran on the device."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.n_device_events == 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
