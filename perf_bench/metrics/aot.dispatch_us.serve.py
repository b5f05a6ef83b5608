"""Mean host time, in us, to issue one super-batch of the serving engine
over the window: ``raft_tpu_aot_dispatch_seconds{fn,sig}`` of the
engine's backend program (deltas of its sum and count)."""


def _cells(ctx):
    from raft_tpu_torch import telemetry

    srv = ctx.server
    eng = getattr(srv, "engine", None)
    hist = telemetry.REGISTRY.get("raft_tpu_aot_dispatch_seconds")
    if eng is None or hist is None:
        return None
    fn = eng._backend_fn()
    tot_s = tot_n = 0
    for labels, cell in hist.items():
        if labels[0] == fn:
            tot_s += cell.sum
            tot_n += cell.count
    return tot_s, tot_n


def before(ctx):
    c = _cells(ctx)
    if c is not None:
        ctx.store[__name__] = c


def read(ctx):
    c = _cells(ctx)
    if c is None or __name__ not in ctx.store:
        return None
    s0, n0 = ctx.store[__name__]
    dn = c[1] - n0
    return (c[0] - s0) / dn * 1e6 if dn > 0 else None
