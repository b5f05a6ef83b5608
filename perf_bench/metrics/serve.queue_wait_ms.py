"""Mean wait, in ms, of a request in the serving engine's ``submit()``
queue over the window: ``raft_tpu_serve_queue_wait_seconds{engine}``
(deltas of its sum and count), from ``submit()`` to the moment the
scheduler thread takes the request out."""


def _cell(ctx):
    eng = getattr(ctx.server, "engine", None)
    hist = getattr(eng, "queue_wait_hist", None)
    if hist is None:
        return None
    cell = hist.cell((eng._engine_id,))
    return (cell.sum, cell.count) if cell is not None else (0.0, 0)


def before(ctx):
    c = _cell(ctx)
    if c is not None:
        ctx.store[__name__] = c


def read(ctx):
    c = _cell(ctx)
    if c is None or __name__ not in ctx.store:
        return None
    s0, n0 = ctx.store[__name__]
    dn = c[1] - n0
    return (c[0] - s0) / dn * 1e3 if dn > 0 else None
