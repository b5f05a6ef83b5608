"""Queries a coalesced super-batch carried over the window: the serving
engine's ``stats["queries"] / stats["super_batches"]`` (deltas)."""


def _engine(ctx):
    srv = ctx.server
    return getattr(srv, "engine", None)


def before(ctx):
    eng = _engine(ctx)
    if eng is not None:
        ctx.store[__name__] = (eng.stats["queries"],
                               eng.stats["super_batches"])


def read(ctx):
    eng = _engine(ctx)
    if eng is None or __name__ not in ctx.store:
        return None
    q0, b0 = ctx.store[__name__]
    db = eng.stats["super_batches"] - b0
    return (eng.stats["queries"] - q0) / db if db > 0 else None
