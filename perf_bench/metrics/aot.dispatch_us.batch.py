"""Mean host time, in us, to issue one keyed dispatch of a closed-loop
call, from the trace: from a ``bench.call`` span's start to the end of
its last runtime call that issues work (a launch, copy or set; the
call's final wait issues none), over the call's keyed dispatches."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.q_rows is None:
        return None
    per = ctx.entry.dispatches_per_call(ctx.system, len(ctx.q_rows))
    times = []
    for s in tr.spans_named("bench.call"):
        end = tr.last_launch_in(s)
        if end is not None:
            times.append((end - s.t0) / per)
    return sum(times) / len(times) * 1e6 if times else None
