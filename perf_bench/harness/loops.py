"""The measured window: a closed loop of calls or an open loop of
requests.

Both record what the comparison needs once the window has closed: every
call's results (closed loop) or every request's (open loop), with the
time each request was due, sent and answered.  The traced run profiles
the window's last ``TRACE_SECONDS``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent import futures
from typing import Any, List, Optional

import numpy as np

#: the profiled stretch of a traced window
TRACE_SECONDS = 2.0
#: how long past the window's close an answer is waited for
LATE_S = 60.0


@dataclasses.dataclass
class Window:
    seconds: float
    queries: int
    attempted: int
    failed: int
    unanswered: int
    calls: List[Any] = dataclasses.field(default_factory=list)
    latencies_s: Optional[np.ndarray] = None
    late_s: float = 0.0
    answered_by_s: float = 0.0


class _Stretch:
    """Start the tracer's capture when the window reaches *t_start* and
    stop it at *t_stop* (or when the window ends)."""

    def __init__(self, tracer, out: list, t_start: float, t_stop: float):
        self.tracer, self.out = tracer, out
        self.t_start, self.t_stop = t_start, t_stop
        self.stack = contextlib.ExitStack()
        self.state = 0

    def tick(self, now: float) -> None:
        if not self.tracer.enabled:
            return
        if self.state == 0 and now >= self.t_start:
            self.stack.enter_context(self.tracer.capture(self.out))
            self.state = 1
        elif self.state == 1 and now >= self.t_stop:
            self.close()

    def close(self) -> None:
        if self.state == 1:
            self.stack.close()
        self.state = 2


def _stretch(tracer, out, t0: float, seconds: float) -> _Stretch:
    start = t0 + seconds - min(TRACE_SECONDS, seconds)
    return _Stretch(tracer, out, start, t0 + seconds)


def closed(entry, system, q, seconds: float, tracer,
           trace_out: list) -> Window:
    """Calls of ``entry.call`` on the query rows *q*, back to back, each
    result copied to the host, until *seconds* have passed; the window
    ends with the last call."""
    calls = []
    t0 = time.perf_counter()
    st = _stretch(tracer, trace_out, t0, seconds)
    now = t0
    while now - t0 < seconds:
        st.tick(now)
        with tracer.span("bench.call"):
            d, i = entry.call(system, q)
        with tracer.span("bench.fetch"):
            calls.append((d.cpu().numpy(), i.cpu().numpy()))
        now = time.perf_counter()
    st.close()
    return Window(seconds=now - t0, queries=len(calls) * q.shape[0],
                  attempted=len(calls), failed=0, unanswered=0, calls=calls)


def open_loop(server, requests: List[np.ndarray], arrivals: np.ndarray,
              seconds: float, tracer, trace_out: list) -> Window:
    """Submit request j at ``arrivals[j]`` seconds into the window (an
    open loop: whether or not earlier ones are answered); each is timed
    from when it was due to when its answer reached the host.  Answers
    are waited for up to ``LATE_S`` past the window."""
    n = len(requests)
    futs: List[Optional[futures.Future]] = [None] * n
    t_due = np.zeros(n)
    t_done = np.full(n, np.nan)
    late = 0.0

    def stamp(j):
        def done(_f):
            t_done[j] = time.perf_counter()
        return done

    lead = 0.01
    t0 = time.perf_counter() + lead
    st = _stretch(tracer, trace_out, t0, seconds)
    for j, q in enumerate(requests):
        due = t0 + float(arrivals[j])
        now = time.perf_counter()
        st.tick(now)
        if due > now:
            with tracer.span("bench.feeder_sleep"):
                time.sleep(due - now)
        t_due[j] = due
        with tracer.span("bench.submit"):
            sent = time.perf_counter()
            f = server.submit(q)
        late = max(late, sent - due)
        f.add_done_callback(stamp(j))
        futs[j] = f
    while time.perf_counter() < t0 + seconds:
        st.tick(time.perf_counter())
        time.sleep(0.005)
    st.close()
    deadline = time.perf_counter() + LATE_S
    results: List[Any] = []
    failed = unanswered = 0
    for f in futs:
        try:
            results.append(f.result(timeout=max(0.0, deadline
                                                - time.perf_counter())))
        except futures.TimeoutError:
            results.append(None)
            unanswered += 1
        except Exception as e:   # a shed or failed request: its error
            results.append(e)
            failed += 1
    # a done-callback runs after the future's waiters wake: let the last
    # stamps land
    for _ in range(200):
        if not np.isnan(t_done[[r is not None for r in results]]).any():
            break
        time.sleep(0.001)
    ok = np.array([isinstance(r, tuple) for r in results])
    lat = (t_done - t_due)[ok]
    return Window(seconds=float(seconds),
                  queries=int(sum(len(r) for r, g in zip(requests, ok) if g)),
                  attempted=n, failed=failed, unanswered=unanswered,
                  calls=results, latencies_s=lat, late_s=late,
                  answered_by_s=float(np.nanmax(t_done) - t0)
                  if ok.any() else 0.0)


def threads_left(before: set) -> List[str]:
    """Threads started since *before* that are still alive."""
    return [t.name for t in threading.enumerate()
            if t.ident not in before and t.is_alive()]
