"""The traced run's profiler window and what is read from it.

``--trace 1`` runs the same set-up and window as a measured run, with
``torch.profiler`` (CUPTI on the card) around the build and around a
stretch of the window.  The benchmark's own host spans (``bench.*``,
``record_function`` ranges around its calls into the port) are in the
same trace, so an idle gap of the device is named by the span that was
open on the host.  The trace is written to ``TMPDIR``, read and deleted.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

#: trace events of work on the device
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host runtime calls that wait for the device rather than issue work
_WAITS = ("cudaEventQuery", "cudaEventSynchronize", "cudaStreamQuery",
          "cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cuEventQuery", "cuEventSynchronize", "cuStreamQuery",
          "cuStreamSynchronize", "cuCtxSynchronize")
#: the longest entries of each breakdown list
TOP = 10


@dataclasses.dataclass
class Span:
    name: str
    t0: float     # seconds, trace clock
    t1: float


@dataclasses.dataclass
class Summary:
    """What one profiled stretch shows.  ``busy_s``: the union of the
    device's work intervals inside the stretch; ``window_s``: the
    stretch's length; ``spans``: the ``bench.*`` host spans;
    ``launch_ends``: end times of the host's runtime calls that issue
    work (launches, copies, sets), sorted."""

    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    spans: List[Span]
    launch_ends: List[float]
    n_device_events: int

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def last_launch_in(self, span: Span) -> Optional[float]:
        """End of the last issuing runtime call inside *span*."""
        import bisect

        i = bisect.bisect_right(self.launch_ends, span.t1)
        if i and self.launch_ends[i - 1] >= span.t0:
            return self.launch_ends[i - 1]
        return None


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float,
                                                               float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], window: str = "bench.window") -> Summary:
    """Read a Chrome trace's complete events: the stretch is the host
    span *window*; device work is clipped to it."""
    spans, dev, launches = [], [], []
    by_op: Dict[str, float] = collections.defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
        name = e.get("name", "")
        if cat in _DEVICE_CATS:
            dev.append((t0, t1, name))
        elif cat == "user_annotation" and name.startswith("bench."):
            spans.append(Span(name, t0, t1))
        elif cat in ("cuda_runtime", "cuda_driver") and name not in _WAITS:
            launches.append(t1)
    wins = [s for s in spans if s.name == window]
    if wins:
        w0, w1 = min(s.t0 for s in wins), max(s.t1 for s in wins)
    else:
        w0 = min((s.t0 for s in spans), default=0.0)
        w1 = max((s.t1 for s in spans), default=0.0)
    clipped = []
    for t0, t1, name in dev:
        a, b = max(t0, w0), min(t1, w1)
        if b > a:
            clipped.append((a, b))
            by_op[name] += b - a
    union = _merge(clipped)
    busy = sum(b - a for a, b in union)
    gaps, cur = [], w0
    for a, b in union:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    inner = [s for s in spans if s.name != window]

    def open_at(t: float) -> str:
        cover = [s for s in inner if s.t0 <= t <= s.t1]
        return (min(cover, key=lambda s: s.t1 - s.t0).name if cover
                else "none")

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    ops = sorted(by_op.items(), key=lambda kv: kv[1], reverse=True)
    return Summary(
        busy_s=busy, window_s=w1 - w0,
        device_ops=[(n[:160], s) for n, s in ops[:TOP]],
        idle_gaps=[(open_at(0.5 * (a + b)), b - a) for a, b in gaps[:TOP]],
        spans=sorted(spans, key=lambda s: s.t0),
        launch_ends=sorted(launches), n_device_events=len(dev))


class Tracer:
    """Host spans and profiled stretches of one run; everything is a
    no-op when the run is not traced."""

    def __init__(self, enabled: bool, device):
        self.enabled = bool(enabled)
        self.device = device
        self._pending: list = []

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def capture(self, out: list):
        """Profile the body as the stretch ``bench.window``; :meth:`read`
        later stops the profiler and appends the stretch's
        :class:`Summary` to *out* (nothing when the run is not traced).
        Stopping the profiler parses every event it holds, which takes
        seconds, so it waits until the window has closed."""
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, record_shapes=False,
                       profile_memory=False, with_stack=False)
        prof.start()
        self._pending.append((prof, out))
        with torch.profiler.record_function("bench.window"):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def read(self) -> None:
        """Stop every capture's profiler; write, read and delete its
        trace."""
        while self._pending:
            prof, out = self._pending.pop(0)
            prof.stop()
            fd, path = tempfile.mkstemp(prefix="perf_bench_trace_",
                                        suffix=".json")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f).get("traceEvents", [])
            finally:
                os.unlink(path)
            out.append(summarize(events))
