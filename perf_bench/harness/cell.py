"""One run of one cell: set-up, warm-up, the window, the metrics and the
comparison, returned as the result line's object."""

from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from perf_bench.harness import data, judge, loops, traffic
from perf_bench.harness.spec import Cell
from perf_bench.harness.trace import Summary, Tracer

#: top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")
#: host threads of torch's CPU ops (``run.py`` sets the BLAS ones)
HOST_THREADS = 2
#: timed builds in set-up; ``build_s`` is their mean (a build on the
#: shared host varies by tens of percent from one to the next)
BUILDS = 3


@dataclasses.dataclass
class Context:
    """What a metric reader reads.  ``store`` keeps what a reader's
    ``before`` saw when the window opened."""

    cell: Cell
    seed: int
    seconds: float
    device: Any
    entry: Any
    system: Any
    server: Any
    build_s: float
    setup_s: float
    window: Optional[loops.Window] = None
    q_rows: Optional[np.ndarray] = None
    pool: Any = None
    export: Optional[dict] = None
    traces: List[Summary] = dataclasses.field(default_factory=list)
    build_traces: List[Summary] = dataclasses.field(default_factory=list)
    store: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def trace(self) -> Optional[Summary]:
        return self.traces[0] if self.traces else None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _compiles() -> int:
    """First calls of the port's keyed programs so far (a first call in
    the window would load, size or allocate inside it)."""
    import importlib

    aot = importlib.import_module("raft_tpu_torch.core.aot")
    return int(aot.aot_compile_counters["compiles"])


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class SetUp:
    """What set-up made: the data, the index (``system``), the traffic
    and, for an open loop, the warmed server and its requests; for a
    closed loop the query rows of a call (``q``)."""

    x: Any
    pool: Any
    entry: Any
    system: Any
    build_times: List[float]
    build_traces: List[Summary]
    mix: Any
    server: Any = None
    requests: Optional[list] = None
    q: Any = None

    @property
    def build_s(self) -> float:
        return sum(self.build_times) / len(self.build_times)


def set_up(cell: Cell, seed: int, seconds: float, device, tracer: Tracer,
           entry=None) -> SetUp:
    """Everything before the window: the seeded data, the kernels, the
    warm build and the timed ones, the traffic of *seconds*, and a call
    (closed loop) or the warmed server and a submit at each of the plan's
    smallest, median and largest sizes (open loop)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(HOST_THREADS)
    cfg = cell.config
    entry = entry or cell.entry()
    x, pool = data.make(cfg["data"], seed, device)
    entry.prepare(cfg, x, device)
    _sync(device)
    build_traces: List[Summary] = []
    times = []
    with tracer.capture(build_traces):
        for _ in range(BUILDS):
            system = None
            t = time.perf_counter()
            system = entry.build(cfg, x, device)
            _sync(device)
            times.append(time.perf_counter() - t)
    tracer.read()
    mix = traffic.make(cell.traffic, seed, seconds, pool.shape[0],
                       x.shape[1])
    s = SetUp(x=x, pool=pool, entry=entry, system=system,
              build_times=times, build_traces=build_traces, mix=mix)
    if isinstance(mix, traffic.BatchTraffic):
        s.q = pool[torch.as_tensor(mix.rows, device=device)]
        d, i = entry.call(system, s.q)
        d.cpu(), i.cpu()
    else:
        s.server = entry.serve(system, int(cfg["serve"]["max_batch"]))
        pool_host = pool.cpu().numpy()
        s.requests = [pool_host[r] for r in mix.rows]
        for n in sorted({1, max(mix.sizes), int(np.median(mix.sizes))}):
            s.server.submit(pool_host[:n]).result(timeout=loops.LATE_S)
    _sync(device)
    return s


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, entry=None, log=None,
        control: bool = False) -> Dict[str, Any]:
    """Run *cell* once and return the result object (see ``run.py``).
    *entry* replaces the configuration's entry module (tests plant faults
    through it); with *control* the result also holds the control's
    readings on the same sample (``control.py``; a benchmark run never
    computes them)."""
    import torch

    log = log or (lambda *a: None)
    threads_before = {t.ident for t in threading.enumerate()}
    cfg = cell.config
    tracer = Tracer(trace, device)
    su = set_up(cell, seed, seconds, device, tracer, entry)
    x, pool, mix, server, system = su.x, su.pool, su.mix, su.server, su.system
    log(f"build {su.build_s:.3f} s")
    compiles0 = _compiles()
    # what set-up made lives to the end: keep the collector off it
    gc.collect()
    gc.freeze()
    ctx = Context(cell=cell, seed=seed, seconds=seconds, device=device,
                  entry=su.entry, system=system, server=server,
                  build_s=su.build_s,
                  setup_s=time.perf_counter() - t_start, pool=pool,
                  build_traces=su.build_traces)
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: cell.reader(m["name"]) for m in metrics}
    for r in readers.values():
        if hasattr(r, "before"):
            r.before(ctx)
    log(f"setup {ctx.setup_s:.3f} s; window {seconds} s")

    if server is None:
        ctx.window = loops.closed(su.entry, system, su.q, seconds, tracer,
                                  ctx.traces)
        ctx.q_rows = mix.rows
    else:
        ctx.window = loops.open_loop(server, su.requests, mix.arrivals,
                                     seconds, tracer, ctx.traces)
    compiles = _compiles() - compiles0
    gc.unfreeze()
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    if server is not None:
        server.close()
    tracer.read()
    ctx.export = su.entry.export(system)

    found = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            found[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the comparison, once the window has closed and the peak is read
    lim = cfg["check"]
    w = ctx.window
    if server is None:
        rows, got_d, got_i, differ = judge.closed_answers(
            w.calls, mix.rows, seed)
        diff_name = "calls_differ"
    else:
        rows, got_d, got_i, differ = judge.open_answers(w.calls, mix.rows)
        diff_name = "rows_differ"
    w.calls = []
    t = time.perf_counter()
    nums = judge.numbers(cfg, x, pool, ctx.export, rows, got_d, got_i)
    nums[diff_name] = differ
    nums["unanswered"] = w.unanswered
    correct, shown = judge.verdict(nums, lim["limits"])
    ctrl = (judge.control(cfg, x, pool, ctx.export, rows) if control
            else None)
    log(f"reference {time.perf_counter() - t:.3f} s over {len(rows)} "
        f"answers; recall@{cfg['k']} {1.0 - nums['recall_miss']:.4f}")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": peak}
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(w.attempted),
                           "failed": int(w.failed + w.unanswered),
                           "metrics": found, "device": dev}
    tr = ctx.trace
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": [list(o) for o in tr.device_ops],
                            "idle_gaps": [list(g) for g in tr.idle_gaps]}
    lat = w.latencies_s
    out["info"] = {"recall": 1.0 - nums["recall_miss"],
                   "queries": int(w.queries),
                   "latency_ms": ({f"p{q}": float(np.percentile(lat, q))
                                   * 1e3 for q in (50, 90, 95, 99)}
                                  if lat is not None and len(lat) else None),
                   "window_s": w.seconds, "late_s": w.late_s,
                   "build_s": su.build_times, "setup_s": ctx.setup_s,
                   "compiles_in_window": compiles,
                   "threads_left": loops.threads_left(threads_before)}
    if ctrl is not None:
        out["control"] = ctrl
    out["check"] = shown
    return out
