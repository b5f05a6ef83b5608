"""The port's stage spans and queue wait on the CPU: one span per stage per
keyed dispatch of the IVF searches (eager ``search()`` and the serving
engine alike, and whatever the probe count), one per stage per build, the
queue-wait histogram once per submitted request and never above its
latency, ``serve.hold`` only while the scheduler holds work back, nothing
with telemetry off, and the scheduler thread's spans as ranges on that
thread under a profiler of all threads."""

import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from raft_tpu_torch import telemetry
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.serve import SchedulerConfig, ServeEngine

K = 4
STAGES = {"ivf_pq": ("ivf_pq.coarse", "ivf_pq.lut", "ivf_pq.scan",
                     "ivf_pq.select"),
          "ivf_flat": ("ivf_flat.coarse", "ivf_flat.scan")}
BUILD_STAGES = {"ivf_pq": ("build.train", "build.codebooks", "build.encode",
                           "build.populate"),
                "ivf_flat": ("build.train", "build.populate")}
FAMILY = {"ivf_pq": ivf_pq, "ivf_flat": ivf_flat}


@pytest.fixture
def enabled():
    prev = telemetry.set_enabled(True)
    yield
    telemetry.set_enabled(prev)


def _counts(names):
    hist = telemetry.REGISTRY.histogram("raft_tpu_span_seconds",
                                        labelnames=("span",))
    return {n: hist.count((n,)) for n in names}


def _grown(before):
    after = _counts(before)
    return {n: after[n] - before[n] for n in before}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centres = rng.normal(size=(16, 16))
    x = (centres[rng.integers(0, 16, 3000)]
         + 0.3 * rng.normal(size=(3000, 16))).astype(np.float32)
    return x, x[rng.choice(3000, 300, replace=False)]


def _build(family, x):
    if family == "ivf_pq":
        p = ivf_pq.IndexParams(n_lists=16, pq_dim=8, kmeans_n_iters=5)
    else:
        p = ivf_flat.IndexParams(n_lists=16, kmeans_n_iters=5)
    return FAMILY[family].build(p, x, device="cpu")


@pytest.fixture(scope="module")
def indexes(data):
    return {f: _build(f, data[0]) for f in FAMILY}


@pytest.mark.parametrize("family", list(FAMILY))
def test_build_stage_spans_once_per_build(enabled, data, family):
    before = _counts(BUILD_STAGES[family])
    for _ in range(2):
        _build(family, data[0])
    assert _grown(before) == {n: 2 for n in BUILD_STAGES[family]}


@pytest.mark.parametrize("n_probes", [1, 4, 16])
@pytest.mark.parametrize("family", list(FAMILY))
def test_search_stage_spans_once_per_dispatch(enabled, data, indexes,
                                              family, n_probes):
    """300 queries in batches of 64: five keyed dispatches, so five spans
    of each stage, at any probe count (no span per scan step)."""
    mod = FAMILY[family]
    before = _counts(STAGES[family])
    mod.search(mod.SearchParams(n_probes=n_probes), indexes[family],
               data[1], K, batch_size_query=64)
    assert _grown(before) == {n: 5 for n in STAGES[family]}


@pytest.mark.parametrize("family", list(FAMILY))
def test_engine_stage_spans_once_per_dispatch(enabled, data, indexes,
                                              family):
    """Under the serving engine, through ``search()`` and through the
    scheduler thread: one span of each stage per super-batch or solo
    dispatch."""
    mod = FAMILY[family]
    eng = ServeEngine(indexes[family], K, mod.SearchParams(n_probes=4),
                      max_batch=64,
                      scheduler=SchedulerConfig(quantum_s=0.01))
    try:
        eng.warmup()
        q = data[1]
        reqs = [q[:3], q[3:4], q[4:13], q[13:33], q[33:93]]
        before = _counts(STAGES[family])
        s0 = eng.stats["super_batches"] + eng.stats["solo_fallbacks"]
        eng.search(reqs)
        for f in [eng.submit(r) for r in reqs[:4]]:
            f.result(timeout=60)
        n = eng.stats["super_batches"] + eng.stats["solo_fallbacks"] - s0
        assert n >= 2
        assert _grown(before) == {s: n for s in STAGES[family]}
    finally:
        eng.close()


def _engine(data, quantum_s):
    eng = ServeEngine(data[0], K, max_batch=32, device="cpu",
                      scheduler=SchedulerConfig(quantum_s=quantum_s))
    eng.warmup()
    return eng


def test_queue_wait_once_per_request_and_within_latency(enabled, data):
    q = data[1]
    eng = _engine(data, 0.01)
    label = (eng._engine_id,)
    try:
        hist = eng.queue_wait_hist
        c0 = hist.count(label)
        futs = [eng.submit(q[j:j + 1 + j % 5]) for j in range(7)]
        for f in futs:
            f.result(timeout=60)
        assert hist.count(label) - c0 == 7
        for j in range(3):
            s0 = hist.cell(label).sum
            t0 = telemetry.now()
            eng.submit(q[j:j + 2]).result(timeout=60)
            latency = telemetry.now() - t0
            wait = hist.cell(label).sum - s0
            assert 0.0 <= wait <= latency
        assert hist.count(label) - c0 == 10
    finally:
        eng.close()
    # flush() takes the queue out in the caller's thread: observed too
    eng = _engine(data, 30.0)
    label = (eng._engine_id,)
    try:
        c0 = eng.queue_wait_hist.count(label)
        fut = eng.submit(q[:2])
        eng.flush()
        fut.result(timeout=60)
        assert eng.queue_wait_hist.count(label) - c0 == 1
    finally:
        eng.close()


def test_hold_only_while_waiting_for_a_fuller_bucket(enabled, data):
    eng = _engine(data, 0.2)
    try:
        before = _counts(("serve.hold",))
        waits0 = eng.stats["sched_waits"]
        eng.submit(data[1][:32]).result(timeout=60)   # the largest bucket
        assert _grown(before) == {"serve.hold": 0}
        eng.submit(data[1][:1]).result(timeout=60)    # held one quantum
        held = _grown(before)["serve.hold"]
        assert held >= 1
        assert held == eng.stats["sched_waits"] - waits0
    finally:
        eng.close()


def test_disabled_telemetry_records_nothing(data, indexes):
    names = (STAGES["ivf_pq"] + STAGES["ivf_flat"]
             + BUILD_STAGES["ivf_pq"] + ("serve.hold", "serve.dispatch"))
    prev = telemetry.set_enabled(False)
    try:
        before = _counts(names)
        eng = _engine(data, 0.05)
        label = (eng._engine_id,)
        try:
            with telemetry.collect_spans() as col, profile(
                    activities=[ProfilerActivity.CPU]) as prof:
                _build("ivf_pq", data[0][:1000])
                for family, mod in FAMILY.items():
                    mod.search(mod.SearchParams(n_probes=4),
                               indexes[family], data[1], K,
                               batch_size_query=64)
                eng.submit(data[1][:1]).result(timeout=60)
            assert eng.queue_wait_hist.count(label) == 0
        finally:
            eng.close()
        assert _grown(before) == {n: 0 for n in names}
        assert col.events == []
        assert not {e.name for e in prof.events()} & set(names)
    finally:
        telemetry.set_enabled(prev)


def test_scheduler_thread_spans_in_an_all_threads_trace(enabled, data,
                                                        indexes, tmp_path):
    """The profiler started on this thread; the engine's spans open on its
    scheduler thread and still appear there as ranges."""
    eng = ServeEngine(indexes["ivf_flat"], K,
                      ivf_flat.SearchParams(n_probes=4), max_batch=64,
                      scheduler=SchedulerConfig(quantum_s=0.01))
    try:
        eng.warmup()
        cfg = _ExperimentalConfig(profile_all_threads=True)
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=cfg) as prof:
            for f in [eng.submit(data[1][j:j + 3]) for j in range(4)]:
                f.result(timeout=60)
        sched = eng._sched_thread.native_id
    finally:
        eng.close()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    tids = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            tids.setdefault(e["name"], set()).add(e["tid"])
    for name in ("serve.dispatch", "serve.deliver", "ivf_flat.coarse",
                 "ivf_flat.scan"):
        assert tids.get(name) == {sched}, name
