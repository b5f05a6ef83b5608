"""The port's telemetry against ``raft_tpu.telemetry``: the same seeded
observation stream gives the same histogram buckets, quantiles, reservoir,
snapshot and Prometheus text (exactly); spans nest, feed the JSONL sink
and open ``torch.profiler`` ranges only while a trace runs; device
sampling follows the same gate; the serving engine's latency histogram,
``stats`` view and scrape surface work on the CPU."""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu import telemetry as jtel
from raft_tpu.telemetry import device as jdevice
from raft_tpu.telemetry import export as jexport
from raft_tpu_torch import telemetry as ttel
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.serve import ServeEngine
from raft_tpu_torch.telemetry import device as tdevice
from raft_tpu_torch.telemetry import export as texport

#: observation streams (seconds): inside the 1 µs – 100 s geometry, at and
#: beyond both edges, and heavy-tailed
STREAMS = {
    "uniform": lambda rng: rng.uniform(1e-4, 1e-1, 500),
    "lognormal": lambda rng: np.exp(rng.normal(-6.0, 2.5, 2000)),
    "edges": lambda rng: np.concatenate([
        [0.0, 1e-7, 1e-6, 100.0, 1e3], rng.uniform(1e-6, 100.0, 50)]),
    "overflow_reservoir": lambda rng: rng.exponential(0.01, 5000),
}


@pytest.fixture
def enabled():
    """Force-enable both packages' gates around a test."""
    prev = ttel.set_enabled(True), jtel.set_enabled(True)
    yield
    ttel.set_enabled(prev[0])
    jtel.set_enabled(prev[1])


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' exporters over empty registries of their own."""
    regs = ttel.Registry(), jtel.Registry()
    monkeypatch.setattr(texport, "REGISTRY", regs[0])
    monkeypatch.setattr(jexport, "REGISTRY", regs[1])
    return regs


def _fill(regs, values, reservoir=64):
    """The same metrics and observations in both registries."""
    for reg in regs:
        h = reg.histogram("lat_seconds", "latency", labelnames=("engine",),
                          reservoir=reservoir)
        for j, v in enumerate(values):
            h.observe(float(v), (str(j % 3),))
        c = reg.counter("events_total", 'said "hi"\n', labelnames=("kind",))
        c.inc(3, ("a",))
        c.inc(2.5, ("b",))
        reg.gauge("depth", "queue depth").set(7)
    return [r.histogram("lat_seconds", labelnames=("engine",),
                        reservoir=reservoir) for r in regs]


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_histogram_and_exports_equal_the_reference(enabled, fresh, stream):
    values = STREAMS[stream](np.random.default_rng(len(stream)))
    th, jh = _fill(fresh, values)
    for labels in (("0",), ("1",), ("2",)):
        tc, jc = th.cell(labels), jh.cell(labels)
        assert tc.counts == jc.counts
        assert (tc.count, tc.sum, tc.min, tc.max) == (jc.count, jc.sum,
                                                      jc.min, jc.max)
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert th.quantile(q, labels) == jh.quantile(q, labels)
        assert th.reservoir(labels) == jh.reservoir(labels)
        assert len(th.reservoir(labels)) <= 64
    assert texport.snapshot(fresh[0]) == jexport.snapshot(fresh[1])
    assert ttel.prometheus_text() == jtel.prometheus_text()
    for prefix in ((), ("1",)):
        assert ttel.merged_quantile(th, 0.5, prefix) == \
            jtel.registry.merged_quantile(jh, 0.5, prefix)


@pytest.mark.parametrize("value", [0.0, 1e-6, 3.3e-6, 1e-3, 99.9, 100.0])
def test_bucket_geometry_equals_the_reference(value):
    assert ttel.bucket_index(value) == jtel.bucket_index(value)
    i = ttel.bucket_index(value)
    assert ttel.bucket_upper(i) == jtel.bucket_upper(i)


def test_empty_quantile_and_disabled_recording():
    h = ttel.Registry().histogram("h")
    assert h.quantile(0.5) is None
    prev = ttel.set_enabled(False)
    try:
        h.observe(1.0)
        assert h.count() == 0
        c = ttel.Registry().counter("c")
        c.inc()
        assert c.get() == 1   # counters stay live
        assert ttel.span("x") is ttel.span("y")   # the shared no-op
    finally:
        ttel.set_enabled(prev)


def test_counter_view_reads_like_a_dict():
    view = ttel.legacy_counter("t_torch_view_stats", "s",
                               labelnames=("engine", "key"), fixed=("e9",))
    view["requests"] = 0
    view.inc("requests", 3)
    view.inc("queries")
    assert view["requests"] == 3 and view["missing"] == 0
    assert dict(view) == {"queries": 1, "requests": 3}
    assert json.loads(json.dumps(dict(view))) == {"queries": 1,
                                                   "requests": 3}
    assert len(view) == 2 and "queries" in view
    assert view.fixed_labels == ("e9",)


class TestSpans:
    def test_nesting_and_jsonl_sink(self, enabled):
        sink = io.StringIO()
        ttel.set_jsonl_sink(sink)
        try:
            with ttel.collect_spans() as col:
                with ttel.span("t.outer"):
                    assert ttel.current_span() == "t.outer"
                    with ttel.span("t.inner"):
                        assert ttel.current_span() == "t.inner"
        finally:
            ttel.set_jsonl_sink(None)
        lines = [json.loads(x) for x in sink.getvalue().splitlines()]
        assert [e["span"] for e in lines] == ["t.inner", "t.outer"]
        assert lines[0]["parent"] == "t.outer" and lines[0]["depth"] == 1
        assert lines[1]["parent"] is None and not lines[1]["error"]
        assert [e["span"] for e in col.events] == ["t.inner", "t.outer"]
        assert ttel.current_span() is None

    def test_exception_safety(self, enabled):
        before = ttel.REGISTRY.histogram(
            "raft_tpu_span_seconds", labelnames=("span",)).count(("t.boom",))
        with pytest.raises(ValueError):
            with ttel.collect_spans() as col:
                with ttel.span("t.boom"):
                    raise ValueError("x")
        assert col.events[0]["error"] is True
        assert ttel.current_span() is None
        after = ttel.REGISTRY.histogram(
            "raft_tpu_span_seconds", labelnames=("span",)).count(("t.boom",))
        assert after == before + 1

    def test_profiler_range_only_while_tracing(self, enabled, monkeypatch):
        from torch.profiler import ProfilerActivity, profile

        from raft_tpu_torch.telemetry import spans

        entered = []
        real = spans._trace_annotation_cls

        def spy():
            cls = real()
            entered.append(cls is not None)
            return cls

        monkeypatch.setattr(spans, "_trace_annotation_cls", spy)
        with ttel.span("t.untraced"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with ttel.span("t.traced"):
                torch.ones(4).sum()
        assert entered == [False, True]
        names = {e.name for e in prof.events()}
        assert "t.traced" in names and "t.untraced" not in names


def test_device_sampling_gate_equals_the_reference(enabled):
    prev = tdevice.set_sample_every(3), jdevice.set_sample_every(3)
    try:
        got = [tdevice.sample_due("t_torch_fn") for _ in range(10)]
        ref = [jdevice.sample_due("t_torch_fn") for _ in range(10)]
        assert got == ref == [True, False, False] * 3 + [True]
        tdevice.set_sample_every(0)
        assert not tdevice.sample_due("t_torch_fn")
    finally:
        tdevice.set_sample_every(prev[0])
        jdevice.set_sample_every(prev[1])
    ttel.record_device_sample("t_torch_fn", "float32[8,4]", 0.002)
    hist = ttel.REGISTRY.get("raft_tpu_device_seconds")
    assert hist.quantile(0.5, ("t_torch_fn",)) == pytest.approx(0.002)
    by_sig = ttel.REGISTRY.get("raft_tpu_device_signature_seconds")
    assert by_sig.quantile(0.5, ("t_torch_fn", "float32[8,4]")) == \
        pytest.approx(0.002)


@pytest.mark.parametrize("entry", [
    lambda: ttel.program_costs(None), lambda: ttel.gather(None),
    lambda: ttel.merge([])], ids=["program_costs", "gather", "merge"])
def test_entries_left_for_later_raise(entry, request):
    """``program_costs`` stays dropped (it reads XLA's cost analysis) and
    raises; ``gather`` and ``merge`` came with the distributed layer: a
    host of one gathers its own snapshot, and no snapshot merges to an
    empty one."""
    which = request.node.callspec.id
    if which == "program_costs":
        with pytest.raises(LogicError, match="not ported yet"):
            entry()
    elif which == "gather":
        fleet = entry()
        assert fleet["world"] == 1 and list(fleet["hosts"]) == ["0"]
        assert fleet["rollup"] == ttel.merge([fleet["hosts"]["0"]])
    else:
        assert entry() == {}


@pytest.fixture
def served(enabled):
    rng = np.random.default_rng(3)
    x = rng.random((600, 8), dtype=np.float32)
    eng = ServeEngine(x, 4, max_batch=32, device="cpu")
    eng.warmup()
    reqs = [rng.random((n, 8), dtype=np.float32) for n in (3, 1, 9, 40)]
    yield eng, reqs
    eng.close()


def test_engine_latency_stats_and_dispatch_telemetry(served):
    eng, reqs = served
    assert eng.latency_quantiles() == [None, None]
    eng.search(reqs)
    p50, p99 = eng.latency_quantiles((0.5, 0.99))
    assert 0 < p50 <= p99
    assert len(eng.last_latencies) == len(reqs)
    stats = dict(eng.stats)
    assert len(stats) == 18 and stats["requests"] == 4
    assert stats["solo_fallbacks"] == 1 and stats["queries"] == 53
    assert json.loads(json.dumps(stats)) == stats
    snap = ttel.snapshot()
    fn = "_knn_scan_impl"
    assert any(k.startswith(f"fn={fn},sig=float32[")
               for k in snap["raft_tpu_aot_dispatch_seconds"]["values"])
    assert f"fn={fn}" in snap["raft_tpu_device_seconds"]["values"]
    assert snap["raft_tpu_span_seconds"]["values"][
        "span=serve.deliver"]["count"] >= 1


def test_scrape_surface(served):
    eng, reqs = served
    srv = eng.serve_http(0, slow_threshold_s=0.0)
    assert eng.serve_http(0) is srv   # idempotent
    eng.search(reqs[:2])

    def get(path):
        try:
            with urllib.request.urlopen(srv.url + path, timeout=5) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    code, body = get("/metrics")
    assert code == 200
    assert "raft_tpu_serve_request_latency_seconds_bucket" in body
    code, body = get("/healthz")
    health = json.loads(body)
    assert code == 200 and health["ready"] and health["backend"] == \
        "brute_force"
    assert health["warmed"] == {"float32": [8, 16, 32]}
    code, body = get("/varz")
    assert code == 200 and "raft_tpu_serve_engine_stats" in json.loads(body)
    code, body = get("/debug/slow")
    slow = json.loads(body)
    assert code == 200 and slow["recorded"] >= 1
    assert slow["entries"][-1]["spans"][0]["span"] == "serve.request"
    assert get("/nope")[0] == 404
    eng.close()
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen(srv.url + "/healthz", timeout=1)
