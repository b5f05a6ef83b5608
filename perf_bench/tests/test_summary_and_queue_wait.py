"""``harness/trace.py``'s ``summarize`` pinned on a hand-made Chrome
trace (its fields equal hand-computed values, whatever program spans,
threads and correlation ids the trace also holds), and the
``serve.queue_wait_ms`` reader: its window deltas, and None on a run
whose program has no queue-wait histogram."""

import types

import pytest

from perf_bench.harness import spec
from perf_bench.harness.trace import summarize

MAIN, SCHED = 1, 2


def _x(name, ts, dur, tid=MAIN, cat="user_annotation", corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _call(name, ts, corr, tid=SCHED):
    return _x(name, ts, 5, tid, "cuda_runtime", corr)


def _dev(name, ts, end, corr, cat="kernel"):
    return _x(name, ts, end - ts, 0, cat, corr)


#: the window 0–1000 µs on the feeder thread; the scheduler thread opens
#: a request whose dispatch holds the coarse step and a scan, then a
#: delivery, and a second request whose scan crosses the window's end
SERVE_TRACE = [
    _x("bench.window", 0, 1000),
    _x("bench.feeder_sleep", 100, 200),
    _x("bench.submit", 300, 20),
    _x("bench.feeder_sleep", 600, 300),
    _x("serve.request", 120, 830, SCHED),
    _x("serve.dispatch", 120, 300, SCHED),
    _x("ivf_flat.coarse", 130, 15, SCHED),
    _x("ivf_flat.scan", 150, 200, SCHED),
    _x("serve.deliver", 420, 530, SCHED),
    _x("serve.request", 960, 240, SCHED),
    _x("serve.dispatch", 960, 140, SCHED),
    _x("ivf_flat.scan", 980, 120, SCHED),
    _call("cudaLaunchKernel", 135, 1),
    _call("cudaLaunchKernel", 160, 2),
    _call("cudaLaunchKernel", 200, 3),
    _call("cudaLaunchKernel", 310, 4, tid=MAIN),
    _call("cudaMemcpyAsync", 430, 5),
    _x("cudaStreamSynchronize", 440, 200, SCHED, "cuda_runtime", 7),
    _call("cudaLaunchKernel", 990, 6),
    _dev("k_orphan", 50, 75, 42),
    _dev("k_coarse", 200, 230, 1),
    _dev("k_scan", 260, 330, 2),
    _dev("k_scan", 330, 380, 3),
    _dev("k_other", 600, 660, 4),
    _dev("Memcpy DtoH", 700, 720, 5, "gpu_memcpy"),
    _dev("k_scan", 995, 1050, 6),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 135, "id": 1},
]

def _us(v):
    return pytest.approx(v * 1e-6, abs=1e-12)


def _named(pairs):
    return [(n, _us(v)) for n, v in pairs]


def test_existing_fields_equal_hand_computed_values():
    tr = summarize(SERVE_TRACE)
    # device work clipped to 0–1000: 50–75, 200–230, 260–380, 600–660,
    # 700–720, 995–1000
    assert tr.busy_s == _us(260)
    assert tr.window_s == _us(1000)
    assert tr.device_ops == _named([("k_scan", 125), ("k_other", 60),
                                    ("k_coarse", 30), ("k_orphan", 25),
                                    ("Memcpy DtoH", 20)])
    assert tr.idle_gaps == _named([
        ("bench.feeder_sleep", 275), ("none", 220),
        ("bench.feeder_sleep", 125), ("none", 50),
        ("bench.feeder_sleep", 40), ("bench.feeder_sleep", 30)])
    assert [(s.name, s.t0, s.t1) for s in tr.spans] == [
        ("bench.window", _us(0), _us(1000)),
        ("bench.feeder_sleep", _us(100), _us(300)),
        ("bench.submit", _us(300), _us(320)),
        ("bench.feeder_sleep", _us(600), _us(900))]
    # the wait (cudaStreamSynchronize) puts no work on the device
    assert tr.launch_ends == [_us(t) for t in (140, 165, 205, 315, 435,
                                               995)]
    assert tr.n_device_events == 7
    assert tr.last_launch_in(tr.spans[2]) == _us(315)


def _ctx(trace=None, server=None):
    return types.SimpleNamespace(trace=trace, build_traces=[],
                                 server=server, store={})


def _reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py")


class _Cell:
    def __init__(self, s, n):
        self.sum, self.count = s, n


class _Hist:
    def __init__(self):
        self.cells = {}

    def cell(self, labels):
        return self.cells.get(labels)


def test_queue_wait_reader_reads_window_deltas():
    hist = _Hist()
    eng = types.SimpleNamespace(queue_wait_hist=hist, _engine_id="3")
    ctx = _ctx(server=types.SimpleNamespace(engine=eng))
    r = _reader("serve.queue_wait_ms")
    r.before(ctx)
    hist.cells[("3",)] = _Cell(0.5, 100)
    assert r.read(ctx) == pytest.approx(5.0)


def test_queue_wait_reader_none_without_the_histogram():
    r = _reader("serve.queue_wait_ms")
    plain = _ctx(summarize(SERVE_TRACE),
                 server=types.SimpleNamespace(engine=types.SimpleNamespace()))
    for ctx in (plain, _ctx()):
        r.before(ctx)
        assert r.read(ctx) is None
