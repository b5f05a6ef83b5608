"""The serving layer on the card: ``submit()`` from several threads at
once, through the scheduler thread and both stream lanes, gives each
request bit for bit what ``search()`` gives it; a sampled dispatch leaves
its device time (CUDA events) in ``raft_tpu_device_seconds``; a transient
fault is retried on the other lane with identical results; a refresh
under ``submit()`` traffic resolves every future.

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_serve.py -q -m cuda``.
"""

import threading

import numpy as np
import pytest
import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.serve import SchedulerConfig, ServeEngine
from raft_tpu_torch.testing import faults

pytestmark = pytest.mark.cuda

_DIM, _K = 32, 10
SIZES = (1, 7, 64, 3, 300, 33, 128, 2, 511, 17, 90, 5)


@pytest.fixture(scope="module")
def data():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(0)
    c = rng.uniform(-3, 3, (64, _DIM))

    def draw(n):
        return (c[rng.integers(0, 64, n)]
                + rng.standard_normal((n, _DIM))).astype(np.float32)

    return draw(20_000), [draw(n) for n in SIZES]


@pytest.fixture(scope="module", params=["brute_force_l1", "ivf_pq"])
def engine(request, data):
    x, _ = data
    if request.param == "ivf_pq":
        index = ivf_pq.build(ivf_pq.IndexParams(n_lists=64, pq_dim=16),
                             x, device="cuda")
        eng = ServeEngine(index, _K, ivf_pq.SearchParams(n_probes=8),
                          max_batch=256,
                          scheduler=SchedulerConfig(quantum_s=0.005))
    else:
        eng = ServeEngine(x, _K, metric="l1", max_batch=256,
                          batch_size_index=4096,
                          scheduler=SchedulerConfig(quantum_s=0.005))
    eng.warmup()
    yield eng
    eng.close()


def _submit_from_threads(eng, reqs, n_threads=4):
    futs = [None] * len(reqs)

    def worker(t):
        for j in range(t, len(reqs), n_threads):
            futs[j] = eng.submit(reqs[j])

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    return [f.result(timeout=60) for f in futs]


def _assert_same(got, ref):
    for (d, i), (rd, ri) in zip(got, ref):
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(d, rd)


def test_threaded_submit_equals_search(engine, data):
    _, reqs = data
    ref = [engine.search([q])[0] for q in reqs]
    for _ in range(3):
        _assert_same(_submit_from_threads(engine, reqs), ref)
    assert engine.stats["sched_dispatches"] >= 1
    assert engine.stats["dispatch_errors"] == 0
    fn = engine._backend_fn()
    hist = telemetry.REGISTRY.get("raft_tpu_device_seconds")
    assert hist.count((fn,)) >= 1
    assert 0.0 < hist.quantile(0.5, (fn,)) < 1.0


def test_transient_fault_retried_on_the_card(engine, data):
    _, reqs = data
    ref = engine.search(reqs)
    r0 = engine.stats["retries"]
    with faults.plan("dispatch:n=1:raise"):
        got = engine.search(reqs)
    assert engine.stats["retries"] == r0 + 1
    _assert_same(got, ref)


def test_refresh_under_submit_traffic_on_the_card(engine, data):
    _, reqs = data
    ref = [engine.search([q])[0] for q in reqs]
    n0 = engine.stats["refreshes"]
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault("v", _submit_from_threads(engine,
                                                                reqs * 4)))
    t.start()
    engine.refresh(engine.index)
    t.join(60)
    assert not t.is_alive()
    _assert_same(out["v"], ref * 4)
    assert engine.stats["refreshes"] == n0 + 1
