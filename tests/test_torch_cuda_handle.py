"""The resource model on the card: a handle's streams run kernels B1–B5
and give the bits of the handle-less call; the IVF-PQ pool spreads query
batches over its streams; a handle holds its inputs until its work is
done (the caching-allocator check); ``Handle.sync`` waits on the
handle's own streams only and can be cancelled.

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_handle.py -q -m cuda``.
Tolerances: every output bit for bit against the call without a handle.
"""

import threading
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

#: about half a second of sleep on the card (its clock near 2 GHz)
SLEEP_CYCLES = 1_000_000_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _data(n=20_000, dim=32, nq=3000, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (64, dim))
    x = (c[rng.integers(0, 64, n)]
         + rng.standard_normal((n, dim))).astype(np.float32)
    q = (c[rng.integers(0, 64, nq)]
         + rng.standard_normal((nq, dim))).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(q).cuda()


@pytest.fixture(scope="module")
def pq():
    from raft_tpu_torch.neighbors import ivf_pq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, q = _data()
    idx = ivf_pq.build(ivf_pq.IndexParams(n_lists=64, pq_dim=16,
                                          kmeans_n_iters=5), x)
    return idx, x, q


def _same(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def _counts():
    from raft_tpu_torch.kernels import native

    return dict(native.LAUNCHES)


def test_ivf_pq_search_no_handle_handle_and_pool(dev, pq):
    from raft_tpu_torch.core import Handle
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_pq

    idx, _, q = pq
    sp = ivf_pq.SearchParams(n_probes=8)
    ref = ivf_pq.search(sp, idx, q, 10, batch_size_query=512)
    for h in (Handle(), Handle(n_streams=4)):
        native.reset_launches()
        got = ivf_pq.search(sp, idx, q, 10, batch_size_query=512, handle=h)
        h.sync()
        assert _same(got, ref)
        assert _counts()["lut_scan"] == 6 and _counts()["select_k"] >= 6
        assert all(s.query() for s in [h.get_stream()] + h._pool)


def test_pool_lanes_hold_their_batches(dev, pq):
    from raft_tpu_torch.core import Handle
    from raft_tpu_torch.neighbors import ivf_pq

    idx, _, q = pq
    h = Handle(n_streams=4)
    with h.get_stream().context():
        torch.cuda._sleep(SLEEP_CYCLES)
    got = ivf_pq.search(ivf_pq.SearchParams(n_probes=8), idx, q, 10,
                        batch_size_query=512, handle=h)
    # every lane waits behind the sleep on the main stream
    assert sum(not s.query() for s in h._pool) == 4
    h.sync()
    assert all(s.query() for s in h._pool)
    assert _same(got, ivf_pq.search(ivf_pq.SearchParams(n_probes=8), idx,
                                     q, 10, batch_size_query=512))


def test_ivf_flat_knn_pairwise_kmeans_under_a_handle(dev):
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
    from raft_tpu_torch.core import Handle
    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import brute_force, ivf_flat

    x, q = _data()
    h = Handle(n_streams=2)
    native.reset_launches()
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=64), x, handle=h)
    got = ivf_flat.search(ivf_flat.SearchParams(n_probes=8), index, q, 10,
                          handle=h)
    l1 = brute_force.knn(x, q[:256], 10, "l1", handle=h)
    cb = pairwise_distance(x[:2048], q[:300], "cityblock", handle=h)
    p = KMeansParams(n_clusters=64, init=InitMethod.Array, max_iter=5,
                     tol=0.0)
    km = kmeans.fit(p, x, centroids=x[:64], handle=h)
    h.sync()
    counts = _counts()
    for name in ("fused_l2_nn", "fused_l2_nn_partials", "select_k",
                 "pairwise_accumulate"):
        assert counts[name] > 0, name
    assert _same(got, ivf_flat.search(ivf_flat.SearchParams(n_probes=8),
                                      index, q, 10))
    assert _same(l1, brute_force.knn(x, q[:256], 10, "l1"))
    assert torch.equal(cb, pairwise_distance(x[:2048], q[:300], "cityblock"))
    ref = kmeans.fit(p, x, centroids=x[:64])
    assert torch.equal(km.centroids, ref.centroids)
    assert torch.equal(km.inertia, ref.inertia)


def test_inputs_outlive_their_caller(dev, pq):
    """The caching-allocator check: the caller drops its queries and
    overwrites fresh memory of the same size on its own stream while the
    handle's streams still read them; the results keep their bits."""
    from raft_tpu_torch.core import Handle
    from raft_tpu_torch.neighbors import ivf_pq

    idx, _, q = pq
    sp = ivf_pq.SearchParams(n_probes=8)
    ref = ivf_pq.search(sp, idx, q, 10, batch_size_query=512)
    h = Handle(n_streams=4)
    qd = q.clone()
    ptr = qd.data_ptr()
    with h.get_stream().context():
        torch.cuda._sleep(SLEEP_CYCLES)
    got = ivf_pq.search(sp, idx, qd, 10, batch_size_query=512, handle=h)
    del qd
    junk = torch.empty_like(q).fill_(float("nan"))
    assert junk.data_ptr() != ptr
    h.sync()
    assert _same(got, ref)


def test_sync_waits_on_its_own_streams_only(dev):
    from raft_tpu_torch.core import Handle

    h = Handle(n_streams=2)
    foreign = torch.cuda.Stream()
    with torch.cuda.stream(foreign):
        torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    h.sync()
    waited = time.perf_counter() - t0
    assert not foreign.query() and waited < 0.1
    foreign.synchronize()


def test_cancel_during_sync(dev):
    from raft_tpu_torch.core import Handle, interruptible
    from raft_tpu_torch.core.error import InterruptedError_

    h = Handle()
    with h.get_stream().context():
        torch.cuda._sleep(SLEEP_CYCLES)
    h.get_stream().record()
    box, started = {}, threading.Event()

    def waiter():
        box["tid"] = threading.get_ident()
        started.set()
        try:
            h.sync()
            box["raised"] = False
        except InterruptedError_:
            box["raised"] = True

    t = threading.Thread(target=waiter)
    t.start()
    assert started.wait(10)
    time.sleep(0.02)
    interruptible.cancel(box["tid"])
    t.join(timeout=10)
    assert not t.is_alive() and box["raised"] is True
    assert not h.get_stream().query()
    h.sync()
    assert h.get_stream().query()
