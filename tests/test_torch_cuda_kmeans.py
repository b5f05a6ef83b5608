"""The public k-means API through the port's kernels, on the card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one; run
them on a machine with a card with
``python -m pytest --noconftest tests/test_torch_cuda_kmeans.py -q -m cuda``.
Tolerances: from one init, the kernel path's fit (B1, B3) and the plain
path's (``engine="torch"``) reach ARI ≥ 0.999 between their labels and
inertia within the E-step's value contract (per row 1e-5 of ‖x‖² + ‖c‖²,
B1's 3xTF32 products) plus 1e-6; ``predict`` labels equal except near
ties; copy slots of a k-means‖ buffer own no row; a row's label and
distance bit for bit the same in any batch.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _blobs(dev, n=20_000, d=64, k=256, seed=0):
    from raft_tpu_torch.random import RngState, make_blobs

    return make_blobs(RngState(seed), n, d, n_clusters=k, device=dev)


def _near_tie(x, y):
    d = torch.cdist(x.double(), y.double()) ** 2
    two = torch.topk(d, 2, dim=1, largest=False)
    scale = (x.double() ** 2).sum(1) + (y.double() ** 2).sum(1)[
        two.indices[:, 0]]
    return (two.values[:, 1] - two.values[:, 0]) <= 1e-5 * scale


def test_kernel_fit_matches_plain_fit_from_one_init(dev):
    from raft_tpu_torch import cluster, stats
    from raft_tpu_torch.cluster import InitMethod, KMeansParams
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.random import RngState

    x, _, _ = _blobs(dev)
    c0 = cluster.init_plus_plus(RngState(3), x, 256)
    p = KMeansParams(n_clusters=256, init=InitMethod.Array, max_iter=20,
                     tol=0.0)
    native.reset_launches()
    kern = cluster.fit(p, x, centroids=c0, loop="fori", engine="cuda")
    assert native.LAUNCHES["fused_l2_nn_partials"] == 20
    plain = cluster.fit(p, x, centroids=c0, loop="fori", engine="torch")
    lk, _ = cluster.predict(p, x, kern.centroids, engine="cuda")
    lp, _ = cluster.predict(p, x, plain.centroids, engine="torch")
    assert float(stats.adjusted_rand_index(lk, lp)) >= 0.999
    ik, ip = float(kern.inertia), float(plain.inertia)
    cn = (kern.centroids.double() ** 2).sum(1)
    slack = 1e-5 * float((x.double() ** 2).sum() + cn[lk.long()].sum())
    assert abs(ik - ip) <= slack + 1e-6 * ip
    lt, _ = cluster.predict(p, x, kern.centroids, engine="torch")
    diff = lk != lt
    assert bool(_near_tie(x[diff], kern.centroids).all())


@pytest.mark.parametrize("copies", ["first", "sampled"])
def test_kmeans_pp_buffer_copies_own_nothing(dev, copies):
    from raft_tpu_torch.cluster import min_cluster_and_distance

    x, _, _ = _blobs(dev, n=50_000, d=128, k=1024)
    l, cap = 2048, 1 + 5 * 2048                       # k = 10,241
    g = torch.Generator(device=dev).manual_seed(1)
    rows = x[torch.randperm(x.shape[0], generator=g, device=dev)[:l]]
    buf = x[:1].expand(cap, 128).clone()
    buf[1:1 + l] = rows
    if copies == "sampled":
        buf[1 + l:] = rows.repeat(4, 1)
    nn = min_cluster_and_distance(x, buf, engine="cuda")
    counts = torch.bincount(nn.key.long(), minlength=cap)
    assert int(counts[1 + l:].sum()) == 0


def test_labels_do_not_depend_on_the_batch(dev):
    from raft_tpu_torch.cluster import min_cluster_and_distance

    x, _, c = _blobs(dev, n=8192, d=128, k=1024)
    full = min_cluster_and_distance(x, c, engine="cuda")
    for m in (1, 2, 7, 64, 1000, 4097):
        part = min_cluster_and_distance(x[:m], c, engine="cuda")
        assert torch.equal(part.key, full.key[:m])
        assert torch.equal(part.value, full.value[:m])


def test_l1_fit_launches_b5(dev):
    from raft_tpu_torch import cluster, stats
    from raft_tpu_torch.cluster import InitMethod, KMeansParams
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.kernels import native

    x, _, _ = _blobs(dev, n=10_000, d=32, k=64)
    c0 = x[:64].clone()
    p = KMeansParams(n_clusters=64, init=InitMethod.Array, max_iter=5,
                     tol=0.0, metric=DistanceType.L1, batch_samples=2048)
    native.reset_launches()
    kern = cluster.fit(p, x, centroids=c0, loop="fori")
    # 5 iterations + the final E-step, 5 row blocks each
    assert native.LAUNCHES["pairwise_accumulate"] == 6 * 5
    assert native.LAUNCHES["fused_l2_nn"] == 0
    plain = cluster.fit(p, x, centroids=c0, loop="fori", engine="torch")
    lk, _ = cluster.predict(p, x, kern.centroids)
    lp, _ = cluster.predict(p, x, plain.centroids, engine="torch")
    assert float(stats.adjusted_rand_index(lk, lp)) >= 0.999
    np.testing.assert_allclose(float(kern.inertia), float(plain.inertia),
                               rtol=1e-5)


def test_bfloat16_fit_keeps_centroids_bfloat16(dev):
    from raft_tpu_torch import cluster, stats
    from raft_tpu_torch.cluster import KMeansParams
    from raft_tpu_torch.kernels import native

    x, truth, _ = _blobs(dev, n=20_000, d=64, k=64)
    xb = x.bfloat16()
    native.reset_launches()
    out = cluster.fit_predict(KMeansParams(n_clusters=64, seed=1), xb)
    assert out.centroids.dtype == torch.bfloat16
    assert out.inertia.dtype == torch.float32
    assert native.LAUNCHES["fused_l2_nn_partials"] == int(out.n_iter)
    assert float(stats.adjusted_rand_index(truth, out.labels)) > 0.95


def test_init_reads_nothing_back_per_step(dev):
    import warnings

    from raft_tpu_torch.cluster import init_plus_plus
    from raft_tpu_torch.random import RngState

    x, _, _ = _blobs(dev, n=20_000, d=32, k=128)
    init_plus_plus(RngState(0), x, 32)          # load the kernels first
    syncs = []
    for k in (32, 128):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                init_plus_plus(RngState(0), x, k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum("synchronizing CUDA operation" in str(w.message)
                         for w in caught))
    # the uniforms' one move to the card at most; none per round or step
    assert syncs[0] == syncs[1] <= 2, syncs
