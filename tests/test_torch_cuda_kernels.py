"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one; run
them on a machine with a card with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q -m cuda``
(``--noconftest``: the suite's conftest imports jax, which the port's
machine need not have).
Tolerances: select_k positions and values bit-identical; fused L2 NN
labels identical except near ties (two best distances within 1e-5
relative), values to rtol 1e-5; M-step partials from equal labels to
1e-5 of the members' absolute sums (summation order differs from the
plain version's atomics).
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


def _near_tie(x, y):
    d = torch.cdist(x.double(), y.double()) ** 2
    two = torch.topk(d, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].clamp_min(1e-30)


@pytest.mark.parametrize("m,k,d", [(1000, 1000, 100), (300, 70, 33),
                                   (64, 1, 8), (4097, 130, 128)])
def test_fused_l2_nn_kernel_matches_plain(dev, m, k, d):
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn

    g = torch.Generator(device="cpu").manual_seed(m + k + d)
    x = torch.randn(m, d, generator=g).to(dev)
    y = torch.randn(k, d, generator=g).to(dev)
    if k > 3:
        y[k - 1] = y[1]                           # duplicate: lower wins
    val, idx = fused_l2_nn(x, y)
    pv, pi = fused_l2_nn_plain(x, y)
    torch.cuda.synchronize()
    diff = idx != pi
    if bool(diff.any()):
        assert not bool((diff & ~_near_tie(x, y)).any())
    if k > 3:
        assert not bool((idx == k - 1).any())
    torch.testing.assert_close(val, pv, rtol=1e-5, atol=1e-5)


def test_fused_l2_nn_kernel_bf16_dot_matches_plain(dev):
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn

    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(5000, 128, generator=g).to(dev)
    y = torch.randn(300, 128, generator=g).to(dev)
    val, idx = fused_l2_nn(x, y, bf16_dot=True)
    pv, pi = fused_l2_nn_plain(x, y, bf16_dot=True)
    # both sum the same exact bf16 products in float32, in other orders
    torch.testing.assert_close(val, pv, rtol=1e-5, atol=1e-4)
    diff = idx != pi
    if bool(diff.any()):
        xb, yb = x.bfloat16().double(), y.bfloat16().double()
        d = ((x.double() ** 2).sum(1)[:, None] + (y.double() ** 2).sum(1)
             - 2 * xb @ yb.T)
        two = torch.topk(d, 2, dim=1, largest=False).values
        near = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].clamp_min(1e-30)
        assert not bool((diff & ~near).any())


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_l2_nn_partials_kernel_matches_plain(dev, weighted):
    from raft_tpu_torch.distance.fused_l2_nn import cluster_partials_plain
    from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn_partials

    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(20000, 130, generator=g).to(dev)
    y = torch.randn(300, 130, generator=g).to(dev)
    w = torch.rand(20000, generator=g).to(dev) + 0.5 if weighted else None
    val, idx, sums, wsum, inertia = fused_l2_nn_partials(x, y, w)
    ps, pw = cluster_partials_plain(x, idx, 300, w)
    scale, _ = cluster_partials_plain(x.abs(), idx, 300, w)
    assert bool(((sums - ps).abs() <= 1e-5 * scale + 1e-6).all())
    torch.testing.assert_close(wsum, pw, rtol=1e-5, atol=1e-5)
    again = fused_l2_nn_partials(x, y, w)
    assert torch.equal(again[2], sums) and torch.equal(again[3], wsum)


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k,n", [(1, 20), (10, 257), (20, 1024), (32, 33),
                                 (33, 100), (64, 1024), (100, 5000),
                                 (128, 128)])
def test_select_k_kernel_bit_identical(dev, k, n, select_min):
    from raft_tpu_torch.kernels.select_k import select_k_blockwise
    from raft_tpu_torch.matrix.select_k import select_k_plain

    rng = np.random.default_rng(k * 7 + n)
    v = (rng.integers(-40, 40, (37, n)) / 4.0).astype(np.float32)
    flat = v.reshape(-1)
    spots = rng.choice(flat.size, max(3, flat.size // 40), replace=False)
    flat[spots[0::3]] = np.nan
    flat[spots[1::3]] = np.inf
    flat[spots[2::3]] = -np.inf
    vt = torch.from_numpy(v).to(dev)
    for t in (vt, vt.half(), vt.bfloat16()):
        kv, kp = select_k_blockwise(t, k, select_min)
        pv, pp = select_k_plain(t, k, select_min)
        assert torch.equal(kp, pp)
        assert torch.equal(torch.nan_to_num(kv.float(), nan=7.5),
                           torch.nan_to_num(pv.float(), nan=7.5))


def test_ivf_flat_search_kernel_path_equals_plain_path(dev):
    from raft_tpu_torch.neighbors import ivf_flat

    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(20000, 32, generator=g)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=64), x.to(dev))
    q = torch.randn(500, 32, generator=g).to(dev)
    d1, i1 = ivf_flat.search(ivf_flat.SearchParams(8), idx, q, 10,
                             engine="cuda")
    d2, i2 = ivf_flat.search(ivf_flat.SearchParams(8), idx, q, 10,
                             engine="torch")
    assert torch.equal(i1, i2) and torch.equal(d1, d2)


def test_search_rows_do_not_depend_on_the_batch(dev):
    """A query's result bits must not depend on the batch it rides in —
    the coalesced == solo serving contract (cuBLAS picks its GEMM
    algorithm by shape, which the search avoids)."""
    from raft_tpu_torch.neighbors import ivf_flat

    g = torch.Generator(device="cpu").manual_seed(10)
    x = torch.randn(50000, 128, generator=g)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=128), x.to(dev))
    q = torch.randn(1024, 128, generator=g).to(dev)
    for metric in ("L2Expanded", "InnerProduct"):
        idx.metric = ivf_flat.DistanceType[metric]
        d, i = ivf_flat._search_batch_impl(q, idx, 10, 20, False, "cuda")
        for n in (8, 64, 512):
            dn, i_n = ivf_flat._search_batch_impl(q[:n], idx, 10, 20, False,
                                                  "cuda")
            assert torch.equal(dn, d[:n]) and torch.equal(i_n, i[:n])
