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
plain version's atomics); LUT scores (B4) to 1e-5 × Σ_m |lut term| of the
plain version (another summation order).
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


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16, torch.float8_e4m3fn])
@pytest.mark.parametrize("nq,cap,pq_dim,pq_bits", [
    (1, 37, 8, 8), (37, 300, 64, 8), (5, 1000, 12, 5), (9, 257, 10, 5),
    (3, 129, 9, 7), (64, 700, 16, 4), (2, 50, 64, 6),
    # rows beyond one block's shared memory, staged in subspace chunks
    (3, 300, 480, 8), (4, 130, 2000, 5)])
def test_lut_score_kernel_matches_plain(dev, nq, cap, pq_dim, pq_bits,
                                        lut_dtype):
    """B4 reads each query's row of a code block in place; scores to
    1e-5 × Σ_m |lut term| of the plain version (another summation order),
    for rows that fit one block's shared memory and rows staged in
    chunks."""
    from raft_tpu_torch.kernels import ivf_pq_lut
    from raft_tpu_torch.neighbors.ivf_pq import _pack_codes

    g = torch.Generator(device="cpu").manual_seed(nq + cap + pq_bits)
    kcb = 1 << pq_bits
    n_rows = 7
    codes = torch.randint(0, kcb, (n_rows * cap, pq_dim), generator=g)
    block = _pack_codes(codes, pq_bits).reshape(n_rows, cap, -1).to(dev)
    rows = torch.randint(0, n_rows, (nq,), generator=g,
                         dtype=torch.int32).to(dev)
    lut = (torch.rand(nq, pq_dim * kcb, generator=g) * 400).to(dev)
    lut = lut.to(lut_dtype)
    got = ivf_pq_lut.lut_score_rows(block, rows, lut, pq_dim, pq_bits, kcb)
    torch.cuda.synchronize()
    gathered = block[rows.long()]
    ref = ivf_pq_lut._lut_score_plain(gathered, lut, pq_dim, pq_bits, kcb)
    mag = ivf_pq_lut._lut_score_plain(gathered, lut.float().abs(), pq_dim,
                                      pq_bits, kcb)
    assert bool(((got - ref).abs() <= 1e-5 * mag).all())
    # the JAX signature: already gathered codes, rows = arange(nq)
    again = ivf_pq_lut.lut_score_rows(
        gathered, torch.arange(nq, dtype=torch.int32, device=dev), lut,
        pq_dim, pq_bits, kcb)
    assert torch.equal(again, got)
    # a row outside the block clamps into it
    wild = torch.where(rows == n_rows - 1, n_rows + 5, rows)
    wild = torch.where(rows == 0, -3, wild)
    clamped = ivf_pq_lut.lut_score_rows(block, wild, lut, pq_dim, pq_bits,
                                        kcb)
    assert torch.equal(clamped, got)


def test_ivf_pq_rows_do_not_depend_on_the_batch(dev):
    """The IVF-PQ serving contract: a query's bits are the same in every
    batch, for the float32 and the fp8 LUT, and the kernel path equals the
    plain path's ids up to near-ties."""
    from raft_tpu_torch.neighbors import ivf_pq

    g = torch.Generator(device="cpu").manual_seed(12)
    x = torch.randn(40000, 64, generator=g)
    idx = ivf_pq.build(ivf_pq.IndexParams(n_lists=128), x.to(dev))
    q = torch.randn(256, 64, generator=g).to(dev)
    for lut in ("float32", "float8_e4m3"):
        engines = ivf_pq._resolve_engines(idx, None)
        assert engines == ("cuda", "cuda")
        d, i = ivf_pq._full_search_impl(q, idx, 10, 20, lut, engines)
        for n in (8, 32, 128):
            dn, i_n = ivf_pq._full_search_impl(q[:n], idx, 10, 20, lut,
                                               engines)
            assert torch.equal(dn, d[:n]) and torch.equal(i_n, i[:n])
        _, ip = ivf_pq.search(ivf_pq.SearchParams(20, lut_dtype=lut), idx,
                              q, 10, engine="torch")
        agree = (i[:, :, None] == ip[:, None, :]).any(-1).float().mean()
        assert float(agree) >= 0.99
