"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one; run
them on a machine with a card with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q -m cuda``
(``--noconftest``: the suite's conftest imports jax, which the port's
machine need not have).
Tolerances: select_k positions and values bit-identical; fused L2 NN
labels identical except near ties (two best distances within 1e-5
relative), values to rtol 1e-5; M-step partials from equal labels to
1e-5 of the members' absolute sums (the kernel adds each block's rows and
then the blocks in a fixed order, the plain version's ``index_add_`` in
its own), and bit for bit from run to run and between one launch for S
subspaces and S launches of one; LUT scores (B4) to 1e-5 × Σ_m |lut term| of the
plain version (another summation order); pairwise accumulations (B5) to
rtol 1e-5 of the plain version for the summing ops (their terms are
non-negative, so that is 1e-5 of Σ|terms|; fused multiply-add and powf
round differently), linf and the hamming count exactly.
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


def _assert_partials_close(x, y, w, out, ref):
    """One problem's kernel output against its plain version: labels equal
    except near ties; values within 1e-5 of ‖x‖² + ‖y‖² (the expanded form
    rounds at the scale of the norms, and the kernel forms the norms by
    fused multiply-adds, the plain version by a reduction: a row that is
    one of the centres has a distance of a few ulp of its norm, not 0);
    sums and weights from the kernel's labels within 1e-5 of the members'
    absolute sums; inertia to rtol 1e-5."""
    from raft_tpu_torch.distance.fused_l2_nn import cluster_partials_plain

    val, idx, sums, wsum, inertia = out
    k = y.shape[0]
    diff = idx != ref[1]
    if bool(diff.any()):
        assert not bool((diff & ~_near_tie(x, y)).any())
    scale = (x * x).sum(1) + (y * y).sum(1)[idx.long()]
    assert bool(((val - ref[0]).abs() <= 1e-5 * scale + 1e-6).all())
    ps, pw = cluster_partials_plain(x, idx, k, w)
    scale, wscale = cluster_partials_plain(x.abs(), idx, k, w)
    assert bool(((sums - ps).abs() <= 1e-5 * scale + 1e-6).all())
    assert bool(((wsum - pw).abs() <= 1e-5 * wscale + 1e-6).all())
    torch.testing.assert_close(inertia, ref[4], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ds", [1, 2, 4, 16])
@pytest.mark.parametrize("k", [7, 256])
@pytest.mark.parametrize("s", [1, 3, 64])
def test_fused_l2_nn_partials_batched_matches_plain(dev, s, k, ds, weighted):
    """B3 at narrow rows, all S subspaces in one launch, against its plain
    twin; n = 3001 is not a multiple of the kernel's row chunk or pass."""
    from raft_tpu_torch.distance.fused_l2_nn import (
        fused_l2_nn_partials_batched_plain)
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.kernels.fused_l2nn import (
        fused_l2_nn_partials_batched)

    n = 3001
    g = torch.Generator(device="cpu").manual_seed(s * 1000 + k * 10 + ds)
    x = torch.randn(s, n, ds, generator=g).to(dev)
    y = torch.stack([x[i, torch.randperm(n, generator=g)[:k].to(dev)]
                     for i in range(s)])
    w = (torch.rand(s, n, generator=g) + 0.5).to(dev) if weighted else None
    native.reset_launches()
    out = fused_l2_nn_partials_batched(x, y, w)
    torch.cuda.synchronize()
    assert native.LAUNCHES["fused_l2_nn_partials"] == 1
    ref = fused_l2_nn_partials_batched_plain(x, y, w)
    assert out[0].shape == (s, n) and out[2].shape == (s, k, ds)
    for i in range(s):
        _assert_partials_close(x[i], y[i], None if w is None else w[i],
                               [t[i] for t in out], [t[i] for t in ref])
    again = fused_l2_nn_partials_batched(x, y, w)
    for a, b in zip(again, out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ds", [2, 16])
@pytest.mark.parametrize("s", [3, 64])
def test_fused_l2_nn_partials_batched_equals_per_subspace(dev, s, ds):
    """One launch for S subspaces gives the bits of S launches of one, with
    no weights, weights shared by the subspaces, and weights per subspace."""
    from raft_tpu_torch.kernels.fused_l2nn import (
        fused_l2_nn_partials, fused_l2_nn_partials_batched)

    n, k = 5000, 256
    g = torch.Generator(device="cpu").manual_seed(s + ds)
    x = torch.randn(s, n, ds, generator=g).to(dev)
    y = torch.randn(s, k, ds, generator=g).to(dev)
    shared = (torch.rand(n, generator=g) + 0.5).to(dev)
    per = (torch.rand(s, n, generator=g) + 0.5).to(dev)
    for w in (None, shared, per):
        got = fused_l2_nn_partials_batched(x, y, w)
        for i in range(s):
            wi = None if w is None else (w if w.ndim == 1 else w[i])
            one = fused_l2_nn_partials(x[i], y[i], wi)
            for a, b in zip(got, one):
                assert torch.equal(a[i], b)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m,k,d", [(20000, 1500, 37), (3000, 1024, 128),
                                   (257, 3, 2048), (100, 300, 17),
                                   (5000, 257, 16)])
def test_cluster_partials_kernel_wide_shapes(dev, m, k, d, weighted):
    """B3 at wide rows (B1's E-step, then the column-slab partials): more
    clusters than one block accumulates (1,500), widths off the 16-column
    slab, 2,048 features, and k just above the narrow kernel's 256."""
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_partials_plain
    from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn_partials

    g = torch.Generator(device="cpu").manual_seed(m + k + d)
    x = torch.randn(m, d, generator=g).to(dev)
    y = x[torch.randperm(m, generator=g)[:k].to(dev)] if k <= m else \
        torch.randn(k, d, generator=g).to(dev)
    w = (torch.rand(m, generator=g) + 0.5).to(dev) if weighted else None
    out = fused_l2_nn_partials(x, y, w)
    torch.cuda.synchronize()
    _assert_partials_close(x, y, w, out, fused_l2_nn_partials_plain(x, y, w))
    again = fused_l2_nn_partials(x, y, w)
    assert torch.equal(again[2], out[2]) and torch.equal(again[3], out[3])


def _ties_nan_inf(rows, n, seed):
    rng = np.random.default_rng(seed)
    v = (rng.integers(-40, 40, (rows, n)) / 4.0).astype(np.float32)
    flat = v.reshape(-1)
    spots = rng.choice(flat.size, max(3, flat.size // 40), replace=False)
    flat[spots[0::3]] = np.nan
    flat[spots[1::3]] = np.inf
    flat[spots[2::3]] = -np.inf
    return v


@pytest.mark.parametrize("rows", [1, 37, 1024])
@pytest.mark.parametrize("n", [16384, 100000, 2448, 1024])
def test_select_k_kernel_long_rows_bit_identical(dev, n, rows):
    """B2 against the plain version, positions and values bit for bit, at
    the main paths' row lengths and beyond: k from 1 to 128, ties, NaN and
    ±inf, float32 / float16 / bfloat16, select-min and select-max, rows
    whose starts lie off the 16-byte boundary (a view at an odd offset)
    and a column slice of a wider matrix."""
    from raft_tpu_torch.kernels.select_k import select_k_blockwise
    from raft_tpu_torch.matrix.select_k import select_k_plain

    v = torch.from_numpy(_ties_nan_inf(rows, n, n + rows)).to(dev)
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        vd = v.to(dt)
        flat = torch.empty(rows * n + 1, dtype=dt, device=dev)
        flat[1:] = vd.reshape(-1)
        wide = torch.zeros(rows, n + 3, dtype=dt, device=dev)
        wide[:, 1:n + 1] = vd
        for t in (vd, flat[1:].view(rows, n), wide[:, 1:n + 1]):
            for k in (1, 10, 20, 32, 33, 128):
                for select_min in (True, False):
                    kv, kp = select_k_blockwise(t, k, select_min)
                    pv, pp = select_k_plain(t, k, select_min)
                    assert kv.dtype == t.dtype
                    assert torch.equal(kp, pp), (dt, k, select_min)
                    assert torch.equal(torch.nan_to_num(kv.float(), nan=7.5),
                                       torch.nan_to_num(pv.float(), nan=7.5))


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


def _assert_accumulate_close(got, ref, op):
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    if op in ("linf", "hamming"):
        assert torch.equal(got[~nan], ref[~nan])
    else:
        assert bool(((got - ref).abs() <= 1e-5 * ref.abs())[~nan].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("op", ["l1", "l2", "linf", "lp", "hamming",
                                "canberra"])
@pytest.mark.parametrize("m,n,k", [(37, 129, 1), (1, 16385, 127),
                                   (64, 700, 960), (300, 65, 33)])
def test_pairwise_accumulate_kernel_matches_plain(dev, m, n, k, op, dtype):
    """B5 against its plain version: values quantized to quarters (equal
    and zero coordinates occur), one NaN in x; any k (960 is above the TPU
    kernel's cap of 512)."""
    from raft_tpu_torch.kernels import pairwise as pk

    g = torch.Generator(device="cpu").manual_seed(m + n + k)
    x = torch.round(torch.randn(m, k, generator=g) * 4) / 4
    y = torch.round(torch.randn(n, k, generator=g) * 4) / 4
    x[0, k // 2] = float("nan")
    x, y = x.to(dev).to(dtype), y.to(dev).to(dtype)
    got = pk.pairwise_accumulate(x, y, op, 3.0)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _assert_accumulate_close(got, pk.pairwise_accumulate_plain(x, y, op, 3.0),
                             op)


def test_pairwise_accumulate_rows_do_not_depend_on_the_batch(dev):
    from raft_tpu_torch.kernels import pairwise as pk

    g = torch.Generator(device="cpu").manual_seed(14)
    x = torch.randn(1024, 128, generator=g).to(dev)
    y = torch.randn(5000, 128, generator=g).to(dev)
    for op in pk.OPS:
        full = pk.pairwise_accumulate(x, y, op, 3.0)
        assert torch.equal(pk.pairwise_accumulate(x[:37], y, op, 3.0),
                           full[:37])


def test_brute_force_serve_l1_coalesced_equals_solo(dev):
    """The L1 brute-force engine runs B5 and B2, and each request's
    coalesced result equals its solo knn bit for bit."""
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.serve import ServeEngine

    g = torch.Generator(device="cpu").manual_seed(15)
    x = torch.randn(60000, 64, generator=g).to(dev)
    reqs = [torch.randn(n, 64, generator=g).numpy()
            for n in (1, 7, 300, 1500, 33, 128)]
    native.reset_launches()
    eng = ServeEngine(x, 10, metric="l1", max_batch=1024)
    eng.warmup()
    out = eng.search(reqs)
    assert native.LAUNCHES["pairwise_accumulate"] > 0
    assert native.LAUNCHES["select_k"] > 0
    assert eng.stats["solo_fallbacks"] == 1
    for q, (d, i) in zip(reqs, out):
        sd, si = brute_force.knn(x, q, 10, "l1")
        assert np.array_equal(d, sd.cpu().numpy())
        assert np.array_equal(i, si.cpu().numpy())
    _, ip = brute_force.knn(x, reqs[2], 10, "l1", engine="torch")
    agree = (torch.as_tensor(out[2][1])[:, :, None]
             == ip.cpu()[:, None, :]).any(-1).float().mean()
    assert float(agree) >= 0.99
