"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one; run
them on a machine with a card with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q -m cuda``
(``--noconftest``: the suite's conftest imports jax, which the port's
machine need not have).
Tolerances: select_k positions and values bit-identical; fused L2 NN
labels identical except near ties (two best distances within 1e-5
relative), values to rtol 1e-5 or, where the distance is far below the
norms (B1's 3xTF32 products), to 1e-5 of ‖x‖² + ‖y‖², and a row's bits
the same in any batch; M-step partials from equal labels to
1e-5 of the members' absolute sums (the kernel adds each block's rows and
then the blocks in a fixed order, the plain version's ``index_add_`` in
its own), and bit for bit from run to run and between one launch for S
subspaces and S launches of one; LUT scores (B4) to 1e-5 × Σ_m |lut
term| of the plain version (another summation order), and B4's scan mode
bit for bit against raw mode + the PyTorch epilogue + B2 (both sum in m
order in one thread); pairwise accumulations (B5) to
rtol 1e-5 of the plain version for the summing ops (their terms are
non-negative, so that is 1e-5 of Σ|terms|; fused multiply-add and powf
round differently), linf and the hamming count exactly, and a row's bits
the same at every batch size (each output summed in k order by one
thread, whatever the tile).
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


def _assert_nn_close(x, y, val, idx, pv, pi):
    """B1's contract against its plain version: labels equal except near
    ties; values within 1e-5 of ‖x‖² + ‖y‖² of the row's label (the scale
    at which the float32 expanded form rounds)."""
    diff = idx != pi
    if bool(diff.any()):
        assert not bool((diff & ~_near_tie(x, y)).any())
    scale = (x * x).sum(1) + (y * y).sum(1)[idx.long()]
    assert bool(((val - pv).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("m,k,d", [
    (1, 1, 128), (1, 1000, 33), (7, 63, 100), (130, 64, 33), (129, 65, 128),
    (1000, 1, 8), (257, 1000, 9), (300, 500, 256), (50, 20, 4),
    (200, 100, 2), (100, 50, 300), (4097, 31, 64)])
def test_fused_l2_nn_kernel_widths_and_edges(dev, m, k, d):
    """B1 at widths off 4 and off the 32-feature stage (33, 100, 9), narrow
    and wide rows on either side of the tensor-core kernel's range, k below
    and just above a 64-centroid tile, k = 1, m = 1, and a duplicate
    centroid (the lower index wins)."""
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn

    g = torch.Generator(device="cpu").manual_seed(m * 7 + k * 3 + d)
    x = torch.randn(m, d, generator=g).to(dev)
    y = torch.randn(k, d, generator=g).to(dev)
    if k > 3:
        y[k - 1] = y[1]
    val, idx = fused_l2_nn(x, y)
    torch.cuda.synchronize()
    assert val.shape == (m,) and idx.dtype == torch.int32
    _assert_nn_close(x, y, val, idx, *fused_l2_nn_plain(x, y))
    if k > 3:
        assert not bool((idx == k - 1).any())


@pytest.mark.parametrize("d", [32, 128])
def test_fused_l2_nn_kernel_cancellation(dev, d):
    """Rows of x that are rows of y plus noise at 1e-3 of their norm: the
    distance is 1e-6 of the norms, where the products' error shows first.
    Each row finds its source row, with the value to 1e-5 of the norms."""
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn

    g = torch.Generator(device="cpu").manual_seed(d)
    y = torch.randn(1024, d, generator=g) * 10.0
    src = torch.randint(0, 1024, (20000,), generator=g)
    noise = torch.randn(20000, d, generator=g)
    noise *= 1e-3 * y[src].norm(dim=1, keepdim=True) / noise.norm(
        dim=1, keepdim=True)
    x = (y[src] + noise).to(dev)
    y = y.to(dev)
    val, idx = fused_l2_nn(x, y)
    pv, pi = fused_l2_nn_plain(x, y)
    torch.cuda.synchronize()
    assert torch.equal(idx.cpu().long(), src)
    _assert_nn_close(x, y, val, idx, pv, pi)


def test_fused_l2_nn_rows_do_not_depend_on_the_batch(dev):
    """A row's (value, label) bits are the same whether it rides in a
    batch of 1, 7, 1,000 or 4,097 rows, at any position in its block."""
    from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn

    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(4097, 128, generator=g).to(dev)
    y = torch.randn(1024, 128, generator=g).to(dev)
    val, idx = fused_l2_nn(x, y)
    for m in (1, 7, 1000, 4097):
        v, i = fused_l2_nn(x[:m], y)
        assert torch.equal(v, val[:m]) and torch.equal(i, idx[:m])
    for r0 in (5, 127, 1000):
        v, i = fused_l2_nn(x[r0:r0 + 7], y)
        assert torch.equal(v, val[r0:r0 + 7])
        assert torch.equal(i, idx[r0:r0 + 7])


def test_fused_l2_nn_kernel_nan_never_wins(dev):
    """A NaN centroid is never the label; a NaN row gets label 0."""
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn

    g = torch.Generator(device="cpu").manual_seed(12)
    x = torch.randn(500, 64, generator=g).to(dev)
    y = torch.randn(200, 64, generator=g).to(dev)
    y[3, 10] = float("nan")
    x[7, 0] = float("nan")
    val, idx = fused_l2_nn(x, y)
    far = y.clone()
    far[3] = 1e30           # never the nearest row
    pv, pi = fused_l2_nn_plain(x, far)
    torch.cuda.synchronize()
    assert not bool((idx == 3).any())
    assert int(idx[7]) == 0
    keep = torch.ones(500, dtype=torch.bool, device=dev)
    keep[7] = False
    _assert_nn_close(x[keep], far, val[keep], idx[keep], pv[keep], pi[keep])


@pytest.mark.parametrize("m,k,d", [(1000, 1000, 300), (300, 70, 257),
                                   (129, 65, 2048)])
def test_fused_l2_nn_fma_kernel_wide_rows(dev, m, k, d):
    """Rows wider than TC_MAX_D take the float32 FMA kernel, which holds
    the contract against the plain version."""
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels.fused_l2nn import (TC_MAX_D, fused_l2_nn,
                                                   tensor_cores)

    assert d > TC_MAX_D and not tensor_cores(d, False)
    g = torch.Generator(device="cpu").manual_seed(m + k + d)
    x = torch.randn(m, d, generator=g).to(dev)
    y = torch.randn(k, d, generator=g).to(dev)
    y[k - 1] = y[1]
    val, idx = fused_l2_nn(x, y)
    torch.cuda.synchronize()
    _assert_nn_close(x, y, val, idx, *fused_l2_nn_plain(x, y))
    assert not bool((idx == k - 1).any())


@pytest.mark.parametrize("d", [2, 33, 128])
def test_fused_l2_nn_bf16_dot_keeps_the_fma_kernel(dev, d):
    """bf16_dot is dispatched to the float32 FMA kernel (its bfloat16
    products are exact in float32) at every width, also where float32
    products take the tensor cores; it sums the plain version's exact
    products in another order."""
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn, tensor_cores

    assert not tensor_cores(d, True) and tensor_cores(d, False)
    g = torch.Generator(device="cpu").manual_seed(4 + d)
    x = torch.randn(2000, d, generator=g).to(dev)
    y = torch.randn(300, d, generator=g).to(dev)
    val, idx = fused_l2_nn(x, y, bf16_dot=True)
    pv, pi = fused_l2_nn_plain(x, y, bf16_dot=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(val, pv, rtol=1e-5, atol=1e-4)
    diff = idx != pi
    if bool(diff.any()):
        xb, yb = x.bfloat16().double(), y.bfloat16().double()
        dd = ((x.double() ** 2).sum(1)[:, None] + (y.double() ** 2).sum(1)
              - 2 * xb @ yb.T)
        two = torch.topk(dd, 2, dim=1, largest=False).values
        near = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].clamp_min(1e-30)
        assert not bool((diff & ~near).any())


def test_fused_l2_nn_partials_wide_e_step_is_b1(dev):
    """B3 at wide rows takes B1's tensor-core E-step: its labels and
    distances are B1's bits, its partials hold their contract."""
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_partials_plain
    from raft_tpu_torch.kernels.fused_l2nn import (fused_l2_nn,
                                                   fused_l2_nn_partials,
                                                   tensor_cores)

    g = torch.Generator(device="cpu").manual_seed(21)
    x = torch.randn(30000, 128, generator=g).to(dev)
    y = x[torch.randperm(30000, generator=g)[:1024].to(dev)]
    assert tensor_cores(128, False)
    out = fused_l2_nn_partials(x, y)
    val, idx = fused_l2_nn(x, y)
    torch.cuda.synchronize()
    assert torch.equal(out[0], val) and torch.equal(out[1], idx)
    _assert_partials_close(x, y, None, out,
                           fused_l2_nn_partials_plain(x, y))


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
    # rows beyond one block's shared memory, read from global memory
    (3, 300, 480, 8), (4, 130, 2000, 5)])
def test_lut_score_kernel_matches_plain(dev, nq, cap, pq_dim, pq_bits,
                                        lut_dtype):
    """B4 reads each query's row of a code block in place; scores to
    1e-5 × Σ_m |lut term| of the plain version (another summation order),
    for rows that fit one block's shared memory and rows read from global
    memory."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_pairwise_accumulate_same_bits_at_every_bucket(dev, dtype):
    """B5 picks its tile by the batch (128, 64, 32 or 16 rows); every
    output is still summed in k order by one thread, so a row's bits are
    the same at every bucket size from 1 to 1,024 and off the ladder."""
    from raft_tpu_torch.kernels import pairwise as pk

    g = torch.Generator(device="cpu").manual_seed(21)
    x = torch.randn(1024, 128, generator=g).to(dev).to(dtype)
    y = torch.randn(3000, 128, generator=g).to(dev).to(dtype)
    for op in pk.OPS:
        full = pk.pairwise_accumulate(x, y, op, 3.0)
        for m in (1, 8, 16, 17, 32, 33, 37, 64, 65, 128, 256, 512):
            assert torch.equal(pk.pairwise_accumulate(x[:m], y, op, 3.0),
                               full[:m]), (op, m)


@pytest.mark.parametrize("k", [1, 3, 127, 960])
@pytest.mark.parametrize("m", [5, 40, 70])
def test_pairwise_accumulate_ragged_k(dev, m, k):
    """B5 at ragged k (the scalar staging path below a whole vector and
    the vector path at 960) for every op and input type, under the 16-,
    64- and 128-row tiles."""
    from raft_tpu_torch.kernels import pairwise as pk

    g = torch.Generator(device="cpu").manual_seed(m * 1000 + k)
    x = torch.round(torch.randn(m, k, generator=g) * 4) / 4
    y = torch.round(torch.randn(333, k, generator=g) * 4) / 4
    x[0, k // 2] = float("nan")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xd, yd = x.to(dev).to(dtype), y.to(dev).to(dtype)
        for op in pk.OPS:
            got = pk.pairwise_accumulate(xd, yd, op, 3.0)
            _assert_accumulate_close(
                got, pk.pairwise_accumulate_plain(xd, yd, op, 3.0), op)


def _scan_data(dev, nq, n_steps, cap, pq_dim, pq_bits, lut_dtype, n_luts,
               seed):
    """Rows of every fill (full, partial, one slot, empty) and the empty
    dummy row 6; dummy steps; per-probe tables when n_luts > 1; the fp8
    scale with the fp8 LUT; the list-side sums."""
    from raft_tpu_torch.neighbors.ivf_pq import _pack_codes

    g = torch.Generator(device="cpu").manual_seed(seed)
    kcb = 1 << pq_bits
    n_rows = 7
    codes = torch.randint(0, kcb, (n_rows * cap, pq_dim), generator=g)
    block = _pack_codes(codes, pq_bits).reshape(n_rows, cap, -1)
    sizes = torch.tensor([cap, cap // 2, 1, 0, cap - 1, 3, 0],
                         dtype=torch.int32)
    ids = torch.randperm(n_rows * cap * 3, generator=g)[:n_rows * cap].to(
        torch.int32).reshape(n_rows, cap)
    ids[torch.arange(cap)[None, :] >= sizes[:, None]] = -1
    phys = torch.randint(0, n_rows, (nq, n_steps), generator=g,
                         dtype=torch.int32)
    phys[:, -2:] = n_rows - 1
    shape = (nq, pq_dim * kcb) if n_luts == 1 else (nq, n_luts, pq_dim * kcb)
    lut = (torch.rand(shape, generator=g) * 400).to(lut_dtype)
    probe_ord = (torch.randint(0, n_luts, (nq, n_steps), generator=g,
                               dtype=torch.int32) if n_luts > 1 else None)
    base = torch.rand(nq, n_steps, generator=g) * 100 - 50
    csum = torch.rand(n_rows, cap, generator=g) * 40 - 20
    scale = (torch.rand(nq, generator=g) * 2 + 0.5
             if lut_dtype == torch.float8_e4m3fn else None)
    out = [block, sizes, ids, phys, lut, probe_ord, base, csum, scale]
    return [t.to(dev) if t is not None else None for t in out]


def _assert_scan_equals_raw(dev, data, n_steps, cap, pq_dim, pq_bits,
                            ks=(10, 40)):
    """Scan mode on *data* (from :func:`_scan_data`) equals raw mode + the
    PyTorch epilogue + the live mask + B2 bit for bit: each step's
    (values, slots), and after the one select over the steps the
    (distances, ids) of the per-step path's running merge; one scan
    launch; its plain twin to the raw kernel's tolerance."""
    from raft_tpu_torch.kernels import ivf_pq_lut, native
    from raft_tpu_torch.kernels.select_k import select_k_blockwise
    from raft_tpu_torch.neighbors._common import scan_probe_lists
    from raft_tpu_torch.neighbors.ivf_pq import _select_scanned

    block, sizes, ids, phys, lut, probe_ord, base, csum, scale = data
    kcb = 1 << pq_bits
    slots_all = torch.arange(cap, device=dev)

    def step_scores(s):
        rows = phys[:, s]
        lut_t = ivf_pq_lut._lut_slice(lut, probe_ord, s)
        d = ivf_pq_lut.lut_score_rows(block, rows, lut_t, pq_dim, pq_bits,
                                      kcb)
        if scale is not None:
            d = d / scale[:, None]
        d = d + base[:, s, None]
        return d + csum[rows.long()]

    for k in ks:
        kk = min(k, cap)
        native.reset_launches()
        vals, slots = ivf_pq_lut.lut_scan_topk(block, phys, sizes, lut,
                                               probe_ord, base, csum, scale,
                                               pq_dim, pq_bits, kcb, kk)
        torch.cuda.synchronize()
        assert native.LAUNCHES["lut_scan"] == 1
        for s in range(n_steps):
            d = step_scores(s)
            live = slots_all[None, :] < sizes[phys[:, s].long()][:, None]
            d = torch.where(live, d, torch.full_like(d, float("inf")))
            rv, rp = select_k_blockwise(d, kk)
            assert torch.equal(vals[:, s], rv) and torch.equal(slots[:, s],
                                                               rp), (k, s)
        got = _select_scanned(vals, slots, phys, ids, k, True, "cuda")
        ref = scan_probe_lists(phys, lambda rows, s: step_scores(s), ids,
                               sizes, k, select_min=True,
                               dtype=torch.float32, engine="cuda",
                               xs=(range(n_steps),))
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        # its plain twin on the same inputs, to the raw kernel's tolerance
        pv, _ = ivf_pq_lut.lut_scan_topk_plain(block, phys, sizes, lut,
                                               probe_ord, base, csum, scale,
                                               pq_dim, pq_bits, kcb, kk)
        fin = torch.isfinite(pv)
        assert torch.equal(fin, torch.isfinite(vals))
        assert bool(((vals - pv).abs()[fin]
                     <= 1e-5 * (pv.abs()[fin] + 400.0 * pq_dim)).all())


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16, torch.float8_e4m3fn])
@pytest.mark.parametrize("nq,cap,pq_dim,pq_bits,n_luts", [
    (1, 300, 64, 8, 1), (37, 300, 64, 8, 1), (37, 257, 64, 8, 4),
    (37, 1001, 13, 4, 1), (5, 999, 10, 5, 3), (37, 333, 17, 7, 1),
    # LUT rows wider than a block's shared memory: read from global memory
    (3, 300, 480, 8, 1), (4, 130, 2000, 5, 2)])
def test_lut_scan_equals_raw_epilogue_select(dev, nq, cap, pq_dim, pq_bits,
                                             n_luts, lut_dtype):
    """B4's scan mode equals raw mode + the PyTorch epilogue + the live
    mask + B2 bit for bit: each step's (values, slots), and after the one
    select over the steps the (distances, ids) of the per-step path's
    running merge, for k below and above 24; one scan launch."""
    n_steps = 6
    data = _scan_data(dev, nq, n_steps, cap, pq_dim, pq_bits, lut_dtype,
                      n_luts, nq + cap + pq_bits)
    _assert_scan_equals_raw(dev, data, n_steps, cap, pq_dim, pq_bits)


@pytest.mark.parametrize("lut_dtype", [torch.bfloat16, torch.float16,
                                       torch.float8_e4m3fn])
@pytest.mark.parametrize("nq", [1, 37, 600])
def test_lut_scan_runs_of_dummy_steps(dev, nq, lut_dtype):
    """Per-probe LUTs (staged per step, double-buffered) across runs of 1
    to 7 consecutive dummy steps: a solo query (each step split over
    several blocks), 37 queries (a few steps per block) and 600 (all 40
    steps in one block); scan mode equals raw mode + epilogue + B2 bit for
    bit, and repeats itself bit for bit."""
    from raft_tpu_torch.kernels import ivf_pq_lut

    n_steps, cap, pq_dim, pq_bits = 40, 2200, 16, 8
    data = _scan_data(dev, nq, n_steps, cap, pq_dim, pq_bits, lut_dtype, 3,
                      nq + 7)
    phys = data[3]
    # live steps at 0, 2, 5, 9, 14, 20, 27, 35: dummy runs of 1 to 7
    live_at = torch.tensor([0, 2, 5, 9, 14, 20, 27, 35], device=dev)
    dummy = torch.ones(n_steps, dtype=torch.bool, device=dev)
    dummy[live_at] = False
    phys[:, dummy] = 6
    phys[:, ~dummy] = phys[:, ~dummy] % 6
    _assert_scan_equals_raw(dev, data, n_steps, cap, pq_dim, pq_bits,
                            ks=(10, 100))
    block, sizes, _, phys, lut, probe_ord, base, csum, scale = data
    runs = [ivf_pq_lut.lut_scan_topk(block, phys, sizes, lut, probe_ord,
                                     base, csum, scale, pq_dim, pq_bits,
                                     1 << pq_bits, 10) for _ in range(4)]
    for v, sl in runs[1:]:
        assert torch.equal(v, runs[0][0]) and torch.equal(sl, runs[0][1])


def test_ivf_pq_search_scans_in_one_launch(dev):
    """The IVF-PQ search of a query batch runs B4 once, in scan mode, for
    the float32 and the fp8 LUT; k above B2's limit keeps the per-step
    raw launches."""
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_pq

    g = torch.Generator(device="cpu").manual_seed(16)
    x = torch.randn(40000, 64, generator=g)
    idx = ivf_pq.build(ivf_pq.IndexParams(n_lists=128), x.to(dev))
    q = torch.randn(300, 64, generator=g).to(dev)
    for lut in ("float32", "float8_e4m3"):
        native.reset_launches()
        ivf_pq._full_search_impl(q, idx, 10, 20, lut, ("cuda", "cuda"))
        torch.cuda.synchronize()
        assert native.LAUNCHES["lut_scan"] == 1
        assert native.LAUNCHES["lut_score"] == 0
    native.reset_launches()
    ivf_pq._full_search_impl(q, idx, 200, 20, "float32", ("cuda", "cuda"))
    assert native.LAUNCHES["lut_scan"] == 0
    assert native.LAUNCHES["lut_score"] > 1
