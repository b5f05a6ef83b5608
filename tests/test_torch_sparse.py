"""The port's sparse containers, conversions, structural ops and sparse
linear algebra (``raft_tpu_torch.sparse``) against the JAX package's
(``raft_tpu.sparse``) on the same seeded inputs: containers and padding
equal entry for entry (nnz included), ``from_triplets`` with duplicates
and explicit zeros, every conversion and op, ``csr_to_ell``'s cols, vals
and overflow arrays, SpMV / ELL SpMV / SpMM at rtol 1e-6, degrees,
``row_normalize``, transpose, add, ``symmetrize``, ``weak_cc`` (labels
equal) and the Laplacian, plain and normalised."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.sparse as js
from raft_tpu_torch import native
from raft_tpu_torch import sparse as ts
from raft_tpu_torch.sparse import convert, linalg, op

CPU = "cpu"


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_coo_equal(t, j):
    assert t.shape == j.shape
    assert int(t.nnz) == int(j.nnz)
    np.testing.assert_array_equal(_np(t.rows), np.asarray(j.rows))
    np.testing.assert_array_equal(_np(t.cols), np.asarray(j.cols))
    np.testing.assert_allclose(_np(t.vals), np.asarray(j.vals), rtol=1e-6,
                               atol=1e-7)


def assert_csr_equal(t, j, rtol=1e-6):
    assert t.shape == j.shape
    np.testing.assert_array_equal(_np(t.indptr), np.asarray(j.indptr))
    np.testing.assert_array_equal(_np(t.indices), np.asarray(j.indices))
    np.testing.assert_allclose(_np(t.data), np.asarray(j.data), rtol=rtol,
                               atol=1e-7)


def triplets(seed, m=37, n=29, nnz=160, square=False):
    rng = np.random.default_rng(seed)
    n = m if square else n
    r = rng.integers(0, m, nnz).astype(np.int32)
    c = rng.integers(0, n, nnz).astype(np.int32)
    v = rng.standard_normal(nnz).astype(np.float32)
    # duplicates (one of which cancels) and explicit zeros
    r = np.concatenate([r, r[:10], r[10:12], r[20:23]])
    c = np.concatenate([c, c[:10], c[10:12], c[20:23]])
    v = np.concatenate([v, v[:10], -v[10:12], np.zeros(3, np.float32)])
    return r, c, v, (m, n)


@pytest.fixture(params=[0, 1])
def pair(request):
    r, c, v, shape = triplets(request.param)
    return (ts.from_triplets(r, c, v, shape, device=CPU),
            js.from_triplets(r, c, v, shape))


def padded_coo(seed, square=False):
    """A COO with capacity past nnz (padding rows = n_rows), duplicates
    and zeros, in both packages."""
    r, c, v, shape = triplets(seed, square=square)
    cap = len(r) + 9
    rows = np.full(cap, shape[0], np.int32)
    cols = np.zeros(cap, np.int32)
    vals = np.zeros(cap, np.float32)
    rows[:len(r)], cols[:len(r)], vals[:len(r)] = r, c, v
    return (ts.COO(rows, cols, vals, shape, nnz=len(r), device=CPU),
            js.COO(rows, cols, vals, shape, nnz=len(r)))


def test_containers_and_padding():
    t, j = padded_coo(3)
    assert t.capacity == j.capacity and t.device.type == "cpu"
    assert t.nnz.ndim == 0 and t.nnz.dtype == torch.int32
    np.testing.assert_array_equal(_np(t.mask()), np.asarray(j.mask()))
    assert_coo_equal(t, j)
    tc, jc = convert.coo_to_csr(op.coo_sort(t)), js.coo_to_csr(js.coo_sort(j))
    assert tc.capacity == jc.capacity
    assert int(tc.nnz) == int(jc.nnz)
    np.testing.assert_array_equal(_np(tc.row_ids()), np.asarray(jc.row_ids()))
    np.testing.assert_array_equal(_np(tc.mask()), np.asarray(jc.mask()))
    assert_csr_equal(tc, jc)
    with pytest.raises(Exception, match="n_rows\\+1"):
        ts.CSR(np.zeros(3, np.int32), np.zeros(0, np.int32),
               np.zeros(0, np.float32), (5, 5), device=CPU)


def test_from_triplets_dups_and_zeros(pair):
    t, j = pair
    assert_csr_equal(t, j)
    assert t.capacity == int(t.nnz)      # compacted: no padding
    assert (_np(t.data) != 0).all()      # zeros and the cancelled pair gone


@pytest.mark.parametrize("seed", [0, 5])
def test_canonicalize_native_equals_numpy_twin(seed):
    r, c, v, shape = triplets(seed)
    nr, nc, nv = native.coo_canonicalize(r, c, v)
    pr, pc, pv = convert.canonicalize_numpy(r, c, v, shape)
    np.testing.assert_array_equal(nr, pr)
    np.testing.assert_array_equal(nc, pc)
    np.testing.assert_allclose(nv, pv, rtol=1e-6)


def test_from_triplets_int_values_and_device():
    r, c = np.array([0, 1, 1]), np.array([1, 0, 0])
    t = ts.from_triplets(r, c, np.array([2, 3, 4]), (2, 2), device=CPU)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(_np(ts.csr_to_dense(t)), [[0, 2], [7, 0]])


def test_conversions(pair):
    t, j = pair
    assert_coo_equal(ts.csr_to_coo(t), js.csr_to_coo(j))
    np.testing.assert_allclose(_np(ts.csr_to_dense(t)),
                               np.asarray(js.csr_to_dense(j)), rtol=1e-6)
    tp, jp = padded_coo(2)
    np.testing.assert_allclose(_np(ts.coo_to_dense(tp)),
                               np.asarray(js.coo_to_dense(jp)), rtol=1e-6)
    assert_csr_equal(ts.coo_to_csr(ts.coo_sort(tp)),
                     js.coo_to_csr(js.coo_sort(jp)))
    dense = np.asarray(js.csr_to_dense(j))
    for cap in (None, 40, 10_000):
        assert_coo_equal(ts.dense_to_coo(torch.from_numpy(dense.copy()), cap),
                         js.dense_to_coo(dense, cap))
        assert_csr_equal(ts.dense_to_csr(dense, cap, device=CPU),
                         js.dense_to_csr(dense, cap))
    adj = dense > 0.5
    assert_csr_equal(ts.adj_to_csr(adj, device=CPU), js.adj_to_csr(adj))


def test_ops():
    t, j = padded_coo(4)
    assert_coo_equal(ts.coo_sort(t), js.coo_sort(j))
    val = float(np.asarray(j.vals)[5])
    assert_coo_equal(ts.coo_remove_scalar(t, val), js.coo_remove_scalar(j, val))
    assert_coo_equal(ts.coo_remove_zeros(t), js.coo_remove_zeros(j))
    assert_coo_equal(ts.coo_sum_duplicates(t), js.coo_sum_duplicates(j))
    assert_coo_equal(ts.coo_max_duplicates(t), js.coo_max_duplicates(j))
    tc = ts.coo_to_csr(ts.coo_sum_duplicates(t))
    jc = js.coo_to_csr(js.coo_sum_duplicates(j))
    for start, stop in ((0, 37), (3, 11), (36, 37), (5, 5)):
        assert_csr_equal(ts.csr_row_slice(tc, start, stop),
                         js.csr_row_slice(jc, start, stop))
    assert_csr_equal(
        ts.csr_row_op(tc, lambda r, v: v * (r.to(v.dtype) + 1)),
        js.csr_row_op(jc, lambda r, v: v * (r.astype(v.dtype) + 1)))


def test_symmetrize_min_matches():
    t, j = padded_coo(6, square=True)
    for combine in ("sum", "max", "min"):
        assert_coo_equal(linalg.symmetrize(t, combine),
                         js.linalg.symmetrize(j, combine))


@pytest.mark.parametrize("seed", [0, 7])
def test_csr_to_ell_same_arrays(seed):
    rng = np.random.default_rng(seed)
    # skewed rows so some spill into the overflow
    n = 100
    deg = rng.integers(0, 6, n)
    deg[::40] = 25
    r = np.repeat(np.arange(n), deg).astype(np.int32)
    c = rng.integers(0, n, len(r)).astype(np.int32)
    v = rng.standard_normal(len(r)).astype(np.float32)
    t = ts.from_triplets(r, c, v, (n, n), device=CPU)
    j = js.from_triplets(r, c, v, (n, n))
    te, je = ts.csr_to_ell(t), js.csr_to_ell(j)
    assert je.ov_rows.shape[0] > 0
    for a, b in ((te.cols, je.cols), (te.vals, je.vals),
                 (te.ov_rows, je.ov_rows), (te.ov_cols, je.ov_cols),
                 (te.ov_vals, je.ov_vals)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # the native conversion equals its numpy twin
    ip, ind, dat = _np(t.indptr), _np(t.indices), _np(t.data)
    r8 = linalg.ell_width(np.diff(ip), 0.95)
    for a, b in zip(native.csr_to_ell(ip, ind, dat, r8),
                    linalg.csr_to_ell_numpy(ip, ind, dat, r8)):
        np.testing.assert_array_equal(a, b)
    # an empty matrix: one zero column, no overflow
    e = ts.CSR(np.zeros(5, np.int32), np.zeros(3, np.int32),
               np.zeros(3, np.float32), (4, 4), device=CPU)
    ee = ts.csr_to_ell(e)
    assert tuple(ee.cols.shape) == (4, 1) and ee.ov_rows.shape[0] == 0


def test_products(pair):
    t, j = pair
    rng = np.random.default_rng(11)
    x = rng.standard_normal(t.shape[1]).astype(np.float32)
    b = rng.standard_normal((t.shape[1], 5)).astype(np.float32)
    want = np.asarray(js.spmv(j, x))
    np.testing.assert_allclose(_np(ts.spmv(t, torch.from_numpy(x))), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(ts.ell_spmv(ts.csr_to_ell(t), torch.from_numpy(x))),
        np.asarray(js.ell_spmv(js.csr_to_ell(j), x)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(linalg.apply_matvec(linalg.matvec_operand(t),
                                torch.from_numpy(x))), want,
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(linalg.best_matvec(t)(
        torch.from_numpy(x))), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(ts.spmm(t, torch.from_numpy(b))),
                               np.asarray(js.spmm(j, b)), rtol=1e-6,
                               atol=1e-6)


def test_degrees_norms_transpose_add(pair):
    t, j = pair
    np.testing.assert_array_equal(_np(ts.csr_degree(t)),
                                  np.asarray(js.csr_degree(j)))
    tp, jp = padded_coo(8)
    np.testing.assert_array_equal(_np(ts.coo_degree(tp)),
                                  np.asarray(js.coo_degree(jp)))
    for norm in ("l1", "max"):
        assert_csr_equal(ts.row_normalize(t, norm),
                         js.row_normalize(j, norm))
    with pytest.raises(ValueError):
        ts.row_normalize(t, "l3")
    assert_csr_equal(ts.csr_transpose(t), js.csr_transpose(j))
    r, c, v, shape = triplets(9)
    t2 = ts.from_triplets(r, c, v, shape, device=CPU)
    j2 = js.from_triplets(r, c, v, shape)
    assert_csr_equal(ts.csr_add(t, t2), js.csr_add(j, j2))


def graph_triplets(seed, n=50, parts=4):
    """A symmetric weighted graph of *parts* disconnected chunks."""
    rng = np.random.default_rng(seed)
    chunk = rng.integers(0, parts, n)
    r, c = [], []
    for _ in range(2 * n):
        a = rng.integers(0, n)
        same = np.flatnonzero(chunk == chunk[a])
        r.append(a)
        c.append(rng.choice(same))
    r, c = np.array(r, np.int32), np.array(c, np.int32)
    keep = r != c
    r, c = r[keep], c[keep]
    v = rng.uniform(0.5, 2.0, len(r)).astype(np.float32)
    return r, c, v, (n, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_symmetrize_weak_cc_laplacian(seed):
    r, c, v, shape = graph_triplets(seed)
    t = ts.from_triplets(r, c, v, shape, device=CPU)
    j = js.from_triplets(r, c, v, shape)
    for combine in ("sum", "max"):
        assert_csr_equal(ts.symmetrize(t, combine),
                         js.symmetrize(j, combine))
    ts_, js_ = ts.symmetrize(t), js.symmetrize(j)
    np.testing.assert_array_equal(_np(ts.weak_cc(t)), np.asarray(js.weak_cc(j)))
    np.testing.assert_array_equal(_np(ts.weak_cc(ts_)),
                                  np.asarray(js.weak_cc(js_)))
    for normalized in (False, True):
        assert_csr_equal(ts.laplacian(ts_, normalized),
                         js.laplacian(js_, normalized), rtol=1e-6)


def test_segment_reduce_drops_out_of_range():
    data = torch.tensor([1.0, 2.0, 3.0, 4.0])
    ids = torch.tensor([0, 2, 5, -1])
    np.testing.assert_array_equal(_np(op.segment_reduce(data, ids, 3)),
                                  [1, 0, 2])
    out = op.segment_reduce(data, ids, 3, "amax")
    assert out[1] == float("-inf") and out[2] == 2
    jnp.zeros(1)  # the JAX package stays on the CPU in this process
