"""The port's matrix primitives (``raft_tpu_torch.matrix.ops``) against
raft_tpu on the CPU, on the same seeded inputs.

Index results (argmax, argmin, the sort's order, gathers), copies and
selections are held exactly, as are ties (the first index wins in both
packages, and the column sort keeps tied rows in order); arithmetic to
rtol 1e-6 (one rounding an element), sums to rtol 1e-5.
"""

import io
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.matrix as jm
import raft_tpu_torch.matrix as tm


@pytest.fixture(scope="module")
def m():
    rng = np.random.default_rng(161)
    a = rng.standard_normal((13, 9)).astype(np.float32)
    a[4, 2] = a[4, 7] = a.max() + 1        # a tied row maximum
    a[:, 3] = np.round(a[:, 3])            # ties inside a column
    return a


def T(a):
    return torch.from_numpy(np.array(a))


def same(got, want):
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("fn", ["argmax", "argmin"])
@pytest.mark.parametrize("axis", [0, 1])
def test_arg_extrema(m, fn, axis):
    same(getattr(tm, fn)(T(m), axis), getattr(jm, fn)(m, axis))


def test_col_wise_sort(m):
    same(tm.col_wise_sort(T(m)), jm.col_wise_sort(m))
    tv, ti = tm.col_wise_sort(T(m), return_indices=True)
    jv, ji = jm.col_wise_sort(m, return_indices=True)
    same(tv, jv)
    same(ti, ji)


def test_copies_and_diagonals(m):
    sq = m[:9].copy()
    t = T(m)
    c = tm.copy(t)
    assert c.data_ptr() != t.data_ptr()
    same(c, jm.copy(m))
    same(tm.truncate_rows(t, 5), jm.truncate_rows(m, 5))
    same(tm.diagonal(T(sq)), jm.diagonal(sq))
    vec = np.arange(9, dtype=np.float32)
    before = T(sq)
    same(tm.set_diagonal(before, T(vec)), jm.set_diagonal(sq, vec))
    same(before, sq)                      # the input is left as it was
    np.testing.assert_allclose(tm.matrix_diagonal_inverse(T(sq)).numpy(),
                               np.asarray(jm.matrix_diagonal_inverse(sq)),
                               rtol=1e-6)
    same(tm.set_diagonal(T(m), T(vec)), jm.set_diagonal(m, vec))


def test_init(m):
    same(tm.eye(4, 6, torch.float32, device="cpu"),
         jm.eye(4, 6, jnp.float32))
    same(tm.eye(3, device="cpu"), jm.eye(3))
    same(tm.fill((2, 5), 2.5, device="cpu"), jm.fill((2, 5), 2.5))


def test_gather(m):
    idx = np.array([2, 2, 0, 12, 7])
    same(tm.gather(T(m), T(idx)), jm.gather(m, idx))
    stencil = np.array([1.0, -1.0, 1.0, -1.0, 0.5], np.float32)
    same(tm.gather_if(T(m), T(idx), T(stencil), lambda s: s > 0, -5.0),
         jm.gather_if(m, idx, stencil, lambda s: s > 0, -5.0))


@pytest.mark.parametrize("along_lines", [True, False])
def test_linewise_op(m, along_lines):
    n = m.shape[1] if along_lines else m.shape[0]
    v1 = np.linspace(-1, 1, n).astype(np.float32)
    v2 = np.linspace(2, 3, n).astype(np.float32)
    np.testing.assert_allclose(
        tm.linewise_op(T(m), T(v1), torch.add, along_lines).numpy(),
        np.asarray(jm.linewise_op(m, v1, jnp.add, along_lines)), rtol=1e-6)
    np.testing.assert_allclose(
        tm.linewise_op(T(m), [T(v1), T(v2)], lambda a, b, c: a * b - c,
                       along_lines).numpy(),
        np.asarray(jm.linewise_op(m, [v1, v2], lambda a, b, c: a * b - c,
                                  along_lines)), rtol=1e-6)


@pytest.mark.parametrize("scalar", [None, 2.5])
def test_math(m, scalar):
    pos = np.abs(m) + 0.1
    for name in ("power", "seq_root", "sqrt"):
        np.testing.assert_allclose(
            getattr(tm, name)(T(pos), scalar).numpy(),
            np.asarray(getattr(jm, name)(pos, scalar)), rtol=1e-6)
    np.testing.assert_allclose(
        tm.seq_root(T(m), scalar, set_neg_zero=True).numpy(),
        np.asarray(jm.seq_root(m, scalar, set_neg_zero=True)), rtol=1e-6)
    np.testing.assert_allclose(tm.ratio(T(pos)).numpy(),
                               np.asarray(jm.ratio(pos)), rtol=1e-5)
    w = np.linspace(0, 1, m.size).reshape(m.shape).astype(np.float32)
    np.testing.assert_allclose(tm.weighted_ratio(T(pos), T(w)).numpy(),
                               np.asarray(jm.weighted_ratio(pos, w)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm.sq_norm(T(m))),
                               float(jm.sq_norm(m)), rtol=1e-5)


@pytest.mark.parametrize("set_zero", [True, False])
def test_reciprocal(m, set_zero):
    a = m.copy()
    a[1, 1] = 0.0
    a[2, 2] = 1e-20
    if not set_zero:
        a = np.abs(a) + 0.5
    np.testing.assert_allclose(
        tm.reciprocal(T(a), 3.0, set_zero, 1e-15).numpy(),
        np.asarray(jm.reciprocal(a, 3.0, set_zero, 1e-15)), rtol=1e-6)


def test_reorder_and_select(m):
    for axis in (0, 1):
        same(tm.reverse(T(m), axis), jm.reverse(m, axis))
    same(tm.sign_flip(T(m)), jm.sign_flip(m))
    z = m.copy()
    z[:, 0] = 0.0                         # a zero column keeps its sign
    same(tm.sign_flip(T(z)), jm.sign_flip(z))
    same(tm.slice_matrix(T(m), 1, 2, 9, 7), jm.slice_matrix(m, 1, 2, 9, 7))
    with pytest.raises(Exception, match="out of range"):
        tm.slice_matrix(T(m), 3, 0, 2, 4)
    same(tm.upper_triangular(T(m)), jm.upper_triangular(m))
    for name in ("threshold", "zero_small_values"):
        same(getattr(tm, name)(T(m), 0.5), getattr(jm, name)(m, 0.5))


def test_print_matrix(m):
    outs = []
    for mod, arg in ((tm, T(m[:3, :4])), (jm, m[:3, :4])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            text = mod.print_matrix(arg, "M", ",", ";")
        outs.append((text, buf.getvalue()))
    assert outs[0] == outs[1]
    assert tm.print_matrix(np.eye(2)) == jm.print_matrix(np.eye(2))
