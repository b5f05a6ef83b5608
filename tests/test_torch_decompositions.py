"""The port's factorizations against raft_tpu on the CPU, on the same
seeded inputs.

Eigenvectors and singular vectors are defined up to sign (and up to a
rotation within a repeated value), and each backend picks its own, so
vectors are compared by what they mean: the reconstruction's relative
Frobenius error, ‖VᵀV − I‖ and the subspace angle to the JAX package's
vectors (1 − the smallest singular value of V_portᵀ V_jax).  Bounds, for
float32 at these sizes: reconstruction 1e-5, orthogonality 1e-5, values
to 1e-5 of the largest, subspace 1e-4 (the spectra of the seeded inputs
are separated by far more than that); least squares and solves to rtol
1e-4 of the float64 answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.linalg as jl
import raft_tpu_torch.linalg as tl


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(160)
    tall = rng.standard_normal((60, 12)).astype(np.float32)
    tall[:, 0] *= 4.0                       # a separated spectrum
    wide = rng.standard_normal((9, 25)).astype(np.float32)
    m = rng.standard_normal((20, 20)).astype(np.float32)
    sym = ((m + m.T) / 2 + np.diag(np.arange(20, dtype=np.float32))
           ).astype(np.float32)
    spd = (m @ m.T + 20 * np.eye(20)).astype(np.float32)
    b = rng.standard_normal(60).astype(np.float32)
    bm = rng.standard_normal((60, 3)).astype(np.float32)
    return dict(tall=tall, wide=wide, sym=sym, spd=spd, b=b, bm=bm)


def T(a):
    return torch.from_numpy(np.array(a))


def rec_err(a, u, s, v):
    a = np.asarray(a, np.float64)
    rec = (np.asarray(u, np.float64) * np.asarray(s, np.float64)[None, :]
           ) @ np.asarray(v, np.float64).T
    return np.linalg.norm(a - rec) / np.linalg.norm(a)


def orth_err(v):
    v = np.asarray(v, np.float64)
    return np.abs(v.T @ v - np.eye(v.shape[1])).max()


def subspace_gap(v1, v2):
    """1 − cos of the largest principal angle between the column spans."""
    q1, _ = np.linalg.qr(np.asarray(v1, np.float64))
    q2, _ = np.linalg.qr(np.asarray(v2, np.float64))
    return 1.0 - np.linalg.svd(q1.T @ q2, compute_uv=False).min()


@pytest.mark.parametrize("fn", ["eig_dc", "eig_jacobi"])
def test_eig(mats, fn):
    a = mats["sym"]
    tv, tw = getattr(tl, fn)(T(a))
    jv, jw = getattr(jl, fn)(jnp.asarray(a))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                               atol=1e-5 * np.abs(np.asarray(jw)).max())
    assert np.all(np.diff(tw.numpy()) >= 0)          # ascending
    res = np.linalg.norm(a @ tv.numpy() - tv.numpy() * tw.numpy()[None, :])
    assert res / np.linalg.norm(a) < 1e-5
    assert orth_err(tv) < 1e-5
    for j in range(a.shape[0]):                      # each vector's line
        assert subspace_gap(tv[:, j:j + 1], np.asarray(jv)[:, j:j + 1]) \
            < 1e-4


@pytest.mark.parametrize("smallest", [True, False])
def test_eig_sel_dc(mats, smallest):
    a = mats["sym"]
    tv, tw = tl.eig_sel_dc(T(a), 5, smallest)
    jv, jw = jl.eig_sel_dc(jnp.asarray(a), 5, smallest)
    assert tuple(tv.shape) == (20, 5) and tuple(tw.shape) == (5,)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                               atol=1e-5 * np.abs(np.asarray(jw)).max())
    assert subspace_gap(tv, jv) < 1e-4


# svd_eig is the tall, skinny path (through aᵀa)
@pytest.mark.parametrize("fn,which", [("svd_qr", "tall"), ("svd_qr", "wide"),
                                      ("svd_jacobi", "tall"),
                                      ("svd_jacobi", "wide"),
                                      ("svd_eig", "tall")])
def test_svd(mats, fn, which):
    a = mats[which]
    tu, ts, tv = getattr(tl, fn)(T(a))
    ju, js, jv = getattr(jl, fn)(jnp.asarray(a))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                               atol=1e-5 * float(np.asarray(js)[0]))
    assert rec_err(a, tu, ts, tv) < 1e-5
    assert abs(rec_err(a, tu, ts, tv) - rec_err(a, ju, js, jv)) < 1e-5
    assert orth_err(tv) < 1e-5
    k = min(a.shape)
    for j in range(k):
        assert subspace_gap(tv[:, j:j + 1], np.asarray(jv)[:, j:j + 1]) \
            < 1e-4
    recon = tl.svd_reconstruction(tu, ts, tv).numpy()
    np.testing.assert_allclose(recon, np.asarray(jl.svd_reconstruction(
        ju, js, jv)), atol=1e-4)
    assert tl.evaluate_svd_by_reconstruction(T(a), tu, ts, tv) \
        == jl.evaluate_svd_by_reconstruction(jnp.asarray(a), ju, js, jv) \
        is True


def test_svd_without_vectors(mats):
    u, s, v = tl.svd_qr(T(mats["tall"]), gen_left_vec=False,
                        gen_right_vec=False)
    assert u is None and v is None and tuple(s.shape) == (12,)
    # a broken factor fails the reconstruction test
    u, s, v = tl.svd_qr(T(mats["tall"]))
    assert not tl.evaluate_svd_by_reconstruction(T(mats["tall"]), u, s * 1.01,
                                                 v)


@pytest.mark.parametrize("which", ["tall", "sym"])
def test_qr(mats, which):
    a = mats[which]
    tq, tr = tl.qr_get_qr(T(a))
    jq, jr = jl.qr_get_qr(jnp.asarray(a))
    assert orth_err(tq) < 1e-5
    np.testing.assert_allclose((tq @ tr).numpy(), a, atol=1e-5 * np.abs(a).max())
    assert np.allclose(np.tril(tr.numpy(), -1), 0)
    # Householder QR's factors agree up to the sign of each column / row
    sign = np.sign(np.diag(tr.numpy())) * np.sign(np.diag(np.asarray(jr)))
    np.testing.assert_allclose(tq.numpy() * sign[None, :], np.asarray(jq),
                               atol=1e-4)
    assert np.array_equal(tl.qr_get_q(T(a)).numpy(), tq.numpy())


@pytest.mark.parametrize("k,p,n_iters", [(3, 5, 2), (5, 2, 0), (8, 10, 1)])
def test_rsvd_fixed_rank_with_one_omega(mats, k, p, n_iters):
    """The same Ω in both packages: the JAX package draws it from its key,
    the port takes it as ``omega=``; the results then agree by value,
    reconstruction and subspace."""
    a = mats["tall"]
    q = min(k + p, min(a.shape))
    key = jax.random.PRNGKey(7)
    omega = np.asarray(jax.random.normal(key, (a.shape[1], q), jnp.float32))
    tu, ts, tv = tl.rsvd_fixed_rank(T(a), k, p, n_iters, omega=T(omega))
    ju, js, jv = jl.rsvd_fixed_rank(jnp.asarray(a), k, p, n_iters, key=key)
    assert tuple(tu.shape) == (60, k) and tuple(tv.shape) == (12, k)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                               atol=1e-5 * float(np.asarray(js)[0]))
    assert abs(rec_err(a, tu, ts, tv) - rec_err(a, ju, js, jv)) < 1e-5
    assert orth_err(tv) < 1e-5
    assert subspace_gap(tv, jv) < 1e-4


def test_rsvd_generator_and_perc(mats):
    a = T(mats["tall"])
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    u1, s1, v1 = tl.rsvd_fixed_rank(a, 4, generator=g1)
    u2, s2, v2 = tl.rsvd_fixed_rank(a, 4, generator=g2)
    assert torch.equal(s1, s2) and torch.equal(v1, v2)
    # the rank as a share of min(m, n), as the JAX package counts it
    u, s, v = tl.rsvd_perc(a, 0.5, omega=torch.ones(12, 12))
    _, js, _ = jl.rsvd_perc(jnp.asarray(mats["tall"]), 0.5)
    assert s.shape == js.shape == (6,)
    with pytest.raises(Exception, match="omega"):
        tl.rsvd_fixed_rank(a, 4, omega=torch.ones(3, 3))


@pytest.mark.parametrize("rhs", ["b", "bm"])
@pytest.mark.parametrize("fn", ["lstsq_svd_qr", "lstsq_svd_jacobi",
                                "lstsq_eig", "lstsq_qr"])
def test_lstsq(mats, fn, rhs):
    a, b = mats["tall"], mats[rhs]
    got = getattr(tl, fn)(T(a), T(b)).numpy()
    want = np.asarray(getattr(jl, fn)(jnp.asarray(a), jnp.asarray(b)))
    exact = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                            rcond=None)[0]
    assert got.shape == want.shape == exact.shape
    np.testing.assert_allclose(got, exact, rtol=1e-4,
                               atol=1e-4 * np.abs(exact).max())
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(exact).max())


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("n", [0, 1, 7, 19])
def test_cholesky_r1_update(mats, lower, n):
    a = mats["spd"].astype(np.float32)
    ln = np.linalg.cholesky(a[:n, :n].astype(np.float64)).astype(np.float32)
    lf = ln if lower else ln.T.copy()
    x = a[:n + 1, n].copy()
    got = tl.cholesky_r1_update(T(lf), T(x), lower).numpy()
    want = np.asarray(jl.cholesky_r1_update(jnp.asarray(lf), jnp.asarray(x),
                                            lower))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    full = np.linalg.cholesky(a[:n + 1, :n + 1].astype(np.float64))
    np.testing.assert_allclose(got, full if lower else full.T, rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(Exception, match="n\\+1"):
        tl.cholesky_r1_update(T(lf), T(x[:n]), lower)
