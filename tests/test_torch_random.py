"""The port's random surface against raft_tpu's, by distribution.

``torch``'s generators cannot reproduce ``jax.random``'s streams, so each
draw is judged by its moments: the sample mean and variance of 200,000
draws within 5 standard errors of the distribution's, and of the JAX
package's own draws (a two-sample difference within 5 standard errors of
the difference).  ``discrete`` frequencies and the generators' statistics
(balanced ``make_blobs`` labels, cluster means and spread) are held the
same way; the k-means‖ init is held to the JAX package's quality gates
(ARI > 0.99 on its blobs fixture; under half of a random init's inertia)
and to the JAX package's own init over seeds: the port's greedy finish no
worse, its one-draw finish the same by distribution.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import random as jr
from raft_tpu.cluster import init_plus_plus as jax_init_plus_plus
from raft_tpu.random import RngState as JaxRng
from raft_tpu.random import make_blobs as jax_blobs
from raft_tpu_torch import random as tr
from raft_tpu_torch.cluster import KMeansParams, fit_predict, init_plus_plus
from raft_tpu_torch.cluster import kmeans as port_kmeans
from raft_tpu_torch.cluster import min_cluster_and_distance
from raft_tpu_torch.random import RngState
from raft_tpu_torch.stats import adjusted_rand_index

N = 200_000
G = 0.5772156649015329   # Euler–Mascheroni

#: name → (port call, JAX call, (mean, variance)) of one distribution
DRAWS = {
    "uniform": (lambda r: tr.uniform(r, N, -2.0, 3.0, device="cpu"),
                lambda k: jr.uniform(k, (N,), -2.0, 3.0), (0.5, 25 / 12)),
    "normal": (lambda r: tr.normal(r, N, 1.5, 2.0, device="cpu"),
               lambda k: jr.normal(k, (N,), 1.5, 2.0), (1.5, 4.0)),
    "lognormal": (lambda r: tr.lognormal(r, N, 0.1, 0.5, device="cpu"),
                  lambda k: jr.lognormal(k, (N,), 0.1, 0.5),
                  (math.exp(0.1 + 0.125),
                   (math.exp(0.25) - 1) * math.exp(0.2 + 0.25))),
    "gumbel": (lambda r: tr.gumbel(r, N, 1.0, 2.0, device="cpu"),
               lambda k: jr.gumbel(k, (N,), 1.0, 2.0),
               (1.0 + 2.0 * G, math.pi ** 2 * 4.0 / 6)),
    "logistic": (lambda r: tr.logistic(r, N, -1.0, 0.5, device="cpu"),
                 lambda k: jr.logistic(k, (N,), -1.0, 0.5),
                 (-1.0, 0.25 * math.pi ** 2 / 3)),
    "exponential": (lambda r: tr.exponential(r, N, 2.0, device="cpu"),
                    lambda k: jr.exponential(k, (N,), 2.0), (0.5, 0.25)),
    "rayleigh": (lambda r: tr.rayleigh(r, N, 1.5, device="cpu"),
                 lambda k: jr.rayleigh(k, (N,), 1.5),
                 (1.5 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 2.25)),
    "laplace": (lambda r: tr.laplace(r, N, 0.5, 1.5, device="cpu"),
                lambda k: jr.laplace(k, (N,), 0.5, 1.5), (0.5, 2 * 2.25)),
    "bernoulli": (lambda r: tr.bernoulli(r, N, 0.3, device="cpu"),
                  lambda k: jr.bernoulli(k, (N,), 0.3), (0.3, 0.21)),
    "scaled_bernoulli": (
        lambda r: tr.scaled_bernoulli(r, N, 0.3, 2.0, device="cpu"),
        lambda k: jr.scaled_bernoulli(k, (N,), 0.3, 2.0),
        (2.0 * 0.4, 4.0 * (1 - 0.16))),
    "uniform_int": (lambda r: tr.uniform_int(r, N, 3, 10, device="cpu"),
                    lambda k: jr.uniform_int(k, (N,), 3, 10),
                    (6.0, (49 - 1) / 12)),
    "normal_int": (lambda r: tr.normal_int(r, N, 5.0, 3.0, device="cpu"),
                   lambda k: jr.normal_int(k, (N,), 5.0, 3.0),
                   (5.0, 9.0 + 1 / 12)),
}


def _moments(a):
    a = np.asarray(a, np.float64).reshape(-1)
    m = a.mean()
    c = a - m
    v = (c * c).mean()
    # standard errors of the mean and of the variance
    return m, v, math.sqrt(v / a.size), math.sqrt(
        max((c ** 4).mean() - v * v, 1e-30) / a.size)


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_moments_match_distribution_and_jax(name):
    port_fn, jax_fn, (mu, var) = DRAWS[name]
    got = port_fn(RngState(3))
    assert got.shape == (N,) and got.device.type == "cpu"
    m, v, se_m, se_v = _moments(got.numpy())
    assert abs(m - mu) <= 5 * se_m, (m, mu)
    assert abs(v - var) <= 5 * se_v, (v, var)
    rm, rv, rse_m, rse_v = _moments(jax_fn(JaxRng(3)))
    assert abs(m - rm) <= 5 * math.hypot(se_m, rse_m), (m, rm)
    assert abs(v - rv) <= 5 * math.hypot(se_v, rse_v), (v, rv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_draws_take_dtype_and_rng_forms(dtype):
    a = tr.normal(RngState(5), (4, 6), dtype=dtype, device="cpu")
    b = tr.normal(RngState(5).next_generator(), (4, 6), dtype=dtype,
                  device="cpu")
    assert a.dtype == dtype and a.shape == (4, 6)
    assert torch.equal(a, b)
    r = RngState(5)
    tr.uniform(r, 3, device="cpu")
    assert r.base_subsequence == 1       # every draw advances the state
    assert torch.equal(tr.fill(r, (2, 3), 7.0, device="cpu"),
                       torch.full((2, 3), 7.0))


def test_normal_table_columns():
    t = tr.normal_table(RngState(1), N // 4, [0.0, 10.0, -3.0],
                        [1.0, 0.1, 2.0], device="cpu")
    m, s = t.mean(0), t.std(0)
    np.testing.assert_allclose(m.numpy(), [0.0, 10.0, -3.0], atol=0.05)
    np.testing.assert_allclose(s.numpy(), [1.0, 0.1, 2.0], rtol=0.02)
    ref = np.asarray(jr.normal_table(JaxRng(1), 10, jnp.asarray([0., 10.,
                                                                 -3.])))
    assert ref.shape == tuple(tr.normal_table(RngState(1), 10,
                                              [0., 10., -3.],
                                              device="cpu").shape)


def test_discrete_frequencies_match_weights_and_jax():
    w = np.array([1.0, 0.0, 3.0, 6.0])
    got = tr.discrete(RngState(2), N, torch.from_numpy(w))
    ref = np.asarray(jr.discrete(JaxRng(2), (N,), jnp.asarray(w)))
    p = w / w.sum()
    se = np.sqrt(p * (1 - p) / N)
    f = np.bincount(got.numpy(), minlength=4) / N
    fr = np.bincount(ref, minlength=4) / N
    assert f[1] == 0.0 and fr[1] == 0.0     # a zero weight is never drawn
    assert np.all(np.abs(f - p) <= 5 * se + 1e-12)
    assert np.all(np.abs(f - fr) <= 5 * np.sqrt(2) * se + 1e-12)
    assert got.dtype == torch.int32


def test_inverse_cdf_skips_zero_weights_at_the_edges():
    w = torch.tensor([0.0, 2.0, 0.0, 0.0, 1.0, 0.0])
    u = torch.tensor([0.0, 0.5, 0.6666, 0.6667, 0.999999, 1.0 - 1e-16])
    idx = tr.rng.inverse_cdf(w, u)
    assert idx.tolist() == [1, 1, 1, 4, 4, 4]


def test_permute_is_a_permutation_and_uniform():
    x = torch.arange(50.0)[:, None].repeat(1, 3)
    rows, perm = tr.permute(RngState(4), x)
    assert sorted(perm.tolist()) == list(range(50))
    assert torch.equal(rows, x[perm])
    assert tr.permute(RngState(4), n=50, device="cpu").tolist() == \
        perm.tolist()
    # the position of item 0 over many permutations is uniform
    pos = np.array([int((tr.permute(RngState(s), n=10, device="cpu")
                         == 0).nonzero()) for s in range(2000)])
    f = np.bincount(pos, minlength=10) / 2000
    assert np.all(np.abs(f - 0.1) <= 5 * math.sqrt(0.09 / 2000))
    ref = np.asarray(jr.permute(JaxRng(4), jnp.asarray(x.numpy()))[1])
    assert sorted(ref.tolist()) == list(range(50))


def test_sample_without_replacement_rngstate_equals_generator():
    x = torch.arange(300.0)[:, None]
    w = torch.rand(300, generator=torch.Generator().manual_seed(0))
    for weights in (None, w):
        a = tr.sample_without_replacement(RngState(7), x, 40, weights)
        b = tr.sample_without_replacement(RngState(7).next_generator(), x,
                                          40, weights)
        assert torch.equal(a, b)
        assert len(set(a[:, 0].tolist())) == 40
    _, idx = tr.sample_without_replacement(RngState(7), x, 40,
                                           return_indices=True)
    assert torch.equal(idx, tr.rng.gumbel_top_k(
        torch.rand(300, generator=RngState(7).next_generator(),
                   dtype=torch.float64), 40))


def test_weighted_sampling_follows_weights():
    # the first pick of a weighted draw without replacement is ∝ weights
    w = torch.tensor([1.0, 2.0, 7.0])
    x = torch.arange(3.0)[:, None]
    first = np.array([int(tr.sample_without_replacement(
        RngState(s), x, 1, w)[0, 0]) for s in range(3000)])
    f = np.bincount(first, minlength=3) / 3000
    p = np.array([0.1, 0.2, 0.7])
    assert np.all(np.abs(f - p) <= 5 * np.sqrt(p * (1 - p) / 3000))


def test_make_blobs_statistics_match_jax():
    n, d, k, std = 20_000, 6, 5, 0.7
    x, labels, centers = tr.make_blobs(RngState(9), n, d, k, std,
                                       device="cpu")
    rx, rl, rc = jax_blobs(JaxRng(9), n, d, k, std)
    assert x.shape == (n, d) and labels.dtype == torch.int32
    assert centers.shape == tuple(np.asarray(rc).shape)
    assert np.asarray(rl).dtype == np.int32
    counts = np.bincount(labels.numpy(), minlength=k)
    assert counts.tolist() == np.bincount(np.asarray(rl),
                                          minlength=k).tolist()
    assert counts.tolist() == [n // k] * k                # balanced
    assert float(centers.min()) >= -10 and float(centers.max()) <= 10
    for j in range(k):
        rows = x[labels == j].double()
        se = std / math.sqrt(rows.shape[0])
        assert float((rows.mean(0) - centers[j]).abs().max()) <= 5 * se
        np.testing.assert_allclose(rows.std(0).numpy(), std, rtol=0.05)
    # a shuffle: labels are not in arange order
    assert not torch.equal(labels, torch.arange(n, dtype=torch.int32) % k)
    fixed = torch.zeros(3, d)
    x2, l2, c2 = tr.make_blobs(RngState(1), 30, d, centers=fixed,
                               shuffle=False)
    assert torch.equal(c2, fixed) and l2.tolist() == [i % 3
                                                      for i in range(30)]


@pytest.mark.parametrize("effective_rank", [None, 3])
def test_make_regression_matches_jax_shapes_and_model(effective_rank):
    x, y, w = tr.make_regression(RngState(2), 300, 8, n_informative=5,
                                 bias=1.5, effective_rank=effective_rank,
                                 coef=True, device="cpu")
    rx, ry, rw = jr.make_regression(JaxRng(2), 300, 8, n_informative=5,
                                    bias=1.5, effective_rank=effective_rank,
                                    coef=True)
    assert x.shape == rx.shape and y.shape == ry.shape
    assert w.shape == rw.shape
    assert bool((w[5:] == 0).all()) and bool((w[:5] > 0).all())
    torch.testing.assert_close(y, x @ w + 1.5, rtol=1e-5, atol=1e-3)
    if effective_rank is not None:
        s = torch.linalg.svdvals(x.double())
        rs = np.linalg.svd(np.asarray(rx, np.float64), compute_uv=False)
        np.testing.assert_allclose(s.numpy(), rs, rtol=1e-3, atol=1e-4)
    _, y2 = tr.make_regression(RngState(2), 300, 8, n_targets=2, noise=0.1,
                               device="cpu")
    assert y2.shape == (300, 2)


@pytest.mark.parametrize("method", ["cholesky", "jacobi"])
def test_multi_variable_gaussian_covariance(method):
    cov = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, -0.3], [0.0, -0.3, 0.5]])
    mean = np.array([1.0, -2.0, 0.5])
    s = tr.multi_variable_gaussian(RngState(6), torch.from_numpy(mean),
                                   torch.from_numpy(cov), N // 4, method)
    ref = np.asarray(jr.multi_variable_gaussian(
        JaxRng(6), jnp.asarray(mean), jnp.asarray(cov), 10, method))
    assert s.shape == (N // 4, 3) and ref.shape == (10, 3)
    np.testing.assert_allclose(s.mean(0).numpy(), mean, atol=0.02)
    np.testing.assert_allclose(np.cov(s.numpy().T), cov, atol=0.03)


@pytest.mark.parametrize("clip_and_flip", [False, True])
def test_rmat_quadrants_follow_theta(clip_and_flip):
    theta = [0.57, 0.19, 0.19, 0.05]
    out, src, dst = tr.rmat_rectangular_gen(RngState(8), theta, 6, 4, N // 4,
                                            clip_and_flip, device="cpu")
    ro, rs, rd = jr.rmat_rectangular_gen(JaxRng(8), jnp.asarray(theta), 6,
                                         4, 10, clip_and_flip)
    assert out.shape == (N // 4, 2) and tuple(ro.shape) == (10, 2)
    assert torch.equal(out[:, 0], src) and torch.equal(out[:, 1], dst)
    if clip_and_flip:
        assert bool((src >= dst).all())
        return
    assert int(src.max()) < 64 and int(dst.max()) < 16
    # the top level's quadrant: (row bit, col bit) = the highest bits
    quad = ((src >> 5) & 1) * 2 + ((dst >> 3) & 1)
    f = np.bincount(quad.numpy(), minlength=4) / (N // 4)
    p = np.array(theta)
    assert np.all(np.abs(f - p) <= 5 * np.sqrt(p * (1 - p) / (N // 4)))


@pytest.mark.parametrize("seed", [3, 4])
def test_fit_predict_kmeans_pp_on_the_reference_blobs(seed):
    # the JAX package's fixture (tests/test_cluster.py) and gate
    x, truth, _ = jax_blobs(JaxRng(42), 1000, 16, n_clusters=5,
                            cluster_std=0.4)
    out = fit_predict(KMeansParams(n_clusters=5, seed=seed, max_iter=100),
                      torch.from_numpy(np.array(x)))
    ari = float(adjusted_rand_index(torch.from_numpy(np.array(truth)),
                                    out.labels))
    assert ari > 0.99, ari
    assert int(out.n_iter) <= 100


@pytest.mark.parametrize("seed", range(5))
def test_init_plus_plus_beats_random_init(seed):
    x, _, _ = tr.make_blobs(RngState(51), 2000, 8, n_clusters=16,
                            cluster_std=0.2, device="cpu")
    pp = init_plus_plus(RngState(seed), x, 16, 2.0)
    r = np.random.default_rng(seed)
    rand_init = x[torch.from_numpy(r.choice(len(x), 16, replace=False))]

    def inertia(c):
        return float(min_cluster_and_distance(x, c).value.sum())

    assert pp.shape == (16, 8)
    assert inertia(pp) < 0.5 * inertia(rand_init)


def test_init_plus_plus_candidates_own_their_weights():
    # a duplicate row in x: the weighted finish never returns a centre
    # twice while distinct candidates remain
    x, _, _ = tr.make_blobs(RngState(2), 600, 4, n_clusters=6,
                            cluster_std=0.1, device="cpu")
    x = torch.cat([x, x[:50]])
    c = init_plus_plus(RngState(0), x, 6)
    assert len({tuple(r) for r in c.tolist()}) == 6


#: seeds of the init comparisons with the JAX package's k-means‖
PP_SEEDS = range(8)


@functools.lru_cache(maxsize=None)
def _pp_blobs():
    x, _, _ = jax_blobs(JaxRng(7), 4000, 16, n_clusters=64, cluster_std=1.0)
    return x, torch.from_numpy(np.array(x))


def _pp_inertia(c):
    _, xt = _pp_blobs()
    c = torch.as_tensor(np.array(c))
    return float(min_cluster_and_distance(xt, c).value.double().sum())


@functools.lru_cache(maxsize=None)
def _jax_pp_inertias():
    x, _ = _pp_blobs()
    return np.array([_pp_inertia(jax_init_plus_plus(JaxRng(s), x, 64))
                     for s in PP_SEEDS])


def _port_pp_inertias():
    _, xt = _pp_blobs()
    return np.array([_pp_inertia(init_plus_plus(RngState(s), xt, 64))
                     for s in PP_SEEDS])


def test_init_plus_plus_no_worse_than_jax_init():
    # the greedy finish (local_trials draws a step) against the JAX
    # package's one draw a step, on the same blobs over eight seeds
    ref = _jax_pp_inertias()
    got = _port_pp_inertias()
    assert got.mean() <= ref.mean(), (got, ref)
    assert np.median(got) <= np.median(ref), (got, ref)


def test_one_draw_finish_matches_jax_init_by_distribution(monkeypatch):
    # with one draw a step the port's finish is the JAX package's: the
    # mean inertias over eight seeds differ by at most 5 standard errors
    # of the difference
    monkeypatch.setattr(port_kmeans, "local_trials", lambda k: 1)
    ref = _jax_pp_inertias()
    got = _port_pp_inertias()
    se = math.sqrt(ref.var(ddof=1) / ref.size + got.var(ddof=1) / got.size)
    assert abs(got.mean() - ref.mean()) <= 5 * se, (got, ref)
