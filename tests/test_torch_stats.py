"""Parity of ``raft_tpu_torch.stats`` with ``raft_tpu.stats`` on the CPU.

Every function of the JAX package's ``stats`` takes the same seeded numpy
inputs in both packages; results agree to rtol 1e-5, atol 1e-6 (sums in
other orders; counts and the information-theoretic sums are float64 in
both), integer results exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import stats as js
from raft_tpu.distance.distance_types import DistanceType as JaxDT
from raft_tpu_torch import stats as ts
from raft_tpu_torch.distance import DistanceType


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def _labels(seed, n=500, k=6):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, k, n).astype(np.int32)
    p = np.where(rng.random(n) < 0.7, t, rng.integers(0, k, n)).astype(
        np.int32)
    return t, p


def _blobs(seed, n=300, d=5, k=4):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (k, d))
    lab = rng.integers(0, k, n).astype(np.int32)
    x = (c[lab] + 0.7 * rng.standard_normal((n, d))).astype(np.float32)
    return x, lab


def test_stats_exports_every_name_of_the_jax_package():
    import raft_tpu.stats as jmod

    ours = set(ts.__all__)
    theirs = {n for n in dir(jmod) if not n.startswith("_")} - {
        "metrics", "summary"}
    assert theirs <= ours, theirs - ours


def test_accuracy_r2_regression_metrics():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(401).astype(np.float32)
    yh = (y + 0.3 * rng.standard_normal(401)).astype(np.float32)
    _close(ts.accuracy(torch.from_numpy(np.round(y)),
                       torch.from_numpy(np.round(yh))),
           js.accuracy(np.round(y), np.round(yh)))
    _close(ts.r2_score(torch.from_numpy(y), torch.from_numpy(yh)),
           js.r2_score(y, yh))
    for even in (False, True):
        n = 400 if even else 401
        got = ts.regression_metrics(torch.from_numpy(yh[:n]),
                                    torch.from_numpy(y[:n]))
        ref = js.regression_metrics(yh[:n], y[:n])
        for a, b in zip(got, ref):
            _close(a, b)


@pytest.mark.parametrize("n_classes", [None, 9])
def test_contingency_and_information_scores(n_classes):
    t, p = _labels(1)
    tt, pt = torch.from_numpy(t), torch.from_numpy(p)
    np.testing.assert_array_equal(
        ts.contingency_matrix(tt, pt, n_classes).numpy(),
        np.asarray(js.contingency_matrix(t, p, n_classes)))
    for name in ("mutual_info_score", "homogeneity_score",
                 "completeness_score", "v_measure"):
        _close(getattr(ts, name)(tt, pt, n_classes),
               getattr(js, name)(t, p, n_classes))
    _close(ts.entropy(tt, n_classes), js.entropy(t, n_classes))
    _close(ts.v_measure(tt, pt, n_classes, beta=2.0),
           js.v_measure(t, p, n_classes, beta=2.0))


@pytest.mark.parametrize("case", ["noisy", "identical", "permuted",
                                  "one_cluster"])
def test_rand_indices(case):
    t, p = _labels(2)
    if case == "identical":
        p = t.copy()
    elif case == "permuted":
        p = ((t + 2) % 6).astype(np.int32)
    elif case == "one_cluster":
        p = np.zeros_like(t)
    tt, pt = torch.from_numpy(t), torch.from_numpy(p)
    _close(ts.rand_index(tt, pt), js.rand_index(t, p))
    _close(ts.adjusted_rand_index(tt, pt), js.adjusted_rand_index(t, p))


def test_kl_divergence():
    rng = np.random.default_rng(3)
    p = rng.random(50).astype(np.float32)
    p[::7] = 0.0
    q = rng.random(50).astype(np.float32)
    p, q = p / p.sum(), q / q.sum()
    _close(ts.kl_divergence(torch.from_numpy(p), torch.from_numpy(q)),
           js.kl_divergence(p, q))


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L1,
                                    DistanceType.CosineExpanded],
                         ids=lambda m: m.name)
def test_silhouette_scores(metric):
    x, lab = _blobs(4)
    lab[7] = 5                 # a singleton cluster; cluster 4 stays empty
    jm = JaxDT[metric.name]
    got, gs = ts.silhouette_score(torch.from_numpy(x), torch.from_numpy(lab),
                                  6, metric, return_samples=True)
    ref, rs = js.silhouette_score(x, lab, 6, jm, return_samples=True)
    _close(got, ref)
    _close(gs, rs, atol=1e-5)
    assert float(gs[7]) == 0.0
    gb, gbs = ts.silhouette_score_batched(torch.from_numpy(x),
                                          torch.from_numpy(lab), 6, metric,
                                          batch_size=64, return_samples=True)
    rb = js.silhouette_score_batched(x, lab, 6, jm, batch_size=64)
    _close(gb, rb)
    _close(gbs, gs, atol=1e-5)


def test_trustworthiness_score():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((120, 10)).astype(np.float32)
    emb = (x[:, :2] + 0.2 * rng.standard_normal((120, 2))).astype(np.float32)
    for k in (3, 10):
        _close(ts.trustworthiness_score(torch.from_numpy(x),
                                        torch.from_numpy(emb), k),
               js.trustworthiness_score(x, emb, k))


def test_dispersion_and_information_criterion():
    rng = np.random.default_rng(6)
    c = rng.standard_normal((7, 4)).astype(np.float32)
    sizes = rng.integers(1, 50, 7).astype(np.float32)
    _close(ts.dispersion(torch.from_numpy(c), torch.from_numpy(sizes)),
           js.dispersion(c, sizes))
    g = rng.standard_normal(4).astype(np.float32)
    _close(ts.dispersion(torch.from_numpy(c), torch.from_numpy(sizes),
                         torch.from_numpy(g), 300),
           js.dispersion(c, sizes, jnp.asarray(g), 300))
    ll = rng.standard_normal(9).astype(np.float32) * 100
    for ic in ("AIC", "AICc", "BIC"):
        _close(ts.information_criterion_batched(
            torch.from_numpy(ll), ts.IC_Type[ic], 5, 200),
            js.information_criterion_batched(ll, js.IC_Type[ic], 5, 200))


@pytest.mark.parametrize("sample", [False, True])
def test_summary_statistics(sample):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((257, 6)) * 3 + 1).astype(np.float32)
    xt = torch.from_numpy(x)
    _close(ts.mean(xt, sample), js.mean(x, sample))
    _close(ts.mean_center(xt), js.mean_center(x), atol=1e-5)
    mu = ts.mean(xt)
    _close(ts.mean_add(ts.mean_center(xt, mu), mu),
           js.mean_add(js.mean_center(x), js.mean(x)), atol=1e-5)
    for a, b in zip(ts.meanvar(xt, sample), js.meanvar(x, sample)):
        _close(a, b)
    _close(ts.stddev(xt, sample=sample), js.stddev(x, sample=sample))
    _close(ts.stddev(xt, mu, sample), js.stddev(x, js.mean(x), sample))
    _close(ts.vars_(xt, sample=sample), js.vars_(x, sample=sample))
    _close(ts.sum_(xt), js.sum_(x), atol=1e-4)
    _close(ts.cov(xt, sample=sample), js.cov(x, sample=sample), atol=1e-5)
    for a, b in zip(ts.minmax(xt), js.minmax(x)):
        _close(a, b, rtol=0, atol=0)


def test_weighted_means_and_histogram():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    xt = torch.from_numpy(x)
    wr = rng.random(6).astype(np.float32)
    wc = rng.random(40).astype(np.float32)
    _close(ts.row_weighted_mean(xt, wr), js.row_weighted_mean(x, wr))
    _close(ts.col_weighted_mean(xt, wc), js.col_weighted_mean(x, wc))
    _close(ts.weighted_mean(xt, wr), js.weighted_mean(x, wr))
    _close(ts.weighted_mean(xt, wc, along_rows=False),
           js.weighted_mean(x, wc, along_rows=False))
    for lo, hi in ((None, None), (-1.0, 1.0)):
        got = ts.histogram(xt, 7, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(js.histogram(x, 7, lo, hi)))
    np.testing.assert_array_equal(ts.histogram(xt[:, 0], 5).numpy(),
                                  np.asarray(js.histogram(x[:, 0], 5)))
