"""Parity of the port's public k-means API with raft_tpu on the CPU.

The same seeded numpy inputs go through ``raft_tpu.cluster`` (XLA on the
CPU) and ``raft_tpu_torch.cluster`` (``engine="torch"``, the plain
versions of kernels B1, B3 and B5).  Tolerances: labels equal except at
near ties (the two best float64 distances within 1e-5 relative of the
metric's rounding scale); distances, M-step sums and weights, inertia and
transforms to rtol 1e-5 (the two sum in other orders); a fit from the same
``InitMethod.Array`` centroids takes the same ``n_iter`` and lands on
centroids within rtol 1e-4 / atol 1e-5 and inertia within rtol 1e-5.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from raft_tpu import cluster as jc
from raft_tpu.cluster import InitMethod as JaxInit
from raft_tpu.cluster import KMeansParams as JaxParams
from raft_tpu.distance.distance_types import DistanceType as JaxDT
from raft_tpu_torch import cluster as tc
from raft_tpu_torch.cluster import InitMethod, KMeansParams
from raft_tpu_torch.distance import DistanceType

# the modules (both distance packages export a function of the same name)
jax_fl = importlib.import_module("raft_tpu.distance.fused_l2_nn")
tfl = importlib.import_module("raft_tpu_torch.distance.fused_l2_nn")

METRICS = [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
           DistanceType.L1, DistanceType.CosineExpanded,
           DistanceType.InnerProduct]


def _jdt(metric):
    return JaxDT[metric.name]


def _data(seed, n=1000, d=16, k=8, positive=False):
    rng = np.random.default_rng(seed)
    # centres are fresh draws, not rows: no distance is near 0, where the
    # expanded L2 form's float32 rounding is of the norms' scale
    if positive:   # no cancellation in the per-cluster sums
        x = rng.uniform(1.0, 2.0, (n, d)).astype(np.float32)
        y = rng.uniform(1.0, 2.0, (k, d))
    else:
        c = rng.uniform(-3, 3, (k, d))
        x = (c[rng.integers(0, k, n)]
             + 0.8 * rng.standard_normal((n, d))).astype(np.float32)
        y = c + 0.8 * rng.standard_normal((k, d))
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, y.astype(np.float32), w


def _dist64(x, y, metric):
    """(the float64 distance matrix, its rounding scale) under *metric*."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    xn = (x * x).sum(1)[:, None]
    yn = (y * y).sum(1)[None, :]
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        return xn + yn - 2 * x @ y.T, xn + yn
    if metric == DistanceType.L1:
        d = np.abs(x[:, None] - y[None]).sum(-1)
        return d, d
    if metric == DistanceType.CosineExpanded:
        return 1 - (x @ y.T) / np.sqrt(xn * yn), np.ones_like(xn * yn)
    return x @ y.T, np.sqrt(xn * yn)     # inner product


def _assert_labels(port, ref, x, y, metric):
    port, ref = np.asarray(port), np.asarray(ref)
    diff = port != ref
    if diff.any():
        d, scale = _dist64(x[diff], y, metric)
        order = np.argsort(d, axis=1)[:, :2]
        two = np.take_along_axis(d, order, 1)
        sc = np.take_along_axis(scale, order[:, :1], 1)[:, 0]
        assert np.all(two[:, 1] - two[:, 0] <= 1e-5 * np.maximum(sc, 1e-30))
    return ~diff


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_min_cluster_and_distance_matches_jax(metric):
    x, y, _ = _data(1)
    got = tc.min_cluster_and_distance(torch.from_numpy(x),
                                      torch.from_numpy(y), metric,
                                      batch_samples=256, engine="torch")
    ref = jc.min_cluster_and_distance(jnp.asarray(x), jnp.asarray(y),
                                      _jdt(metric), batch_samples=256)
    assert got.key.dtype == torch.int32 and got.key.shape == (1000,)
    same = _assert_labels(got.key, ref.key, x, y, metric)
    # L2SqrtExpanded too returns squared distances
    _close(got.value.numpy()[same], np.asarray(ref.value)[same])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", [DistanceType.L1,
                                    DistanceType.CosineExpanded],
                         ids=lambda m: m.name)
def test_fused_em_step_matches_jax(metric, weighted):
    # 1,000 rows in blocks of 256: a ragged last block
    x, y, w = _data(2, positive=True)
    wt = torch.from_numpy(w) if weighted else None
    got = tc.fused_em_step(torch.from_numpy(x), torch.from_numpy(y), wt,
                           metric, batch_samples=256, engine="torch",
                           return_labels=True)
    ref = jc.fused_em_step(jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(w) if weighted else None,
                           _jdt(metric), batch_samples=256,
                           return_labels=True)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    _close(got.distances, ref.distances)
    _close(got.sums, ref.sums, atol=0)
    _close(got.weights, ref.weights, atol=0)
    np.testing.assert_allclose(float(got.inertia), float(ref.inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("loop", ["while", "fori"])
def test_fit_from_array_matches_jax(loop):
    x, y, _ = _data(3, n=2000, d=16, k=8)
    p = KMeansParams(n_clusters=8, init=InitMethod.Array, max_iter=100)
    jp = JaxParams(n_clusters=8, init=JaxInit.Array, max_iter=100)
    got = tc.fit(p, torch.from_numpy(x), centroids=torch.from_numpy(y),
                 loop=loop, engine="torch")
    ref = jc.fit(jp, jnp.asarray(x), centroids=jnp.asarray(y), loop=loop)
    assert int(got.n_iter) == int(ref.n_iter) > 1
    _close(got.centroids, ref.centroids, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.inertia), float(ref.inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_fit_weighted_matches_jax(fused):
    x, y, w = _data(4, n=2000, d=16, k=8)
    p = KMeansParams(n_clusters=8, init=InitMethod.Array, max_iter=100)
    jp = JaxParams(n_clusters=8, init=JaxInit.Array, max_iter=100)
    got = tc.fit(p, torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(y), fused=fused, engine="torch")
    ref = jc.fit(jp, jnp.asarray(x), jnp.asarray(w), jnp.asarray(y),
                 fused=fused)
    assert int(got.n_iter) == int(ref.n_iter)
    _close(got.centroids, ref.centroids, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.inertia), float(ref.inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_predict_matches_jax(normalize):
    x, y, w = _data(5)
    p = KMeansParams(n_clusters=8)
    labels, inertia = tc.predict(p, torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(w),
                                 normalize_weight=normalize, engine="torch")
    rl, ri = jc.predict(JaxParams(n_clusters=8), jnp.asarray(x),
                        jnp.asarray(y), jnp.asarray(w),
                        normalize_weight=normalize)
    _assert_labels(labels, rl, x, y, DistanceType.L2Expanded)
    np.testing.assert_allclose(float(inertia), float(ri), rtol=1e-5)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L1,
                                    DistanceType.CosineExpanded],
                         ids=lambda m: m.name)
def test_transform_matches_jax(metric):
    x, y, _ = _data(6)
    got = tc.transform(KMeansParams(n_clusters=8, metric=metric),
                       torch.from_numpy(x), torch.from_numpy(y),
                       engine="torch")
    ref = jc.transform(JaxParams(n_clusters=8, metric=_jdt(metric)),
                       jnp.asarray(x), jnp.asarray(y))
    assert got.shape == (1000, 8)
    _close(got, ref, atol=1e-4)


def test_cluster_cost_matches_jax():
    x, y, w = _data(7)
    nn = tc.min_cluster_and_distance(torch.from_numpy(x),
                                     torch.from_numpy(y), engine="torch")
    rnn = jc.min_cluster_and_distance(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(tc.cluster_cost(nn)),
                               float(jc.cluster_cost(rnn)), rtol=1e-5)
    np.testing.assert_allclose(
        float(tc.cluster_cost(nn, torch.from_numpy(w))),
        float(jc.cluster_cost(rnn, jnp.asarray(w))), rtol=1e-5)
    assert float(tc.cluster_cost(nn.value, torch.zeros(1000))) == 0.0


def test_kmeans_estimator_matches_functional():
    x, _, _ = _data(8, n=1500, d=8, k=6)
    xt = torch.from_numpy(x)
    km = tc.KMeans(6, seed=2, device="cpu").fit(x)
    out = tc.fit_predict(KMeansParams(n_clusters=6, seed=2), xt)
    torch.testing.assert_close(km.cluster_centers_, out.centroids)
    assert km.inertia_ == float(out.inertia)
    assert km.n_iter_ == int(out.n_iter)
    assert torch.equal(km.labels_, out.labels)
    assert torch.equal(km.predict(xt), out.labels)
    ref = jc.transform(JaxParams(n_clusters=6), jnp.asarray(x),
                       jnp.asarray(km.cluster_centers_.numpy()))
    _close(km.transform(xt), ref, atol=1e-4)


def test_graft_kmeans_step_matches_port():
    fn, (x, c) = graft.entry()
    ref_c, ref_inertia = fn(x, c)
    p = tc.fused_em_step(torch.from_numpy(x), torch.from_numpy(c),
                         engine="torch")
    got = tc.centroids_from_sums(p.sums, p.weights, torch.from_numpy(c),
                                 torch.float32)
    _close(got, ref_c, atol=0)
    np.testing.assert_allclose(float(p.inertia), float(ref_inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("sqrt", [False, True])
def test_fused_l2_nn_public_matches_jax(sqrt):
    x, y, _ = _data(9)
    got = tfl.fused_l2_nn(torch.from_numpy(x), torch.from_numpy(y), sqrt)
    ref = jax_fl.fused_l2_nn(jnp.asarray(x), jnp.asarray(y), sqrt)
    same = _assert_labels(got.key, ref.key, x, y, DistanceType.L2Expanded)
    _close(got.value.numpy()[same], np.asarray(ref.value)[same])
    am = tfl.fused_l2_nn_argmin(torch.from_numpy(x), torch.from_numpy(y),
                                sqrt)
    assert torch.equal(am, got.key)
    np.testing.assert_array_equal(
        am.numpy()[same],
        np.asarray(jax_fl.fused_l2_nn_argmin(jnp.asarray(x), jnp.asarray(y),
                                             sqrt))[same])
    mr = tfl.fused_l2_nn_min_reduce(torch.from_numpy(x), torch.from_numpy(y),
                                    sqrt)
    assert torch.equal(mr.value, got.value)


def test_fused_l2_nn_takes_precomputed_norms():
    x, y, _ = _data(10)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = tfl.fused_l2_nn(xt, yt, x_norms=(xt * xt).sum(1),
                          y_norms=(yt * yt).sum(1))
    ref = jax_fl.fused_l2_nn(jnp.asarray(x), jnp.asarray(y))
    same = _assert_labels(got.key, ref.key, x, y, DistanceType.L2Expanded)
    _close(got.value.numpy()[same], np.asarray(ref.value)[same])


@pytest.mark.parametrize("block_n", [3, 8, 64])
def test_l2_nn_tile_matches_jax(block_n):
    x, y, _ = _data(11, n=300, k=20)
    yn = (y.astype(np.float32) ** 2).sum(1)
    tb = tfl.l2_nn_blocks(torch.from_numpy(y), torch.from_numpy(yn), block_n)
    jb = jax_fl.l2_nn_blocks(jnp.asarray(y), jnp.asarray(yn), block_n)
    for a, b in zip(tb, jb):
        assert tuple(a.shape) == tuple(b.shape)
    assert bool(torch.isinf(tb[1].reshape(-1)[20:]).all())
    val, idx = tfl.l2_nn_tile(torch.from_numpy(x), *tb)
    rv, ri = jax_fl.l2_nn_tile(jnp.asarray(x), *jb)
    same = _assert_labels(idx, ri, x, y, DistanceType.L2Expanded)
    _close(val.numpy()[same], np.asarray(rv)[same], atol=1e-4)


def test_pack_unpack_em_partials_roundtrip():
    x, y, _ = _data(12)
    p = tc.fused_em_step(torch.from_numpy(x), torch.from_numpy(y),
                         engine="torch")
    packed = tc.pack_em_partials(p)
    assert packed.shape == (8 * 16 + 8 + 1,)
    q = tc.unpack_em_partials(packed, 8, 16)
    for a, b in zip(q[:3], p[:3]):
        assert torch.equal(a, b)
    rp = jc.pack_em_partials(jc.EMPartials(jnp.asarray(p.sums.numpy()),
                                           jnp.asarray(p.weights.numpy()),
                                           jnp.asarray(p.inertia.numpy())))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(rp))


def test_fused_em_enabled_reads_env_per_call(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_FUSED_EM", raising=False)
    assert tc.fused_em_enabled() and jc.fused_em_enabled()
    monkeypatch.setenv("RAFT_TPU_FUSED_EM", "0")
    assert not tc.fused_em_enabled() and not jc.fused_em_enabled()


def test_sampling_helpers_draw_distinct_rows():
    from raft_tpu_torch.random import RngState

    x, y, _ = _data(13, n=400)
    xt = torch.from_numpy(x)
    rows = tc.shuffle_and_gather(RngState(1), xt, 50)
    assert rows.shape == (50, 16)
    assert len({tuple(r) for r in rows.numpy()}) == 50
    assert all((xt == r).all(1).any() for r in rows)
    d = torch.zeros(400)
    d[:30] = 1.0                       # only 30 rows may be drawn
    got = tc.sample_centroids(RngState(2), xt, d, 30)
    assert sorted(map(tuple, got.numpy())) == sorted(map(tuple, x[:30]))
    r = tc.init_random(RngState(3), xt, 8)
    assert r.shape == (8, 16)


def test_fit_random_init_best_of_n_trials():
    x, _, _ = _data(14, n=1200, d=8, k=6)
    xt = torch.from_numpy(x)
    one = tc.fit(KMeansParams(n_clusters=6, init=InitMethod.Random, seed=4),
                 xt)
    five = tc.fit(KMeansParams(n_clusters=6, init=InitMethod.Random, seed=4,
                               n_init=5), xt)
    # the first trial of five is the single trial: the best is no worse
    assert float(five.inertia) <= float(one.inertia)


def test_bfloat16_fit_keeps_centroids_bfloat16():
    x, y, _ = _data(15)
    xb = torch.from_numpy(x).bfloat16()
    out = tc.fit(KMeansParams(n_clusters=8, init=InitMethod.Array,
                              max_iter=10), xb,
                 centroids=torch.from_numpy(y).bfloat16(), engine="torch")
    assert out.centroids.dtype == torch.bfloat16
    assert out.inertia.dtype == torch.float32
    ref = tc.fit(KMeansParams(n_clusters=8, init=InitMethod.Array,
                              max_iter=10), xb.float(),
                 centroids=torch.from_numpy(y).bfloat16().float(),
                 engine="torch")
    # the same E-steps on the widened rows; only the stored means round
    _close(out.centroids.float(), ref.centroids, rtol=1e-2, atol=1e-2)


def test_handle_issues_fit_on_its_stream():
    from raft_tpu_torch.core import Handle

    x, y, _ = _data(16)
    h = Handle(device="cpu", n_streams=2)
    p = KMeansParams(n_clusters=8, init=InitMethod.Array, max_iter=20)
    got = tc.fit_predict(p, x, centroids=y, handle=h)
    h.sync()
    ref = tc.fit_predict(p, torch.from_numpy(x), centroids=y)
    assert torch.equal(got.labels, ref.labels)
    assert got.centroids.device.type == "cpu"


def test_array_inputs_need_the_card(monkeypatch):
    from raft_tpu_torch import stats
    from raft_tpu_torch.random import RngState, make_blobs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _ = _data(17)
    p = KMeansParams(n_clusters=8)
    for call in (lambda: tc.fit(p, x), lambda: tc.predict(p, x, y),
                 lambda: tc.transform(p, x, y),
                 lambda: tc.KMeans(8).fit(x),
                 lambda: tfl.fused_l2_nn(x, y),
                 lambda: make_blobs(RngState(0), 10, 2),
                 lambda: stats.adjusted_rand_index(np.zeros(4), np.zeros(4))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # a tensor stays where it is
    assert tc.fit(p, torch.from_numpy(x)).centroids.device.type == "cpu"
