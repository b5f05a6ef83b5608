"""The port's brute-force kNN (``raft_tpu_torch.neighbors.brute_force``,
``haversine``) against the JAX package's on the same data.

Tolerance: distances to rtol 1e-5 (atol 1e-5; other summation orders);
ids equal wherever a distance is not within rtol 1e-5 of a neighbour in
its row (the two packages may order near-equal candidates differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors.haversine import haversine_knn as jax_haversine
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors.haversine import haversine_knn

K = 7


def _data(seed, n=1000, nq=37, dim=16):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (20, dim))
    x = (c[rng.integers(0, 20, n)] + rng.standard_normal((n, dim))
         ).astype(np.float32)
    q = (c[rng.integers(0, 20, nq)] + rng.standard_normal((nq, dim))
         ).astype(np.float32)
    return x, q


def assert_knn_close(got, ref):
    gd, gi = (np.asarray(a) for a in got)
    rd, ri = (np.asarray(a) for a in ref)
    assert gd.shape == rd.shape and gi.shape == ri.shape
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
    tied = np.zeros_like(rd, dtype=bool)
    close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(gi[~tied], ri[~tied])


METRICS = [DistanceType.L2SqrtExpanded, DistanceType.InnerProduct,
           DistanceType.CosineExpanded, DistanceType.L1, "euclidean",
           DistanceType.Linf, DistanceType.Canberra,
           DistanceType.LpUnexpanded]


@pytest.mark.parametrize("metric", METRICS, ids=str)
def test_knn_matches_jax(metric):
    x, q = _data(1)
    ref = jbf.knn(jnp.asarray(x), jnp.asarray(q), K, metric, 3.0)
    got = tbf.knn(x, q, K, metric, 3.0, device="cpu")
    assert got[1].dtype == torch.int32
    assert_knn_close(got, ref)


@pytest.mark.parametrize("metric", [DistanceType.L2SqrtExpanded,
                                    DistanceType.L1], ids=str)
def test_ragged_tile_tail_and_query_batches(metric):
    # 1000 rows in tiles of 256 (a 232-row tail); 37 queries in batches of
    # 16 (the last, 5 rows, padded to its bucket of 8)
    x, q = _data(2)
    kw = dict(batch_size_index=256, batch_size_query=16)
    ref = jbf.knn(jnp.asarray(x), jnp.asarray(q), K, metric, **kw)
    got = tbf.knn(x, q, K, metric, device="cpu", **kw)
    assert_knn_close(got, ref)
    whole = tbf.knn(x, q, K, metric, device="cpu")
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


def test_half_inputs_give_float32_distances():
    x, q = _data(3)
    xb, qb = (torch.from_numpy(a).bfloat16() for a in (x, q))
    ref = jbf.knn(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                  jnp.asarray(qb.float().numpy()).astype(jnp.bfloat16), K,
                  DistanceType.L1)
    got = tbf.knn(xb, qb, K, DistanceType.L1, device="cpu")
    assert got[0].dtype == torch.float32
    assert_knn_close(got, ref)


def test_global_id_offset():
    x, q = _data(4, n=300, nq=5)
    d, i = tbf.knn(x, q, K, device="cpu")
    d2, i2 = tbf.knn(x, q, K, device="cpu", global_id_offset=1000)
    assert i2.dtype == torch.int32 and torch.equal(i2, i + 1000)
    big = 2**31 - 100
    d3, i3 = tbf.knn(x, q, K, device="cpu", global_id_offset=big)
    assert i3.dtype == torch.int64
    assert torch.equal(i3, i.long() + big) and torch.equal(d3, d)
    ref = jbf.knn(jnp.asarray(x), jnp.asarray(q), K, global_id_offset=big)
    np.testing.assert_array_equal(i3.numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("metric", [DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct], ids=str)
def test_knn_merge_parts_matches_jax(metric):
    x, q = _data(5, n=900)
    parts_d, parts_i = [], []
    for s in range(0, 900, 300):
        d, i = jbf.knn(jnp.asarray(x[s:s + 300]), jnp.asarray(q), K, metric)
        parts_d.append(np.asarray(d))
        parts_i.append(np.asarray(i))
    pd, pi = np.stack(parts_d), np.stack(parts_i)
    trans = [0, 300, 600]
    ref = jbf.knn_merge_parts(pd, pi, K, translations=trans, metric=metric)
    got = tbf.knn_merge_parts(pd, pi, K, translations=trans, metric=metric,
                              device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    # wider than one part: part 0 is padded before the fold
    wide = tbf.knn_merge_parts(pd[:2], pi[:2], K + 3, translations=trans[:2],
                               metric=metric, device="cpu")
    ref_w = jbf.knn_merge_parts(pd[:2], pi[:2], K + 3,
                                translations=trans[:2], metric=metric)
    np.testing.assert_array_equal(wide[0].numpy(), np.asarray(ref_w[0]))
    np.testing.assert_array_equal(wide[1].numpy(), np.asarray(ref_w[1]))


@pytest.mark.parametrize("sqrt", [True, False])
def test_fused_l2_knn_matches_jax(sqrt):
    x, q = _data(6)
    ref = jbf.fused_l2_knn(jnp.asarray(x), jnp.asarray(q), K, sqrt=sqrt)
    got = tbf.fused_l2_knn(x, q, K, sqrt=sqrt, device="cpu")
    assert_knn_close(got, ref)


def test_haversine_knn_matches_jax():
    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(-1.5, 1.5, 600), rng.uniform(-3.1, 3.1, 600)],
                   axis=1).astype(np.float32)
    x, q = pts[:560], pts[560:]
    ref = jax_haversine(jnp.asarray(x), jnp.asarray(q), K)
    got = haversine_knn(x, q, K, device="cpu")
    assert_knn_close(got, ref)


def test_empty_queries_and_bad_k():
    from raft_tpu_torch.core.error import LogicError

    x, _ = _data(8, n=50)
    d, i = tbf.knn(x, np.zeros((0, 16), np.float32), 3, device="cpu")
    assert d.shape == (0, 3) and i.shape == (0, 3)
    with pytest.raises(LogicError):
        tbf.knn(x, x[:2], 51, device="cpu")
