"""The port's ``pairwise_distance`` against the JAX package's, for every
name of ``SUPPORTED_DISTANCES`` plus BrayCurtis and Haversine, at float32,
bfloat16 and float16 (half inputs give float32 distances in both).

Each metric gets inputs from its domain: non-negative for Hellinger,
positive for KL, probability rows for JensenShannon, (lat, lon) radians
for Haversine; signed values elsewhere.  The JAX side runs its default
engine (``_blocked_reduce`` and the matrix-unit epilogues), the port's
CPU path its plain versions.

Tolerance: rtol 1e-5 with atol 1e-5 (the distances are O(1) to O(10)
and the two packages sum in other orders; correlation's k·Σxy − ΣxΣy
cancels to that absolute level).  Half haversine is held to JAX's on the
widened values: JAX computes it in the input type, the port in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.pairwise import pairwise_distance as jax_pairwise
from raft_tpu_torch.distance import pairwise as tp
from raft_tpu_torch.distance.distance_types import (DISTANCE_TYPES,
                                                    SUPPORTED_DISTANCES,
                                                    DistanceType)

NAMES = SUPPORTED_DISTANCES + ["braycurtis", "haversine"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _inputs(name, seed, m=37, n=45, k=13):
    rng = np.random.default_rng(seed)
    if name == "haversine":
        lat = rng.uniform(-1.5, 1.5, (m + n, 1))
        lon = rng.uniform(-3.1, 3.1, (m + n, 1))
        xy = np.concatenate([lat, lon], axis=1)
    elif name in ("hellinger", "kl_divergence", "russellrao"):
        xy = rng.uniform(0.01, 1.0, (m + n, k))
    elif name == "jensenshannon":
        xy = rng.uniform(0.0, 1.0, (m + n, k))
        xy[rng.random(xy.shape) < 0.1] = 0.0
        xy /= xy.sum(axis=1, keepdims=True)
    else:
        xy = rng.standard_normal((m + n, k))
    return xy[:m].astype(np.float32), xy[m:].astype(np.float32)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of *dtype*."""
    jdt, tdt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(tdt)
    return jnp.asarray(xt.float().numpy()).astype(jdt), xt


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_pairwise_distance_matches_jax(name, dtype):
    x, y = _inputs(name, NAMES.index(name))
    jx, tx = _pair(x, dtype)
    jy, ty = _pair(y, dtype)
    if name == "haversine":
        # JAX computes a half haversine in the input type; the port widens
        # to float32 first (accum_dtype), as JAX does on widened values
        jx, jy = jx.astype(jnp.float32), jy.astype(jnp.float32)
    ref = np.asarray(jax_pairwise(jx, jy, name, p=3.0))
    got = tp.pairwise_distance(tx, ty, name, p=3.0, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_metric_names_and_types():
    assert tp.pairwise_distance(np.zeros((2, 3)), np.zeros((4, 3)),
                                device="cpu").dtype == torch.float32
    assert DISTANCE_TYPES["euclidean"] == DistanceType.L2SqrtUnexpanded
    assert DISTANCE_TYPES["cityblock"] == DistanceType.L1
    from raft_tpu_torch.core.error import LogicError

    with pytest.raises(LogicError):
        tp.pairwise_distance(np.zeros((2, 3)), np.zeros((4, 3)), "nope",
                             device="cpu")
    with pytest.raises(LogicError):
        tp.pairwise_distance(np.zeros((2, 3)), np.zeros((4, 3)), "jaccard",
                             device="cpu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("metric", tp.STATS_METRICS)
def test_hoisted_stats_equal_the_unhoisted_path(metric, dtype):
    x, y = _inputs("euclidean", 5)
    _, tx = _pair(x, dtype)
    _, ty = _pair(y, dtype)
    xs, ys = tp.metric_stats(tx, metric), tp.metric_stats(ty, metric)
    assert xs.dtype == torch.float32
    assert torch.equal(tp.distance_with_stats(tx, ty, metric, 2.0, xs, ys),
                       tp.distance(tx, ty, metric))


def test_other_metrics_have_no_stats():
    x = torch.ones(5, 3)
    for metric in (DistanceType.L1, DistanceType.InnerProduct):
        assert tp.metric_stats(x, metric).shape == (5, 0)
        assert torch.equal(
            tp.distance_with_stats(x, x, metric, 2.0,
                                   tp.metric_stats(x, metric), None),
            tp.distance(x, x, metric))


def test_rows_do_not_depend_on_the_batch():
    """A row's distances are the same bits in any batch: fixed product
    blocks, fixed reduce tiles."""
    x, y = _inputs("euclidean", 9, m=300, n=700, k=20)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for name in ("euclidean", "l1", "cosine", "jensenshannon", "chebyshev"):
        if name == "jensenshannon":
            a, b = tx.abs(), ty.abs()
        else:
            a, b = tx, ty
        full = tp.pairwise_distance(a, b, name, device="cpu")
        assert torch.equal(tp.pairwise_distance(a[:5], b, name,
                                                device="cpu"), full[:5])
