"""Parity of the plain versions of kernels B1 (fused L2 NN) and B3 (fused
E-step + M-step partials) with raft_tpu: its Pallas kernels in interpret
mode, ``min_cluster_and_distance(engine="xla")`` and
``fused_em_step(engine="xla", return_labels=True)``.

Tolerances: labels identical except where the two best distances lie
within 1e-5 relative of each other (the engines sum the dot products in
different orders); duplicated centroids resolve to the lower index in
both; values, sums and weights agree to rtol 1e-5, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans as jax_kmeans
from raft_tpu.kernels import fused_l2nn as jax_kernel
from raft_tpu_torch.cluster import kmeans as tk
from raft_tpu_torch.distance import fused_l2_nn as plain
from raft_tpu_torch.kernels import fused_l2nn as kernel

M, K, D = 300, 70, 33
_DUPES = {10: 3, 50: 20, 69: 0}   # duplicate centroid → its lower twin


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((K, D)).astype(np.float32)
    for hi, lo in _DUPES.items():
        y[hi] = y[lo]
    x = (y[rng.integers(0, K, M)] * 0.7
         + 0.6 * rng.standard_normal((M, D))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, M).astype(np.float32)
    return x, y, w


def _near_tie(x, y):
    """Rows whose two best (f64) distances lie within 1e-5 relative."""
    d = ((x[:, None, :].astype(np.float64) - y[None].astype(np.float64)) ** 2
         ).sum(-1)
    d[:, list(_DUPES)] = np.inf   # exact duplicates are ties by design
    two = np.sort(d, axis=1)[:, :2]
    return two[:, 1] - two[:, 0] <= 1e-5 * np.maximum(two[:, 0], 1e-30)


def _assert_labels(port, ref, x, y):
    port, ref = np.asarray(port), np.asarray(ref)
    diff = port != ref
    assert not np.any(diff & ~_near_tie(x, y)), np.nonzero(diff)
    assert not np.isin(port, list(_DUPES)).any()   # lower twin wins


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-5)


def test_b1_plain_matches_pallas_interpret():
    x, y, _ = _inputs()
    val, idx = plain.fused_l2_nn_plain(torch.from_numpy(x),
                                       torch.from_numpy(y))
    rv, ri = jax_kernel.fused_l2_nn_pallas(jnp.asarray(x), jnp.asarray(y),
                                           bf16_dot=False, interpret=True)
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    _assert_labels(idx, ri, x, y)
    _close(val, rv)


def test_min_cluster_and_distance_matches_xla():
    x, y, _ = _inputs(1)
    got = tk.min_cluster_and_distance(torch.from_numpy(x),
                                      torch.from_numpy(y), engine="torch")
    ref = jax_kmeans.min_cluster_and_distance(jnp.asarray(x), jnp.asarray(y),
                                              engine="xla")
    _assert_labels(got.key, ref.key, x, y)
    _close(got.value, ref.value)


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_em_step_matches_xla(weighted):
    x, y, w = _inputs(2)
    wt = torch.from_numpy(w) if weighted else None
    got = tk.fused_em_step(torch.from_numpy(x), torch.from_numpy(y), wt,
                           engine="torch", return_labels=True)
    ref = jax_kmeans.fused_em_step(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(w) if weighted else None,
                                   engine="xla", return_labels=True)
    _assert_labels(got.labels, ref.labels, x, y)
    _close(got.distances, ref.distances)
    # the seeded data has no near tie, so the partials must agree too
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    _close(got.sums, ref.sums)
    _close(got.weights, ref.weights)
    np.testing.assert_allclose(float(got.inertia), float(ref.inertia),
                               rtol=1e-5)


def test_b3_plain_matches_pallas_interpret():
    x, y, w = _inputs(3)
    got = plain.fused_l2_nn_partials_plain(torch.from_numpy(x),
                                           torch.from_numpy(y),
                                           torch.from_numpy(w))
    ref = jax_kernel.fused_l2_nn_partials(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(w), interpret=True)
    _assert_labels(got[1], ref[1], x, y)
    for a, b in zip((got[0],) + tuple(got[2:]), (ref[0],) + tuple(ref[2:])):
        _close(a, b)


def test_bf16_dot_rounds_only_the_products():
    x, y, _ = _inputs(4)
    val, idx = plain.fused_l2_nn_plain(torch.from_numpy(x),
                                       torch.from_numpy(y), bf16_dot=True)
    xb = torch.from_numpy(x).bfloat16().double()
    yb = torch.from_numpy(y).bfloat16().double()
    xn = (torch.from_numpy(x).double() ** 2).sum(1)
    yn = (torch.from_numpy(y).double() ** 2).sum(1)
    d = torch.clamp_min(xn[:, None] + yn[None] - 2 * xb @ yb.T, 0)
    np.testing.assert_allclose(val.numpy(), d.min(1).values.numpy(),
                               rtol=1e-5, atol=1e-4)


def test_wrappers_on_cpu_run_the_plain_versions():
    x, y, w = (torch.from_numpy(a) for a in _inputs(5))
    assert all(torch.equal(a, b) for a, b in zip(
        kernel.fused_l2_nn(x, y), plain.fused_l2_nn_plain(x, y)))
    assert all(torch.equal(a, b) for a, b in zip(
        kernel.fused_l2_nn_partials(x, y, w),
        plain.fused_l2_nn_partials_plain(x, y, w)))
