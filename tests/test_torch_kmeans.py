"""Parity of the port's balanced k-means with raft_tpu.

From identical centres, one fused EM step and the whole balancing-EM loop
(``_em_program``) match the JAX package: centres to rtol 1e-4.
``build_hierarchical`` draws from its own RNG (``jax.random`` cannot be
reproduced in torch), so it is judged by quality: on clustered data the
port's inertia is at most 1.05× the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import torch

from raft_tpu.cluster import kmeans_balanced as jax_kb
from raft_tpu.distance.distance_types import DistanceType as JaxDT
from raft_tpu.random.rng import RngState as JaxRng
from raft_tpu_torch.cluster import kmeans as tk
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.random.rng import RngState


def _blobs(n, d, k, seed, spread=0.3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, (k, d)).astype(np.float32)
    x = c[rng.integers(0, k, n)] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32), c


def _inertia(x, centers):
    d = ((x[:, None, :].astype(np.float64)
          - np.asarray(centers, np.float64)[None]) ** 2).sum(-1)
    return float(d.min(1).sum())


def test_em_program_matches_jax_from_identical_centers():
    x, _ = _blobs(2000, 16, 24, seed=0)
    c0 = x[np.random.default_rng(1).choice(2000, 24, replace=False)]
    ref = jax_kb._em_program(jnp.asarray(x), jnp.asarray(c0), 24, 6,
                             JaxDT.L2Expanded, 2, fused=True, engine="xla")
    got = tkb._em_program(torch.from_numpy(x), torch.from_numpy(c0), 24, 6,
                          DistanceType.L2Expanded, 2, engine="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_adjust_centers_matches_jax():
    x, _ = _blobs(500, 8, 10, seed=2)
    rng = np.random.default_rng(3)
    centers = x[rng.choice(500, 10, replace=False)]
    labels = rng.integers(0, 10, 500).astype(np.int32)
    labels[labels == 4] = 0                  # cluster 4 goes empty
    counts = np.bincount(labels, minlength=10).astype(np.float32)
    dists = rng.uniform(0, 3, 500).astype(np.float32)
    ref, ref_n = jax_kb.adjust_centers(jnp.asarray(centers),
                                       jnp.asarray(counts), jnp.asarray(x),
                                       jnp.asarray(labels), jnp.asarray(dists))
    got, got_n = tkb.adjust_centers(torch.from_numpy(centers),
                                    torch.from_numpy(counts),
                                    torch.from_numpy(x),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(dists))
    assert int(got_n) == int(ref_n) >= 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_build_hierarchical_quality_vs_jax():
    # one draw of either package lands in a local minimum whose inertia
    # varies by tens of percent with the seed, so both are judged by their
    # mean over the same four seeds
    x, _ = _blobs(4096, 32, 64, seed=4, spread=0.5)
    ref, got = [], []
    for seed in range(4):
        c = jax_kb.build_hierarchical(JaxRng(seed), jnp.asarray(x), 64, 10)
        ref.append(_inertia(x, c))
        t = tkb.build_hierarchical(RngState(seed), torch.from_numpy(x), 64,
                                   10, engine="torch")
        assert t.shape == (64, 32) and bool(torch.isfinite(t).all())
        got.append(_inertia(x, t.numpy()))
    assert np.mean(got) <= 1.05 * np.mean(ref), (got, ref)


def test_centers_round_trip():
    c = np.random.default_rng(5).standard_normal((6, 4)).astype(np.float32)
    t = tk.centers_from_array(c, device="cpu")
    np.testing.assert_array_equal(tk.centers_to_array(t), c)


def test_update_centroids_matches_jax():
    from raft_tpu.cluster import kmeans as jax_kmeans

    x, _ = _blobs(400, 8, 6, seed=6)
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 6, 400).astype(np.int32)
    labels[labels == 2] = 1                  # cluster 2 empty: keeps its old
    old = rng.standard_normal((6, 8)).astype(np.float32)
    w = rng.uniform(0.5, 2, 400).astype(np.float32)
    ref_c, ref_w = jax_kmeans.update_centroids(
        jnp.asarray(x), jnp.asarray(labels), 6, jnp.asarray(w),
        jnp.asarray(old))
    got_c, got_w = tk.update_centroids(torch.from_numpy(x),
                                       torch.from_numpy(labels), 6,
                                       torch.from_numpy(w),
                                       torch.from_numpy(old))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), rtol=1e-5)
    np.testing.assert_array_equal(got_c[2].numpy(), old[2])
