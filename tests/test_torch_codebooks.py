"""The PER_SUBSPACE codebook trainer of the port's IVF-PQ, all subspaces
at once (the batch dimension of the JAX package's ``jax.vmap``).

* The batched plain Lloyd equals the one-subspace-at-a-time loop it
  replaced, bit for bit, from the same generator seed: the initial centres
  are drawn in the same order and each step repeats the same arithmetic.
* From identical numpy centres, one batched EM step (``engine="torch"``,
  kernel B3's plain twin) matches the JAX package's Lloyd step body —
  ``jax.vmap`` of ``_l2_expanded`` + argmin + ``update_centroids`` over
  the subspaces, as ``raft_tpu/neighbors/ivf_pq.py`` runs it: labels equal
  except where the two best distances lie within 1e-5 relative (float64),
  centres to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster.kmeans import update_centroids as jax_update
from raft_tpu.distance.pairwise import _l2_expanded as jax_l2
from raft_tpu_torch.cluster.kmeans import (centroids_from_sums, fused_em_step,
                                           fused_em_step_batched)
from raft_tpu_torch.neighbors import ivf_pq as tpq


def _lloyd_one_subspace(gen, data, k, iters):
    """The trainer before it was batched: one codebook, its centres drawn
    from *gen*, then ``iters`` fused EM steps."""
    n = data.shape[0]
    if n >= k:
        sel = torch.randperm(n, generator=gen)[:k]
    else:
        sel = torch.randint(0, n, (k,), generator=gen)
    centers = data[sel]
    for _ in range(iters):
        p = fused_em_step(data, centers, engine="torch")
        centers = centroids_from_sums(p.sums, p.weights, centers,
                                      torch.float32)
    return centers


@pytest.mark.parametrize("n,pq_dim,ds,k", [(2000, 8, 2, 32), (100, 4, 3, 128),
                                           (1500, 6, 5, 16)])
def test_batched_plain_lloyd_equals_per_subspace_loop(n, pq_dim, ds, k):
    rng = np.random.default_rng(n + k)
    resid = torch.from_numpy(
        rng.standard_normal((n, pq_dim * ds)).astype(np.float32))
    ref_gen = torch.Generator().manual_seed(7)
    ref = torch.stack([
        _lloyd_one_subspace(ref_gen, resid[:, m * ds:(m + 1) * ds]
                            .contiguous(), k, 5) for m in range(pq_dim)])
    got = tpq._train_codebooks_subspace(torch.Generator().manual_seed(7),
                                        resid, pq_dim, k, 5, "torch")
    assert got.shape == (pq_dim, k, ds)
    assert torch.equal(got, ref)


def _jax_lloyd_step(data, centers, k):
    """The body of ``raft_tpu.neighbors.ivf_pq._lloyd_kmeans``' step for one
    subspace, returning the labels beside the new centres."""
    d = jax_l2(data, centers, sqrt=False, precision="high")
    labels = jnp.argmin(d, axis=1).astype(jnp.int32)
    new, _ = jax_update(data, labels, k, old_centroids=centers)
    return labels, new


@pytest.mark.parametrize("s,n,ds,k", [(8, 3000, 2, 64), (3, 1000, 4, 256),
                                      (5, 777, 1, 7)])
def test_batched_em_step_matches_jax_lloyd_body(s, n, ds, k):
    rng = np.random.default_rng(s * n + ds)
    x = rng.standard_normal((s, n, ds)).astype(np.float32)
    c0 = np.stack([x[i, rng.choice(n, k, replace=False)] for i in range(s)])
    ref_labels, ref = jax.vmap(lambda d, c: _jax_lloyd_step(d, c, k))(
        jnp.asarray(x), jnp.asarray(c0))
    p = fused_em_step_batched(torch.from_numpy(x), torch.from_numpy(c0),
                              engine="torch", return_labels=True)
    got = centroids_from_sums(p.sums, p.weights, torch.from_numpy(c0),
                              torch.float32)
    labels = p.labels.numpy()
    diff = labels != np.asarray(ref_labels)
    if diff.any():
        x64, c64 = x.astype(np.float64), c0.astype(np.float64)
        d2 = ((x64[:, :, None, :] - c64[:, None, :, :]) ** 2).sum(-1)
        two = np.sort(d2, axis=2)[:, :, :2]
        near = (two[..., 1] - two[..., 0]) <= 1e-5 * np.maximum(two[..., 0],
                                                               1e-30)
        assert not (diff & ~near).any()
        # centres of clusters a near tie moved are not comparable
        moved = np.zeros((s, k), bool)
        for i, r in zip(*np.nonzero(diff)):
            moved[i, labels[i, r]] = moved[i, np.asarray(ref_labels)[i, r]] = True
    else:
        moved = np.zeros((s, k), bool)
    np.testing.assert_allclose(got.numpy()[~moved], np.asarray(ref)[~moved],
                               rtol=1e-5, atol=1e-6)
    assert p.sums.shape == (s, k, ds) and p.weights.shape == (s, k)
    assert p.inertia.shape == (s,)
