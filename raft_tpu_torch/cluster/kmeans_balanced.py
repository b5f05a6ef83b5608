"""Balanced hierarchical k-means — the ANN coarse quantizer trainer (port of
``raft_tpu/cluster/kmeans_balanced.py``: ``adjust_centers`` :36,
``_em_program`` :69, ``build_clusters`` :106, ``_fine_stage`` :127,
``build_hierarchical`` :187; reference ann_kmeans_balanced.cuh:942).

Every balancing-EM iteration is one fused EM step (kernel B3 on the card);
the mesocluster labels run kernel B1.  The per-mesocluster fine stage is
one batched masked Lloyd-EM over all mesoclusters at once, in plain
PyTorch (``torch.bmm``), as the JAX package leaves it to XLA.  The host
draws that the JAX package makes with numpy (the fine stage's row and seed
choices) stay numpy and match it exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import (centroids_from_sums,
                                           fused_em_step,
                                           min_cluster_and_distance)
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.linalg.reduce import one_hot_by_key
from raft_tpu_torch.random.rng import RngState, sample_without_replacement

_ADJUST_THRESHOLD = 0.25
#: bound on padded rows per mesocluster in the batched fine stage
_FINE_ROW_CAP = 1 << 15


def _adjust_batched(centers, counts, x, labels, distances, mask,
                    threshold: float):
    """:func:`adjust_centers` over a leading batch axis: centers (B, k, d),
    counts (B, k), x (B, m, d), labels/distances (B, m), mask (B, k)."""
    b, k, d = centers.shape
    avg = counts.sum(1) / torch.clamp_min(mask.sum(1).to(counts.dtype), 1)
    small = mask & (counts < (avg * threshold)[:, None])
    n_small = small.sum(1)
    score = torch.gather(counts, 1, labels.long()) * distances
    # stable descending: ties go to the lowest row, as jax.lax.top_k does
    _, donor_idx = torch.sort(score, dim=1, descending=True, stable=True)
    donor_idx = donor_idx[:, :k]
    small_rank = torch.cumsum(small.to(torch.int64), 1) - 1
    take = torch.gather(donor_idx, 1, torch.clamp(small_rank, 0, k - 1))
    donors = torch.gather(x, 1, take[..., None].expand(b, k, d))
    return torch.where(small[..., None], donors, centers), n_small


def adjust_centers(centers, counts, x, labels, distances,
                   threshold: float = _ADJUST_THRESHOLD, mask=None):
    """Re-seed clusters smaller than ``threshold · average`` with the
    far-out members of crowded clusters (highest size × distance first).
    ``mask`` (k,) marks the live centres.  Returns (centers, n_small)."""
    if mask is None:
        mask = torch.ones(centers.shape[0], dtype=torch.bool,
                          device=centers.device)
    new, n_small = _adjust_batched(centers[None], counts[None], x[None],
                                   labels[None], distances[None], mask[None],
                                   threshold)
    return new[0], n_small[0]


def _em_program(x: torch.Tensor, centers0: torch.Tensor, n_clusters: int,
                n_iters: int, metric: DistanceType, adjust_every: int,
                engine: Optional[str] = None) -> torch.Tensor:
    """The balancing-EM loop: each iteration is one fused EM step (labels
    and distances come out of the same pass), then every
    ``adjust_every``-th iteration re-seeds the small clusters."""
    centers = centers0
    for it in range(n_iters):
        p = fused_em_step(x, centers, None, metric, engine=engine,
                          return_labels=bool(adjust_every))
        centers = centroids_from_sums(p.sums, p.weights, centers, x.dtype)
        if adjust_every and it % adjust_every == adjust_every - 1:
            centers, _ = adjust_centers(centers, p.weights, x, p.labels,
                                        p.distances)
    return centers


def build_clusters(rng: RngState, x: torch.Tensor, n_clusters: int,
                   n_iters: int = 20,
                   metric: DistanceType = DistanceType.L2Expanded,
                   adjust_every: int = 2,
                   engine: Optional[str] = None) -> torch.Tensor:
    """Train ``n_clusters`` balanced centres on x (reference
    ann_kmeans_balanced.cuh:626 + :699)."""
    n = x.shape[0]
    centers = sample_without_replacement(rng.next_generator(), x,
                                         min(n_clusters, n))
    if centers.shape[0] < n_clusters:  # tiny inputs: repeat rows
        reps = -(-n_clusters // centers.shape[0])
        centers = centers.repeat(reps, 1)[:n_clusters]
    return _em_program(x, centers, n_clusters, n_iters, metric, adjust_every,
                       engine)


def _fine_stage(xs: torch.Tensor, c0: torch.Tensor, cmask: torch.Tensor,
                n_iters: int, adjust_every: int = 2) -> torch.Tensor:
    """Masked Lloyd-EM with balancing over all mesoclusters at once: xs
    (B, m, d) padded rows, c0 (B, k_max, d) seeds, cmask (B, k_max) live
    centres (masked ones score +inf and are never chosen or re-seeded)."""
    k = c0.shape[1]
    xn = torch.sum(xs * xs, dim=2)
    c = c0
    for it in range(n_iters):
        dist = (xn[:, :, None] + torch.sum(c * c, dim=2)[:, None, :]
                - 2.0 * torch.bmm(xs, c.transpose(1, 2)))
        dist = torch.where(cmask[:, None, :], dist,
                           torch.full_like(dist, float("inf")))
        labels = torch.argmin(dist, dim=2)
        dmin = torch.gather(dist, 2, labels[..., None])[..., 0]
        oh = one_hot_by_key(labels, k, xs.dtype)
        counts = torch.sum(oh, dim=1)
        sums = torch.bmm(oh.transpose(1, 2), xs)
        new = torch.where((counts[..., None] > 0) & cmask[..., None],
                          sums / torch.clamp_min(counts, 1)[..., None], c)
        if adjust_every and it % adjust_every == adjust_every - 1:
            new, _ = _adjust_batched(new, counts, xs, labels, dmin, cmask,
                                     _ADJUST_THRESHOLD)
        c = new
    return c


def _bucket_size(size: int, cap: int) -> int:
    """Next power of two >= size, floored at 8, bounded by ``cap``."""
    return min(1 << max(3, (size - 1).bit_length()), cap)


def build_hierarchical(rng: RngState, x: torch.Tensor, n_clusters: int,
                       n_iters: int = 20,
                       metric: DistanceType = DistanceType.L2Expanded,
                       engine: Optional[str] = None) -> torch.Tensor:
    """Two-level balanced clustering: ≈√n_clusters mesoclusters, fine
    clusters within each in proportion to its population (one batched
    program), then global balancing EM."""
    n = x.shape[0]
    if n_clusters <= 32 or n <= 4 * n_clusters:
        return build_clusters(rng, x, n_clusters, n_iters, metric,
                              engine=engine)
    n_meso = max(2, int(math.sqrt(n_clusters) + 0.5))
    meso_centers = build_clusters(rng, x, n_meso, n_iters, metric,
                                  engine=engine)
    meso_labels = min_cluster_and_distance(
        x, meso_centers, metric, engine=engine).key.cpu().numpy()
    sizes = np.bincount(meso_labels, minlength=n_meso)
    share = np.floor(sizes / n * n_clusters).astype(int)
    quota = np.where(sizes > 0, np.maximum(1, share), 0)
    while quota.sum() < n_clusters:
        quota[np.argmax(np.where(sizes > 0, sizes - quota * (n / n_clusters),
                                 -np.inf))] += 1
    while quota.sum() > n_clusters:
        i = np.argmax(np.where(quota > 1, quota, -1))
        quota[i] -= 1

    live = np.nonzero(quota > 0)[0]
    host_rng = np.random.default_rng(rng.seed + 1000)
    cap = _bucket_size(int(sizes[live].max()), _FINE_ROW_CAP)
    k_max = int(quota.max())
    idx_mat = np.empty((len(live), cap), np.int64)
    seed_mat = np.empty((len(live), k_max), np.int64)
    for b, m in enumerate(live):
        idx = np.nonzero(meso_labels == m)[0]
        if len(idx) > cap:
            take = host_rng.choice(idx, cap, replace=False)
        else:
            take = np.concatenate(
                [idx, host_rng.choice(idx, cap - len(idx), replace=True)])
        idx_mat[b] = take
        seed_mat[b] = host_rng.choice(idx, k_max, replace=len(idx) < k_max)
    dev = x.device
    cmask = torch.as_tensor(np.arange(k_max)[None, :] < quota[live][:, None],
                            device=dev)
    xs = x[torch.as_tensor(idx_mat, device=dev)]
    c0 = x[torch.as_tensor(seed_mat, device=dev)]
    fine = _fine_stage(xs, c0, cmask, max(4, n_iters // 2))
    del xs
    centers = torch.cat([fine[b, :quota[m]] for b, m in enumerate(live)]
                        )[:n_clusters]
    return _em_program(x, centers, n_clusters, max(2, n_iters // 4), metric,
                       adjust_every=1, engine=engine)
