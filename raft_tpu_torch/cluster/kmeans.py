"""K-means building blocks (subset port of ``raft_tpu/cluster/kmeans.py``:
``min_cluster_and_distance`` :46, ``update_centroids`` :149,
``centroids_from_sums`` :166, ``fused_em_step`` :409) and
:func:`fused_em_step_batched`, the batch dimension of the JAX package's
``jax.vmap`` of its Lloyd step over PQ subspaces.

The E-step runs kernel B1 and the fused EM step kernel B3 on a CUDA
device (``engine="cuda"``, the default there); ``engine="torch"`` runs
their plain versions.  Only the L2 family is served — the metric the ANN
coarse quantizer trains with.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.distance import fused_l2_nn as plain
from raft_tpu_torch.distance.distance_types import DistanceType, L2_METRICS
from raft_tpu_torch.kernels.engine import resolve_engine


class KeyValuePair(NamedTuple):
    """Per-sample nearest centre: ``key`` (m,) int32, ``value`` (m,) f32."""

    key: torch.Tensor
    value: torch.Tensor


class EMPartials(NamedTuple):
    """One EM iteration's accumulators (``raft_tpu.cluster.kmeans.
    EMPartials``)."""

    sums: torch.Tensor       # (k, d) Σ w·x per cluster
    weights: torch.Tensor    # (k,)   Σ w per cluster
    inertia: torch.Tensor    # ()     Σ w·min_dist²
    labels: Optional[torch.Tensor] = None
    distances: Optional[torch.Tensor] = None


def _engine(x: torch.Tensor, metric, engine: Optional[str]) -> str:
    expects(metric in L2_METRICS,
            f"k-means E-step: only the L2 family is ported, got {metric}")
    return resolve_engine("l2nn", x.device, metric=metric, engine=engine)


def min_cluster_and_distance(x: torch.Tensor, centroids: torch.Tensor,
                             metric: DistanceType = DistanceType.L2Expanded,
                             engine: Optional[str] = None) -> KeyValuePair:
    """Nearest centroid (index, squared L2 distance) per sample."""
    if _engine(x, metric, engine) == "cuda":
        from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn

        val, idx = fused_l2_nn(x, centroids)
    else:
        val, idx = plain.fused_l2_nn_plain(x, centroids)
    return KeyValuePair(key=idx, value=val)


def centroids_from_sums(sums: torch.Tensor, wsum: torch.Tensor,
                        old_centroids: Optional[torch.Tensor],
                        dtype: torch.dtype) -> torch.Tensor:
    """Weighted means, sums (..., k, d) over wsum (..., k); an empty
    cluster keeps its previous centroid."""
    new = (sums / torch.clamp_min(wsum, 1e-30)[..., None]).to(dtype)
    if old_centroids is not None:
        new = torch.where(wsum[..., None] > 0, new, old_centroids)
    return new


def update_centroids(x: torch.Tensor, labels: torch.Tensor, n_clusters: int,
                     sample_weights: Optional[torch.Tensor] = None,
                     old_centroids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-step: (new centroids, weight per cluster)."""
    sums, wsum = plain.cluster_partials_plain(x, labels, n_clusters,
                                              sample_weights)
    return centroids_from_sums(sums, wsum, old_centroids, x.dtype), wsum


def fused_em_step(x: torch.Tensor, centroids: torch.Tensor,
                  sample_weights: Optional[torch.Tensor] = None,
                  metric: DistanceType = DistanceType.L2Expanded,
                  engine: Optional[str] = None,
                  return_labels: bool = False) -> EMPartials:
    """One EM iteration's accumulators from one pass of the E-step: the
    nearest centre of every row and the M-step partials keyed by it."""
    if _engine(x, metric, engine) == "cuda":
        from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn_partials

        val, idx, sums, wsum, inertia = fused_l2_nn_partials(
            x, centroids, sample_weights)
    else:
        val, idx, sums, wsum, inertia = plain.fused_l2_nn_partials_plain(
            x, centroids, sample_weights)
    return EMPartials(sums, wsum, inertia,
                      idx if return_labels else None,
                      val if return_labels else None)


def fused_em_step_batched(x: torch.Tensor, centroids: torch.Tensor,
                          sample_weights: Optional[torch.Tensor] = None,
                          metric: DistanceType = DistanceType.L2Expanded,
                          engine: Optional[str] = None,
                          return_labels: bool = False) -> EMPartials:
    """:func:`fused_em_step` for S independent problems at once: x
    (S, n, d), centroids (S, k, d), sample_weights (n,) or (S, n); every
    field of the result gains the leading S.  On the card narrow rows
    (the PQ codebooks) run as one launch of kernel B3 for all S."""
    if _engine(x, metric, engine) == "cuda":
        from raft_tpu_torch.kernels.fused_l2nn import (
            fused_l2_nn_partials_batched)

        val, idx, sums, wsum, inertia = fused_l2_nn_partials_batched(
            x, centroids, sample_weights)
    else:
        val, idx, sums, wsum, inertia = (
            plain.fused_l2_nn_partials_batched_plain(x, centroids,
                                                     sample_weights))
    return EMPartials(sums, wsum, inertia,
                      idx if return_labels else None,
                      val if return_labels else None)


def centers_from_array(centers, device=None) -> torch.Tensor:
    """k-means centres from a (k, d) numpy array (e.g. ones the JAX package
    trained) as a float32 tensor on *device* (``None``: the card)."""
    return torch.as_tensor(np.asarray(centers, np.float32),
                           device=resolve_device(device))


def centers_to_array(centers: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`centers_from_array`."""
    return centers.detach().cpu().numpy()
