"""Model-evaluation and clustering metrics (port of
``raft_tpu/stats/metrics.py``; reference raft/stats/{accuracy,r2_score,
regression_metrics,silhouette_score,trustworthiness_score,
adjusted_rand_index,rand_index,completeness_score,homogeneity_score,
v_measure,mutual_info_score,entropy,kl_divergence,contingency_matrix,
dispersion,information_criterion}.cuh).

Inputs are tensors, which stay where they are, or arrays, which go to
``device`` (``None``: the card).  Counts and the information-theoretic
sums are float64, as the JAX package's are under ``jax_enable_x64``.
The distance-based scores go through ``pairwise_distance``'s dispatch, so
on the card kernel B5 serves the metrics it accumulates (``engine`` as in
:func:`raft_tpu_torch.distance.pairwise_distance`).
"""

from __future__ import annotations

import enum
import math
from typing import Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import as_input, distance
from raft_tpu_torch.linalg.reduce import reduce_cols_by_key


# -- classification / regression ---------------------------------------------

def accuracy(predictions, ref_predictions, *, device=None) -> torch.Tensor:
    """Fraction of exact matches (reference stats/accuracy.cuh)."""
    p = as_input(predictions, device)
    r = as_input(ref_predictions, p.device)
    return torch.mean((p == r).to(torch.float32))


def r2_score(y, y_hat, *, device=None) -> torch.Tensor:
    """Coefficient of determination (reference stats/r2_score.cuh)."""
    y = as_input(y, device)
    y_hat = as_input(y_hat, y.device)
    ss_tot = torch.sum((y - torch.mean(y)) ** 2)
    ss_res = torch.sum((y - y_hat) ** 2)
    return 1.0 - ss_res / ss_tot


def regression_metrics(predictions, ref_predictions, *, device=None):
    """(mean absolute error, mean squared error, median absolute error)
    (reference stats/regression_metrics.cuh).  The median of an even
    count is the mean of the two middle values, as ``jnp.median``'s."""
    p = as_input(predictions, device)
    diff = p - as_input(ref_predictions, p.device)
    a = torch.abs(diff).reshape(-1)
    s = torch.sort(a).values
    n = s.shape[0]
    med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    return torch.mean(a), torch.mean(diff * diff), med


# -- contingency-table family ------------------------------------------------

def _labels(a, device) -> torch.Tensor:
    return as_input(a, device).to(torch.int64)


def contingency_matrix(y_true, y_pred, n_classes: Optional[int] = None, *,
                       device=None) -> torch.Tensor:
    """Dense contingency matrix (n_classes, n_classes), int32 (reference
    stats/contingency_matrix.cuh); *n_classes* defaults to the largest
    label + 1 (read to the host)."""
    t = _labels(y_true, device)
    p = _labels(y_pred, t.device)
    if n_classes is None:
        n_classes = int(torch.maximum(t.max(), p.max())) + 1
    counts = torch.bincount(t * n_classes + p,
                            minlength=n_classes * n_classes)
    return counts.reshape(n_classes, n_classes).to(torch.int32)


def _xlogx_ratio(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Σ p·(log p − log q) over p > 0 (0·log 0 := 0)."""
    ok = p > 0
    return torch.sum(torch.where(
        ok, p * (torch.log(torch.where(ok, p, 1.0))
                 - torch.log(torch.where(ok, q, 1.0))), 0.0))


def entropy(labels, n_classes: Optional[int] = None, *,
            device=None) -> torch.Tensor:
    """Shannon entropy (nats) of a label vector (reference
    stats/entropy.cuh)."""
    lab = _labels(labels, device)
    if n_classes is None:
        n_classes = int(lab.max()) + 1
    # exempt(dtype-drift): float64 class shares of an entropy
    p = torch.bincount(lab, minlength=n_classes).double() / lab.shape[0]
    return -_xlogx_ratio(p, torch.ones_like(p))


def mutual_info_score(y_true, y_pred, n_classes: Optional[int] = None, *,
                      device=None) -> torch.Tensor:
    """Mutual information (nats) of two labelings (reference
    stats/mutual_info_score.cuh)."""
    # exempt(dtype-drift): float64 contingency counts of mutual information
    cm = contingency_matrix(y_true, y_pred, n_classes,
                            device=device).double()
    pij = cm / torch.sum(cm)
    denom = torch.sum(pij, 1, keepdim=True) * torch.sum(pij, 0, keepdim=True)
    return _xlogx_ratio(pij, denom)


def homogeneity_score(y_true, y_pred, n_classes: Optional[int] = None, *,
                      device=None) -> torch.Tensor:
    """MI / H(true) (reference stats/homogeneity_score.cuh)."""
    h = entropy(y_true, n_classes, device=device)
    mi = mutual_info_score(y_true, y_pred, n_classes, device=device)
    return torch.where(h > 0, mi / torch.clamp_min(h, 1e-300), 1.0)


def completeness_score(y_true, y_pred, n_classes: Optional[int] = None, *,
                       device=None) -> torch.Tensor:
    """MI / H(pred) (reference stats/completeness_score.cuh)."""
    h = entropy(y_pred, n_classes, device=device)
    mi = mutual_info_score(y_true, y_pred, n_classes, device=device)
    return torch.where(h > 0, mi / torch.clamp_min(h, 1e-300), 1.0)


def v_measure(y_true, y_pred, n_classes: Optional[int] = None,
              beta: float = 1.0, *, device=None) -> torch.Tensor:
    """Weighted harmonic mean of homogeneity and completeness (reference
    stats/v_measure.cuh)."""
    h = homogeneity_score(y_true, y_pred, n_classes, device=device)
    c = completeness_score(y_true, y_pred, n_classes, device=device)
    denom = beta * h + c
    return torch.where(denom > 0,
                       (1 + beta) * h * c / torch.clamp_min(denom, 1e-300),
                       0.0)


def _pair_counts(y_true, y_pred, device):
    """(Σ_ij C(n_ij, 2), Σ_i C(a_i, 2), Σ_j C(b_j, 2), C(n, 2)) of the
    contingency table, float64."""
    # exempt(dtype-drift): pair counts exceed float32's exact integers
    cm = contingency_matrix(y_true, y_pred, device=device).double()

    def comb2(v):
        return v * (v - 1) / 2

    return (torch.sum(comb2(cm)), torch.sum(comb2(torch.sum(cm, 1))),
            torch.sum(comb2(torch.sum(cm, 0))), comb2(torch.sum(cm)))


def rand_index(y_true, y_pred, *, device=None) -> torch.Tensor:
    """Unadjusted Rand index (reference stats/rand_index.cuh)."""
    same, a, b, total = _pair_counts(y_true, y_pred, device)
    return (total + 2 * same - a - b) / total


def adjusted_rand_index(y_true, y_pred, *, device=None) -> torch.Tensor:
    """ARI (reference stats/adjusted_rand_index.cuh)."""
    same, a, b, total = _pair_counts(y_true, y_pred, device)
    expected = a * b / total
    denom = 0.5 * (a + b) - expected
    return torch.where(torch.abs(denom) > 1e-300,
                       (same - expected) / denom, 1.0)


def kl_divergence(p, q, *, device=None) -> torch.Tensor:
    """Σ p·log(p/q) over p > 0 (reference stats/kl_divergence.cuh)."""
    p = as_input(p, device)
    q = as_input(q, p.device)
    ok = p > 0
    return torch.sum(torch.where(
        ok, p * (torch.log(torch.where(ok, p, 1.0))
                 - torch.log(torch.where(q > 0, q, 1.0))), 0.0))


# -- embedding-quality metrics -----------------------------------------------

def _silhouette_rows(d, lb, labels, counts, n_clusters: int):
    """s(i) of the rows whose distances to every sample are *d* (rows,
    n): a(i) the mean distance to the rest of its cluster, b(i) the least
    mean distance to another non-empty cluster, s = (b − a)/max(a, b), 0
    for a singleton."""
    sums = reduce_cols_by_key(d, labels, n_clusters)       # (rows, k)
    own_count = counts[lb]
    a = torch.where(own_count > 1,
                    torch.gather(sums, 1, lb[:, None])[:, 0]
                    / torch.clamp_min(own_count - 1, 1.0), 0.0)
    mean_other = sums / torch.clamp_min(counts[None, :], 1.0)
    own = torch.arange(n_clusters, device=d.device)[None, :] == lb[:, None]
    mean_other = torch.where(own | (counts[None, :] == 0),
                             float("inf"), mean_other)
    b = torch.min(mean_other, dim=1).values
    return torch.where(own_count > 1,
                       (b - a) / torch.clamp_min(torch.maximum(a, b),
                                                 1e-300), 0.0)


def silhouette_score(x, labels, n_clusters: Optional[int] = None,
                     metric: DistanceType = DistanceType.L2Expanded,
                     return_samples: bool = False, *, device=None,
                     engine: Optional[str] = None):
    """Mean silhouette coefficient (reference
    stats/silhouette_score.cuh:46) from one (n, n) distance matrix and its
    columns summed by label."""
    return silhouette_score_batched(x, labels, n_clusters, metric,
                                    batch_size=1 << 62,
                                    return_samples=return_samples,
                                    device=device, engine=engine)


def silhouette_score_batched(x, labels, n_clusters: Optional[int] = None,
                             metric: DistanceType = DistanceType.L2Expanded,
                             batch_size: int = 4096,
                             return_samples: bool = False, *, device=None,
                             engine: Optional[str] = None):
    """Batched silhouette (reference stats/silhouette_score.cuh:62): rows
    in chunks of *batch_size*, so only (batch_size, n) distances are
    live."""
    x = as_input(x, device)
    lab = _labels(labels, x.device)
    if n_clusters is None:
        n_clusters = int(lab.max()) + 1
    counts = torch.bincount(lab, minlength=n_clusters).to(
        torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
        else x.dtype)
    samples = []
    for r in range(0, x.shape[0], batch_size):
        d = distance(x[r:r + batch_size], x, metric, engine=engine)
        samples.append(_silhouette_rows(d, lab[r:r + batch_size], lab,
                                        counts.to(d.dtype), n_clusters))
    s = torch.cat(samples)
    return (torch.mean(s), s) if return_samples else torch.mean(s)


def trustworthiness_score(x, x_embedded, n_neighbors: int = 5,
                          metric: DistanceType = DistanceType.L2SqrtExpanded,
                          *, device=None, engine: Optional[str] = None):
    """Trustworthiness of a low-dimensional embedding (reference
    stats/trustworthiness_score.cuh): full distance ranks in the original
    space, the *n_neighbors* nearest in the embedding (ties to the lower
    index)."""
    x = as_input(x, device)
    xe = as_input(x_embedded, x.device)
    n = x.shape[0]
    expects(n_neighbors < n // 2, "n_neighbors must be < n/2")
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d_orig = distance(x, x, metric, engine=engine).masked_fill(eye,
                                                               float("inf"))
    d_emb = distance(xe, xe, metric, engine=engine).masked_fill(
        eye, float("inf"))
    order = torch.argsort(d_orig, dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=x.device).expand(n, n).contiguous())
    emb_nn = torch.sort(d_emb, dim=1, stable=True).indices[:, :n_neighbors]
    r = torch.gather(ranks, 1, emb_nn)
    # exempt(dtype-drift): float64 trustworthiness penalty sum
    penalty = torch.clamp_min(r - n_neighbors + 1, 0).double()
    return 1.0 - (2.0 / (n * n_neighbors * (2 * n - 3 * n_neighbors - 1))
                  ) * torch.sum(penalty)


# -- cluster dispersion / information criterion ------------------------------

def dispersion(centroids, cluster_sizes, global_centroid=None,
               n_points: Optional[int] = None, *, device=None):
    """√(Σᵢ sizeᵢ·‖cᵢ − μ‖²) (reference stats/detail/dispersion.cuh:31-32),
    μ the size-weighted mean of the centroids unless given."""
    c = as_input(centroids, device)
    sizes = as_input(cluster_sizes, c.device).to(c.dtype)
    if n_points is None:
        n_points = torch.sum(sizes)
    if global_centroid is None:
        global_centroid = torch.sum(c * sizes[:, None], 0) / n_points
    else:
        global_centroid = as_input(global_centroid, c.device)
    diff = c - global_centroid[None, :]
    return torch.sqrt(torch.sum(diff * diff * sizes[:, None]))


class IC_Type(enum.Enum):
    """reference stats/stats_types.hpp:60 ``IC_Type``."""

    AIC = "aic"
    AICc = "aicc"
    BIC = "bic"


def information_criterion_batched(loglikelihood, ic_type: IC_Type,
                                  n_params: int, n_samples: int, *,
                                  device=None):
    """AIC / AICc / BIC per batch element (reference
    stats/detail/batched/information_criterion.cuh:44-69): the criterion's
    base − 2·loglikelihood."""
    ll = as_input(loglikelihood, device)
    n = float(n_params)
    t = float(n_samples)
    if ic_type == IC_Type.AIC:
        base = 2.0 * n
    elif ic_type == IC_Type.AICc:
        base = 2.0 * (n + (n * (n + 1.0)) / (t - n - 1.0))
    else:
        base = math.log(t) * n
    return base - 2.0 * ll
