"""K-means clustering (port of ``raft_tpu/cluster/kmeans.py``; reference
raft/cluster/kmeans.cuh:85-1046, cluster/detail/kmeans.cuh and
kmeans_common.cuh): the E-step (:func:`min_cluster_and_distance`), the
fused EM step (:func:`fused_em_step`), k-means‖ and random init, and the
public ``fit`` / ``predict`` / ``fit_predict`` / ``transform`` / ``KMeans``.
:func:`fused_em_step_batched` adds the batch dimension of the JAX package's
``jax.vmap`` of its Lloyd step over PQ subspaces.

``engine`` picks the kernels.  ``"cuda"`` (the default on a CUDA device)
runs kernel B1 for the E-step and kernel B3 for the fused EM step under the
L2 family, and ``pairwise_distance``'s dispatch for every other metric:
kernel B5 for the metrics it accumulates (L1, the unexpanded L2 forms,
Linf, Canberra, Lp, Hamming) and the product epilogues for the rest.
``"torch"`` runs the plain versions.  The JAX package's env default
(``RAFT_TPU_PALLAS_NN``) has no counterpart: the engine is an argument.

No step reads a tensor back to the host except where a docstring says so:
the ``"while"`` fit loop reads δ² once per iteration (as RAFT itself reads
the inertia, reference kmeans.cuh:470-505), and ``n_init`` > 1 compares
each trial's inertia.  The k-means‖ rounds and the weighted k-means++
finish draw their uniforms from the CPU once and pick every index on the
device.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.analysis.registry import audit_program
from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import auto_sync_handle, resolve_device
from raft_tpu_torch.core.kvp import KeyValuePair
from raft_tpu_torch.distance.fused_l2_nn import (
    cluster_partials_plain,
    fused_l2_nn,
    fused_l2_nn_partials_batched_plain,
    fused_l2_nn_partials_plain,
)
from raft_tpu_torch.distance.distance_types import DistanceType, L2_METRICS
from raft_tpu_torch.distance.pairwise import (_HALF_DTYPES, _dispatch,
                                              accum_dtype, as_input,
                                              distance)
from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.random.rng import (RngState, generator_of, gumbel_top_k,
                                       inverse_cdf,
                                       sample_without_replacement)

__all__ = ["EMPartials", "KMeans", "KMeansOutput", "KeyValuePair",
           "centroids_from_sums", "cluster_cost", "fit", "fit_predict",
           "fused_em_enabled", "fused_em_step", "init_plus_plus",
           "init_random", "kmeans_plus_plus", "min_cluster_and_distance",
           "pack_em_partials", "predict", "sample_centroids",
           "shuffle_and_gather", "transform", "unpack_em_partials",
           "update_centroids"]


class EMPartials(NamedTuple):
    """One EM iteration's accumulators: the k·d + k + 1 numbers the M-step
    and the convergence test need (``raft_tpu.cluster.kmeans.EMPartials``)."""

    sums: torch.Tensor       # (k, d) Σ w·x per cluster
    weights: torch.Tensor    # (k,)   Σ w per cluster
    inertia: torch.Tensor    # ()     Σ w·min_dist
    labels: Optional[torch.Tensor] = None
    distances: Optional[torch.Tensor] = None


def pack_em_partials(p: EMPartials) -> torch.Tensor:
    """(sums, weights, inertia) as one (k·d + k + 1,) vector — the
    multi-GPU wire format: one allreduce per EM iteration."""
    return torch.cat([p.sums.reshape(-1), p.weights, p.inertia.reshape(1)])


def unpack_em_partials(packed: torch.Tensor, n_clusters: int,
                       dim: int) -> EMPartials:
    """Inverse of :func:`pack_em_partials`."""
    kd = n_clusters * dim
    return EMPartials(sums=packed[:kd].reshape(n_clusters, dim),
                      weights=packed[kd:kd + n_clusters],
                      inertia=packed[kd + n_clusters])


def fused_em_enabled() -> bool:
    """The ``RAFT_TPU_FUSED_EM`` gate, read at every call (default on):
    ``RAFT_TPU_FUSED_EM=0`` makes ``fit`` take the two-pass EM iteration
    (E-step labels, then the M-step over x again)."""
    return os.environ.get("RAFT_TPU_FUSED_EM", "1") != "0"


def _engine(x: torch.Tensor, engine: Optional[str]) -> str:
    return resolve_engine("l2nn", x.device, engine=engine)


def _nn_blocks(x, centroids, metric: DistanceType, batch_samples: int,
               engine: str):
    """(val, idx) of the nearest centroid under a metric outside the L2
    family: ``pairwise_distance``'s dispatch over row blocks of
    *batch_samples* (which bound the (rows, k) distance block), the argmin
    and its value per block (ties to the lower index)."""
    pe = "torch" if engine == "torch" else None
    vals, idxs = [], []
    for r in range(0, x.shape[0], batch_samples):
        d = _dispatch(x[r:r + batch_samples], centroids, metric, 2.0, pe)
        v, i = torch.min(d, dim=1)
        vals.append(v)
        idxs.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def min_cluster_and_distance(x: torch.Tensor, centroids: torch.Tensor,
                             metric: DistanceType = DistanceType.L2Expanded,
                             batch_samples: int = 2048,
                             batch_centroids: int = 1024,
                             precision: str = "high",
                             engine: Optional[str] = None) -> KeyValuePair:
    """Nearest centroid (index int32, distance) per sample — the E-step
    (reference kmeans_common.cuh:341).

    Distances are *squared* L2 for the whole L2 family (L2SqrtExpanded
    too: k-means runs on squared distances), through kernel B1 on the card;
    ``precision="default"`` rounds the products' operands to bfloat16
    (B1's ``bf16_dot``), any other value keeps float32.  B1 tiles the
    centroids itself, so *batch_centroids* is accepted for the reference's
    signature only.  Every other metric runs in row blocks of
    *batch_samples* (see the module doc for its kernels).  Values come
    back in the accumulation type (float32 for half inputs)."""
    eng = _engine(x, engine)
    if metric in L2_METRICS:
        idx, val = fused_l2_nn(x, centroids, precision=precision,
                               engine=eng)
    else:
        val, idx = _nn_blocks(x, centroids, metric, batch_samples, eng)
    return KeyValuePair(key=idx, value=val.to(accum_dtype(x.dtype)))


def centroids_from_sums(sums: torch.Tensor, wsum: torch.Tensor,
                        old_centroids: Optional[torch.Tensor],
                        dtype: torch.dtype) -> torch.Tensor:
    """Weighted means, sums (..., k, d) over wsum (..., k), stored in
    *dtype*; an empty cluster keeps its previous centroid."""
    new = (sums / torch.clamp_min(wsum, 1e-30)[..., None]).to(dtype)
    if old_centroids is not None:
        new = torch.where(wsum[..., None] > 0, new, old_centroids)
    return new


def update_centroids(x: torch.Tensor, labels: torch.Tensor, n_clusters: int,
                     sample_weights: Optional[torch.Tensor] = None,
                     old_centroids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-step: (new centroids, weight per cluster)."""
    sums, wsum = cluster_partials_plain(x, labels, n_clusters,
                                        sample_weights)
    return centroids_from_sums(sums, wsum, old_centroids, x.dtype), wsum


@audit_program(
    "cluster.fused_em_step", transient_bytes=12 << 20,
    notes="one EM iteration's E-step argmin and M-step partials (B3 on "
          "the card) — x read once an iteration")
def fused_em_step(x: torch.Tensor, centroids: torch.Tensor,
                  sample_weights: Optional[torch.Tensor] = None,
                  metric: DistanceType = DistanceType.L2Expanded,
                  batch_samples: int = 2048, batch_centroids: int = 1024,
                  precision: str = "high", engine: Optional[str] = None,
                  return_labels: bool = False) -> EMPartials:
    """One EM iteration's accumulators from one E-step: the nearest centre
    of every row and the M-step partials keyed by it.  The L2 family runs
    kernel B3 on the card (E-step and partials); every other metric runs
    :func:`min_cluster_and_distance`'s row blocks and then the plain
    partials keyed by the labels.  Knobs as in
    :func:`min_cluster_and_distance`."""
    eng = _engine(x, engine)
    k = centroids.shape[0]
    if metric in L2_METRICS:
        bf16 = precision == "default"
        if eng == "cuda":
            from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn_partials

            val, idx, sums, wsum, inertia = fused_l2_nn_partials(
                x, centroids, sample_weights, bf16)
        else:
            val, idx, sums, wsum, inertia = fused_l2_nn_partials_plain(
                x, centroids, sample_weights, bf16)
    else:
        val, idx = _nn_blocks(x, centroids, metric, batch_samples, eng)
        val = val.to(accum_dtype(x.dtype))
        sums, wsum = cluster_partials_plain(x, idx, k, sample_weights)
        inertia = (torch.sum(val) if sample_weights is None
                   else torch.sum(val * sample_weights.to(val.dtype)))
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
    field of the result gains the leading S.  L2 family only.  On the card
    narrow rows (the PQ codebooks) run as one launch of kernel B3 for all
    S."""
    expects(metric in L2_METRICS,
            f"fused_em_step_batched: only the L2 family, got {metric}")
    if _engine(x, engine) == "cuda":
        from raft_tpu_torch.kernels.fused_l2nn import (
            fused_l2_nn_partials_batched)

        val, idx, sums, wsum, inertia = fused_l2_nn_partials_batched(
            x, centroids, sample_weights)
    else:
        val, idx, sums, wsum, inertia = (
            fused_l2_nn_partials_batched_plain(x, centroids,
                                               sample_weights))
    return EMPartials(sums, wsum, inertia,
                      idx if return_labels else None,
                      val if return_labels else None)


def cluster_cost(min_distances, sample_weights=None) -> torch.Tensor:
    """Total inertia (reference cluster/kmeans.cuh ``cluster_cost``)."""
    v = (min_distances.value if isinstance(min_distances, KeyValuePair)
         else min_distances)
    if sample_weights is not None:
        v = v * sample_weights
    return torch.sum(v)


def sample_centroids(rng, x: torch.Tensor, min_distances,
                     n_to_sample: int) -> torch.Tensor:
    """Rows drawn without replacement ∝ min-distance (reference
    kmeans_common.cuh:213 ``sampleCentroids``)."""
    d = (min_distances.value if isinstance(min_distances, KeyValuePair)
         else min_distances)
    return sample_without_replacement(rng, x, n_to_sample, weights=d)


def shuffle_and_gather(rng, x: torch.Tensor,
                       n_samples_to_gather: int) -> torch.Tensor:
    """A uniformly random row subset (reference kmeans_common.cuh:307
    ``shuffleAndGather``)."""
    return sample_without_replacement(rng, x, n_samples_to_gather)


# ---------------------------------------------------------------------------
# init (reference cluster/detail/kmeans.cuh initRandom / initKMeansPlusPlus)
# ---------------------------------------------------------------------------

def init_random(rng, x: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Random distinct rows (reference ``initRandom``,
    detail/kmeans.cuh:60)."""
    return shuffle_and_gather(rng, x, n_clusters)


def local_trials(n_clusters: int) -> int:
    """Draws per step of the k-means++ finish: RAFT's and scikit-learn's
    greedy k-means++ rule, 2 + ⌊ln k⌋ (the JAX package draws 1)."""
    return 2 + int(math.log(max(n_clusters, 1)))


def _weighted_kmeans_pp(u: torch.Tensor, candidates: torch.Tensor,
                        weights: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy weighted k-means++ over the candidates — the finish of
    k-means‖.  The first centre is drawn ∝ the weights alone; each next
    step draws ``u.shape[1]`` candidates ∝ weight × squared distance to
    the nearest chosen centre and keeps the one that leaves the least
    weighted potential (reference detail/kmeans.cuh ``kmeansPlusPlus``'s
    local trials; one trial is the JAX package's plain weighted
    k-means++).  Every index comes from the inverse CDF of the device
    uniforms *u* (k, trials): no step reads anything back to the host.
    Zero-weight slots are never drawn while a positive one remains."""
    # exempt(dtype-drift): float64 draw weights keep the CDF exact over n rows
    w = torch.clamp_min(weights.double(), 0.0)
    cf = candidates.float()
    chosen = candidates.new_empty((k, candidates.shape[1]))
    idx = inverse_cdf(w, u[0, :1])
    chosen[0:1] = candidates.index_select(0, idx)
    min_d = torch.sum((cf - cf.index_select(0, idx)) ** 2, dim=1)
    for i in range(1, k):
        idx = inverse_cdf(w * min_d, u[i])                       # (T,)
        d = torch.sum((cf[None] - cf.index_select(0, idx)[:, None]) ** 2,
                      dim=2)                                     # (T, nc)
        d = torch.minimum(d, min_d[None])
        best = torch.argmin(torch.sum(w * d, dim=1)).reshape(1)
        chosen[i:i + 1] = candidates.index_select(0, idx[best])
        min_d = d.index_select(0, best)[0]
    return chosen


def init_plus_plus(rng, x: torch.Tensor, n_clusters: int,
                   oversampling_factor: float = 2.0, n_rounds: int = 5,
                   metric: DistanceType = DistanceType.L2Expanded, *,
                   engine: Optional[str] = None) -> torch.Tensor:
    """Scalable k-means‖ init (reference ``initKMeansPlusPlus``; Bahmani
    et al.): one uniformly random centre; ``n_rounds`` rounds that each
    draw l = oversampling_factor·k rows ∝ d²(x, C) into a fixed buffer of
    ``1 + n_rounds·l`` rows (unfilled slots hold copies of the first
    centre, which own nothing: argmin ties go to the lowest slot); then
    each candidate weighted by the rows it owns, and a greedy weighted
    k-means++ over the candidates.  Every uniform comes from the CPU in one
    draw and moves to the device once.

    Two departures from the JAX package's ``init_plus_plus``, both part
    of this function's contract (the greedy finish is a decision, not a
    gap: ROADMAP §C), so its results match that function's by quality,
    not by distribution:

    - the finish draws :func:`local_trials` candidates a step and keeps
      the one that lowers the weighted potential most (RAFT's and
      scikit-learn's rule), where the JAX package takes one draw a step.
      One draw leaves a few percent of well-separated blobs sharing a
      centre; the greedy finish's inertia is no worse than the JAX
      package's over seeds, and with one trial a step the two agree by
      distribution (``tests/test_torch_random.py``).  It costs
      ``local_trials(k)`` times the finish's distance work a step;
    - a round's l rows are the l largest Gumbel keys (CPU uniforms +
      log d² on the device): a draw without replacement, where the JAX
      package draws l categorical samples with replacement (a repeated
      row would own nothing either way)."""
    n, dim = x.shape
    dev = x.device
    l = max(1, int(oversampling_factor * n_clusters))
    take = min(l, n)
    gen = generator_of(rng)
    first = int(torch.randint(n, (1,), generator=gen))
    u_rounds = torch.rand((n_rounds, n), generator=gen,
                          # exempt(dtype-drift): float64 uniforms, compared against the float64 CDF
                          dtype=torch.float64).to(dev)
    u_pp = torch.rand((n_clusters, local_trials(n_clusters)), generator=gen,
                      # exempt(dtype-drift): float64 uniforms, compared against the float64 CDF
                      dtype=torch.float64).to(dev)
    cap = 1 + n_rounds * l
    candidates = x[first:first + 1].expand(cap, dim).clone()
    for r in range(n_rounds):
        nn = min_cluster_and_distance(x, candidates, metric, engine=engine)
        idx = gumbel_top_k(u_rounds[r], take, nn.value)
        candidates[1 + r * l:1 + r * l + take] = x[idx]
    nn = min_cluster_and_distance(x, candidates, metric, engine=engine)
    # ownership counts in the accumulation type (bfloat16 stops counting
    # at 256); sums of ones are exact in any order, and unlike bincount
    # the add reads nothing back to size its output
    acc = accum_dtype(x.dtype)
    # exempt(raw-segment-sum): cluster sizes, a histogram of labels
    counts = torch.zeros(cap, dtype=acc, device=dev).index_add_(
        0, nn.key.long(), torch.ones(n, dtype=acc, device=dev))
    return _weighted_kmeans_pp(u_pp, candidates, counts, n_clusters)


kmeans_plus_plus = init_plus_plus  # reference kmeans.cuh ``kmeans_plus_plus``


# ---------------------------------------------------------------------------
# fit / predict (reference cluster/detail/kmeans.cuh kmeans_fit_main :362)
# ---------------------------------------------------------------------------

class KMeansOutput(NamedTuple):
    centroids: torch.Tensor
    inertia: torch.Tensor
    n_iter: torch.Tensor
    labels: Optional[torch.Tensor] = None


def _em_body(x, centroids, weights, metric, batch_samples, batch_centroids,
             fused: bool, engine: str):
    """One EM iteration → (new centroids, inertia, δ²).  *x* may be the
    float32 copy of half data; the centroids keep their own type, and δ²
    sums in float32 or wider."""
    k = centroids.shape[0]
    if fused:
        p = fused_em_step(x, centroids, weights, metric, batch_samples,
                          batch_centroids, engine=engine)
        sums, wsum, inertia = p.sums, p.weights, p.inertia
    else:
        nn = min_cluster_and_distance(x, centroids, metric, batch_samples,
                                      batch_centroids, engine=engine)
        sums, wsum = cluster_partials_plain(x, nn.key, k, weights)
        inertia = cluster_cost(nn, weights)
    new = centroids_from_sums(sums, wsum, centroids, centroids.dtype)
    acc = accum_dtype(centroids.dtype)
    delta = torch.sum((new.to(acc) - centroids.to(acc)) ** 2)
    return new, inertia, delta


def _fit_main(x, c, weights, metric, max_iter: int, tol: float,
              batch_samples: int, batch_centroids: int, fused: bool,
              engine: str, loop: str):
    """EM to convergence, then one E-step for the converged inertia
    (reference :661).  ``loop="while"`` reads δ² to the host once per
    iteration and stops at the first δ² ≤ tol²; ``loop="fori"`` runs
    *max_iter* iterations with no read, the updates after that point
    masked out, and counts the same ``n_iter``."""
    thresh = tol * tol
    if loop == "while":
        n_iter = 0
        for _ in range(max_iter):
            c, _, delta = _em_body(x, c, weights, metric, batch_samples,
                                   batch_centroids, fused, engine)
            n_iter += 1
            if not float(delta) > thresh:
                break
        n_iter = torch.tensor(n_iter, device=x.device)
    else:
        live = torch.ones((), dtype=torch.bool, device=x.device)
        n_iter = torch.zeros((), dtype=torch.int64, device=x.device)
        for _ in range(max_iter):
            new, _, delta = _em_body(x, c, weights, metric, batch_samples,
                                     batch_centroids, fused, engine)
            c = torch.where(live, new, c)
            n_iter = n_iter + live
            live = live & (delta > thresh)
    nn = min_cluster_and_distance(x, c, metric, batch_samples,
                                  batch_centroids, engine=engine)
    return c, cluster_cost(nn, weights), n_iter


def _resolve_batches(params: KMeansParams):
    bc = params.batch_centroids if params.batch_centroids > 0 else max(
        1024, params.n_clusters)
    return params.batch_samples, bc


def _weights(sample_weights, x: torch.Tensor, normalize: bool):
    """Sample weights on x's device in the accumulation type, scaled to sum
    to n_samples when *normalize* (reference detail/kmeans.cuh fit)."""
    if sample_weights is None:
        return None
    w = as_input(sample_weights, x.device).to(x.device,
                                              accum_dtype(x.dtype))
    return w * (x.shape[0] / torch.sum(w)) if normalize else w


@auto_sync_handle
def fit(params: KMeansParams, x, sample_weights=None, centroids=None,
        handle=None, loop: str = "while", fused: Optional[bool] = None, *,
        device=None, engine: Optional[str] = None) -> KMeansOutput:
    """Full k-means fit (reference cluster/kmeans.cuh:85 ``fit``): init
    (k-means‖, random rows or ``InitMethod.Array``'s *centroids*), EM to
    ``tol``, the best inertia of ``n_init`` trials (an array init is one
    trial: the others would repeat it).

    *x*: a tensor stays where it is; an array goes to *device* (``None``:
    the card, raising without one) or the *handle*'s.  *handle*: a
    :class:`~raft_tpu_torch.core.Handle` whose stream takes the work (sync
    it before reading the outputs elsewhere; ``auto_sync_handle``).
    *loop*: ``"while"`` or ``"fori"`` (see :func:`_fit_main`).  *fused*: one E-step per iteration
    with the M-step partials (:func:`fused_em_step`); ``None`` reads
    :func:`fused_em_enabled`.  *engine*: see the module doc.  Sample
    weights are scaled to sum to n_samples.  Half data is widened to
    float32 once per fit for the E-steps; the centroids keep the data's
    type."""
    expects(loop in ("while", "fori"), f"unknown loop mode {loop!r}")
    x = as_input(x, handle.device if handle is not None else device)
    expects(x.ndim == 2, "x must be [n_samples, n_features]")
    expects(params.n_clusters <= x.shape[0],
            "n_clusters must be <= n_samples")
    if fused is None:
        fused = fused_em_enabled()
    eng = _engine(x, engine)
    xe = x.float() if x.dtype in _HALF_DTYPES else x
    weights = _weights(sample_weights, x, True)
    bs, bc = _resolve_batches(params)
    rng = RngState(params.seed)
    best: Optional[KMeansOutput] = None
    n_trials = (1 if params.init == InitMethod.Array
                else max(1, params.n_init))
    for _ in range(n_trials):
        if params.init == InitMethod.Array:
            expects(centroids is not None,
                    "init=Array requires centroids")
            c0 = as_input(centroids, x.device).to(x.device, x.dtype)
        elif params.init == InitMethod.Random:
            c0 = init_random(rng, x, params.n_clusters)
        else:
            c0 = init_plus_plus(rng, xe, params.n_clusters,
                                params.oversampling_factor,
                                metric=params.metric,
                                engine=eng).to(x.dtype)
        c, inertia, n_iter = _fit_main(xe, c0, weights, params.metric,
                                       params.max_iter, params.tol, bs,
                                       bc, fused, eng, loop)
        if best is None or float(inertia) < float(best.inertia):
            best = KMeansOutput(c, inertia, n_iter)
    return best


@auto_sync_handle
def predict(params: KMeansParams, x, centroids, sample_weights=None,
            normalize_weight: bool = True, handle=None, *, device=None,
            engine: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels int32, inertia) for fixed centroids (reference kmeans.cuh
    ``predict``); *normalize_weight* scales the sample weights to sum to
    n_samples first, as ``fit`` does.  Inputs, handle and engine as in
    :func:`fit`."""
    x = as_input(x, handle.device if handle is not None else device)
    c = as_input(centroids, x.device).to(x.device)
    w = _weights(sample_weights, x, normalize_weight)
    bs, bc = _resolve_batches(params)
    nn = min_cluster_and_distance(x, c, params.metric, bs, bc,
                                  engine=engine)
    return nn.key, cluster_cost(nn, w)


@auto_sync_handle
def fit_predict(params: KMeansParams, x, sample_weights=None,
                centroids=None, handle=None, *, device=None,
                engine: Optional[str] = None) -> KMeansOutput:
    """:func:`fit`, then the labels of *x* under the fitted centroids
    (reference kmeans.cuh ``fit_predict``)."""
    x = as_input(x, handle.device if handle is not None else device)
    out = fit(params, x, sample_weights, centroids, handle=handle,
              engine=engine)
    labels, _ = predict(params, x, out.centroids, sample_weights,
                        handle=handle, engine=engine)
    return out._replace(labels=labels)


def transform(params: KMeansParams, x, centroids, *, device=None,
              engine: Optional[str] = None) -> torch.Tensor:
    """Distances from every row to every centroid under ``params.metric``
    (reference kmeans.cuh ``transform``), through ``pairwise_distance``'s
    dispatch (B5 on the card for the metrics it accumulates)."""
    x = as_input(x, device)
    c = as_input(centroids, x.device).to(x.device, x.dtype)
    pe = "torch" if _engine(x, engine) == "torch" else None
    return distance(x, c, params.metric, 2.0, pe)


class KMeans:
    """Estimator-style wrapper over the functional API; *device* and
    *engine* go to every call, every other keyword to
    :class:`KMeansParams`."""

    def __init__(self, n_clusters: int = 8, *, device=None,
                 engine: Optional[str] = None, **kwargs):
        self.params = KMeansParams(n_clusters=n_clusters, **kwargs)
        self._kw = dict(device=device, engine=engine)
        self.cluster_centers_ = None
        self.inertia_ = None
        self.n_iter_ = None
        self.labels_ = None

    def fit(self, x, sample_weights=None) -> "KMeans":
        out = fit_predict(self.params, x, sample_weights, **self._kw)
        self.cluster_centers_ = out.centroids
        self.inertia_ = float(out.inertia)
        self.n_iter_ = int(out.n_iter)
        self.labels_ = out.labels
        return self

    def predict(self, x) -> torch.Tensor:
        labels, _ = predict(self.params, x, self.cluster_centers_,
                            **self._kw)
        return labels

    def transform(self, x) -> torch.Tensor:
        return transform(self.params, x, self.cluster_centers_, **self._kw)


def centers_from_array(centers, device=None) -> torch.Tensor:
    """k-means centres from a (k, d) numpy array (e.g. ones the JAX package
    trained) as a float32 tensor on *device* (``None``: the card)."""
    return torch.as_tensor(np.asarray(centers, np.float32),
                           device=resolve_device(device))


def centers_to_array(centers: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`centers_from_array`."""
    return centers.detach().cpu().numpy()
