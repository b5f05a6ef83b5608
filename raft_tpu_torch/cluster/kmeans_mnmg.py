"""Multi-GPU (OPG data-parallel) k-means (port of
``raft_tpu/cluster/kmeans_mnmg.py``).

The reference's distributed model (SURVEY.md §2.13): each worker holds a
block of rows, runs the local E-step, and allreduces per-cluster sums and
counts before the M-step — driven by cuML through raft-dask, with the
building block exposed as ``pylibraft.cluster.kmeans.compute_new_centroids``
(reference python/pylibraft/pylibraft/cluster/kmeans.pyx:71).

Here every rank is a process: it takes its contiguous row block of the
global ``x``, runs the fused E+M step on it (:func:`kmeans.fused_em_step`,
kernel B3 on the card), then ONE SUM allreduce of the packed (k·d + k + 1)
partials (:func:`kmeans.pack_em_partials`), and the same M-step on every
rank; the trailing E-step and ``predict`` run kernel B1.  ``fused=False``
(or ``RAFT_TPU_FUSED_EM=0``) takes the two-pass iteration with three
allreduces (sums, counts, inertia).

``Comms.collective_calls`` counts per call, where the JAX package counts
per trace: a fit issues one allreduce per EM step it runs (``loop="fori"``
runs ``max_iter``) and one for the final inertia.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster import kmeans as _km
from raft_tpu_torch.cluster.kmeans import KMeansOutput
from raft_tpu_torch.cluster.kmeans_types import KMeansParams
from raft_tpu_torch.comms.comms import Comms, as_comms
from raft_tpu_torch.comms.comms_types import ReduceOp
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import (_HALF_DTYPES, accum_dtype,
                                              as_input)
from raft_tpu_torch.distance.fused_l2_nn import cluster_partials_plain
from raft_tpu_torch.random.rng import RngState


def compute_new_centroids(x_shard: torch.Tensor, centroids: torch.Tensor,
                          comms, sample_weights=None,
                          metric=DistanceType.L2Expanded,
                          batch_samples: int = 2048,
                          batch_centroids: int = 1024,
                          fused: Optional[bool] = None,
                          engine: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One distributed E+M step on this rank's rows — the MNMG-composable
    building block (pylibraft ``compute_new_centroids``).  Every rank of
    *comms* (a Comms or a Handle carrying one) calls it with its own rows
    and the same centroids.  Returns (new_centroids, weight_per_cluster,
    global_inertia_sum), the same on every rank.

    *fused* (None → :func:`kmeans.fused_em_enabled`): the shard's partials
    from :func:`kmeans.fused_em_step` and ONE allreduce of the packed
    carry; False: the E-step, the M-step partials over the rows again and
    three allreduces.  *engine* as in :func:`kmeans.min_cluster_and_distance`.
    """
    comms = as_comms(comms)
    k = centroids.shape[0]
    if fused is None:
        fused = _km.fused_em_enabled()
    if fused:
        p = _km.fused_em_step(x_shard, centroids, sample_weights, metric,
                              batch_samples, batch_centroids, engine=engine)
        packed = comms.allreduce(_km.pack_em_partials(p), ReduceOp.SUM)
        sums, wsum, inertia = _km.unpack_em_partials(packed, k,
                                                     x_shard.shape[1])[:3]
    else:
        nn = _km.min_cluster_and_distance(x_shard, centroids, metric,
                                          batch_samples, batch_centroids,
                                          engine=engine)
        sums, wsum = cluster_partials_plain(x_shard, nn.key, k,
                                            sample_weights)
        inertia = _km.cluster_cost(nn.value, sample_weights)
        # the OPG allreduce (reference: comms.allreduce on per-cluster sums)
        sums = comms.allreduce(sums, ReduceOp.SUM)
        wsum = comms.allreduce(wsum, ReduceOp.SUM)
        inertia = comms.allreduce(inertia, ReduceOp.SUM)
    new = _km.centroids_from_sums(sums, wsum, centroids, centroids.dtype)
    return new, wsum, inertia


def _row_block(comms: Comms, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of the global rows (OPG: equal
    parts)."""
    nranks = comms.get_size()
    n = x.shape[0]
    expects(n % nranks == 0,
            f"n ({n}) must be divisible by the number of ranks ({nranks}) — "
            "pad or trim the shard (reference OPG assumes equal parts)")
    per = n // nranks
    r = comms.get_rank()
    return x[r * per:(r + 1) * per]


def _step(xs, c, comms, metric, bs, bc, fused, engine):
    """One distributed EM step → (new centroids, δ² = ‖new − c‖²)."""
    new, _, _ = compute_new_centroids(xs, c, comms, metric=metric,
                                      batch_samples=bs, batch_centroids=bc,
                                      fused=fused, engine=engine)
    acc = accum_dtype(c.dtype)
    return new, torch.sum((new.to(acc) - c.to(acc)) ** 2)


def _inertia(comms: Comms, xs, c, metric, bs, bc, engine):
    """(labels of this rank's rows, global inertia) under *c*."""
    nn = _km.min_cluster_and_distance(xs, c, metric, bs, bc, engine=engine)
    return nn.key, comms.allreduce(_km.cluster_cost(nn.value), ReduceOp.SUM)


def fit(params: KMeansParams, comms, x, centroids=None,
        loop: str = "device", sync_every: int = 8,
        fused: Optional[bool] = None, *, device=None,
        engine: Optional[str] = None) -> KMeansOutput:
    """Distributed k-means fit; every rank calls it with the global *x*
    [n, dim] and works on its own contiguous row block (n must divide
    evenly).  *comms* may be a Comms or a Handle carrying one.  Init: the
    *centroids* array, or k-means‖ on the global rows (every rank draws
    the same).  *x*: a tensor stays where it is; an array goes to
    *device* (None: the card, raising without one).

    loop:
      - ``"device"``: δ² read once per iteration, stop at the first
        δ² ≤ tol² (the single-device ``loop="while"``).
      - ``"fori"``: ``max_iter`` steps, the updates after convergence
        masked out, no read (the single-device ``loop="fori"``).
      - ``"host"``: δ² read every *sync_every* iterations (never when
        tol == 0), so a fit may run up to ``sync_every − 1`` steps past
        convergence — the reference's own host-driven MNMG shape.

    All three end with the E-step under the returned centroids and one
    allreduce of its inertia.  At world 1 the fit is the single-device
    ``kmeans.fit`` with ``InitMethod.Array`` (loop ``"while"``), bit for
    bit."""
    comms = as_comms(comms)
    expects(loop in ("device", "fori", "host"), f"unknown loop mode {loop!r}")
    expects(sync_every >= 1, f"sync_every must be >= 1, got {sync_every}")
    if fused is None:
        fused = _km.fused_em_enabled()
    x = as_input(x, device)
    expects(x.ndim == 2, "x must be [n_samples, n_features]")
    eng = _km._engine(x, engine)
    xs = _row_block(comms, x)
    k = params.n_clusters
    if centroids is None:
        xe = x.float() if x.dtype in _HALF_DTYPES else x
        c = _km.init_plus_plus(RngState(params.seed), xe, k,
                               params.oversampling_factor,
                               metric=params.metric, engine=eng).to(x.dtype)
    else:
        c = as_input(centroids, x.device).to(x.device, x.dtype)
    # half data: the E-steps read a float32 copy, as in kmeans.fit
    xs = xs.float() if xs.dtype in _HALF_DTYPES else xs
    bs, bc = _km._resolve_batches(params)
    tol2 = float(params.tol) ** 2
    args = (comms, params.metric, bs, bc, fused, eng)
    if loop == "fori":
        live = torch.ones((), dtype=torch.bool, device=x.device)
        n_iter = torch.zeros((), dtype=torch.int64, device=x.device)
        for _ in range(params.max_iter):
            new, delta = _step(xs, c, *args)
            c = torch.where(live, new, c)
            n_iter = n_iter + live
            live = live & (delta > tol2)
    else:
        # "device" reads δ² every step, "host" every sync_every steps and
        # never when tol == 0; a read after the last step would be a dead
        # break
        every = 1 if loop == "device" else sync_every
        reads = loop == "device" or tol2 > 0
        n_iter = 0
        while n_iter < params.max_iter:
            c, delta = _step(xs, c, *args)
            n_iter += 1
            if reads and n_iter % every == 0 and n_iter < params.max_iter \
                    and not float(delta) > tol2:
                break
        n_iter = torch.tensor(n_iter, device=x.device)
    _, inertia = _inertia(comms, xs, c, params.metric, bs, bc, eng)
    return KMeansOutput(c, inertia, n_iter)


def predict(params: KMeansParams, comms, x, centroids, *, device=None,
            engine: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed (labels [n] int32, inertia): each rank labels its row
    block, then one allgather gives every rank all n labels (the JAX
    package's output sharding gathers them with no counted collective)
    and one allreduce the inertia.  Inputs as in :func:`fit`."""
    comms = as_comms(comms)
    x = as_input(x, device)
    c = as_input(centroids, x.device).to(x.device)
    xs = _row_block(comms, x)
    xs = xs.float() if xs.dtype in _HALF_DTYPES else xs
    bs, bc = _km._resolve_batches(params)
    labels, inertia = _inertia(comms, xs, c, params.metric, bs, bc,
                               _km._engine(x, engine))
    return comms.allgather(labels).reshape(-1), inertia
