"""Random ball cover: landmark-based exact kNN (port of
``raft_tpu/neighbors/ball_cover.py``; reference neighbors/ball_cover.cuh
``build_index`` / ``knn_query`` / ``all_knn_query`` / ``eps_nn``, Cayton's
random ball cover).

Build: ≈√n landmarks drawn from the seed (the JAX package's own numpy
draw, so both pick the same rows), every point grouped under its nearest
landmark (``pairwise.distance`` + argmin, the expanded form for
L2SqrtExpanded), per-landmark radii (the largest member distance, −inf
for a landmark with no member), and the groups packed into the port's
chunked lists (``_build.pack_device``: a group of s points spans
ceil(s / cap) physical rows of one (n_phys + 1, cap, dim) block).

Query: rank the landmarks by distance (``select_k``, kernel B2 on the
card: the earlier landmark wins a tie, as ``jax.lax.top_k`` does), scan
the chunks of the P nearest (``_common.scan_probe_lists``: each step's
best k by kernel B2, merged into the running top-k), then check the
certificate of exactness — no unprobed landmark's lower bound
``d(q, L) − radius(L)`` undercuts the k-th distance.  A query that fails
it gets one more pass over exactly the unprobed landmarks whose bound
does not exceed its k-th distance: the reference CUDA design's per-query
pruning, which the JAX package replaced by rescanning the whole batch
with 2P, 4P, … probes (static shapes on the TPU).  On a mixture the
outer landmarks' radii are large, so doubling ends near every landmark
for most queries, where the pruned pass scans only the landmarks that
can matter.  A query's result depends only on its own distances, so it
is the same whatever the batch it rides in.  Tiles are scored in the
direct Σ(q−x)² form, summed column by column, so a self-pair scores
exactly 0 and the bits do not depend on the batch.

``eps_nn`` scores every stored point in groups of physical rows, in the
same direct form (the JAX package takes the expanded one here, whose
rounding near ε is ~1e-6 on unit-scale points; the direct form's is an
ulp of the distance), and writes the hits into the (nq, n) adjacency by
id.

Metrics: L2SqrtExpanded, L2SqrtUnexpanded and Haversine, as in the
reference.  ``index_from_arrays`` carries a JAX ``BallCoverIndex`` across
(its flat padded lists become one chunk per landmark).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import (accum_dtype, as_float_tensor,
                                              distance)
from raft_tpu_torch.matrix.select_k import merge_sorted_runs, select_k
from raft_tpu_torch.neighbors._build import pack_device
from raft_tpu_torch.neighbors._common import (array_to_tensor, empty_result,
                                              expand_probes,
                                              scan_probe_lists)

_SUPPORTED = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded,
              DistanceType.Haversine)
#: the JAX ``BallCoverIndex`` leaves, in order (``raft_tpu``
#: ball_cover.py:55-59)
ARRAY_FIELDS = ("landmarks", "radii", "list_data", "list_indices",
                "list_sizes")
#: rows per block of the build's landmark 1-NN
_ASSIGN_ROWS = 1 << 16
#: (query, slot, column) differences per group of eps_nn's scan
_EPS_GROUP_ELEMS = 1 << 28


@dataclasses.dataclass
class BallCoverIndex:
    """Landmarks, radii and the points grouped by landmark in chunked
    padded lists.

    ``landmarks``    (n_landmarks, dim)
    ``radii``        (n_landmarks,) f32 — largest member distance
    ``list_data``    (n_phys+1, cap, dim) — the points, in their own type
    ``list_indices`` (n_phys+1, cap) int32 — source ids, −1 at padding
    ``phys_sizes``   (n_phys+1,) int32 — live rows per physical chunk
    ``list_sizes``   (n_landmarks,) int32 — points per landmark
    ``chunk_table``  (n_landmarks, max_chunks) int32 — landmark → chunks
    """

    landmarks: torch.Tensor
    radii: torch.Tensor
    list_data: torch.Tensor
    list_indices: torch.Tensor
    phys_sizes: torch.Tensor
    list_sizes: torch.Tensor
    chunk_table: torch.Tensor
    metric: DistanceType

    @property
    def device(self) -> torch.device:
        return self.landmarks.device

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def dim(self) -> int:
        return self.landmarks.shape[1]

    @property
    def capacity(self) -> int:
        return self.list_data.shape[1]


def index_from_arrays(arrays: Dict[str, np.ndarray], metric,
                      device=None) -> BallCoverIndex:
    """A :class:`BallCoverIndex` from a JAX ``BallCoverIndex``'s leaves as
    numpy arrays under their field names (:data:`ARRAY_FIELDS`): each of
    its padded lists becomes one chunk, and an empty dummy row follows."""
    dev = resolve_device(device)
    v = {name: array_to_tensor(arrays[name], dev) for name in ARRAY_FIELDS}
    nl, cap = v["list_indices"].shape
    sizes = v["list_sizes"].to(torch.int32)
    data = torch.cat([v["list_data"], v["list_data"].new_zeros(
        (1, cap) + tuple(v["list_data"].shape[2:]))])
    idx = torch.cat([v["list_indices"].to(torch.int32),
                     torch.full((1, cap), -1, dtype=torch.int32,
                                device=dev)])
    return BallCoverIndex(
        landmarks=v["landmarks"], radii=v["radii"].float(), list_data=data,
        list_indices=idx,
        phys_sizes=torch.cat([sizes, sizes.new_zeros(1)]), list_sizes=sizes,
        chunk_table=torch.arange(nl, dtype=torch.int32, device=dev)[:, None],
        metric=DistanceType(int(metric)))


def _tile_distance(q: torch.Tensor, data: torch.Tensor,
                   metric: DistanceType) -> torch.Tensor:
    """Distances from queries (nq, dim) to gathered tiles (nq, cap, dim),
    in float32 for half inputs.  The L2 metrics take the DIRECT Σ(q−x)²
    form, summed column by column in one order: a self-pair scores
    exactly 0 (the expanded form's cancellation would not), which the
    certificate relies on, and no reduction whose order could follow the
    batch's shape is involved."""
    acc = accum_dtype(q.dtype)
    q = q.to(acc)
    data = data.to(acc)
    if metric == DistanceType.Haversine:
        dlat = q[:, None, 0] - data[:, :, 0]
        dlon = q[:, None, 1] - data[:, :, 1]
        h = (torch.sin(dlat / 2) ** 2
             + torch.cos(q[:, None, 0]) * torch.cos(data[:, :, 0])
             * torch.sin(dlon / 2) ** 2)
        return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))
    diff = q[:, None, :] - data
    sq = diff * diff
    s = sq[..., 0]
    for c in range(1, sq.shape[-1]):
        s = s + sq[..., c]
    return torch.sqrt(s)


def build_index(x, metric: DistanceType = DistanceType.L2SqrtExpanded,
                n_landmarks: Optional[int] = None, seed: int = 0, *,
                device=None, engine: Optional[str] = None
                ) -> BallCoverIndex:
    """Sample ≈√n landmarks, group the points by nearest landmark and
    record the radii (reference ``build_index``).  *x* is an (n, dim)
    array or tensor (a tensor stays where it is; an array goes to
    *device*, default the card)."""
    x = (x if isinstance(x, torch.Tensor)
         else as_float_tensor(x, resolve_device(device)))
    expects(x.ndim == 2, "x must be (n, dim)")
    metric = DistanceType(metric)
    expects(metric in _SUPPORTED, f"ball_cover: unsupported metric {metric}")
    if metric == DistanceType.Haversine:
        expects(x.shape[1] == 2, "haversine needs (lat, lon) columns")
    n = x.shape[0]
    if n_landmarks is None:
        n_landmarks = max(1, int(math.isqrt(n)))
    n_landmarks = min(n_landmarks, n)
    sel = np.sort(np.random.default_rng(seed).choice(
        n, size=n_landmarks, replace=False))
    landmarks = x[torch.as_tensor(sel, device=x.device)]
    labels, dist = [], []
    for r in range(0, n, _ASSIGN_ROWS):
        d = distance(x[r:r + _ASSIGN_ROWS], landmarks, metric, 2.0, engine)
        dmin, lab = torch.min(d, dim=1)   # the first minimum on ties
        labels.append(lab)
        dist.append(dmin)
    labels = torch.cat(labels)
    dist = torch.cat(dist).float()
    radii = torch.full((n_landmarks,), float("-inf"), dtype=torch.float32,
                       device=x.device)
    radii.scatter_reduce_(0, labels, dist, "amax", include_self=True)
    data, idx, phys_sizes, sizes, chunk_table, _ = pack_device(
        x, torch.arange(n, dtype=torch.int32, device=x.device), labels,
        n_landmarks)
    return BallCoverIndex(landmarks=landmarks, radii=radii, list_data=data,
                          list_indices=idx, phys_sizes=phys_sizes,
                          list_sizes=sizes, chunk_table=chunk_table,
                          metric=metric)


def _scan_landmarks(index: BallCoverIndex, queries: torch.Tensor,
                    probe_ids: torch.Tensor, k: int,
                    engine: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each query over the points of its landmarks *probe_ids*
    (nq, P), scanned in that order; an entry ``n_landmarks`` is padding
    (an empty landmark)."""
    n_rows = index.list_data.shape[0]
    table = torch.cat([index.chunk_table, torch.full_like(
        index.chunk_table[:1], n_rows - 1)])
    # steps: the most chunks any query's landmarks span (the dummy
    # entries past them score nothing)
    steps = int((table[probe_ids.long()] != n_rows - 1).sum(dim=(1, 2))
                .max())
    phys = expand_probes(probe_ids, table, n_rows,
                         extra=max(0, steps - probe_ids.shape[1]))

    def score_tile(rows):
        return _tile_distance(queries, index.list_data[rows], index.metric)

    return scan_probe_lists(phys, score_tile, index.list_indices,
                            index.phys_sizes, k, select_min=True,
                            dtype=accum_dtype(queries.dtype), engine=engine)


def _query_batch(index: BallCoverIndex, queries: torch.Tensor, k: int,
                 n_probe: int, engine: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of one query batch in at most two passes: the
    *n_probe* nearest landmarks, then, for each query the certificate
    fails, every unprobed landmark whose lower bound
    ``max(d(q, L) − radius(L), 0)`` does not exceed its k-th distance, in
    rank order, merged after the first pass's run (which wins ties).
    Every landmark left out then bounds its points above the k-th
    distance, so the result is exact."""
    nl = index.n_landmarks
    ql = distance(queries, index.landmarks, index.metric, 2.0, engine)
    _, first = select_k(ql, n_probe, select_min=True, engine=engine)
    d, i = _scan_landmarks(index, queries, first, k, engine)
    probed = torch.zeros((queries.shape[0], nl), dtype=torch.bool,
                         device=queries.device)
    probed.scatter_(1, first.long(), True)
    lb = torch.clamp_min(ql - index.radii[None, :], 0.0)
    open_ = ~probed & (lb <= d[:, -1:])
    todo = torch.nonzero(open_.any(dim=1)).squeeze(1)
    if todo.numel():
        open_ = open_[todo]
        count = open_.sum(dim=1)
        width = int(count.max())
        _, second = select_k(torch.where(open_, ql[todo], float("inf")),
                             width, select_min=True, engine=engine)
        second = torch.where(
            torch.arange(width, device=ql.device)[None, :] < count[:, None],
            second, nl)
        d2, i2 = _scan_landmarks(index, queries[todo], second, k, engine)
        d[todo], i[todo] = merge_sorted_runs(d[todo], i[todo], d2, i2, k=k,
                                             select_min=True)
    return d, i


def knn_query(index: BallCoverIndex, queries, k: int, *,
              initial_probes: Optional[int] = None,
              batch_size_query: int = 4096, engine: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN against the indexed points (reference ``knn_query``):
    (distances (nq, k), ids (nq, k) int32) on the index's device."""
    q = as_float_tensor(queries, index.device)
    expects(q.ndim == 2 and q.shape[1] == index.dim, "query dim mismatch")
    expects(k >= 1, "k must be >= 1")
    q = q.to(index.landmarks.dtype)
    k = int(k)
    if q.shape[0] == 0:
        return empty_result(0, k, accum_dtype(q.dtype), index.device)
    nl = index.n_landmarks
    p0 = (min(nl, initial_probes) if initial_probes
          else min(nl, max(4, int(math.isqrt(nl)) * 2)))
    out = [_query_batch(index, q[q0:q0 + batch_size_query], k, p0, engine)
           for q0 in range(0, q.shape[0], batch_size_query)]
    if len(out) == 1:
        return out[0]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def all_knn_query(index: BallCoverIndex, k: int, **kw
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN of the indexed points among themselves (reference
    ``all_knn_query``): the live slots of every physical row, queried in
    source-id order."""
    ids = index.list_indices.reshape(-1)
    live = ids >= 0
    flat = index.list_data.reshape(-1, index.dim)[live]
    order = torch.argsort(ids[live])
    return knn_query(index, flat[order], k, **kw)


def eps_nn(index: BallCoverIndex, queries, eps: float, *,
           batch_size_query: int = 4096
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All indexed points within *eps* of each query (reference
    ``eps_nn``): boolean adjacency (nq, n_indexed) in source-id order and
    the per-query degree (int32).  Every stored point is scored; pruned
    landmarks could hold no hit."""
    q = as_float_tensor(queries, index.device)
    expects(q.ndim == 2 and q.shape[1] == index.dim, "query dim mismatch")
    q = q.to(index.landmarks.dtype)
    n_total = int(index.list_sizes.sum())
    n_rows, cap = index.list_indices.shape
    slots = torch.arange(cap, device=index.device)
    out = []
    for q0 in range(0, q.shape[0], batch_size_query):
        qb = q[q0:q0 + batch_size_query]
        adj = torch.zeros((qb.shape[0], n_total), dtype=torch.bool,
                          device=index.device)
        group = max(1, _EPS_GROUP_ELEMS
                    // max(1, qb.shape[0] * cap * index.dim))
        for r0 in range(0, n_rows, group):
            live = (slots[None, :] < index.phys_sizes[r0:r0 + group, None]
                    ).reshape(-1)
            ids = index.list_indices[r0:r0 + group].reshape(-1)[live]
            data = index.list_data[r0:r0 + group].reshape(
                -1, index.dim)[live]
            if not ids.numel():
                continue
            d = _tile_distance(qb, data[None], index.metric)
            adj[:, ids.long()] = d <= eps
        out.append(adj)
    adj = (torch.cat(out) if out else
           torch.zeros((0, n_total), dtype=torch.bool, device=index.device))
    return adj, torch.sum(adj, dim=1, dtype=torch.int32)
