"""Exact brute-force k-nearest neighbours (port of
``raft_tpu/neighbors/brute_force.py``; reference neighbors/brute_force.cuh:
76,144, ``knn_merge_parts`` and ``knn``).

One design for every metric: a loop over index tiles where each step
computes a (queries × tile) distance tile (``distance_with_stats``:
kernel B5 on the card for the metrics with no inner-product form, a
product in fixed 1,024-row blocks for the expanded ones), keeps its best
k (``select_k``, kernel B2) and merges them into the running top-k
(``merge_sorted_runs``; the carry, holding lower ids, wins ties).  The
(m, n) matrix never exists.  Query statistics are computed once per
batch, index statistics once per scan.  The index is never padded: its
ragged last tile is one extra step.  Query batches are padded to the
power-of-two bucket ladder and sliced after, as the serving engine pads
its super-batches, so a query's result is the same in every batch.

Ids are int32; a ``global_id_offset`` that pushes them past int32 makes
them int64.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.distance.distance_types import (DISTANCE_TYPES,
                                                    DistanceType)
from raft_tpu_torch.distance.pairwise import (accum_dtype, as_float_tensor,
                                              distance_with_stats,
                                              metric_stats)
from raft_tpu_torch.matrix.select_k import (merge_sorted_parts,
                                            merge_sorted_runs, select_k)
from raft_tpu_torch.neighbors._common import empty_result

_INT32_MAX = 2**31 - 1


def _resolve_metric(metric) -> DistanceType:
    if isinstance(metric, str):
        m = DISTANCE_TYPES.get(metric.lower())
        expects(m is not None, f"unknown metric {metric!r}")
        return m
    return DistanceType(metric)


def _knn_scan_impl(index: torch.Tensor, queries: torch.Tensor, k: int,
                   metric: DistanceType, metric_arg: float, tile: int,
                   select_min: bool, engine: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k of *queries* over the index tiles: (distances (nq, k)
    in ``accum_dtype``, ids (nq, k) int32)."""
    # sqrt is monotone: scan and select on squared L2, root the (nq, k)
    # result only
    defer_sqrt = metric == DistanceType.L2SqrtExpanded
    scan_metric = DistanceType.L2Expanded if defer_sqrt else metric
    n = index.shape[0]
    q_stats = metric_stats(queries, scan_metric)
    i_stats = metric_stats(index, scan_metric)
    nq = queries.shape[0]
    val_dtype = accum_dtype(queries.dtype)
    best_d = torch.full((nq, k), float("inf") if select_min else float("-inf"),
                        dtype=val_dtype, device=queries.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32,
                        device=queries.device)
    for base in range(0, n, tile):
        width = min(tile, n - base)
        d = distance_with_stats(queries, index[base:base + width],
                                scan_metric, metric_arg, q_stats,
                                i_stats[base:base + width], engine)
        tile_d, pos = select_k(d.to(val_dtype), min(k, width),
                               select_min=select_min, engine=engine)
        best_d, best_i = merge_sorted_runs(best_d, best_i, tile_d, pos + base,
                                           k=k, select_min=select_min)
    if defer_sqrt:
        best_d = torch.sqrt(best_d)
    return best_d, best_i


def knn(index, queries, k: int,
        metric: Union[str, DistanceType] = DistanceType.L2SqrtExpanded,
        metric_arg: float = 2.0, *, batch_size_index: int = 16384,
        batch_size_query: int = 4096, global_id_offset: int = 0,
        device=None, engine: Optional[str] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest rows of *index* for each row of *queries*
    (reference ``brute_force::knn``, neighbors/brute_force.cuh:144):
    (distances (nq, k), ids (nq, k) int32 — int64 when *global_id_offset*
    pushes them past int32).  InnerProduct selects the largest values.
    Queries take the index's type.  ``device=None`` runs on the card;
    ``engine`` picks the kernels (``"cuda"``) or their plain versions
    (``"torch"``)."""
    dev = resolve_device(device)
    index = as_float_tensor(index, dev)
    queries = as_float_tensor(queries, dev).to(index.dtype)
    metric = _resolve_metric(metric)
    expects(index.ndim == 2 and queries.ndim == 2, "inputs must be 2-d")
    expects(index.shape[1] == queries.shape[1], "feature dim mismatch")
    expects(1 <= k <= index.shape[0],
            f"k={k} must be in [1, n_index={index.shape[0]}]")
    k = int(k)
    if queries.shape[0] == 0:
        return empty_result(0, k, accum_dtype(queries.dtype), dev)
    tile = min(int(batch_size_index), index.shape[0])
    select_min = metric != DistanceType.InnerProduct
    bs = int(batch_size_query)
    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], bs):
        qb = queries[q0:q0 + bs]
        n_valid = qb.shape[0]
        bucket = min(bucket_dim(n_valid), bs)
        if bucket != n_valid:
            qb = torch.cat([qb, qb.new_zeros((bucket - n_valid,
                                              qb.shape[1]))])
        d, i = _knn_scan_impl(index, qb, k, metric, float(metric_arg), tile,
                              select_min, engine)
        out_d.append(d[:n_valid])
        out_i.append(i[:n_valid])
    d = out_d[0] if len(out_d) == 1 else torch.cat(out_d)
    i = out_i[0] if len(out_i) == 1 else torch.cat(out_i)
    if global_id_offset:
        expects(global_id_offset >= 0, "global_id_offset must be >= 0")
        if int(global_id_offset) + index.shape[0] - 1 > _INT32_MAX:
            i = i.long() + int(global_id_offset)
        else:
            i = i + int(global_id_offset)
    return d, i


def brute_force_knn(index, queries, k: int, **kw):
    """Alias with the reference's legacy name (spatial/knn/knn.cuh)."""
    return knn(index, queries, k, **kw)


def fused_l2_knn(index, queries, k: int, sqrt: bool = True, **kw
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2 kNN without the distance matrix (reference
    spatial/knn/detail/fused_l2_knn.cuh): the tiled scan already is the
    fused form; this pins the metric."""
    metric = (DistanceType.L2SqrtExpanded if sqrt
              else DistanceType.L2Expanded)
    return knn(index, queries, k, metric, **kw)


def knn_merge_parts(part_distances, part_indices, k: Optional[int] = None,
                    translations: Optional[Sequence[int]] = None,
                    metric: Union[str, DistanceType] = (
                        DistanceType.L2SqrtExpanded),
                    *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-part top-k results (n_parts, n_queries, in_k), each part
    sorted best-first, into the global top-k (reference
    ``knn_merge_parts``, neighbors/brute_force.cuh:76).  *translations*
    offset each part's local ids into the global id space; *metric* must be
    the parts' (InnerProduct merges by max).  When k exceeds in_k, slots
    past the real candidates hold the worst value and id -1."""
    select_min = _resolve_metric(metric) != DistanceType.InnerProduct
    dev = resolve_device(device)
    d = as_float_tensor(part_distances, dev)
    i = torch.as_tensor(part_indices, device=dev)
    expects(d.ndim == 3 and i.shape == d.shape,
            "expected (n_parts, n_queries, k) distances+indices")
    n_parts, _, in_k = d.shape
    k = int(in_k if k is None else k)
    expects(k <= n_parts * in_k, "k larger than total candidates")
    if translations is not None:
        expects(len(translations) == n_parts,
                "need one translation per part")
        t = torch.as_tensor(list(translations), dtype=i.dtype, device=dev)
        i = i + t.reshape(n_parts, 1, 1)
    return merge_sorted_parts(d, i, k=k, select_min=select_min)
