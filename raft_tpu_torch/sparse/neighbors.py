"""Sparse neighbours: batched sparse brute-force kNN, the kNN-graph
builder and the connect-components MST fix-up (port of
``raft_tpu/sparse/neighbors.py``; reference ``sparse/neighbors/`` —
``detail/knn.cuh``, ``knn_graph.cuh``, ``detail/connect_components.cuh``).

Every select and merge is :func:`raft_tpu_torch.matrix.select_k`: kernel
B2 on the card for k <= 128.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance import DistanceType
from raft_tpu_torch.distance.pairwise import as_input, distance
from raft_tpu_torch.matrix import select_k
from raft_tpu_torch.sparse import distance as _sparse_distance
from raft_tpu_torch.sparse.op import csr_row_slice, segment_reduce
from raft_tpu_torch.sparse.solver import boruvka_mst
from raft_tpu_torch.sparse.solver.mst import sorted_mst_edges
from raft_tpu_torch.sparse.types import COO, CSR

#: the sparse ``pairwise_distance`` without its handle wrapper: the kNN
#: tile loop stays on the caller's stream, with no host wait per tile
sparse_pairwise = _sparse_distance.pairwise_distance.__wrapped__


def brute_force_knn(index: CSR, query: CSR, k: int,
                    metric: DistanceType = DistanceType.L2Expanded,
                    batch_size_index: int = 16384,
                    batch_size_query: int = 4096
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched sparse brute-force kNN (reference
    sparse/neighbors/detail/knn.cuh ``brute_force_knn``): tiles over query
    and index rows, the per-tile top-k merged as ``knn_merge_parts``.
    Returns (distances (nq, k), indices (nq, k) int32)."""
    nq, ni = query.shape[0], index.shape[0]
    expects(1 <= k <= ni, "brute_force_knn: need 1 <= k <= n_index")
    bq = min(batch_size_query, nq)
    bi = min(batch_size_index, ni)
    out_d, out_i = [], []
    for q0 in range(0, nq, bq):
        qs = csr_row_slice(query, q0, min(q0 + bq, nq))
        best_d = best_i = None
        for i0 in range(0, ni, bi):
            i1 = min(i0 + bi, ni)
            d = sparse_pairwise(qs, csr_row_slice(index, i0, i1), metric)
            vals, idx = select_k(d, min(k, i1 - i0), select_min=True)
            idx = idx + i0
            if best_d is None:
                best_d, best_i = vals, idx
            else:
                # merge parts: the top k of the running and new candidates
                cat_d = torch.cat([best_d, vals], dim=1)
                cat_i = torch.cat([best_i, idx], dim=1)
                best_d, best_i = select_k(cat_d, min(k, cat_d.shape[1]),
                                          select_min=True, indices=cat_i)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d, dim=0), torch.cat(out_i, dim=0)


def build_k(n_samples: int, c: int) -> int:
    """k of the kNN graph's connectivity (reference
    sparse/neighbors/detail/knn_graph.cuh:56): min(n, max(2, ⌊log₂ n⌋ +
    c))."""
    return int(min(n_samples,
                   max(2, math.floor(math.log2(max(n_samples, 2))) + c)))


def knn_graph(x, metric: DistanceType = DistanceType.L2SqrtExpanded,
              c: int = 15, k: Optional[int] = None, batch_size: int = 4096,
              device=None) -> COO:
    """Directed kNN graph of dense points as a COO (reference
    sparse/neighbors/knn_graph.cuh): self-edges excluded, edge (i, j)
    carries the metric's distance.  *x*: a tensor stays where it is, an
    array goes to *device* (``None``: the card)."""
    x = as_input(x, device)
    n = x.shape[0]
    kk = min(int(k) if k is not None else build_k(n, c), n - 1)
    rows, cols, vals = [], [], []
    for i0 in range(0, n, batch_size):
        i1 = min(i0 + batch_size, n)
        d = distance(x[i0:i1], x, metric)
        r = torch.arange(i0, i1, device=x.device)
        d[torch.arange(i1 - i0, device=x.device), r] = float("inf")
        v, idx = select_k(d, kk, select_min=True)
        rows.append(torch.repeat_interleave(r, kk).to(torch.int32))
        cols.append(idx.reshape(-1))
        vals.append(v.reshape(-1))
    return COO(torch.cat(rows), torch.cat(cols), torch.cat(vals), (n, n))


def connect_components(x, colors,
                       metric: DistanceType = DistanceType.L2SqrtExpanded,
                       batch_size: int = 4096) -> COO:
    """Cross-component nearest-neighbour edges (reference
    sparse/neighbors/detail/connect_components.cuh): each point's nearest
    point of another component, reduced to the least such edge of each
    colour (``min_components_by_color``), in both directions.  Merged
    with a spanning forest, these edges strictly reduce its component
    count."""
    x = as_input(x, colors.device if isinstance(colors, torch.Tensor)
                 else None)
    colors = torch.as_tensor(colors, device=x.device).to(torch.int32)
    n = x.shape[0]
    nn_idx, nn_dist = [], []
    for i0 in range(0, n, batch_size):
        i1 = min(i0 + batch_size, n)
        d = distance(x[i0:i1], x, metric)
        d = torch.where(colors[i0:i1, None] == colors[None, :], float("inf"),
                        d)
        best, arg = torch.min(d, dim=1)
        nn_idx.append(arg.to(torch.int32))
        nn_dist.append(best)
    nn_idx = torch.cat(nn_idx)
    nn_dist = torch.cat(nn_dist)
    # each colour's least outgoing edge; among equals the least point id
    best_dist = segment_reduce(nn_dist, colors, n, "amin")
    is_best = ((nn_dist == best_dist[torch.clamp(colors, 0, n - 1).long()])
               & torch.isfinite(nn_dist))
    iota = torch.arange(n, dtype=torch.int32, device=x.device)
    best_pt = segment_reduce(torch.where(is_best, iota, n), colors, n, "amin")
    has = best_pt < n
    src = torch.where(has, best_pt, n)
    src_safe = torch.clamp(src, 0, n - 1).long()
    dst = torch.where(has, nn_idx[src_safe], 0)
    w = torch.where(has, nn_dist[src_safe], 0.0)
    rows = torch.cat([src, torch.where(has, dst, n)])
    cols = torch.cat([dst, torch.where(has, src_safe.to(torch.int32), 0)])
    vals = torch.cat([w, torch.where(has, w, 0.0)])
    # live entries to the front: the module's padding convention
    pad = rows >= n
    order = torch.sort(pad.to(torch.uint8), stable=True).indices
    return COO(rows[order], torch.where(pad, 0, cols)[order],
               torch.where(pad, 0.0, vals)[order], (n, n),
               nnz=2 * has.sum(dtype=torch.int32))


def mst_from_knn_graph(x, metric: DistanceType = DistanceType.L2SqrtExpanded,
                       c: int = 15, max_fixup_iter: int = 32, device=None):
    """Sorted MST edges of the kNN-graph connectivity (reference
    cluster/detail/connectivities.cuh + detail/mst.cuh
    ``build_sorted_mst`` with the ``connect_components`` fix-up of a
    disconnected kNN graph): (src, dst, weight) by ascending weight, with
    exactly n−1 edges.  One host read a fix-up round (the component
    count); the rounds are counted in ``raft_tpu_mst_fixup_rounds_total``.
    *x*: a tensor stays where it is, an array goes to *device* (``None``:
    the card)."""
    x = as_input(x, device)
    n = x.shape[0]
    knn = knn_graph(x, metric, c)
    # both directions (duplicates are harmless for the MST)
    live = knn.mask()
    g = COO(torch.cat([knn.rows, torch.where(live, knn.cols, n)]),
            torch.cat([knn.cols, torch.where(live, knn.rows, 0)]),
            torch.cat([knn.vals, knn.vals]), (n, n), nnz=2 * knn.nnz)
    res = boruvka_mst(g)
    rounds = telemetry.counter("raft_tpu_mst_fixup_rounds_total",
                               "connect_components fix-up rounds")
    for _ in range(max_fixup_iter):
        if torch.unique(res.color).numel() == 1:
            break
        rounds.inc()
        fix = connect_components(x, res.color, metric)
        # the forest's edges and the fix-up edges, Borůvka again (the
        # same tree as the reference's MST(msf) ∪ MST(cross edges) by cut
        # optimality)
        flive = (torch.arange(res.src.shape[0], device=x.device)
                 < res.n_edges)
        rows = torch.cat([torch.where(flive, res.src, n),
                          torch.where(flive, res.dst, n), fix.rows])
        cols = torch.cat([torch.where(flive, res.dst, 0),
                          torch.where(flive, res.src, 0), fix.cols])
        fw = torch.where(flive, res.weight, 0.0)
        g = COO(rows, cols, torch.cat([fw, fw, fix.vals]), (n, n),
                nnz=2 * res.n_edges + fix.nnz)
        res = boruvka_mst(g)
    expects(int(res.n_edges) == n - 1,
            "mst_from_knn_graph: could not connect the kNN graph")
    return sorted_mst_edges(res)
