"""IVF-Flat approximate nearest-neighbour index (port of
``raft_tpu/neighbors/ivf_flat.py``; reference neighbors/ivf_flat.cuh).

Build: a balanced hierarchical k-means coarse quantizer (kernels B3 and B1
on the card), list assignment (kernel B1) and a device pack into chunked
padded lists — a list of size s spans ceil(s / cap) physical rows of one
(n_phys + 1, cap, dim) block, the last row an empty dummy.

Search, per query batch: coarse GEMM against the centres → top-n_probes
(kernel B2) → the probed physical rows, one scan step per (probe rank,
chunk): gather each query's row, score it (plain PyTorch, as the JAX
package leaves it to XLA), keep the best k of
the tile (kernel B2) and merge them into the running top-k.  The tail
batch is padded to the power-of-two bucket ladder.

Stored vectors are float32.  The squared norms of the stored rows are
computed once when an :class:`Index` is made (``list_norms``) instead of
once per scan step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import min_cluster_and_distance
from raft_tpu_torch.cluster.kmeans_balanced import build_hierarchical
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import _dot_fixed_rows, _row_norms
from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.linalg.reduce import reduce_rows_by_key
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors._common import (empty_result, expand_probes,
                                              pack_lists, scan_probe_lists,
                                              subsample_trainset)
from raft_tpu_torch.random.rng import RngState

_SUPPORTED = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
              DistanceType.InnerProduct, DistanceType.CosineExpanded)
#: the JAX Index leaves, in order (``raft_tpu`` ivf_flat.py:106-111)
ARRAY_FIELDS = ("centers", "list_data", "list_indices", "list_sizes",
                "phys_sizes", "chunk_table")
#: rows per block of the inner-product list assignment
_ASSIGN_ROWS = 1 << 16


@dataclasses.dataclass
class IndexParams:
    """Reference ``ivf_flat::index_params`` (ivf_flat_types.hpp:30)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    adaptive_centers: bool = False
    add_data_on_build: bool = True
    seed: int = 1234


@dataclasses.dataclass
class SearchParams:
    """Reference ``ivf_flat::search_params`` (ivf_flat_types.hpp:118)."""

    n_probes: int = 20


@dataclasses.dataclass
class Index:
    """IVF-Flat index: chunked padded inverted lists.

    ``list_data``    (n_phys+1, cap, dim) f32 — stored vectors
    ``list_indices`` (n_phys+1, cap) int32 — source ids, −1 at padding
    ``phys_sizes``   (n_phys+1,) int32 — live rows per physical chunk
    ``chunk_table``  (n_lists, max_chunks) int32 — logical → physical rows
    ``list_sizes``   (n_lists,) int32 — logical list sizes
    ``centers``      (n_lists, dim) f32 coarse centroids
    ``list_norms``   (n_phys+1, cap) f32 — squared norms of the stored rows
    """

    centers: torch.Tensor
    list_data: torch.Tensor
    list_indices: torch.Tensor
    list_sizes: torch.Tensor
    phys_sizes: torch.Tensor
    chunk_table: torch.Tensor
    metric: DistanceType
    adaptive_centers: bool = False
    list_norms: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.list_norms = torch.sum(self.list_data * self.list_data, dim=-1)

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def capacity(self) -> int:
        return self.list_data.shape[1]

    @property
    def size(self) -> int:
        return int(torch.sum(self.list_sizes))

    @property
    def padding_fraction(self) -> float:
        total = self.list_data.shape[0] * self.capacity
        return 1.0 - self.size / max(total, 1)


def index_from_arrays(arrays: Dict[str, np.ndarray], metric,
                      adaptive_centers: bool = False, device=None) -> Index:
    """An :class:`Index` from the JAX ``Index`` leaves as numpy arrays under
    their field names (:data:`ARRAY_FIELDS`) — e.g. an index the JAX
    package built."""
    dev = resolve_device(device)
    vals = {}
    for name in ARRAY_FIELDS:
        dt = np.float32 if name in ("centers", "list_data") else np.int32
        vals[name] = torch.as_tensor(np.array(arrays[name], dt), device=dev)
    return Index(**vals, metric=DistanceType(int(metric)),
                 adaptive_centers=bool(adaptive_centers))


def index_to_arrays(index: Index) -> Dict[str, np.ndarray]:
    """Inverse of :func:`index_from_arrays`."""
    return {name: getattr(index, name).cpu().numpy() for name in ARRAY_FIELDS}


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    n = torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-30)
    return x / n


def _assign_lists(q: torch.Tensor, centers: torch.Tensor,
                  metric: DistanceType, engine: Optional[str] = None
                  ) -> torch.Tensor:
    """List of each vector, ranked as search ranks probes: max-dot for
    inner product / cosine (q pre-normalized for cosine), else the nearest
    centre by L2 (kernel B1)."""
    if metric in (DistanceType.InnerProduct, DistanceType.CosineExpanded):
        c = (_normalize_rows(centers) if metric == DistanceType.CosineExpanded
             else centers)
        return torch.cat([torch.argmax(q[r:r + _ASSIGN_ROWS] @ c.T, dim=1)
                          for r in range(0, q.shape[0], _ASSIGN_ROWS)]
                         ).to(torch.int32)
    return min_cluster_and_distance(q, centers, engine=engine).key


def _train_centers(params: IndexParams, x: torch.Tensor, n_lists: int,
                   engine: Optional[str]) -> torch.Tensor:
    train = subsample_trainset(x, params.kmeans_trainset_fraction, n_lists,
                               params.seed)
    if params.metric == DistanceType.CosineExpanded:
        train = _normalize_rows(train)
    return build_hierarchical(RngState(params.seed), train, n_lists,
                              params.kmeans_n_iters, engine=engine)


def build(params: IndexParams, dataset, ids=None, *, device=None,
          engine: Optional[str] = None) -> Index:
    """Train and populate an IVF-Flat index (reference ``ivf_flat::build``).
    *dataset* is an (n, dim) float32 array or tensor; ``device=None`` runs
    on the card.  ``engine`` picks the kernels (``"cuda"``) or their plain
    versions (``"torch"``) for the E-steps."""
    dev = resolve_device(device)
    x = torch.as_tensor(dataset, device=dev)
    expects(x.ndim == 2, "dataset must be (n, dim)")
    expects(x.dtype == torch.float32, "ivf_flat: the port stores float32")
    expects(params.metric in _SUPPORTED,
            f"ivf_flat: unsupported metric {params.metric}")
    n = x.shape[0]
    n_lists = min(params.n_lists, n)
    centers = _train_centers(params, x, n_lists, engine)
    index = Index(centers=centers,
                  list_data=torch.zeros((1, 8, x.shape[1]), device=dev),
                  list_indices=torch.full((1, 8), -1, dtype=torch.int32,
                                          device=dev),
                  list_sizes=torch.zeros(n_lists, dtype=torch.int32,
                                         device=dev),
                  phys_sizes=torch.zeros(1, dtype=torch.int32, device=dev),
                  chunk_table=torch.zeros((n_lists, 1), dtype=torch.int32,
                                          device=dev),
                  metric=params.metric,
                  adaptive_centers=params.adaptive_centers)
    if params.add_data_on_build:
        index = extend(index, x, ids, engine=engine)
    else:
        expects(ids is None, "ids were passed but add_data_on_build=False "
                "stores no rows — pass them to extend() instead")
    return index


def extend(index: Index, new_vectors, new_ids=None, *,
           engine: Optional[str] = None) -> Index:
    """Add vectors to an EMPTY index (reference ``ivf_flat::extend``):
    assign each to its list and pack.  Appending into a non-empty index is
    not ported yet and raises."""
    x = torch.as_tensor(new_vectors, device=index.device)
    expects(x.ndim == 2 and x.shape[1] == index.dim, "dim mismatch")
    expects(x.dtype == torch.float32, "ivf_flat: the port stores float32")
    expects(index.size == 0,
            "ivf_flat.extend: appending into a non-empty index is not "
            "ported yet")
    n = x.shape[0]
    if new_ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=index.device)
    else:
        ids = torch.as_tensor(new_ids, device=index.device).to(torch.int32)
        expects(ids.shape == (n,), "ids must be (n_new,)")
        expects(torch.unique(ids).numel() == n,
                "extend: duplicate ids within new_ids")
    cosine = index.metric == DistanceType.CosineExpanded
    q = _normalize_rows(x) if cosine else x
    labels = _assign_lists(q, index.centers, index.metric, engine)
    data, idx, phys_sizes, sizes, chunk_table, _ = pack_lists(
        x, ids, labels, index.n_lists)
    centers = index.centers
    if index.adaptive_centers:
        sums = reduce_rows_by_key(x, labels, index.n_lists)
        n_old = index.list_sizes.to(centers.dtype)[:, None]
        n_tot = torch.clamp_min(sizes.to(centers.dtype), 1)[:, None]
        centers = torch.where(sizes[:, None] > 0,
                              (centers * n_old + sums) / n_tot, centers)
    return Index(centers=centers, list_data=data, list_indices=idx,
                 list_sizes=sizes, phys_sizes=phys_sizes,
                 chunk_table=chunk_table, metric=index.metric,
                 adaptive_centers=index.adaptive_centers)


def _coarse_distances(q: torch.Tensor, centers: torch.Tensor,
                      metric: DistanceType) -> torch.Tensor:
    if metric == DistanceType.CosineExpanded:
        return -_dot_fixed_rows(q, _normalize_rows(centers))
    if metric == DistanceType.InnerProduct:
        return -_dot_fixed_rows(q, centers)
    d = (_row_norms(q)[:, None] + _row_norms(centers)[None, :]
         - 2.0 * _dot_fixed_rows(q, centers))
    return torch.clamp_min(d, 0.0)


def _search_batch_impl(queries: torch.Tensor, index: Index, k: int,
                       n_probes: int, sqrt: bool, engine: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query batch: coarse ranking → top-n_probes → probe scan."""
    cd = _coarse_distances(queries, index.centers, index.metric)
    _, probe_ids = select_k(cd, n_probes, select_min=True, engine=engine)
    return _probe_search_impl(queries, probe_ids, index, k, sqrt, engine)


def _probe_search_impl(queries: torch.Tensor, probe_ids: torch.Tensor,
                       index: Index, k: int, sqrt: bool, engine: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score the probed lists of every query and keep the best k."""
    metric = index.metric
    is_ip = metric == DistanceType.InnerProduct
    is_cos = metric == DistanceType.CosineExpanded
    q_sq = _row_norms(queries)[:, None]
    qrow = queries[:, None, :]

    def score_tile(rows):
        data = index.list_data[rows]                        # (nq, cap, dim)
        # a product and a row sum rather than torch.bmm: the batched GEMM
        # picks its algorithm by batch count and would give a query other
        # bits in another batch (see pairwise._dot_fixed_rows); the
        # reduction does not depend on the number of rows
        dots = torch.sum(data * qrow, dim=-1)               # (nq, cap)
        if is_ip:
            return dots
        xn = index.list_norms[rows]
        if is_cos:
            return 1.0 - dots / torch.sqrt(torch.clamp_min(xn, 1e-30))
        return q_sq + xn - 2.0 * dots

    phys = expand_probes(probe_ids, index.chunk_table,
                         index.list_data.shape[0])
    best_d, best_i = scan_probe_lists(phys, score_tile, index.list_indices,
                                      index.phys_sizes, k,
                                      select_min=not is_ip,
                                      dtype=torch.float32, engine=engine)
    if sqrt:
        best_d = torch.sqrt(torch.clamp_min(best_d, 0.0))
    return best_d, best_i


def search(params: SearchParams, index: Index, queries, k: int, *,
           batch_size_query: int = 1024, engine: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search the index (reference ``ivf_flat::search``): returns
    (distances (nq, k) f32, indices (nq, k) int32) on the index's device.
    ``engine`` picks kernel B2 (``"cuda"``) or its plain version
    (``"torch"``) for the selections; the default follows the device."""
    q = torch.as_tensor(queries, device=index.device)
    expects(q.ndim == 2 and q.shape[1] == index.dim, "query dim mismatch")
    expects(q.dtype == torch.float32, "ivf_flat: float32 queries")
    expects(k >= 1, "k must be >= 1")
    n_probes = min(params.n_probes, index.n_lists)
    if q.shape[0] == 0:
        return empty_result(0, int(k), torch.float32, index.device)
    if index.metric == DistanceType.CosineExpanded:
        q = _normalize_rows(q)
    sqrt = index.metric == DistanceType.L2SqrtExpanded
    engine = resolve_engine("select_k", index.device, engine=engine)
    out_d, out_i = [], []
    for q0 in range(0, q.shape[0], batch_size_query):
        qb = q[q0:q0 + batch_size_query]
        n_valid = qb.shape[0]
        bucket = min(bucket_dim(n_valid), batch_size_query)
        if bucket != n_valid:
            qb = torch.cat([qb, qb.new_zeros((bucket - n_valid, qb.shape[1]))])
        d, i = _search_batch_impl(qb, index, int(k), int(n_probes), sqrt,
                                  engine)
        out_d.append(d[:n_valid])
        out_i.append(i[:n_valid])
    if len(out_d) == 1:
        return out_d[0], out_i[0]
    return torch.cat(out_d), torch.cat(out_i)
