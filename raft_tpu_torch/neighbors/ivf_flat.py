"""IVF-Flat approximate nearest-neighbour index (port of
``raft_tpu/neighbors/ivf_flat.py``; reference neighbors/ivf_flat.cuh).

Build: a balanced hierarchical k-means coarse quantizer (kernels B3 and B1
on the card), list assignment (kernel B1) and a device pack into chunked
padded lists — a list of size s spans ceil(s / cap) physical rows of one
(n_phys + 1, cap, dim) block, the last row an empty dummy.  ``extend``
appends into a non-empty index (``_build.extend_device``: each list's
free tail slots, new chunks only for lists that overflow; ``in_place``
writes into the index's own tensors when none does).

Search, per query batch: coarse GEMM against the centres → top-n_probes
(kernel B2) → the probed physical rows, one scan step per (probe rank,
chunk): gather each query's row, score it (plain PyTorch, as the JAX
package leaves it to XLA), keep the best k of
the tile (kernel B2) and merge them into the running top-k.  The tail
batch is padded to the power-of-two bucket ladder.  A tombstone bitmap
(``tombstones=``, the mutable index's deletes) masks dead rows inside
the scan.

Stored vectors are float32, int8, uint8 or bfloat16 (the dataset's own
type); training, list assignment and scoring widen them to float32 and
accumulate in float32, as the JAX package's ``_probe_search_impl`` does.
The squared norms of the stored rows are computed once when an
:class:`Index` is made (``list_norms``) instead of once per scan step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.analysis.registry import audit_program
from raft_tpu_torch.cluster.kmeans import min_cluster_and_distance
from raft_tpu_torch.cluster.kmeans_balanced import build_hierarchical
from raft_tpu_torch.core.aot import aot
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import (auto_sync_handle, device_of,
                                       resolve_device)
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import _dot_fixed_rows, _row_norms
from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.linalg.reduce import reduce_rows_by_key
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors._build import extend_device, pack_device
from raft_tpu_torch.neighbors._common import (array_to_tensor, empty_result,
                                              expand_probes,
                                              new_ids_of,
                                              scan_probe_lists,
                                              subsample_trainset,
                                              tensor_to_array)
from raft_tpu_torch.random.rng import RngState

_SUPPORTED = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
              DistanceType.InnerProduct, DistanceType.CosineExpanded)
#: the JAX Index leaves, in order (``raft_tpu`` ivf_flat.py:106-111)
ARRAY_FIELDS = ("centers", "list_data", "list_indices", "list_sizes",
                "phys_sizes", "chunk_table")
#: rows per block of the inner-product list assignment and of the
#: stored rows' norms
_ASSIGN_ROWS = 1 << 16
#: the stored vectors' types (the reference's float, int8_t, uint8_t, and
#: the JAX package's bfloat16)
STORAGE_DTYPES = (torch.float32, torch.int8, torch.uint8, torch.bfloat16)


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
    # exact re-rank ratio of the tiered searcher (neighbors.tiering)
    refine_ratio: Optional[int] = None


@dataclasses.dataclass
class Index:
    """IVF-Flat index: chunked padded inverted lists.

    ``list_data``    (n_phys+1, cap, dim) — stored vectors, f32, int8,
                     uint8 or bf16
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
        self.list_norms = row_norms(self.list_data)

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

    def shard(self, comms):
        """This rank's round-robin list shard of the index across *comms*'
        ranks (``ann_mnmg.shard_ivf_flat``)."""
        from raft_tpu_torch.neighbors import ann_mnmg

        return ann_mnmg.shard_ivf_flat(self, comms)


def index_from_arrays(arrays: Dict[str, np.ndarray], metric,
                      adaptive_centers: bool = False, device=None) -> Index:
    """An :class:`Index` from the JAX ``Index`` leaves as numpy arrays under
    their field names (:data:`ARRAY_FIELDS`) — e.g. an index the JAX
    package built."""
    dev = resolve_device(device)
    vals = {name: array_to_tensor(arrays[name], dev)
            for name in ARRAY_FIELDS}
    for name in ARRAY_FIELDS[2:]:
        vals[name] = vals[name].to(torch.int32)
    # the JAX package trains a bfloat16 dataset's centres in bfloat16;
    # they widen exactly
    vals["centers"] = vals["centers"].to(torch.float32)
    expects(vals["list_data"].dtype in STORAGE_DTYPES,
            f"ivf_flat: unsupported storage type {vals['list_data'].dtype}")
    return Index(**vals, metric=DistanceType(int(metric)),
                 adaptive_centers=bool(adaptive_centers))


def index_to_arrays(index: Index) -> Dict[str, np.ndarray]:
    """Inverse of :func:`index_from_arrays` (bfloat16 rows as their bits,
    ``|V2``)."""
    return {name: tensor_to_array(getattr(index, name))
            for name in ARRAY_FIELDS}


def row_norms(list_data: torch.Tensor, device=None) -> torch.Tensor:
    """(n_phys+1, cap) f32 squared norms of the stored rows, summed block
    by block on *device* (default: the rows').  The blocks are the same
    wherever the rows lie, so rows kept on the host get the bits of the
    index resident on *device*."""
    dev = list_data.device if device is None else torch.device(device)
    rows, cap = list_data.shape[:2]
    if not rows:
        return torch.zeros((0, cap), dtype=torch.float32,
                           device=list_data.device)
    step = max(1, _ASSIGN_ROWS // max(cap, 1))
    return torch.cat([
        torch.sum(torch.square(list_data[r:r + step].to(dev).float()),
                  -1).to(list_data.device)
        for r in range(0, rows, step)])


def _ingest(data, device) -> torch.Tensor:
    """*data* as a tensor on *device* in one of :data:`STORAGE_DTYPES`."""
    x = torch.as_tensor(data, device=device)
    expects(x.dtype in STORAGE_DTYPES,
            f"ivf_flat: unsupported dataset type {x.dtype}; the port stores "
            "float32, int8, uint8 or bfloat16")
    return x


def ingest_queries(queries, device) -> torch.Tensor:
    """Queries as float32 on *device*: every storage type, and float16,
    widens exactly."""
    q = torch.as_tensor(queries, device=device)
    expects(q.dtype in STORAGE_DTYPES or q.dtype == torch.float16,
            f"ivf_flat: unsupported query type {q.dtype}")
    return q.float()


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


@auto_sync_handle
def build(params: IndexParams, dataset, ids=None, *, handle=None,
          device=None, engine: Optional[str] = None) -> Index:
    """Train and populate an IVF-Flat index (reference ``ivf_flat::build``):
    the balanced k-means and the assignment under one ``build.train``
    span, the list layout under ``build.populate``.
    *dataset* is an (n, dim) float32 array or tensor; ``device=None`` runs
    on the card.  ``engine`` picks the kernels (``"cuda"``) or their plain
    versions (``"torch"``) for the E-steps; *handle* as
    ``pairwise_distance``'s."""
    dev = device_of(handle, device)
    x = _ingest(dataset, dev)
    expects(x.ndim == 2, "dataset must be (n, dim)")
    expects(params.metric in _SUPPORTED,
            f"ivf_flat: unsupported metric {params.metric}")
    n = x.shape[0]
    n_lists = min(params.n_lists, n)
    xf = x.float()
    with telemetry.span("build.train"):
        centers = _train_centers(params, xf, n_lists, engine)
        labels = (_assign_lists(_queries_of(xf, params.metric), centers,
                                params.metric, engine)
                  if params.add_data_on_build else None)
    index = Index(centers=centers,
                  list_data=torch.zeros((1, 8, x.shape[1]), dtype=x.dtype,
                                        device=dev),
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
        index = _append(index, x, new_ids_of(index, ids, n), labels)
    else:
        expects(ids is None, "ids were passed but add_data_on_build=False "
                "stores no rows — pass them to extend() instead")
    return index


def build_sharded(params: IndexParams, dataset, comms, ids=None, *,
                  device=None, engine: Optional[str] = None):
    """Train once and populate straight into list shards (the JAX
    package's ``build_sharded``): the communicator's first rank trains the
    centres and assigns every row its list, both broadcast; then each rank
    packs ONLY the rows of its round-robin list shard.  The result is an
    ``ann_mnmg.ShardedIndex``, bit for bit ``build(params,
    dataset).shard(comms)`` on the same device and engine, without the
    full padded index on any rank.  Every rank passes the same
    *dataset*."""
    from raft_tpu_torch.neighbors import ann_mnmg

    comms = ann_mnmg._full_axis_comms(comms)
    dev = resolve_device(device)
    x = _ingest(dataset, dev)
    expects(x.ndim == 2, "dataset must be (n, dim)")
    expects(params.metric in _SUPPORTED,
            f"ivf_flat: unsupported metric {params.metric}")
    expects(params.add_data_on_build,
            "build_sharded populates by construction — use "
            "build(add_data_on_build=False) + extend + shard() for "
            "deferred ingest")
    n, dim = x.shape
    n_lists = min(params.n_lists, n)

    def train():
        xf = x.float()
        centers = _train_centers(params, xf, n_lists, engine)
        return centers, _assign_lists(_queries_of(xf, params.metric),
                                      centers, params.metric, engine)

    centers, labels = ann_mnmg.train_on_first(
        comms, [((n_lists, dim), torch.float32, dev),
                ((n,), torch.int32, dev)], train)
    ids = (torch.arange(n, dtype=torch.int32, device=dev) if ids is None
           else torch.as_tensor(ids, device=dev).to(torch.int32))
    expects(ids.shape == (n,), "ids must be (n,)")
    mine = torch.nonzero(labels.long() % comms.get_size()
                         == comms.get_rank()).flatten()
    ((data,), idx, psz, table, _, probe_extra, _) = \
        ann_mnmg.populate_shard(comms, labels, n_lists, (x[mine],), ids,
                                mine)
    aux = ann_mnmg._ivf_flat_aux(comms.get_size(), int(dim),
                                 int(params.metric), n_lists, probe_extra)
    return ann_mnmg.ShardedIndex("ivf_flat", comms, (centers,),
                                 (data, idx, psz, table), aux)


def extend(index: Index, new_vectors, new_ids=None, *,
           engine: Optional[str] = None, in_place: bool = False,
           ladder: bool = False) -> Index:
    """Add vectors to the index (reference ``ivf_flat::extend``): assign
    each to its list (kernel B1 on the card for the L2 family) and append
    it into the list's free tail slots; only lists that overflow grow a
    chunk.  Returns a new :class:`Index`; with ``in_place`` and no list
    overflowing, its blocks are *index*'s own, written in place (O(n_new),
    and *index* holds the new rows too).  *new_ids* default to
    ``size, size + 1, …``; given ones must be new (``ValueError`` on a
    duplicate in the batch or an id already live — replace semantics are
    ``mutable.MutableIndex.upsert``'s).  With ``adaptive_centers`` each
    centre moves to the mean of its old and new members.  With *ladder*
    the blocks grow up the power-of-two ladder (``_common.ladder_layout``:
    the mutable index's delta, whose shapes then change O(log n) times).
    """
    x = _ingest(new_vectors, index.device)
    expects(x.ndim == 2 and x.shape[1] == index.dim, "dim mismatch")
    expects(index.size == 0 or x.dtype == index.list_data.dtype,
            f"extend type {x.dtype} != the index's storage type "
            f"{index.list_data.dtype}")
    ids = new_ids_of(index, new_ids, x.shape[0])
    labels = _assign_lists(_queries_of(x.float(), index.metric),
                           index.centers, index.metric, engine)
    return _append(index, x, ids, labels, in_place, ladder)


def _queries_of(xf: torch.Tensor, metric) -> torch.Tensor:
    """Rows as the assignment ranks them (normalized for cosine)."""
    return (_normalize_rows(xf) if metric == DistanceType.CosineExpanded
            else xf)


def _append(index: Index, x: torch.Tensor, ids: torch.Tensor,
            labels: torch.Tensor, in_place: bool = False,
            ladder: bool = False) -> Index:
    """Lay assigned rows into *index*'s lists (one ``build.populate``
    span): a fresh pack when the index is empty, else an append into
    each list's free tail slots; adaptive centres move."""
    with telemetry.span("build.populate"):
        if index.size:
            data, idx, phys_sizes, sizes, chunk_table, _ = extend_device(
                index.list_data, index.list_indices, index.list_sizes,
                index.chunk_table, x, ids, labels, in_place=in_place,
                ladder=ladder)
        else:
            data, idx, phys_sizes, sizes, chunk_table, _ = pack_device(
                x, ids, labels, index.n_lists, ladder)
        centers = index.centers
        if index.adaptive_centers:
            sums = reduce_rows_by_key(x.float(), labels, index.n_lists)
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


@audit_program(
    "ivf_flat.search_batch", transient_bytes=4 << 20,
    notes="the whole one-batch IVF-Flat search (coarse product, "
          "top-n_probes, probe scan) — the serving engine's backend")
def _search_batch_impl(queries: torch.Tensor, index: Index, k: int,
                       n_probes: int, sqrt: bool, engine: str,
                       tombstones: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query batch: coarse ranking → top-n_probes (one
    ``ivf_flat.coarse`` span) → probe scan (rows whose id is set in
    *tombstones* masked in the scan)."""
    with telemetry.span("ivf_flat.coarse"):
        cd = _coarse_distances(queries, index.centers, index.metric)
        _, probe_ids = select_k(cd, n_probes, select_min=True,
                                engine=engine)
    return _probe_search_impl(queries, probe_ids, index, k, sqrt, engine,
                              tombstones)


def _probe_search_impl(queries: torch.Tensor, probe_ids: torch.Tensor,
                       index: Index, k: int, sqrt: bool, engine: str,
                       tombstones: Optional[torch.Tensor] = None,
                       extra: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score the probed lists of every query and keep the best k, under one
    ``ivf_flat.scan`` span (never one a step); *extra* bounds the scan's
    steps as ``expand_probes`` does (None: the index's continuation
    chunks)."""
    metric = index.metric
    is_ip = metric == DistanceType.InnerProduct
    is_cos = metric == DistanceType.CosineExpanded
    q_sq = _row_norms(queries)[:, None]
    qrow = queries[:, None, :]

    def score_tile(rows):
        data = index.list_data[rows].float()                # (nq, cap, dim)
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

    with telemetry.span("ivf_flat.scan"):
        phys = expand_probes(probe_ids, index.chunk_table,
                             index.list_data.shape[0], extra=extra)
        best_d, best_i = scan_probe_lists(
            phys, score_tile, index.list_indices, index.phys_sizes, k,
            select_min=not is_ip, dtype=torch.float32, engine=engine,
            tombstones=tombstones)
        if sqrt:
            best_d = torch.sqrt(torch.clamp_min(best_d, 0.0))
    return best_d, best_i


#: the one-batch search program, keyed per signature (``raft_tpu/neighbors/
#: ivf_flat.py:460`` ``_search_batch_aot``); ``search`` and the serving
#: engine's IVF-Flat backend dispatch it
_search_batch_aot = aot(_search_batch_impl, static_argnums=(2, 3, 4, 5))

#: the probe-scoring program (explicit probe ids), keyed per signature
#: (``raft_tpu/neighbors/ivf_flat.py:468`` ``_probe_search_aot``): each
#: tiered cold tile dispatches it
_probe_search_aot = aot(_probe_search_impl, static_argnums=(3, 4, 5))


@auto_sync_handle
def search(params: SearchParams, index: Index, queries, k: int, *,
           batch_size_query: int = 1024, handle=None,
           engine: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search the index (reference ``ivf_flat::search``): returns
    (distances (nq, k) f32, indices (nq, k) int32) on the index's device.
    Queries of any storage type, or float16, are widened to float32.
    ``engine`` picks kernel B2 (``"cuda"``) or its plain version
    (``"torch"``) for the selections; the default follows the device.
    *handle*: its main stream takes the work, as the JAX package's
    (one stream, no pool)."""
    q = ingest_queries(queries, index.device)
    expects(q.ndim == 2 and q.shape[1] == index.dim, "query dim mismatch")
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
        d, i = _search_batch_aot(qb, index, int(k), int(n_probes), sqrt,
                                 engine)
        out_d.append(d[:n_valid])
        out_i.append(i[:n_valid])
    if len(out_d) == 1:
        return out_d[0], out_i[0]
    return torch.cat(out_d), torch.cat(out_i)


@auto_sync_handle
def build_and_search(dataset, queries, k: int,
                     index_params: Optional[IndexParams] = None,
                     search_params: Optional[SearchParams] = None, *,
                     handle=None, device=None, engine: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build an index over *dataset* and search it with *queries* in one
    call (the JAX package's convenience one-shot)."""
    index = build(index_params or IndexParams(), dataset, handle=handle,
                  device=device, engine=engine)
    return search(search_params or SearchParams(), index, queries, k,
                  handle=handle, engine=engine)
