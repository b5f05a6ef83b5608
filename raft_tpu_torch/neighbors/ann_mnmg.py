"""Sharded multi-rank ANN search: IVF-Flat, IVF-PQ and brute force across
the ranks of one communicator (port of ``raft_tpu/neighbors/ann_mnmg.py``:
``ShardedIndex`` :101, ``_partition`` :147, the aux builders :207/:217,
``shard_ivf_flat`` :238, ``shard_ivf_pq`` :267, ``shard_brute_force``
:298, ``ReplicaSet`` :350, ``replicate`` :393, ``_merge_one_allgather``
:436, the shard programs :465/:494/:519 with their masked variants,
``ShardedSearcher`` :565, ``_ingest`` :674 and ``search`` :692).

The port runs one process per rank.  A rank's :class:`ShardedIndex`
holds its OWN shard's blocks (``stacked``), the ``replicated`` tables
equal on every rank, and ``aux``, byte for byte the JAX index's (world
included):

* **Partitioning** — inverted lists are assigned round-robin (list l →
  rank l % world).  The coarse centres (IVF-PQ: also rotation, codebooks
  and ``list_adc``) replicate; a rank keeps the physical rows of its lists
  with its local chunk table (lists owned elsewhere point at the local
  dummy row) and the per-shard continuation budget ``probe_extra``, the
  worst case over the ranks, so every rank scans the same number of
  steps.  Brute force splits rows contiguously; ragged counts pad with
  huge-magnitude sentinel rows under the float L2 metrics only.
* **Search** — each rank runs the single-device pieces themselves: the
  coarse step (replicated, identical everywhere), then the probe scan on
  its lists (IVF-PQ: kernel B4's scan mode; IVF-Flat: the per-step scan
  with kernel B2; brute force: the tile loop, kernel B5 under L1), then
  ONE allgather of the packed (nq, 2k) distances and ids and the part
  merge, earlier ranks winning ties.  The L2Sqrt root is taken after the
  merge.  At world 1 the collective is an identity and the bits are the
  single-device bits.  The masked variant (``ShardedSearcher(masked=
  True)``, what ``neighbors.mutable`` serves a sharded main through)
  threads a tombstone bitmap into each rank's scan and leaves the root
  to its caller.
* **Replicas** — :func:`replicate` carves the world into R groups
  (``Comms.replica_split``); a rank shards a full copy into its own
  group only and keeps every group's aux and ranks, so the serving
  engine's leader can route a batch to any group.  Every group runs the
  same partition arithmetic, so any group answers a batch with the same
  bits.

Every rank calls :func:`search` / :meth:`ShardedSearcher.dispatch` with
the same queries (they are collectives).  ``serve.ServeEngine`` drives
them from one leader rank (see its module doc).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.analysis.registry import audit_program
from raft_tpu_torch.comms.comms import Comms, ReplicaLayout, as_comms
from raft_tpu_torch.core.aot import aot
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import accum_dtype, as_float_tensor
from raft_tpu_torch.matrix.select_k import merge_sorted_parts, select_k
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors._common import empty_result

#: query rows per batch of :func:`search` (the JAX default)
_QUERY_BATCH = 1024


def _full_axis_comms(comms) -> Comms:
    comms = as_comms(comms)
    expects(isinstance(comms, Comms),
            "sharded ANN needs a Comms (or a Handle carrying one)")
    # a split communicator's size is group-local: the partition arithmetic
    # needs an unsplit one (a replica group's own communicator is one)
    expects(getattr(comms, "groups", None) is None,
            "sharded ANN needs a full (non-split) communicator")
    return comms


# ---------------------------------------------------------------------------
# the sharded index container


@dataclasses.dataclass
class ShardedIndex:
    """A list- (or row-) partitioned ANN index across the ranks of one
    communicator, as this rank holds it.

    ``replicated``: the global tables every rank reads (IVF-Flat:
    ``(centers,)``; IVF-PQ: ``(centers, rotation, codebooks, list_adc)``;
    brute force: none).  ``stacked``: this rank's blocks (IVF-Flat:
    ``(list_data, list_indices, phys_sizes, chunk_table)``; IVF-PQ:
    ``(list_codes, list_indices, phys_sizes, chunk_table, owner,
    list_csum)``; brute force: ``(rows,)``), each the JAX index's stacked
    leaf at this rank's row.  ``aux``: the static search configuration.
    Build with ``Index.shard`` / :func:`shard_ivf_flat` /
    :func:`shard_ivf_pq` / :func:`shard_brute_force` or
    ``build_sharded``; search with :func:`search` or through
    ``serve.ServeEngine``."""

    kind: str                    # "ivf_flat" | "ivf_pq" | "brute_force"
    comms: Comms
    replicated: Tuple[torch.Tensor, ...]
    stacked: Tuple[torch.Tensor, ...]
    aux: Dict[str, Any]
    _local: Any = dataclasses.field(default=None, init=False, repr=False)

    @property
    def world(self) -> int:
        return int(self.aux["world"])

    @property
    def dim(self) -> int:
        return int(self.aux["dim"])

    @property
    def n_lists(self) -> int:
        return int(self.aux.get("n_lists", 0))

    @property
    def metric(self) -> DistanceType:
        return DistanceType(self.aux["metric"])

    @property
    def device(self) -> torch.device:
        return self.stacked[0].device

    def local_index(self):
        """This rank's shard as a single-device index of its family (the
        global model, the local blocks), made once: the single-device scan
        runs on it unchanged."""
        if self._local is None and self.kind != "brute_force":
            self._local = _local_index(self)
        return self._local

    def search(self, queries, k: int, params=None, **kw):
        return search(self, queries, k, params, **kw)

    def searcher(self, k: int, params=None,
                 engine: Optional[str] = None) -> "ShardedSearcher":
        return ShardedSearcher(self, k, params, engine=engine)


def _local_sizes(phys_sizes: torch.Tensor, table: torch.Tensor):
    """(n_lists,) live rows of each list on this rank (0 for a list owned
    elsewhere: its chunks are all the local dummy, whose size is 0)."""
    return phys_sizes[table.long()].sum(dim=1).to(torch.int32)


def _local_index(sh: ShardedIndex):
    if sh.kind == "ivf_flat":
        (centers,) = sh.replicated
        data, idx, psz, table = sh.stacked
        return ivf_flat.Index(centers=centers, list_data=data,
                              list_indices=idx,
                              list_sizes=_local_sizes(psz, table),
                              phys_sizes=psz, chunk_table=table,
                              metric=sh.metric)
    centers, rotation, codebooks, list_adc = sh.replicated
    codes, idx, psz, table, owner, csum = sh.stacked
    return ivf_pq.Index(centers=centers, rotation=rotation,
                        codebooks=codebooks, list_codes=codes,
                        list_indices=idx, list_sizes=_local_sizes(psz, table),
                        phys_sizes=psz, chunk_table=table, owner=owner,
                        list_adc=list_adc, list_csum=csum, metric=sh.metric,
                        codebook_kind=ivf_pq.CodebookKind(
                            sh.aux["codebook_kind"]),
                        pq_bits=int(sh.aux["pq_bits"]),
                        dataset_dtype=sh.aux["dataset_dtype"])


# ---------------------------------------------------------------------------
# partitioning


def _partition(chunk_table_h: np.ndarray, n_rows: int, world: int):
    """Round-robin partition of a chunked-list layout; *n_rows* is the
    global physical block's leading dim (n_phys + 1).

    Returns ``(gather, local_tables, probe_extra, local_rows)``:
    ``gather`` (world, local_rows+1) maps each rank's local physical slot
    to a GLOBAL physical row (padding slots and the local dummy map to the
    global dummy, whose size is 0); ``local_tables`` (world, n_lists,
    max_chunks) int32 is each rank's logical → local chunk table (lists
    owned elsewhere → the local dummy); ``probe_extra`` is the most local
    continuation chunks of any rank, the scan budget every rank uses."""
    n_lists, max_chunks = chunk_table_h.shape
    dummy = n_rows - 1
    lists = np.arange(n_lists)
    shard_of = lists % world
    real = chunk_table_h != dummy
    counts = real.sum(axis=1)
    n_local = np.array([int(counts[shard_of == s].sum())
                        for s in range(world)], np.int64)
    local_rows = int(n_local.max()) if world else 0
    gather = np.full((world, local_rows + 1), dummy, np.int64)
    local_tables = np.full((world, n_lists, max_chunks), local_rows,
                           np.int32)
    for s in range(world):
        ls = lists[shard_of == s]
        rs, cs = np.nonzero(real[ls])            # list-major, chunk ascending
        glob = chunk_table_h[ls[rs], cs]
        gather[s, :glob.size] = glob
        local_tables[s, ls[rs], cs] = np.arange(glob.size, dtype=np.int32)
    probe_extra = int(max(
        (int((counts[shard_of == s] - 1).clip(min=0).sum())
         for s in range(world)), default=0))
    return gather, local_tables, probe_extra, local_rows


def _ivf_flat_aux(world: int, dim: int, metric: int, n_lists: int,
                  probe_extra: int) -> Dict[str, Any]:
    """The IVF-Flat aux — one builder for :func:`shard_ivf_flat` and
    ``ivf_flat.build_sharded``."""
    return {"world": world, "dim": dim, "metric": metric,
            "n_lists": n_lists, "probe_extra": probe_extra}


def _ivf_pq_aux(world: int, dim: int, metric: int, n_lists: int,
                probe_extra: int, pq_bits: int, codebook_kind: int,
                dataset_dtype: str, pq_dim: int,
                max_chunks: int) -> Dict[str, Any]:
    """The IVF-PQ aux — one builder for :func:`shard_ivf_pq` and
    ``ivf_pq.build_sharded``.  ``cap_n_phys`` / ``cap_max_chunks`` feed
    the per-shard batch cap (the scan budget is n_probes + probe_extra)."""
    return {"world": world, "dim": dim, "metric": metric,
            "n_lists": n_lists, "probe_extra": probe_extra,
            "pq_bits": pq_bits, "codebook_kind": codebook_kind,
            "dataset_dtype": dataset_dtype, "pq_dim": pq_dim,
            "cap_n_phys": int(n_lists + probe_extra),
            "cap_max_chunks": int(max_chunks)}


def _take_rows(leaf: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """This rank's physical rows of a global block (a gather of the local
    rows only)."""
    return leaf[torch.as_tensor(rows, device=leaf.device)]


def _my_partition(index, comms: Comms, n_rows: int):
    world = comms.get_size()
    rank = comms.get_rank()
    gather, tables, probe_extra, _ = _partition(
        index.chunk_table.cpu().numpy(), n_rows, world)
    table = torch.as_tensor(tables[rank], device=index.device)
    return world, gather[rank], table, probe_extra


def shard_ivf_flat(index: ivf_flat.Index, comms) -> ShardedIndex:
    """This rank's round-robin list shard of an IVF-Flat index (lists l
    with l % world == rank); the centres replicate."""
    comms = _full_axis_comms(comms)
    world, rows, table, probe_extra = _my_partition(
        index, comms, index.list_data.shape[0])
    stacked = (_take_rows(index.list_data, rows),
               _take_rows(index.list_indices, rows),
               _take_rows(index.phys_sizes, rows), table)
    aux = _ivf_flat_aux(world, index.dim, int(index.metric), index.n_lists,
                        probe_extra)
    return ShardedIndex("ivf_flat", comms, (index.centers,), stacked, aux)


def shard_ivf_pq(index: ivf_pq.Index, comms) -> ShardedIndex:
    """This rank's round-robin list shard of an IVF-PQ index; the trained
    model and ``list_adc`` replicate, and probe ids stay global list ids,
    so the LUT stage runs against the full tables while the scan touches
    only local rows."""
    comms = _full_axis_comms(comms)
    world, rows, table, probe_extra = _my_partition(
        index, comms, index.list_codes.shape[0])
    stacked = (_take_rows(index.list_codes, rows),
               _take_rows(index.list_indices, rows),
               _take_rows(index.phys_sizes, rows), table,
               _take_rows(index.owner, rows),
               _take_rows(index.list_csum, rows))
    replicated = (index.centers, index.rotation, index.codebooks,
                  index.list_adc)
    aux = _ivf_pq_aux(world, index.dim, int(index.metric), index.n_lists,
                      probe_extra, int(index.pq_bits),
                      int(index.codebook_kind), index.dataset_dtype,
                      int(index.pq_dim), int(index.chunk_table.shape[1]))
    return ShardedIndex("ivf_pq", comms, replicated, stacked, aux)


def shard_brute_force(dataset, comms, metric=DistanceType.L2SqrtExpanded,
                      metric_arg: float = 2.0,
                      batch_size_index: int = 16384, *,
                      device=None) -> ShardedIndex:
    """This rank's contiguous row block of a dense (n, dim) matrix (the
    OPG split of ``knn_mnmg``): global ids are ``rank·rows_per + local``.
    A ragged row count pads with huge-magnitude sentinel rows, which rank
    worst under the float L2 metrics (only there: no finite row is sure to
    lose under inner product or cosine, and integer types overflow the
    filler).  Only this rank's rows go to *device* (default: the card)."""
    comms = _full_axis_comms(comms)
    world, rank = comms.get_size(), comms.get_rank()
    x = dataset if isinstance(dataset, torch.Tensor) else np.asarray(dataset)
    expects(x.ndim == 2, "brute-force index must be (n, dim)")
    n = int(x.shape[0])
    metric = brute_force._resolve_metric(metric)
    rows_per = -(-n // world)
    lo, hi = rank * rows_per, min((rank + 1) * rows_per, n)
    dev = (x.device if isinstance(x, torch.Tensor) and device is None
           else resolve_device(device))
    mine = as_float_tensor(x[lo:hi], dev)
    if rows_per * world != n:
        expects(metric in (DistanceType.L2Expanded,
                           DistanceType.L2SqrtExpanded)
                and mine.dtype.is_floating_point,
                f"n ({n}) not divisible by world ({world}): sentinel row "
                f"padding is only sound for float L2 metrics, not "
                f"{DistanceType(metric).name}/{mine.dtype} — pad the "
                "dataset to a multiple of world first")
        pad = rows_per - mine.shape[0]
        if pad:
            filler = torch.full((pad, mine.shape[1]), 1e30,
                                dtype=torch.float32, device=dev)
            mine = torch.cat([mine, filler.to(mine.dtype)])
    aux = {"world": world, "dim": int(x.shape[1]), "metric": int(metric),
           "metric_arg": float(metric_arg), "rows_per": int(rows_per),
           "n_rows": int(n), "tile": int(min(batch_size_index, rows_per))}
    return ShardedIndex("brute_force", comms, (), (mine,), aux)


def train_on_first(comms: Comms, specs, make) -> Tuple[torch.Tensor, ...]:
    """Tensors made ONCE, by ``make()`` on the communicator's first rank,
    and broadcast to every rank (``build_sharded``'s trained model): every
    other rank allocates *specs* — ``(shape, dtype, device)`` each — and
    receives.  A world of one just runs ``make()``."""
    if comms.get_size() == 1:
        return tuple(make())
    if comms.get_rank() == 0:
        made = tuple(make())
    else:
        made = tuple(torch.empty(shape, dtype=dt, device=dev)
                     for shape, dt, dev in specs)
    return tuple(comms.bcast(t, root=0) for t in made)


def populate_shard(comms: Comms, labels: torch.Tensor, n_lists: int,
                   payloads, ids: torch.Tensor, mine: torch.Tensor):
    """Pack this rank's list shard straight from its rows: *labels* (n,)
    are every row's lists, *payloads* the rows of this rank (``mine``, in
    dataset order) side by side, *ids* every row's id.  The global layout
    comes from the list counts alone; the round-robin partition of it
    (:func:`_partition`) places each row at the local slot ``build(...)
    .shard(comms)`` gives it, so the two are the same blocks.  Returns
    ``(datas, idx, phys_sizes, chunk_table, owner, probe_extra,
    max_chunks)`` of this rank."""
    from raft_tpu_torch.neighbors import _build
    from raft_tpu_torch.neighbors._common import chunk_layout

    world, rank = comms.get_size(), comms.get_rank()
    dev = labels.device
    lay = chunk_layout(_build._counts(labels, n_lists))
    gather, tables, probe_extra, local_rows = _partition(
        lay.chunk_table, lay.n_phys + 1, world)
    table = torch.as_tensor(tables[rank], device=dev)
    lab = labels[mine]
    # every row of a list is on the list's rank, in dataset order: its
    # rank within the list here is its rank within the list globally
    flat = _build.list_slots(lab, torch.zeros(n_lists, dtype=torch.int32,
                                              device=dev),
                             table, lay.cap, n_lists)
    datas, idx = _build.scatter_new(tuple(payloads), ids[mine], flat,
                                    local_rows + 1, lay.cap)
    rows = gather[rank]
    return (datas, idx, torch.as_tensor(lay.phys_sizes[rows], device=dev),
            table, torch.as_tensor(lay.owner[rows], device=dev),
            int(probe_extra), int(lay.chunk_table.shape[1]))


# ---------------------------------------------------------------------------
# replica groups


@dataclasses.dataclass(frozen=True)
class ReplicaSet:
    """R full :class:`ShardedIndex` copies on a 2D (shard × replica) carve
    of one communicator, as one rank holds them: ``local`` is the copy of
    this rank's group (``replica``), sharded over the group's ranks; every
    group's aux is in ``auxes`` and its ranks in ``layout.groups[r].ranks``
    — what the serving engine's leader needs to route a batch to any
    group.  A batch runs on ONE group, so R groups serve R batches at
    once; each group makes one allgather per batch on its own
    communicator."""

    kind: str
    layout: ReplicaLayout
    replica: int
    local: ShardedIndex
    auxes: Tuple[Dict[str, Any], ...]

    @property
    def n_replicas(self) -> int:
        return self.layout.n_replicas

    @property
    def dim(self) -> int:
        return self.local.dim

    @property
    def metric(self) -> DistanceType:
        return self.local.metric

    @property
    def aux(self) -> Dict[str, Any]:
        return self.local.aux

    @property
    def device(self) -> torch.device:
        return self.local.device

    def ranks(self, replica: int) -> Tuple[int, ...]:
        """The global ranks of group *replica*, in shard order."""
        return tuple(self.layout.groups[replica].ranks)


def replicate(index, comms_or_layout, n_replicas: Optional[int] = None, *,
              metric=DistanceType.L2SqrtExpanded, metric_arg: float = 2.0,
              batch_size_index: int = 16384, device=None) -> ReplicaSet:
    """Carve *comms_or_layout* into replica groups
    (:meth:`Comms.replica_split`, a collective, unless a
    :class:`ReplicaLayout` is passed) and shard one full copy of *index*
    into this rank's group.  *index* picks the kind as ``ServeEngine``
    does: an ``ivf_flat.Index``, an ``ivf_pq.Index`` or a dense (n, dim)
    matrix (brute force; ``metric`` / ``metric_arg`` /
    ``batch_size_index`` / ``device`` apply)."""
    if isinstance(comms_or_layout, ReplicaLayout):
        expects(n_replicas is None
                or int(n_replicas) == comms_or_layout.n_replicas,
                "replicate: n_replicas disagrees with the provided layout")
        layout = comms_or_layout
    else:
        expects(n_replicas is not None,
                "replicate: pass n_replicas (or a prebuilt ReplicaLayout)")
        layout = as_comms(comms_or_layout).replica_split(int(n_replicas))
    mine = layout.parent.get_global_rank() // layout.group_size
    group = layout.groups[mine]
    if isinstance(index, ivf_flat.Index):
        local = shard_ivf_flat(index, group)
    elif isinstance(index, ivf_pq.Index):
        local = shard_ivf_pq(index, group)
    else:
        local = shard_brute_force(index, group, metric, metric_arg,
                                  batch_size_index, device=device)
    return ReplicaSet(local.kind, layout, mine, local,
                      tuple(dict(local.aux)
                            for _ in range(layout.n_replicas)))


# ---------------------------------------------------------------------------
# the one-allgather cross-rank merge


def _allgather_packed(comms: Comms, d: torch.Tensor, i: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (rows, k) distances and ids as (world, rows, k) parts,
    moved by ONE allgather of the (rows, 2k) packed payload (float64
    distances carry the ids widened exactly)."""
    i = i.to(torch.int32)
    # exempt(dtype-drift): float64 distances carry int32 ids exactly
    if d.dtype == torch.float64:
        # exempt(dtype-drift): float64 distances carry int32 ids exactly
        parts = comms.allgather(torch.cat([d, i.to(torch.float64)], dim=1))
        return parts[..., :k], parts[..., k:].to(torch.int32)
    parts = comms.allgather(torch.cat([d.to(torch.float32),
                                       i.view(torch.float32)], dim=1))
    return parts[..., :k], parts[..., k:].contiguous().view(torch.int32)


def _merge_one_allgather(comms: Comms, d: torch.Tensor, i: torch.Tensor,
                         k: int, select_min: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-rank (nq, k) top-k runs with EXACTLY ONE collective.
    ``Comms.collective_calls`` records the allgather and its nq·2k·4
    bytes."""
    pd, pi = _allgather_packed(comms, d, i, k)
    return merge_sorted_parts(pd, pi, k=k, select_min=select_min)


# ---------------------------------------------------------------------------
# the per-kind shard programs: the local scan, the merge, the deferred root


def _ivf_flat_scan(local, q: torch.Tensor, k: int, n_probes: int,
                   engine: str, extra: int,
                   tombstones: Optional[torch.Tensor] = None):
    """This rank's IVF-Flat scan: the replicated coarse step, then the
    probe scan of its own lists (squared distances)."""
    q = q.float()
    cd = ivf_flat._coarse_distances(q, local.centers, local.metric)
    _, probes = select_k(cd, n_probes, select_min=True, engine=engine)
    return ivf_flat._probe_search_impl(q, probes, local, k, False, engine,
                                       tombstones, extra=extra)


def _ivf_pq_scan(local, q: torch.Tensor, k: int, n_probes: int,
                 lut_dtype: str, int_dtype: str, hoisted: bool,
                 engines: Tuple[str, str], extra: int,
                 tombstones: Optional[torch.Tensor] = None):
    """This rank's IVF-PQ scan (squared distances)."""
    q = q.float()
    probes = ivf_pq.coarse_probes(q, local, n_probes, engines[0])
    return ivf_pq._search_batch_impl(q, probes, local, k, lut_dtype,
                                     engines, tombstones, False,
                                     int_dtype=int_dtype, hoisted=hoisted,
                                     extra=extra)


def _brute_force_scan(xs: torch.Tensor, q: torch.Tensor, k: int,
                      scan_metric: DistanceType, metric_arg: float,
                      tile: int, select_min: bool, engine: Optional[str],
                      offset: int):
    """This rank's brute-force scan of its rows, ids made global."""
    d, i = brute_force._knn_scan_impl(xs, q.to(xs.dtype), k, scan_metric,
                                      metric_arg, tile, select_min, engine)
    return d, i + offset


def _fold_parts(part_d: torch.Tensor, part_i: torch.Tensor, k: int,
                select_min: bool, root: Optional[str]):
    """The gathered runs folded in rank order, then the deferred root
    (``"clamp"``: √max(d, 0), the IVF kinds'; ``"plain"``: √d, knn's
    epilogue; None: squared, for a caller that merges further)."""
    d, i = merge_sorted_parts(part_d, part_i, k=k, select_min=select_min)
    if root == "clamp":
        d = torch.sqrt(torch.clamp_min(d, 0.0))
    elif root == "plain":
        d = torch.sqrt(d)
    return d, i


#: each rank's own programs, keyed per signature (the reference keys the
#: whole ``shard_map`` program with ``MeshAotFunction``, ann_mnmg.py:541-560;
#: the port runs one process per rank, so a rank keys its scan and its
#: fold, and the one allgather between them is no program of its own)
_ivf_flat_scan_aot = aot(_ivf_flat_scan, static_argnums=(2, 3, 4, 5))
_ivf_pq_scan_aot = aot(_ivf_pq_scan, static_argnums=(2, 3, 4, 5, 6, 7, 8))
_brute_force_scan_aot = aot(_brute_force_scan,
                            static_argnums=(2, 3, 4, 5, 6, 7, 8))
_fold_parts_aot = aot(_fold_parts, static_argnums=(2, 3, 4))


def _gather_fold(sh: ShardedIndex, d: torch.Tensor, i: torch.Tensor, k: int,
                 root: Optional[str]):
    """ONE allgather of this rank's run, then the keyed fold."""
    pd, pi = _allgather_packed(sh.comms, d, i, k)
    return _fold_parts_aot(pd, pi, k, sh.metric != DistanceType.InnerProduct,
                           root)


def _ivf_flat_program(sh: ShardedIndex, q: torch.Tensor, k: int,
                      n_probes: int, engine: str,
                      tombstones: Optional[torch.Tensor] = None,
                      root: bool = True):
    d, i = _ivf_flat_scan_aot(sh.local_index(), q, k, n_probes, engine,
                              sh.aux["probe_extra"], tombstones)
    return _gather_fold(sh, d, i, k, _root_mode(sh, root))


def _ivf_pq_program(sh: ShardedIndex, q: torch.Tensor, k: int,
                    n_probes: int, lut_dtype: str, int_dtype: str,
                    hoisted: bool, engines: Tuple[str, str],
                    tombstones: Optional[torch.Tensor] = None,
                    root: bool = True):
    d, i = _ivf_pq_scan_aot(sh.local_index(), q, k, n_probes, lut_dtype,
                            int_dtype, hoisted, engines,
                            sh.aux["probe_extra"], tombstones)
    return _gather_fold(sh, d, i, k, _root_mode(sh, root))


def _root_mode(sh: ShardedIndex, root: bool) -> Optional[str]:
    return ("clamp" if root and sh.metric == DistanceType.L2SqrtExpanded
            else None)


def _brute_force_statics(sh: ShardedIndex):
    """(scan metric, metric arg, tile, select_min, id offset, root) of a
    brute-force shard: L2Sqrt scans squared and roots after the merge."""
    defer = sh.metric == DistanceType.L2SqrtExpanded
    return (DistanceType.L2Expanded if defer else sh.metric,
            sh.aux["metric_arg"], sh.aux["tile"],
            sh.metric != DistanceType.InnerProduct,
            sh.comms.get_rank() * sh.aux["rows_per"],
            "plain" if defer else None)


def _brute_force_program(sh: ShardedIndex, q: torch.Tensor, k: int,
                         engine: Optional[str]):
    (xs,) = sh.stacked
    scan_metric, arg, tile, select_min, offset, root = \
        _brute_force_statics(sh)
    d, i = _brute_force_scan_aot(xs, q, k, scan_metric, arg, tile,
                                 select_min, engine, offset)
    # knn's deferred-root epilogue, after the merge
    return _gather_fold(sh, d, i, k, root)


#: one allgather of the packed (64, 2k) float32 merge payload at world 1
_SHARDED_AUDIT_BYTES = 64 * 2 * 8 * 4


class ShardedSearcher:
    """The batch program of one (sharded index, k, params) serving key —
    what ``serve.ServeEngine``'s sharded and replica backends run.
    ``dispatch(qb)`` searches one pre-bucketed (bucket, dim) batch on
    every rank of the index's communicator (a collective: every rank
    calls it with the same batch) and returns (d (bucket, k), i (bucket,
    k)) on every rank; ``warm(bucket, dtype)`` runs it once on zeros, so
    the kernels are built and the allocator has seen the shape.
    ``engine`` picks the kernels or their plain versions (default: by
    device).

    ``masked=True`` is the variant ``neighbors.mutable`` serves a sharded
    main through: ``dispatch(qb, tombstones)`` threads a tombstone bitmap
    into each rank's scan (IVF-Flat: the probe scan's mask; IVF-PQ: kernel
    B4's scan mode with the bitmap), keyed by global row id, so the one
    copy every rank holds serves every shard; and it returns SQUARED
    L2Sqrt distances, because the mutable search merges main ∪ delta
    before it takes the root.  Brute force has no masked variant."""

    def __init__(self, sharded: ShardedIndex, k: int, params=None, *,
                 engine: Optional[str] = None, masked: bool = False):
        expects(k >= 1, "k must be >= 1")
        self.sharded = sharded
        self.k = int(k)
        self.masked = bool(masked)
        aux = sharded.aux
        dev = sharded.device
        from raft_tpu_torch.kernels.engine import resolve_engine

        if sharded.kind == "ivf_flat":
            p = params or ivf_flat.SearchParams()
            self.n_probes = int(min(p.n_probes, aux["n_lists"]))
            eng = resolve_engine("select_k", dev, engine=engine)
            self.fn = _ivf_flat_program
            self._args = (self.n_probes, eng)
        elif sharded.kind == "ivf_pq":
            p = params or ivf_pq.SearchParams()
            ivf_pq.check_search_params(p)
            self.n_probes = int(min(p.n_probes, aux["n_lists"]))
            self.hoisted = ivf_pq._resolve_hoisted(p)
            self.lut_dtype = p.lut_dtype
            engines = (resolve_engine("select_k", dev, engine=engine),
                       resolve_engine("pq_lut", dev, engine=engine))
            self.fn = _ivf_pq_program
            self._args = (self.n_probes, p.lut_dtype,
                          p.internal_distance_dtype, self.hoisted, engines)
        else:
            expects(sharded.kind == "brute_force",
                    f"unknown sharded kind {sharded.kind!r}")
            expects(not self.masked, "tombstone masking needs an IVF kind "
                    "(brute force has no id-carrying probe scan)")
            expects(params is None, "brute_force sharded search takes no "
                    "SearchParams (the metric rides the ShardedIndex)")
            expects(self.k <= aux["n_rows"],
                    f"k={k} must be <= n_index={aux['n_rows']}")
            self.fn = _brute_force_program
            self._args = (engine,)

    @property
    def dim(self) -> int:
        return self.sharded.dim

    @property
    def device(self) -> torch.device:
        return self.sharded.device

    def warm(self, bucket: int, dtype=torch.float32) -> None:
        self.dispatch(torch.zeros((int(bucket), self.dim), dtype=dtype,
                                  device=self.device))

    def warm_local(self, bucket: int,
                   tombstones: Optional[torch.Tensor] = None,
                   dtype=torch.float32) -> None:
        """Warm this rank's keyed programs at *bucket* — the scan (with
        *tombstones*' signature on a masked searcher) and the fold of
        :meth:`dispatch` — without the allgather between them, so one
        rank alone can run it (a mutable write's rewarm); nothing runs
        where the scan's signature is warm."""
        sh = self.sharded
        q = torch.zeros((int(bucket), self.dim), dtype=dtype,
                        device=self.device)
        if sh.kind == "ivf_flat":
            scan = _ivf_flat_scan_aot
            args = (sh.local_index(), q, self.k, *self._args,
                    sh.aux["probe_extra"], tombstones)
            root = _root_mode(sh, not self.masked)
        elif sh.kind == "ivf_pq":
            scan = _ivf_pq_scan_aot
            args = (sh.local_index(), q, self.k, *self._args,
                    sh.aux["probe_extra"], tombstones)
            root = _root_mode(sh, not self.masked)
        else:
            (xs,) = sh.stacked
            scan_metric, arg, tile, select_min, offset, root = \
                _brute_force_statics(sh)
            scan = _brute_force_scan_aot
            args = (xs, q, self.k, scan_metric, arg, tile, select_min,
                    *self._args, offset)
        if scan.is_warm(*args):
            # every run of this scan was followed by its fold
            return
        d, i = scan(*args)
        # the fold's inputs as the allgather gives them: (world, bucket, k)
        # float32 runs (float64 ones stay float64) and int32 ids
        # exempt(dtype-drift): float64 runs stay float64, as the allgather packs them
        part = torch.float64 if d.dtype == torch.float64 else torch.float32
        w = sh.comms.get_size()
        fold = (d.to(part).expand(w, *d.shape),
                i.to(torch.int32).expand(w, *i.shape), self.k,
                sh.metric != DistanceType.InnerProduct, root)
        if not _fold_parts_aot.is_warm(*fold):
            _fold_parts_aot(*fold)

    # the four world-1 audit programs (inputs: analysis/programs.py)
    @audit_program("ann_mnmg.ivf_flat_sharded", comms=True, collectives=1,
                   collective_bytes=_SHARDED_AUDIT_BYTES,
                   notes="a sharded IVF-Flat batch: coarse step, this "
                         "rank's probe scan, ONE allgather merge (world 1)")
    @audit_program("ann_mnmg.brute_force_sharded", comms=True,
                   collectives=1, collective_bytes=_SHARDED_AUDIT_BYTES,
                   notes="row-sharded brute force: this rank's scan, ONE "
                         "allgather merge (world 1)")
    @audit_program("ann_mnmg.ivf_pq_sharded", comms=True, collectives=1,
                   collective_bytes=_SHARDED_AUDIT_BYTES,
                   notes="a sharded IVF-PQ batch (hoisted-LUT scan), ONE "
                         "allgather merge (world 1)")
    @audit_program("ann_mnmg.ivf_flat_replica_group", comms=True,
                   collectives=1, collective_bytes=_SHARDED_AUDIT_BYTES,
                   notes="one replica group's batch (one group of one rank "
                         "at world 1): ONE allgather on the group's "
                         "communicator")
    def dispatch(self, qb: torch.Tensor,
                 tombstones: Optional[torch.Tensor] = None):
        """One pre-bucketed batch on every rank; a masked searcher takes
        the replicated bitmap and returns squared L2Sqrt distances."""
        if not self.masked:
            return self.fn(self.sharded, qb.to(self.device), self.k,
                           *self._args)
        return self.fn(self.sharded, qb.to(self.device), self.k, *self._args,
                       tombstones=tombstones, root=False)


# ---------------------------------------------------------------------------
# the public search entry point


def _ingest(sharded: ShardedIndex, queries) -> torch.Tensor:
    """Each kind's single-device ingest on this rank's device, so sharded
    results stay comparable bit for bit."""
    dev = sharded.device
    if sharded.kind == "ivf_pq":
        q, q_dtype = ivf_pq._ingest_dataset(queries, dev)
        expects(q_dtype in (sharded.aux["dataset_dtype"], "float32"),
                f"query dtype {q_dtype} != index dataset dtype "
                f"{sharded.aux['dataset_dtype']}")
        return q
    if sharded.kind == "ivf_flat":
        q = ivf_flat.ingest_queries(queries, dev)
        if sharded.metric == DistanceType.CosineExpanded and q.shape[0]:
            q = ivf_flat._normalize_rows(q)
        return q
    return as_float_tensor(queries, dev).to(sharded.stacked[0].dtype)


def batch_cap(sharded: ShardedIndex,
              searcher: ShardedSearcher) -> Optional[int]:
    """The per-shard IVF-PQ transient cap on a query batch
    (``ivf_pq.hoisted_batch_cap_dims`` over the shard's scan budget), or
    None where the config has none."""
    if sharded.kind != "ivf_pq" or not searcher.hoisted:
        return None
    aux = sharded.aux
    return ivf_pq.hoisted_batch_cap_dims(
        sharded.metric,
        aux["codebook_kind"] == int(ivf_pq.CodebookKind.PER_CLUSTER),
        aux["cap_n_phys"], aux["cap_max_chunks"], aux["n_lists"],
        aux["pq_dim"], aux["pq_bits"], searcher.n_probes, searcher.lut_dtype,
        searcher.hoisted)


def search(sharded: ShardedIndex, queries, k: int, params=None, *,
           batch_size_query: int = _QUERY_BATCH,
           engine: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a :class:`ShardedIndex` across all of its ranks (every rank
    calls it with the same queries): per bucketed query batch, the
    replicated coarse ranking, each rank's probe scan, ONE allgather and
    the part merge.  Returns ``(distances (nq, k), indices (nq, k))`` on
    every rank — the single-device search's top-k (ties at exactly equal
    distances may resolve by rank order instead of scan order)."""
    q = _ingest(sharded, queries)
    expects(q.ndim == 2 and q.shape[1] == sharded.dim, "query dim mismatch")
    if q.shape[0] == 0:
        return empty_result(0, int(k), accum_dtype(q.dtype), q.device)
    s = sharded.searcher(int(k), params, engine)
    cap = batch_cap(sharded, s)
    bs = int(batch_size_query) if cap is None else min(int(batch_size_query),
                                                      cap)
    return bucketed(q, bs, s.dispatch)


def bucketed(q: torch.Tensor, bs: int,
             dispatch: Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                      torch.Tensor]]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """*q* (non-empty) in batches of at most *bs* rows, each zero-padded
    to its bucket and run by *dispatch*; the valid rows' ``(distances,
    indices)``, concatenated."""
    out_d, out_i = [], []
    for q0 in range(0, q.shape[0], bs):
        qb = q[q0:q0 + bs]
        n_valid = qb.shape[0]
        bucket = min(bucket_dim(n_valid), bs)
        if bucket != n_valid:
            qb = torch.cat([qb, qb.new_zeros((bucket - n_valid,
                                              qb.shape[1]))])
        d, i = dispatch(qb)
        out_d.append(d[:n_valid])
        out_i.append(i[:n_valid])
    if len(out_d) == 1:
        return out_d[0], out_i[0]
    return torch.cat(out_d), torch.cat(out_i)
