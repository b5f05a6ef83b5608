"""Host/device tiering of an IVF index (port of
``raft_tpu/neighbors/tiering.py``: ``_select_probes`` :95, ``_scan_block``
:112, the hot phase :134, the cold scan :151, ``_refine_impl`` :164,
``TieredIndex`` :206, ``_select_hot`` :311, ``_tier_from_parts`` :338,
``tier`` :425, ``retier`` :483, ``to_index`` :504, ``TieredSearcher``
:543, ``search`` :773).

An IVF-Flat or IVF-PQ index whose rows do not all fit on the card is split
by a hotness policy (per-list probe counts, counted on the device by the
serve path; list size before any count exists):

* **hot tier** — the most-probed lists' physical rows, compacted into one
  block on the device, its chunk table the index's own with the cold lists
  pointed at the block's empty dummy row (``_common.remap_chunk_table``);
* **cold tier** — the other rows, cut into tiles of ``tile_phys``
  physical rows (the tail padded with the empty dummy row) kept in pinned
  host memory on a CUDA index, pinned once at :func:`tier`.

A batch is searched in two phases through the families' own scans, so a
candidate's distance has the same bits as in the resident index: the hot
phase (coarse ranking → top-n_probes → hot-block scan → the per-list probe
counter, ``index_add_``), then each cold tile, copied to the card with
``non_blocking=True`` on one of the searcher's two stream lanes while the
previous tile scores; the scan's stream waits on the copy's event, and the
staged tensors are marked used on that stream (``record_stream``).  The
runs fold by ``merge_sorted_runs`` (hot first, tiles in storage order,
run a winning ties), so the top-k equals the resident search's bit for
bit wherever distances are not tied.  A tile's scan is cut to its true
worst case (the rows of the n_probes lists with most rows in it), which
drops only empty dummy steps.

**Exact re-rank** (``SearchParams.refine_ratio``): the two phases keep
k·ratio candidates, whose original vectors are gathered from the host
refine store (one id read and one staged copy per batch) and re-scored
exactly — the IVF-PQ + refine recipe.  IVF-Flat rebuilds the store from
its own rows; IVF-PQ needs ``tier(..., dataset=)``.

Re-tiering (:func:`retier` from a :meth:`TieredSearcher.hotness`
snapshot) is swapped in through ``ServeEngine.refresh``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.analysis.registry import audit_program
from raft_tpu_torch import telemetry
from raft_tpu_torch.core.aot import aot
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import Handle, resolve_device
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.matrix.select_k import merge_sorted_runs, select_k
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.neighbors._common import empty_result, remap_chunk_table

#: residency events and bytes moved (hot_dispatches, cold_tiles,
#: prefetch_bytes, refine_gather_bytes, retiers)
tier_counters = telemetry.legacy_counter(
    "raft_tpu_tier_events_total",
    "Tiered-serving residency events and bytes moved (hot dispatches, "
    "cold tiles scanned, staged prefetch bytes, refine gather bytes)")

#: host time to hand one cold tile (or one refine gather) to its copy
prefetch_seconds = telemetry.histogram(
    "raft_tpu_tier_prefetch_seconds",
    "Cold-tile / refine-gather staging enqueue latency (seconds)")

_DEFAULT_TILE_PHYS = 512
#: queries per batch of the eager :func:`search`
_BATCH = 1024
#: the per-row leaves of a block, in order
_LEAVES = {"ivf_flat": ("data", "indices", "sizes", "table", "norms"),
           "ivf_pq": ("codes", "indices", "sizes", "table", "owner", "csum")}
#: the model tables, in order
_MODEL = {"ivf_flat": ("centers",),
          "ivf_pq": ("centers", "rotation", "codebooks", "list_adc")}


@audit_program(
    "tiering.refine", transient_bytes=2 << 20,
    notes="the exact re-rank of the k·ratio staged candidates")
def _refine_impl(q: torch.Tensor, cand_vecs: torch.Tensor,
                 cand_ids: torch.Tensor, metric: DistanceType, k: int,
                 engine: str):
    """Exact re-rank: the candidates' original vectors (nq, r, dim)
    re-scored exactly and the best k kept; a slot of id −1 scores the
    sentinel.  The products are a broadcast multiply and a row sum, so a
    query's bits do not depend on its batch."""
    v = cand_vecs.float()
    dots = torch.sum(v * q[:, None, :], dim=-1)
    is_ip = metric == DistanceType.InnerProduct
    if is_ip:
        d = dots
    elif metric == DistanceType.CosineExpanded:
        vn = torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), 1e-30))
        d = 1.0 - dots / vn
    else:
        q_sq = torch.sum(q * q, dim=-1)[:, None]
        d = q_sq + torch.sum(v * v, dim=-1) - 2.0 * dots
    sentinel = float("-inf") if is_ip else float("inf")
    d = torch.where(cand_ids >= 0, d, torch.full_like(d, sentinel))
    d, i = select_k(d, k, not is_ip, indices=cand_ids, engine=engine)
    if metric == DistanceType.L2SqrtExpanded:
        d = torch.sqrt(torch.clamp_min(d, 0.0))
    return d, i


#: the refine, keyed per signature (``raft_tpu/neighbors/tiering.py:198``
#: ``_refine_aot``)
_refine_aot = aot(_refine_impl, static_argnums=(3, 4, 5))


def _scan_block(q: torch.Tensor, probes: torch.Tensor, blk, kind: str,
                k: int, extra: Optional[int], lut_dtype: str,
                engines: Tuple[str, str], int_dtype: str, hoisted: bool):
    """One block (the hot block, or one staged cold tile) through its
    family's keyed probe-scoring program (``ivf_flat._probe_search_aot``,
    ``ivf_pq._search_batch_aot``): squared distances, the L2Sqrt root
    taken after the merge.  A cold tile's call is the reference's
    ``_cold_scan_aot`` (:196): one keyed program per tile; inside the hot
    phase's program it runs inline."""
    if kind == "ivf_flat":
        return ivf_flat._probe_search_aot(q, probes, blk, k, False,
                                          engines[0], None, extra)
    return ivf_pq._search_batch_aot(q, probes, blk, k, lut_dtype, engines,
                                    None, False, int_dtype=int_dtype,
                                    hoisted=hoisted, extra=extra)


def _hot_phase_impl(q: torch.Tensor, acc: torch.Tensor, blk, kind: str,
                    metric: DistanceType, k: int, n_probes: int,
                    extra: Optional[int], lut_dtype: str,
                    engines: Tuple[str, str], int_dtype: str, hoisted: bool):
    """The hot phase as one program: coarse ranking → top-n_probes (each
    family's serving ranking: ``ivf_flat._coarse_distances`` and kernel
    B2) → hot-block scan → the per-list probe counter *acc* (``index_add_``
    in place).  A warm run passes a scratch counter of *acc*'s signature,
    so warming counts no probes and keys the same program."""
    coarse = ivf_flat._coarse_distances(q, blk.centers, metric)
    _, probes = select_k(coarse, n_probes, select_min=True,
                         engine=engines[0])
    d, i = _scan_block(q, probes, blk, kind, k, extra, lut_dtype, engines,
                       int_dtype, hoisted)
    flat = probes.reshape(-1).long()
    # exempt(raw-segment-sum): the per-list probe counter, a histogram
    acc.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return probes, d, i


#: the hot phase, keyed per signature (``raft_tpu/neighbors/tiering.py:194``
#: ``_hot_phase_aot``)
_hot_phase_aot = aot(_hot_phase_impl,
                     static_argnums=(3, 4, 5, 6, 7, 8, 9, 10, 11))


@dataclasses.dataclass
class TieredIndex:
    """Two-tier residency split of one packed IVF index (module
    docstring).

    ``model``      the model tables on the device — IVF-Flat: (centers,);
                   IVF-PQ: (centers, rotation, codebooks, list_adc)
    ``hot_scan``   the hot block's per-row leaves on the device, in
                   :data:`_LEAVES` order
    ``cold_tiles`` per tile the same leaves on the host (pinned on a CUDA
                   index), every tile ``tile_phys + 1`` rows
    ``cold_counts`` per tile the physical rows of each list in it, most
                   first (a tile's scan budget)
    ``host``       the full per-row blocks on the host — re-tiering and
                   archives read them, never the device
    """

    kind: str
    metric: DistanceType
    n_lists: int
    dim: int
    tile_phys: int
    hot_lists: np.ndarray
    chunk_table: np.ndarray
    list_sizes: np.ndarray
    model: Tuple[torch.Tensor, ...]
    hot_scan: Tuple[torch.Tensor, ...]
    cold_tiles: Tuple[Tuple[torch.Tensor, ...], ...]
    cold_counts: Tuple[np.ndarray, ...]
    host: dict
    probe_extra_hot: int
    aux: dict
    device: torch.device
    refine_store: Optional[torch.Tensor] = None
    _template: object = dataclasses.field(default=None, repr=False)
    _searchers: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def probe_extra_cold(self) -> int:
        """The bound on a cold tile's dummy probe steps (the JAX package's
        field: one tile's rows).  The searcher scans each tile with its
        own, smaller count (``TieredSearcher._cold_extra``)."""
        return self.tile_phys

    @property
    def n_hot_lists(self) -> int:
        return int(np.sum(self.hot_lists))

    @property
    def hot_rows(self) -> int:
        """Real physical rows on the device (the dummy not counted)."""
        return int(self.hot_scan[0].shape[0]) - 1

    @property
    def n_phys(self) -> int:
        """Real physical rows of both tiers."""
        return int(self.host["sizes"].shape[0]) - 1

    def device_bytes(self) -> int:
        """The hot tier's residency: the model tables, IVF-PQ's rotated
        centres and the hot block."""
        derived = ((self._template.rot_centers,) if self.kind == "ivf_pq"
                   else ())
        return int(sum(t.numel() * t.element_size()
                       for t in (*self.model, *self.hot_scan, *derived)))

    def tile_bytes(self) -> int:
        """Bytes of one staged tile (0 without a cold tier)."""
        if not self.cold_tiles:
            return 0
        return int(sum(t.numel() * t.element_size()
                       for t in self.cold_tiles[0]))

    def searcher(self, k: int, params=None,
                 engine: Optional[str] = None) -> "TieredSearcher":
        """The serving searcher of (k, params, engine), made once and
        shared by the serve backend and :func:`search`, so both count
        probes into the same hotness counter."""
        key = (int(k), repr(params), engine)
        s = self._searchers.get(key)
        if s is None:
            s = self._searchers[key] = TieredSearcher(self, int(k), params,
                                                      engine)
        return s


def _host_parts(index) -> dict:
    """An index's per-row blocks as CPU tensors (the list norms of an
    IVF-Flat index ride along, so a block scores with the resident
    index's own bits)."""
    if isinstance(index, ivf_flat.Index):
        return {"kind": "ivf_flat", "data": index.list_data.cpu(),
                "indices": index.list_indices.cpu(),
                "sizes": index.phys_sizes.cpu(),
                "norms": index.list_norms.cpu()}
    expects(isinstance(index, ivf_pq.Index),
            f"tier(): expected an ivf_flat/ivf_pq Index, got {type(index)}")
    return {"kind": "ivf_pq", "codes": index.list_codes.cpu(),
            "indices": index.list_indices.cpu(),
            "sizes": index.phys_sizes.cpu(), "owner": index.owner.cpu(),
            "csum": index.list_csum.cpu()}


def _owners_from_table(chunk_table: np.ndarray, n_phys: int) -> np.ndarray:
    """(n_phys + 1,) owning list of each physical row, from the chunk table
    (IVF-Flat carries no owner leaf)."""
    n_lists, max_chunks = chunk_table.shape
    owner = np.zeros(n_phys + 1, np.int64)
    flat = chunk_table.reshape(-1).astype(np.int64)
    ids = np.repeat(np.arange(n_lists, dtype=np.int64), max_chunks)
    real = flat < n_phys
    owner[flat[real]] = ids[real]
    return owner


def _select_hot(hotness: Optional[np.ndarray], counts: np.ndarray,
                cap: int, hot_fraction: float) -> np.ndarray:
    """Greedy hotness policy: lists in (probe count desc, id asc) order
    until their physical rows reach ``hot_fraction`` of the total; with no
    counts yet, list size stands in for them."""
    n_lists = counts.shape[0]
    n_chunks = np.maximum(-(-counts.astype(np.int64) // cap), 1)
    n_phys = int(n_chunks.sum())
    # exempt(dtype-drift): host hotness scores (numpy)
    score = (np.asarray(hotness, np.float64) if hotness is not None
             # exempt(dtype-drift): host hotness scores (numpy)
             else counts.astype(np.float64))
    expects(score.shape == (n_lists,),
            f"hotness must be (n_lists,) = ({n_lists},), got {score.shape}")
    order = np.lexsort((np.arange(n_lists), -score))
    target = int(np.ceil(float(hot_fraction) * n_phys))
    mask = np.zeros(n_lists, bool)
    taken = 0
    for lst in order:
        if taken >= target:
            break
        mask[lst] = True
        taken += int(n_chunks[lst])
    return mask


def _template(kind: str, model, list_sizes: torch.Tensor, metric, aux,
              host: dict):
    """A family :class:`Index` over the model tables with a one-row empty
    block: :func:`_block` copies it and sets a block's leaves, so the
    derived tables (IVF-PQ's rotated centres) are made once."""
    dev = model[0].device
    cap = host["indices"].shape[1]
    indices = torch.full((1, cap), -1, dtype=torch.int32, device=dev)
    sizes = torch.zeros(1, dtype=torch.int32, device=dev)
    table = torch.zeros((list_sizes.shape[0], 1), dtype=torch.int32,
                        device=dev)
    if kind == "ivf_flat":
        data = torch.zeros((1,) + tuple(host["data"].shape[1:]),
                           dtype=host["data"].dtype, device=dev)
        return ivf_flat.Index(
            centers=model[0], list_data=data, list_indices=indices,
            list_sizes=list_sizes, phys_sizes=sizes, chunk_table=table,
            metric=metric, adaptive_centers=bool(aux["adaptive_centers"]))
    centers, rotation, codebooks, list_adc = model
    codes = torch.zeros((1,) + tuple(host["codes"].shape[1:]),
                        dtype=torch.uint8, device=dev)
    return ivf_pq.Index(
        centers=centers, rotation=rotation, codebooks=codebooks,
        list_codes=codes, list_indices=indices, list_sizes=list_sizes,
        phys_sizes=sizes, chunk_table=table,
        owner=torch.zeros(1, dtype=torch.int32, device=dev),
        list_adc=list_adc,
        list_csum=torch.zeros((1, cap), dtype=torch.float32, device=dev),
        metric=metric, codebook_kind=ivf_pq.CodebookKind(
            aux["codebook_kind"]),
        pq_bits=int(aux["pq_bits"]), dataset_dtype=aux["dataset_dtype"])


def _block(template, kind: str, leaves):
    """*template* with one block's per-row leaves (:data:`_LEAVES` order)."""
    blk = copy.copy(template)
    if kind == "ivf_flat":
        (blk.list_data, blk.list_indices, blk.phys_sizes, blk.chunk_table,
         blk.list_norms) = leaves
    else:
        (blk.list_codes, blk.list_indices, blk.phys_sizes, blk.chunk_table,
         blk.owner, blk.list_csum) = leaves
    return blk


def _tier_from_parts(host: dict, chunk_table: np.ndarray,
                     list_sizes: np.ndarray, model, metric: DistanceType,
                     aux: dict, *, hot_fraction: float, hotness, hot_lists,
                     tile_phys, refine_store, device) -> TieredIndex:
    kind = host["kind"]
    chunk_table = np.asarray(chunk_table).astype(np.int32)
    list_sizes = np.asarray(list_sizes).astype(np.int32)
    n_lists = list_sizes.shape[0]
    n_phys = host["sizes"].shape[0] - 1
    cap = host["indices"].shape[1]
    owner = (host["owner"].numpy().astype(np.int64) if kind == "ivf_pq"
             else _owners_from_table(chunk_table, n_phys))
    if hot_lists is not None:
        mask = np.asarray(hot_lists).astype(bool)
        expects(mask.shape == (n_lists,),
                f"hot_lists must be (n_lists,) bool, got {mask.shape}")
    else:
        mask = _select_hot(hotness, list_sizes, cap, hot_fraction)
    names = [name for name in _LEAVES[kind] if name != "table"]

    def leaves(rows: np.ndarray, table: np.ndarray):
        sel = torch.as_tensor(rows)
        blk = {name: host[name][sel].contiguous() for name in names}
        blk["table"] = torch.as_tensor(table)
        return tuple(blk[name] for name in _LEAVES[kind])

    # hot tier: the hot rows in their order, then a fresh dummy row
    hot_sel = np.where(mask[owner[:n_phys]])[0]
    hot_dummy = hot_sel.shape[0]
    row_map = np.full(n_phys + 1, -1, np.int64)
    row_map[hot_sel] = np.arange(hot_dummy)
    row_map[n_phys] = hot_dummy
    hot = leaves(np.concatenate([hot_sel, [n_phys]]).astype(np.int64),
                 remap_chunk_table(chunk_table, row_map, hot_dummy))
    hot = tuple(t.to(device) for t in hot)

    # cold tier: tiles of t_phys rows, the tail padded with the source's
    # empty dummy row (never scored)
    cold = np.where(~mask[owner[:n_phys]])[0]
    t_phys = int(tile_phys or _DEFAULT_TILE_PHYS)
    expects(t_phys >= 1, "tile_phys must be >= 1")
    pin = device.type == "cuda"
    tiles, counts = [], []
    for t0 in range(0, cold.shape[0], t_phys):
        rows_t = cold[t0:t0 + t_phys]
        pad = t_phys - rows_t.shape[0]
        map_t = np.full(n_phys + 1, -1, np.int64)
        map_t[rows_t] = np.arange(rows_t.shape[0])
        map_t[n_phys] = t_phys
        tile = leaves(np.concatenate([rows_t, np.full(pad + 1, n_phys)]
                                     ).astype(np.int64),
                      remap_chunk_table(chunk_table, map_t, t_phys))
        tiles.append(tuple(t.pin_memory() for t in tile) if pin else tile)
        counts.append(-np.sort(-np.bincount(owner[rows_t],
                                            minlength=n_lists)))

    sizes_d = torch.as_tensor(list_sizes, device=device)
    template = _template(kind, model, sizes_d, metric, aux, host)
    return TieredIndex(
        kind=kind, metric=metric, n_lists=n_lists,
        dim=int(model[0].shape[1]), tile_phys=t_phys, hot_lists=mask,
        chunk_table=chunk_table, list_sizes=list_sizes, model=tuple(model),
        hot_scan=hot, cold_tiles=tuple(tiles), cold_counts=tuple(counts),
        host=host, probe_extra_hot=max(0, hot_dummy - int(mask.sum())),
        aux=dict(aux), device=device, refine_store=refine_store,
        _template=template)


def _model_of(index) -> Tuple[Tuple[torch.Tensor, ...], dict]:
    if isinstance(index, ivf_flat.Index):
        return ((index.centers,),
                {"adaptive_centers": bool(index.adaptive_centers)})
    return ((index.centers, index.rotation, index.codebooks, index.list_adc),
            {"codebook_kind": int(index.codebook_kind),
             "pq_bits": int(index.pq_bits), "pq_dim": int(index.pq_dim),
             "dataset_dtype": index.dataset_dtype})


def tier(index, *, hot_fraction: float = 0.25, hotness=None, hot_lists=None,
         tile_phys: Optional[int] = None, dataset=None,
         device=None) -> TieredIndex:
    """Split *index* (IVF-Flat or IVF-PQ) into a :class:`TieredIndex` on
    *device* (default: the index's).  *hot_fraction* is the share of
    physical rows to keep on the device; *hotness* an optional (n_lists,)
    probe count (a :meth:`TieredSearcher.hotness` snapshot; list size
    without one); *hot_lists* an explicit (n_lists,) bool mask instead of
    the policy.  *dataset* holds the original vectors for the refine
    store; IVF-Flat rebuilds it from its own rows without one, IVF-PQ
    cannot refine without it.  An index on the host tiered onto the card
    puts only its model tables and its hot block there — the way to tier
    an index too large for the card."""
    expects(0.0 <= float(hot_fraction) <= 1.0,
            "hot_fraction must be in [0, 1]")
    host = _host_parts(index)
    model, aux = _model_of(index)
    if device is not None:
        model = tuple(t.to(resolve_device(device)) for t in model)
    dev = model[0].device
    if dev != index.device and host["kind"] == "ivf_flat":
        # the norms the index resident on dev would hold
        host["norms"] = ivf_flat.row_norms(host["data"], dev).cpu()
    store = None
    if dataset is not None:
        store = (dataset.float() if isinstance(dataset, torch.Tensor)
                 else torch.as_tensor(np.asarray(dataset, np.float32))
                 ).cpu().contiguous()
        expects(store.ndim == 2 and store.shape[1] == int(index.dim),
                "refine dataset must be (n, dim) with the index's dim")
    elif host["kind"] == "ivf_flat":
        store = _reconstruct_store(host, int(index.dim))
    return _tier_from_parts(
        host, index.chunk_table.cpu().numpy(),
        index.list_sizes.cpu().numpy(), model, index.metric, aux,
        hot_fraction=hot_fraction, hotness=hotness, hot_lists=hot_lists,
        tile_phys=tile_phys, refine_store=store, device=dev)


def _reconstruct_store(host: dict, dim: int) -> torch.Tensor:
    """IVF-Flat's refine store from its packed rows: every live slot back
    at its id's position, widened to float32 (exact)."""
    data, indices, sizes = host["data"], host["indices"], host["sizes"]
    n_phys, cap = indices.shape[0] - 1, indices.shape[1]
    live = torch.arange(cap)[None, :] < sizes[:n_phys, None]
    ids = indices[:n_phys][live].long()
    if ids.numel() == 0:
        return torch.zeros((0, dim), dtype=torch.float32)
    store = torch.zeros((int(ids.max()) + 1, dim), dtype=torch.float32)
    store[ids] = data[:n_phys][live].float()
    return store


def retier(tiered: TieredIndex, hotness=None, *,
           hot_fraction: Optional[float] = None,
           tile_phys: Optional[int] = None) -> TieredIndex:
    """Recut *tiered*'s residency from fresh hotness counts without the
    source index (the full blocks live on the host).  Swap the result in
    through ``ServeEngine.refresh``."""
    frac = (float(hot_fraction) if hot_fraction is not None
            else tiered.hot_rows / max(tiered.n_phys, 1))
    out = _tier_from_parts(
        tiered.host, tiered.chunk_table, tiered.list_sizes, tiered.model,
        tiered.metric, tiered.aux, hot_fraction=frac, hotness=hotness,
        hot_lists=None, tile_phys=tile_phys or tiered.tile_phys,
        refine_store=tiered.refine_store, device=tiered.device)
    tier_counters.inc("retiers")
    return out


def family_arrays(tiered: TieredIndex) -> dict:
    """The family ``Index`` leaves of *tiered* as CPU tensors under their
    field names (``ARRAY_FIELDS``) — the resident index, reassembled from
    the host blocks."""
    h = tiered.host
    model = {name: t.cpu() for name, t in zip(_MODEL[tiered.kind],
                                              tiered.model)}
    common = {"list_indices": h["indices"], "phys_sizes": h["sizes"],
              "list_sizes": torch.as_tensor(tiered.list_sizes),
              "chunk_table": torch.as_tensor(tiered.chunk_table)}
    if tiered.kind == "ivf_flat":
        return {"centers": model["centers"], "list_data": h["data"],
                **common}
    return {**model, **common, "list_codes": h["codes"],
            "owner": h["owner"], "list_csum": h["csum"]}


def to_index(tiered: TieredIndex, device=None):
    """The resident family index reassembled from the host blocks, on
    *device* (default: the tiered index's)."""
    dev = tiered.device if device is None else torch.device(device)
    a = {name: t.to(dev) for name, t in family_arrays(tiered).items()}
    if tiered.kind == "ivf_flat":
        return ivf_flat.Index(
            **a, metric=tiered.metric,
            adaptive_centers=bool(tiered.aux.get("adaptive_centers")))
    return ivf_pq.Index(
        **a, metric=tiered.metric,
        codebook_kind=ivf_pq.CodebookKind(tiered.aux["codebook_kind"]),
        pq_bits=int(tiered.aux["pq_bits"]),
        dataset_dtype=tiered.aux.get("dataset_dtype", "float32"))


class TieredSearcher:
    """The two-phase search of one (TieredIndex, k, params) serving key —
    the tiered serve backend's delegate: its two staging lanes
    (``Handle(n_streams=2)``) and the device's per-list probe counter."""

    def __init__(self, tiered: TieredIndex, k: int, params=None,
                 engine: Optional[str] = None):
        expects(k >= 1, "k must be >= 1")
        self.tiered = tiered
        self.kind = tiered.kind
        self.k = int(k)
        self.dim = int(tiered.dim)
        self.name = f"tiered_{tiered.kind}"
        self.metric = tiered.metric
        self.device = tiered.device
        template = tiered._template
        if self.kind == "ivf_flat":
            self.params = params or ivf_flat.SearchParams()
            sk = resolve_engine("select_k", self.device, engine=engine)
            self.engines = (sk, sk)
            self.lut_dtype, self.int_dtype, self.hoisted = (
                "float32", "float32", False)
        else:
            self.params = params or ivf_pq.SearchParams()
            ivf_pq.check_search_params(self.params)
            self.engines = ivf_pq._resolve_engines(template, engine)
            self.lut_dtype = self.params.lut_dtype
            self.int_dtype = self.params.internal_distance_dtype
            self.hoisted = ivf_pq._resolve_hoisted(self.params)
        self.engine = engine
        self.n_probes = int(min(self.params.n_probes, tiered.n_lists))
        ratio = getattr(self.params, "refine_ratio", None)
        self.refine_ratio = max(1, int(ratio)) if ratio else 1
        if self.refine_ratio > 1:
            expects(tiered.refine_store is not None,
                    "refine_ratio needs the host refine store — "
                    "tier(..., dataset=original_vectors)")
        self.search_k = self.k * self.refine_ratio
        self.select_min = tiered.metric != DistanceType.InnerProduct
        self._hot = _block(template, self.kind, tiered.hot_scan)
        # a tile's steps: its rows of the n_probes lists with most rows
        # in it, so only empty dummy steps are dropped
        self._cold_extra = [int(c[:self.n_probes].sum()) - self.n_probes
                            for c in tiered.cold_counts]
        self._handle = Handle(self.device, n_streams=2)
        self._acc = torch.zeros(tiered.n_lists, dtype=torch.int32,
                                device=self.device)

    @audit_program(
        "tiering.cold_scan", transient_bytes=2 << 20,
        notes="one staged cold tile scored over O(tile) buffers — the "
              "tiered backend's cold phase")
    def _scan(self, qb: torch.Tensor, probes: torch.Tensor, blk,
              extra: Optional[int]):
        """One block through its family's keyed scan (:func:`_scan_block`):
        squared distances (the L2Sqrt root is taken after the merge)."""
        return _scan_block(qb, probes, blk, self.kind, self.search_k, extra,
                           self.lut_dtype, self.engines, self.int_dtype,
                           self.hoisted)

    def _hot_phase(self, qb: torch.Tensor, acc: torch.Tensor):
        """The keyed hot phase (:func:`_hot_phase_impl`) of one batch,
        counting its probes into *acc*."""
        return _hot_phase_aot(qb, acc, self._hot, self.kind, self.metric,
                              self.search_k, self.n_probes,
                              self.tiered.probe_extra_hot, self.lut_dtype,
                              self.engines, self.int_dtype, self.hoisted)

    def _stage(self, tile, lane: int, key: str):
        """Hand host tensors to their copy on pool lane *lane*
        (``Stream.stage``): (the device tensors, the lane)."""
        t0 = telemetry.now()
        stream = self._handle.get_next_usable_stream(lane)
        staged = stream.stage(tuple(tile))
        prefetch_seconds.observe(telemetry.now() - t0)
        tier_counters.inc(key, sum(t.numel() * t.element_size()
                                   for t in tile))
        return staged, stream

    def _use(self, staged):
        """The staged tensors, once the current stream waits on their
        lane's copy and holds them (``record_stream``) until its work is
        done."""
        tensors, stream = staged
        if self.device.type == "cuda":
            stream.join()
            cur = torch.cuda.current_stream(self.device)
            for t in tensors:
                t.record_stream(cur)
        return tensors

    def _dispatch(self, qb: torch.Tensor, acc: torch.Tensor):
        probes, d, i = self._hot_phase(qb, acc)
        tier_counters.inc("hot_dispatches")
        if self.tiered.cold_tiles:
            d, i = self._run_cold(qb, probes, d, i)
        if self.refine_ratio > 1:
            return self._refine(qb, i)
        if self.metric == DistanceType.L2SqrtExpanded:
            d = torch.sqrt(torch.clamp_min(d, 0.0))
        return d, i

    def dispatch(self, qb: torch.Tensor):
        """One pre-bucketed float32 batch on the device: the hot phase,
        the cold tiles (tile n + 1 copying while tile n scores) folded in
        storage order, then the optional exact re-rank.  Every program it
        runs is keyed (the hot phase, each tile's scan, the merges, the
        refine), so after :meth:`warm` at a bucket it makes no first
        call."""
        return self._dispatch(qb, self._acc)

    def warm(self, bucket: int) -> None:
        """Run one batch of *bucket* zero rows against a scratch probe
        counter (the same signature as the live one, so no probe is
        counted): every program a dispatch at *bucket* runs is warm."""
        self._dispatch(torch.zeros((bucket, self.dim), dtype=torch.float32,
                                   device=self.device),
                       torch.zeros_like(self._acc))

    def _run_cold(self, qb, probes, d, i):
        tiles = self.tiered.cold_tiles
        lane = 0
        cur = self._stage(tiles[0], lane, "prefetch_bytes")
        for n in range(len(tiles)):
            nxt = (self._stage(tiles[n + 1], 1 - lane, "prefetch_bytes")
                   if n + 1 < len(tiles) else None)
            blk = _block(self._hot, self.kind, self._use(cur))
            td, ti = self._scan(qb, probes, blk, self._cold_extra[n])
            d, i = merge_sorted_runs(d, i, td, ti, k=self.search_k,
                                     select_min=self.select_min)
            tier_counters.inc("cold_tiles")
            cur, lane = nxt, 1 - lane
        return d, i

    def _refine(self, qb, ids):
        """Exact re-rank: one read of the candidate ids, a host gather from
        the refine store into pinned memory, one staged copy, the
        re-score."""
        store = self.tiered.refine_store
        # exempt(hot-path-host-transfer): the refine's one id read: the host gathers rows
        ids_host = ids.cpu()
        rows = torch.clamp(ids_host.long(), 0, store.shape[0] - 1)
        vecs = torch.empty(rows.shape + (self.dim,), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")
        torch.index_select(store, 0, rows.reshape(-1),
                           out=vecs.view(-1, self.dim))
        staged = self._stage((vecs, ids_host), 0, "refine_gather_bytes")
        vecs_d, ids_d = self._use(staged)
        return _refine_aot(qb, vecs_d, ids_d, self.metric, self.k,
                           self.engines[0])

    def batch_cap(self) -> Optional[int]:
        """IVF-PQ's hoisted-table clamp, sized by the full layout
        (``ivf_pq.hoisted_batch_cap_dims``)."""
        if self.kind != "ivf_pq":
            return None
        t = self.tiered
        return ivf_pq.hoisted_batch_cap_dims(
            t.metric, t._template.per_cluster, t.n_phys,
            t.chunk_table.shape[1], t.n_lists, int(t.aux["pq_dim"]),
            int(t.aux["pq_bits"]), self.n_probes, self.params.lut_dtype,
            self.hoisted)

    def solo(self, q, batch: int = _BATCH):
        return search(self.tiered, q, self.k, params=self.params,
                      engine=self.engine, batch_size_query=batch)

    def hotness(self) -> np.ndarray:
        """A snapshot of the per-list probe counts (the re-tiering
        policy's input)."""
        return self._acc.cpu().numpy()

    def reset_hotness(self) -> None:
        self._acc.zero_()

    def tier_stats(self) -> dict:
        """Residency summary for /healthz."""
        t = self.tiered
        return {"kind": t.kind, "n_lists": t.n_lists,
                "hot_lists": t.n_hot_lists, "hot_rows": t.hot_rows,
                "total_rows": t.n_phys, "cold_tiles": len(t.cold_tiles),
                "tile_phys": t.tile_phys, "device_bytes": t.device_bytes(),
                "tile_bytes": t.tile_bytes(),
                "refine_ratio": self.refine_ratio}


def _ingest(tiered: TieredIndex, queries) -> torch.Tensor:
    """Float32 queries on the device, as the family ``search`` converts
    them (cosine rows normalized)."""
    if tiered.kind == "ivf_pq":
        q, q_dtype = ivf_pq._ingest_dataset(queries, tiered.device)
        expects(q_dtype in (tiered.aux["dataset_dtype"], "float32"),
                f"query dtype {q_dtype} != index dataset dtype "
                f"{tiered.aux['dataset_dtype']}")
    else:
        q = ivf_flat._ingest(queries, tiered.device).float()
        if tiered.metric == DistanceType.CosineExpanded:
            q = ivf_flat._normalize_rows(q)
    expects(q.ndim == 2 and q.shape[1] == tiered.dim, "query dim mismatch")
    return q


def search(tiered: TieredIndex, queries, k: int, params=None,
           engine: Optional[str] = None, *, batch_size_query: int = _BATCH
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiered search: (distances (nq, k) f32, indices (nq, k) int32) on
    the device, equal to the resident family search bit for bit wherever
    distances are not tied.  Batches of up to *batch_size_query* queries
    (IVF-PQ's batch cap below that), the tail padded to the bucket
    ladder."""
    s = tiered.searcher(int(k), params, engine)
    q = _ingest(tiered, queries)
    nq = q.shape[0]
    if nq == 0:
        return empty_result(0, s.k, torch.float32, tiered.device)
    batch = min(int(batch_size_query), s.batch_cap() or _BATCH)
    out_d, out_i = [], []
    for q0 in range(0, nq, batch):
        qb = q[q0:q0 + batch]
        n = qb.shape[0]
        bucket = min(bucket_dim(n), batch)
        if bucket != n:
            qb = torch.cat([qb, qb.new_zeros((bucket - n, qb.shape[1]))])
        d, i = s.dispatch(qb)
        out_d.append(d[:n])
        out_i.append(i[:n])
    if len(out_d) == 1:
        return out_d[0], out_i[0]
    return torch.cat(out_d), torch.cat(out_i)
