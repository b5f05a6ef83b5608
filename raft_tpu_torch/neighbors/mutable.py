"""Mutable index: a delta segment, tombstones and background compaction
(single-device port of ``raft_tpu/neighbors/mutable.py``; design in
``docs/mutable_index.md``).

:class:`MutableIndex` wraps the triple (main index, delta segment,
tombstones) over an IVF-Flat or IVF-PQ index and takes writes while the
main keeps serving:

* **Deletes** set bits in a device bitmap keyed by row id
  (``_common.tombstone_hit``), grown in power-of-two word buckets
  (:func:`_tomb_words`).  The mask acts inside the probe scan: kernel
  B4's scan mode for IVF-PQ, ``_common.scan_probe_lists`` for IVF-Flat,
  so a dead row never enters a step's best candidates.
* **Upserts** tombstone the old row and append into a small delta index
  of the same family that shares the main's trained model (one label
  space), through the family's ``extend`` — kernel B1 assigns the lists.
* **Reads** search main ∪ delta, each masked by its own bitmap, folded
  by ``merge_sorted_parts`` with main as part 0, so main wins ties (the
  one documented tie-order difference from a rebuild of the same live
  rows; at full probe coverage every distance equals the rebuild's).
* **Compaction** (:meth:`MutableIndex.compact`, :class:`Compactor`)
  rebuilds main ∪ delta minus tombstones through the family ``build``
  off the request path (on its own stream on the card), replays the
  writes that came meanwhile, swaps the core under the lock and promotes
  it through ``ServeEngine.refresh``.

Consistency.  A dispatch takes a snapshot of (main, delta, bitmaps) under
the write lock; the scan then runs on the caller's stream after the lock
is released.  JAX arrays never change, so the reference's snapshot is
free; tensors can be written in place, so the port makes every write
build NEW tensors: a write uploads a fresh bitmap (128 KB at a million
ids) and extends the delta through the copying path, never in place.  A
dispatch makes its stream wait on the event of the last write, and marks
every tensor of its snapshot as used on that stream
(``Tensor.record_stream``), so the caching allocator recycles no tensor
a running scan still reads.  Writes serialize with snapshots, not with
scans.

The rows are kept on the main's device: the dataset the main was built
from, and each upserted row (compaction re-encodes the live rows, exact
for IVF-PQ's lossy codes too).

Not ported yet: a sharded main (``comms``), and re-lowering of serve
signatures (eager PyTorch compiles nothing, so the reference's
``rewarms`` event never occurs here).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.matrix.select_k import merge_sorted_parts
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.neighbors._common import empty_result

#: lifecycle events (upsert/delete batches and rows, delta rebuilds,
#: compaction errors)
mutable_counters = telemetry.legacy_counter(
    "raft_tpu_mutable_events_total",
    "Mutable-index lifecycle events (upsert/delete batches + rows, delta "
    "dedup rebuilds, write-path signature rewarms, compaction errors)")
_delta_rows_gauge = telemetry.gauge(
    "raft_tpu_mutable_delta_rows",
    "Rows currently live in the write-optimized delta segment")
_tombstones_gauge = telemetry.gauge(
    "raft_tpu_mutable_tombstones",
    "Row ids currently tombstoned (main + delta)")
_compactions_counter = telemetry.counter(
    "raft_tpu_mutable_compactions",
    "Background compactions completed (delta + tombstones folded back "
    "into a freshly built main)")
compaction_seconds = telemetry.histogram(
    "raft_tpu_mutable_compaction_seconds",
    "Wall seconds per compaction (rebuild + journal chase + rewarm + "
    "swap)")

#: rows per query batch of the eager :func:`search`
_BATCH = 1024


def _tomb_words(max_id: int) -> int:
    """Bitmap words for ids up to *max_id*, on the power-of-two bucket
    ladder, so the bitmap takes O(log max_id) shapes over an index's
    life."""
    return bucket_dim(max((int(max_id) + 32) // 32, 1))


def _family(kind: str):
    return ivf_flat if kind == "ivf_flat" else ivf_pq


def _tensors(index):
    return [v for v in vars(index).values() if isinstance(v, torch.Tensor)]


def _mark_used(tensors) -> None:
    """Mark CUDA tensors as used on the current stream, so the allocator
    recycles none of them before that stream's queued work is done."""
    for t in tensors:
        if t is not None and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


# ---------------------------------------------------------------------------
# the delta-merged search


def _family_scan(q, index, k: int, n_probes: int, lut_dtype: str,
                 engines: Tuple[str, str], tombstones, pq_kw):
    """One segment through the family's own batch search, its bitmap
    threaded into the scan, squared distances (no L2Sqrt root); *pq_kw*
    holds IVF-PQ's ``int_dtype`` and ``hoisted``."""
    if isinstance(index, ivf_flat.Index):
        return ivf_flat._search_batch_impl(q, index, k, n_probes, False,
                                           engines[0], tombstones)
    return ivf_pq._full_search_impl(q, index, k, n_probes, lut_dtype,
                                    engines, tombstones, sqrt=False,
                                    **pq_kw)


def _merged_search_impl(q, main, delta, tomb_main, tomb_delta, k: int,
                        n_probes: int, lut_dtype: str,
                        engines: Tuple[str, str], pq_kw=None):
    """main ∪ delta for one batch: two masked family scans folded by
    ``merge_sorted_parts`` (main is part 0 and wins ties); the L2Sqrt
    root is taken after the fold, which compares squared distances."""
    metric = main.metric
    pq_kw = pq_kw or {}
    d, i = _family_scan(q, main, k, n_probes, lut_dtype, engines, tomb_main,
                        pq_kw)
    if delta is not None:
        dd, di = _family_scan(q, delta, k, n_probes, lut_dtype, engines,
                              tomb_delta, pq_kw)
        d, i = merge_sorted_parts(
            torch.stack([d, dd]), torch.stack([i, di]), k=k,
            select_min=metric != DistanceType.InnerProduct)
    if metric == DistanceType.L2SqrtExpanded:
        d = torch.sqrt(torch.clamp_min(d, 0.0))
    return d, i


# ---------------------------------------------------------------------------
# core state (swapped whole by compaction)


class _Core:
    """One consistent (main, delta, tombstones) state with its host books.
    ``main_ids`` is the main's sorted id roster, ``main_row`` each one's
    row of ``main_x`` (−1: not stored, a dead id restored from an
    archive); ``delta_x`` holds each delta id's row, ``delta_live`` the
    live delta ids in insertion order."""

    __slots__ = ("kind", "main", "delta", "main_ids", "main_row", "main_x",
                 "main_dead", "delta_live", "delta_dead", "delta_x",
                 "n_words", "words_main", "words_delta", "tomb_main_bits",
                 "tomb_delta_bits", "ready")

    def __init__(self, kind, main, main_ids, main_row, main_x, n_words):
        self.kind = kind
        self.main = main
        self.delta = None
        self.main_ids = main_ids
        self.main_row = main_row
        self.main_x = main_x
        self.main_dead: set = set()
        self.delta_live: Dict[int, bool] = {}
        self.delta_dead: set = set()
        self.delta_x: Dict[int, torch.Tensor] = {}
        self.n_words = int(n_words)
        self.words_main = np.zeros(self.n_words, np.uint32)
        self.words_delta = np.zeros(self.n_words, np.uint32)
        self.tomb_main_bits = None
        self.tomb_delta_bits = None
        self.ready = None            # event of the last write (the card)

    @property
    def live_count(self) -> int:
        return (self.main_ids.size - len(self.main_dead)
                + len(self.delta_live))

    @property
    def delta_rows(self) -> int:
        return len(self.delta_live)

    @property
    def tombstones(self) -> int:
        return len(self.main_dead) + len(self.delta_dead)

    def main_live_mask(self) -> np.ndarray:
        dead = np.fromiter(self.main_dead, np.int64, len(self.main_dead))
        return ~np.isin(self.main_ids, dead)

    def in_main(self, ids: np.ndarray) -> np.ndarray:
        if self.main_ids.size == 0:
            return np.zeros(ids.shape, bool)
        pos = np.minimum(np.searchsorted(self.main_ids, ids),
                         self.main_ids.size - 1)
        return self.main_ids[pos] == ids


class MutableIndex:
    """(main index, delta segment, tombstones) with writes while serving.

    *main* is an ``ivf_flat.Index`` or ``ivf_pq.Index``; *dataset* /
    *ids* are the rows it was built from (kept on the main's device:
    compaction re-encodes the live rows from them); *build_params* is the
    family ``IndexParams`` compaction rebuilds with.  State changes only
    through :meth:`upsert`, :meth:`delete` and :meth:`compact`; reads go
    through :func:`search` or a :meth:`searcher` (what
    ``serve.ServeEngine``'s mutable backend dispatches)."""

    def __init__(self, main, dataset, ids=None, *, build_params=None,
                 comms=None):
        expects(comms is None, "MutableIndex over a sharded main is not "
                "ported yet")
        if isinstance(main, ivf_flat.Index):
            kind = "ivf_flat"
        else:
            expects(isinstance(main, ivf_pq.Index),
                    f"unsupported main index type {type(main)!r}")
            kind = "ivf_pq"
        x = torch.as_tensor(dataset, device=main.device)
        expects(x.ndim == 2 and x.shape[1] == main.dim,
                "dataset must be (n, dim) with the index's dim")
        ids = (np.arange(x.shape[0], dtype=np.int64) if ids is None
               else np.asarray(ids, np.int64))
        expects(ids.shape == (x.shape[0],), "ids must be (n,)")
        expects(ids.size == np.unique(ids).size, "ids must be unique")
        expects(ids.size == 0 or int(ids.min()) >= 0,
                "ids must be non-negative")
        order = np.argsort(ids, kind="stable")
        max_id = int(ids.max()) if ids.size else 0
        self._mut_core = _Core(kind, main, ids[order], order, x,
                               _tomb_words(max_id))
        self.build_params = build_params
        self._lock = threading.RLock()
        self._compact_lock = threading.Lock()
        self._compact_stream = None
        self._journal = None
        self._searchers: Dict[tuple, MutableSearcher] = {}
        self._push_tombstones(self._mut_core)

    # -- read side ----------------------------------------------------------

    @property
    def kind(self) -> str:
        return self._mut_core.kind

    @property
    def device(self) -> torch.device:
        return self._mut_core.main.device

    @property
    def dim(self) -> int:
        return int(self._mut_core.main.dim)

    @property
    def metric(self) -> DistanceType:
        return self._mut_core.main.metric

    @property
    def size(self) -> int:
        """LIVE rows (main + delta minus tombstones)."""
        return self._mut_core.live_count

    @property
    def delta_rows(self) -> int:
        return self._mut_core.delta_rows

    @property
    def tombstone_count(self) -> int:
        return self._mut_core.tombstones

    def delta_fraction(self) -> float:
        core = self._mut_core
        return core.delta_rows / max(core.live_count, 1)

    def tombstone_fraction(self) -> float:
        core = self._mut_core
        denom = (core.main_ids.size + len(core.delta_live)
                 + len(core.delta_dead))
        return core.tombstones / max(denom, 1)

    def live_rows(self) -> Tuple[torch.Tensor, np.ndarray]:
        """(vectors on the device, ids) of every live row: the main's in
        id order, then the delta's in insertion order."""
        with self._lock:
            return self._live_rows_locked(self._mut_core)

    def to_index(self, engine: Optional[str] = None):
        """A rebuild of the live rows from scratch with *build_params* (it
        retrains the coarse model, so below full probe coverage it probes
        other lists)."""
        expects(self.build_params is not None,
                "to_index()/compact() need build_params")
        x, ids = self.live_rows()
        return _family(self.kind).build(
            self.build_params, x, ids=torch.as_tensor(ids, dtype=torch.int32),
            device=self.device, engine=engine)

    def searcher(self, k: int, params=None,
                 engine: Optional[str] = None) -> "MutableSearcher":
        """The serving searcher of (k, params, engine), made once."""
        key = (int(k), repr(params), engine)
        with self._lock:
            s = self._searchers.get(key)
            if s is None:
                s = MutableSearcher(self, int(k), params, engine)
                self._searchers[key] = s
            return s

    def _snapshot(self):
        """(main, delta, main bitmap, delta bitmap) of the current core,
        the current stream made to wait for the last write and marked on
        every tensor of the snapshot."""
        with self._lock:
            core = self._mut_core
            snap = (core.main, core.delta, core.tomb_main_bits,
                    None if core.delta is None else core.tomb_delta_bits)
            ready = core.ready
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        if self.device.type == "cuda":
            _mark_used(_tensors(snap[0]) + [snap[2], snap[3]]
                       + (_tensors(snap[1]) if snap[1] is not None else []))
        return snap

    # -- write side ---------------------------------------------------------

    def delete(self, ids) -> int:
        """Tombstone *ids*; unknown or already-dead ids are a no-op.
        Returns the rows newly tombstoned."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._lock:
            if self._journal is not None:
                self._journal.append(("delete", ids.copy()))
            n = self._delete_core(self._mut_core, ids)
            self._record_state(self._mut_core)
            return n

    def upsert(self, x, ids) -> None:
        """Insert or replace rows: tombstone any old row of these ids (in
        main or delta) and append the new rows into the delta.  Upserting
        an id still packed in the delta first repacks the delta without
        it (an append-only segment cannot mask one of two rows of one
        id)."""
        x = torch.as_tensor(x, device=self.device)
        expects(x.ndim == 2 and x.shape[1] == self.dim,
                "upsert rows must be (n, dim)")
        ids = np.asarray(ids, np.int64)
        expects(ids.shape == (x.shape[0],), "ids must be (n,)")
        expects(ids.size == np.unique(ids).size,
                "upsert ids must be unique within the batch")
        expects(ids.size == 0 or int(ids.min()) >= 0,
                "ids must be non-negative")
        x = x.to(self._mut_core.main_x.dtype)
        with self._lock:
            if self._journal is not None:
                # compaction replays it on its own stream after the clone
                self._journal.append(("upsert", x.clone(), ids.copy(),
                                      _record_event(self.device)))
            self._upsert_core(self._mut_core, x, ids)
            self._record_state(self._mut_core)

    def _restore_roster(self, main_ids: np.ndarray, max_id: int) -> None:
        """After a load: the main's full id roster (dead ids included,
        without rows) and a bitmap wide enough for *max_id*."""
        with self._lock:
            core = self._mut_core
            row = np.full(main_ids.size, -1, np.int64)
            pos = np.searchsorted(main_ids, core.main_ids)
            row[pos] = core.main_row
            core.main_ids, core.main_row = main_ids, row
            top = max(max_id, int(main_ids.max()) if main_ids.size else 0)
            if _tomb_words(top) > core.n_words:
                self._grow_tombstones(core, _tomb_words(top))

    # each op acts on an EXPLICIT core: the live one, or compaction's new
    # one while it replays the journal

    def _delete_core(self, core: _Core, ids: np.ndarray) -> int:
        n = 0
        for j, in_main in zip(ids.tolist(), core.in_main(ids).tolist()):
            if j in core.delta_live:
                del core.delta_live[j]
                core.delta_dead.add(j)
                core.words_delta[j >> 5] |= np.uint32(1 << (j & 31))
                n += 1
            elif in_main and j not in core.main_dead:
                core.main_dead.add(j)
                core.words_main[j >> 5] |= np.uint32(1 << (j & 31))
                n += 1
        if n:
            self._push_tombstones(core)
        mutable_counters.inc("deletes")
        mutable_counters.inc("delete_rows", n)
        return n

    def _upsert_core(self, core: _Core, x: torch.Tensor,
                     ids: np.ndarray) -> None:
        top = max(int(ids.max()) if ids.size else 0, core.n_words * 32 - 1)
        if _tomb_words(top) != core.n_words:
            self._grow_tombstones(core, _tomb_words(top))
        stale = {j for j in ids.tolist()
                 if j in core.delta_live or j in core.delta_dead}
        if stale:
            self._rebuild_delta(core, exclude=stale)
        dirty = False
        for j in ids[core.in_main(ids)].tolist():
            if j not in core.main_dead:
                core.main_dead.add(j)
                core.words_main[j >> 5] |= np.uint32(1 << (j & 31))
                dirty = True
        if dirty:
            self._push_tombstones(core)
        self._delta_append(core, x, ids)
        for r, j in enumerate(ids.tolist()):
            core.delta_x[j] = x[r]
            core.delta_live[j] = True
        mutable_counters.inc("upserts")
        mutable_counters.inc("upsert_rows", int(ids.size))

    def _delta_append(self, core: _Core, x: torch.Tensor,
                      ids: np.ndarray) -> None:
        """Append into the delta through the family's copying extend: the
        old delta tensors stay as they are for any scan still reading
        them."""
        if core.delta is None:
            core.delta = self._empty_delta(core)
        _mark_used(_tensors(core.delta))
        core.delta = _family(core.kind).extend(
            core.delta, x, torch.as_tensor(ids, dtype=torch.int32,
                                           device=x.device))
        self._mark_ready(core)

    def _rebuild_delta(self, core: _Core, exclude=()) -> None:
        """Repack the delta from its live rows minus *exclude*; dead rows
        go, so the delta bitmap clears."""
        keep = [j for j in core.delta_live if j not in exclude]
        core.words_delta[:] = 0
        core.delta_dead.clear()
        core.delta = None
        core.delta_live = {}
        core.delta_x = {j: core.delta_x[j] for j in keep}
        if keep:
            self._delta_append(core, torch.stack([core.delta_x[j]
                                                  for j in keep]),
                               np.asarray(keep, np.int64))
            core.delta_live = dict.fromkeys(keep, True)
        self._push_tombstones(core)
        mutable_counters.inc("delta_rebuilds")

    def _grow_tombstones(self, core: _Core, n_words: int) -> None:
        for name in ("words_main", "words_delta"):
            grown = np.zeros(n_words, np.uint32)
            grown[:core.n_words] = getattr(core, name)
            setattr(core, name, grown)
        core.n_words = int(n_words)
        self._push_tombstones(core)

    def _push_tombstones(self, core: _Core) -> None:
        """Upload both bitmaps as NEW device tensors (one O(n_words) copy
        per write batch): a scan still reading the old ones is left
        alone."""
        dev = core.main.device
        core.tomb_main_bits = torch.from_numpy(
            core.words_main.view(np.int32).copy()).to(dev)
        core.tomb_delta_bits = torch.from_numpy(
            core.words_delta.view(np.int32).copy()).to(dev)
        self._mark_ready(core)

    @staticmethod
    def _mark_ready(core: _Core) -> None:
        core.ready = _record_event(core.main.device)

    def _empty_delta(self, core: _Core):
        """A zero-row index of the main's family sharing its trained model,
        so delta rows land in the lists a rebuild would put them in."""
        m = core.main
        dev = m.device
        common = dict(
            list_indices=torch.full((1, 1), -1, dtype=torch.int32,
                                    device=dev),
            list_sizes=torch.zeros(m.n_lists, dtype=torch.int32, device=dev),
            phys_sizes=torch.zeros(1, dtype=torch.int32, device=dev),
            chunk_table=torch.zeros((m.n_lists, 1), dtype=torch.int32,
                                    device=dev),
            metric=m.metric)
        if core.kind == "ivf_flat":
            return ivf_flat.Index(
                centers=m.centers, list_data=torch.zeros(
                    (1, 1, m.dim), dtype=m.list_data.dtype, device=dev),
                adaptive_centers=False, **common)
        return ivf_pq.Index(
            centers=m.centers, rotation=m.rotation, codebooks=m.codebooks,
            list_codes=torch.zeros((1, 1, m.list_codes.shape[-1]),
                                   dtype=torch.uint8, device=dev),
            owner=torch.zeros(1, dtype=torch.int32, device=dev),
            list_adc=m.list_adc, list_csum=torch.zeros((1, 1), device=dev),
            codebook_kind=m.codebook_kind, pq_bits=m.pq_bits,
            dataset_dtype=m.dataset_dtype, **common)

    def _live_rows_locked(self, core: _Core):
        live = core.main_live_mask()
        ids = np.concatenate([core.main_ids[live],
                              np.fromiter(core.delta_live, np.int64,
                                          len(core.delta_live))])
        rows = core.main_row[live]
        expects(bool((rows >= 0).all()), "a live main row has no vector")
        _mark_used([core.main_x])
        parts = [core.main_x[torch.as_tensor(rows, device=core.main_x.device)]]
        if core.delta_live:
            parts.append(torch.stack([core.delta_x[j]
                                      for j in core.delta_live]))
        return torch.cat(parts), ids

    def _record_state(self, core: _Core) -> None:
        _delta_rows_gauge.set(core.delta_rows)
        _tombstones_gauge.set(core.tombstones)

    # -- compaction ---------------------------------------------------------

    def compact_due(self, delta_fraction: float = 0.10,
                    tomb_fraction: float = 0.10) -> bool:
        return (self.delta_fraction() >= delta_fraction
                or self.tombstone_fraction() >= tomb_fraction)

    def compact(self, engine=None) -> None:
        """Rebuild main ∪ delta minus tombstones off the request path and
        swap it in: the live rows are taken under the lock, the family
        ``build`` runs outside it (on its own stream on the card) while
        the old core serves, the writes that came meanwhile are replayed
        from a journal, the core is swapped under the lock, and — with
        *engine* — promoted through ``ServeEngine.refresh`` (its only
        door for a swap)."""
        expects(self.build_params is not None, "compact() needs build_params")
        family = _family(self.kind)
        dev = self.device
        with self._compact_lock:
            t0 = time.perf_counter()
            with self._lock:
                self._journal = []
                core = self._mut_core
                x, ids = self._live_rows_locked(core)
            stream = None
            if dev.type == "cuda":
                if self._compact_stream is None:
                    self._compact_stream = torch.cuda.Stream(dev)
                stream = self._compact_stream
                stream.wait_stream(torch.cuda.current_stream(dev))
                _mark_used([x])
            try:
                with _on(stream):
                    main = family.build(
                        self.build_params, x,
                        ids=torch.as_tensor(ids, dtype=torch.int32,
                                            device=dev), device=dev)
                    order = np.argsort(ids, kind="stable")
                    new_core = _Core(core.kind, main, ids[order], order, x,
                                     _tomb_words(int(ids.max())
                                                 if ids.size else 0))
                    self._push_tombstones(new_core)
                    applied = 0
                    while True:   # chase the journal until its tail is short
                        with self._lock:
                            pending = list(self._journal[applied:])
                        if len(pending) <= 4:
                            break
                        for op in pending:
                            self._apply_op(new_core, op)
                        applied += len(pending)
                with self._lock:
                    with _on(stream):
                        for op in self._journal[applied:]:
                            self._apply_op(new_core, op)
                    if stream is not None:
                        stream.synchronize()
                    self._journal = None
                    self._mut_core = new_core
                    self._record_state(new_core)
            except BaseException:
                with self._lock:
                    self._journal = None
                raise
            _compactions_counter.inc(1)
            compaction_seconds.observe(time.perf_counter() - t0)
        if engine is not None:
            engine.refresh(self)

    def _apply_op(self, core: _Core, op) -> None:
        if op[0] == "delete":
            self._delete_core(core, op[1])
            return
        _, x, ids, ev = op
        if ev is not None:
            torch.cuda.current_stream(x.device).wait_event(ev)
            _mark_used([x])
        self._upsert_core(core, x, ids)


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _record_event(device: torch.device):
    """An event at the end of the work queued so far on the current
    stream (None on the CPU, where that work is done)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


# ---------------------------------------------------------------------------
# the serving searcher


class MutableSearcher:
    """The serving entry of one (MutableIndex, k, params) key — what
    ``serve.ServeEngine``'s mutable backend dispatches: one pre-bucketed
    batch against a snapshot of the core (:func:`_merged_search_impl`)."""

    def __init__(self, mutable: MutableIndex, k: int, params=None,
                 engine: Optional[str] = None):
        expects(k >= 1, "k must be >= 1")
        self.mutable = mutable
        self.kind = mutable.kind
        self.k = int(k)
        self.name = f"mutable_{self.kind}"
        self.metric = mutable.metric
        self.dim = mutable.dim
        main = mutable._mut_core.main
        if self.kind == "ivf_flat":
            self.params = params or ivf_flat.SearchParams()
            self.lut_dtype = "float32"
            sk = resolve_engine("select_k", main.device, engine=engine)
            self.engines = (sk, sk)
            self.pq_kw = {}
        else:
            self.params = params or ivf_pq.SearchParams()
            ivf_pq.check_search_params(self.params)
            self.lut_dtype = self.params.lut_dtype
            self.engines = ivf_pq._resolve_engines(main, engine)
            self.pq_kw = dict(
                int_dtype=self.params.internal_distance_dtype,
                hoisted=ivf_pq._resolve_hoisted(self.params))
        self.engine = engine
        self.n_probes = int(min(self.params.n_probes, main.n_lists))

    def batch_cap(self) -> Optional[int]:
        """The compressed-LUT batch cap of IVF-PQ, sized by the main."""
        if self.kind != "ivf_pq":
            return None
        return ivf_pq.hoisted_batch_cap(self.mutable._mut_core.main,
                                        self.n_probes, self.lut_dtype,
                                        self.pq_kw["hoisted"])

    def dispatch(self, qb: torch.Tensor):
        main, delta, tm, td = self.mutable._snapshot()
        return _merged_search_impl(qb, main, delta, tm, td, self.k,
                                   self.n_probes, self.lut_dtype,
                                   self.engines, self.pq_kw)

    def solo(self, q):
        return search(self.mutable, q, self.k, params=self.params,
                      engine=self.engine)


def _ingest(mutable: MutableIndex, queries) -> torch.Tensor:
    """Float32 queries on the index's device, as the family ``search``
    converts them (cosine rows normalized)."""
    main = mutable._mut_core.main
    if mutable.kind == "ivf_pq":
        q, q_dtype = ivf_pq._ingest_dataset(queries, main.device)
        expects(q_dtype in (main.dataset_dtype, "float32"),
                f"query dtype {q_dtype} != index dataset dtype "
                f"{main.dataset_dtype}")
    else:
        q = ivf_flat._ingest(queries, main.device).float()
        if main.metric == DistanceType.CosineExpanded:
            q = ivf_flat._normalize_rows(q)
    expects(q.ndim == 2 and q.shape[1] == mutable.dim, "query dim mismatch")
    return q


def search(mutable: MutableIndex, queries, k: int, params=None,
           engine: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search main ∪ delta minus tombstones: (distances (nq, k) f32,
    indices (nq, k) int32) on the index's device.  Batches of 1,024
    queries, the tail padded to the power-of-two bucket ladder, as the
    family searches."""
    s = mutable.searcher(int(k), params, engine)
    q = _ingest(mutable, queries)
    nq = q.shape[0]
    if nq == 0:
        return empty_result(0, int(k), torch.float32, mutable.device)
    out_d, out_i = [], []
    for q0 in range(0, nq, _BATCH):
        qb = q[q0:q0 + _BATCH]
        n = qb.shape[0]
        bucket = min(bucket_dim(n), _BATCH)
        if bucket != n:
            qb = torch.cat([qb, qb.new_zeros((bucket - n, qb.shape[1]))])
        d, i = s.dispatch(qb)
        out_d.append(d[:n])
        out_i.append(i[:n])
    if len(out_d) == 1:
        return out_d[0], out_i[0]
    return torch.cat(out_d), torch.cat(out_i)


# ---------------------------------------------------------------------------
# background compaction


class Compactor:
    """Background compaction: past a delta-fraction or tombstone-fraction
    threshold, :meth:`MutableIndex.compact` (and the promotion through
    ``engine.refresh``).  ``start()`` runs a daemon thread whose sleep
    jitter is seeded; without it, drive :meth:`tick` by hand."""

    def __init__(self, mutable: MutableIndex, engine=None, *,
                 delta_fraction: float = 0.10, tomb_fraction: float = 0.10,
                 interval_s: float = 1.0, seed: int = 0):
        self.mutable = mutable
        self.engine = engine
        self.delta_fraction = float(delta_fraction)
        self.tomb_fraction = float(tomb_fraction)
        self.interval_s = float(interval_s)
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._thread = None
        self.compactions = 0
        self.errors = 0

    def due(self) -> bool:
        return self.mutable.compact_due(self.delta_fraction,
                                        self.tomb_fraction)

    def tick(self) -> bool:
        """One check-and-compact step.  An error (an injected refresh
        fault too) is contained: the old core — or, if the swap was done,
        the new one — keeps serving, the error is counted, and the next
        tick retries."""
        if not self.due():
            return False
        try:
            self.mutable.compact(self.engine)
        except Exception:
            self.errors += 1
            mutable_counters.inc("compaction_errors")
            return False
        self.compactions += 1
        return True

    def start(self) -> "Compactor":
        expects(self._thread is None, "compactor already started")
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                self.tick()
                self._stop.wait(self.interval_s * (0.5 + self._rng.random()))

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="raft-tpu-torch-compactor")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
