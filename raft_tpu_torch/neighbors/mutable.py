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

**A sharded main.**  *main* may be an ``ann_mnmg.ShardedIndex`` of an
IVF kind (reference ``MutableIndex`` :262-300).  The port runs one
process per rank, so every rank holds its own shard of the main and the
same host books, the same delta (a single-device index of the family on
the sharded main's trained model) and the same bitmap, keyed by global
row id.  The direct API is a collective, like ``build_sharded`` and
``ann_mnmg.search``: every rank calls ``upsert``, ``delete``, ``search``,
``to_index`` and ``compact`` with the same arguments and gets the same
bits back.  A search runs the masked sharded main
(``ann_mnmg.ShardedSearcher(masked=True)``: one allgather, squared
distances) and the delta's scan, folds them with ``merge_sorted_parts``
(main as part 0) and takes the root once — the single-device rule, so at
world 1 the bits are the single-device index's.  ``to_index`` and
``compact`` go through the family ``build_sharded``.  Compaction issues
its collectives on a communicator of its own (``Comms.dup``, made by
every rank when the index is made), so a compaction under traffic never
interleaves its broadcasts with the serving allgathers.  Served by a
``serve.ServeEngine`` (rank 0 leads, the others follow), the leader's
writes and compactions reach every rank through the engine's control
plane (``serve.spmd``: WRITE and COMPACT), in one order with its
dispatches, and the compacted core is swapped at one point of that order
on every rank.  Closing that engine waits for a compaction in flight;
stop a started ``Compactor`` before it (after the close a compaction is
a collective of the direct API again).

**Zero-compile reads.**  A read runs the keyed program
:data:`_merged_aot` (reference ``_merged_aot`` :161; over a sharded main,
each rank's keyed shard programs and :data:`_fold_aot`), whose signature
holds the shapes of the main, the delta and both bitmaps.  The delta
grows up the power-of-two ladder (``extend(ladder=True)``: its blocks'
rows and its chunk table's width), and the bitmaps by word buckets, so
those shapes change O(log n) times over an index's life.  A write that
changes them re-runs every signature the index's searchers have served
at the new shapes before it returns (:meth:`MutableIndex.
_rewarm_locked`, reference :589; counted as ``mutable_counters
["rewarms"]``), and compaction warms its new core before the swap, so
the first calls ride the write path and a read makes none.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.analysis.registry import audit_program
from raft_tpu_torch import telemetry
from raft_tpu_torch.core.aot import TensorSpec, aot
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

#: what the leader's WRITE carries (``serve.spmd``, the header's
#: argument), and the phases of its COMPACT
WRITE_DELETE, WRITE_UPSERT = 0, 1
COMPACT_START, COMPACT_SWAP, COMPACT_ABORT = 0, 1, 2


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


@audit_program(
    "mutable.delta_merged_search", transient_bytes=4 << 20,
    notes="main ∪ delta, each scan masked by its bitmap, folded by "
          "merge_sorted_parts — the mutable backend's batch")
def _merged_search_impl(q, main, delta, tomb_main, tomb_delta, k: int,
                        n_probes: int, lut_dtype: str,
                        engines: Tuple[str, str], pq_kw=None):
    """main ∪ delta for one batch: two masked family scans folded by
    ``merge_sorted_parts`` (main is part 0 and wins ties); the L2Sqrt
    root is taken after the fold, which compares squared distances."""
    pq_kw = pq_kw or {}
    d, i = _family_scan(q, main, k, n_probes, lut_dtype, engines, tomb_main,
                        pq_kw)
    return _fold_delta(q, d, i, main.metric, delta, tomb_delta, k, n_probes,
                       lut_dtype, engines, pq_kw)


#: the single-device read, keyed per signature (``raft_tpu/neighbors/
#: mutable.py:161`` ``_merged_aot``): the shapes of main, delta and both
#: bitmaps are in its key, so a delta without rows (None) is a signature
#: of its own, as in the reference
_merged_aot = aot(_merged_search_impl, static_argnums=(5, 6, 7, 8))


def _sharded_merged_search_impl(q, main_searcher, delta, tomb_main,
                                tomb_delta, k: int, n_probes: int,
                                lut_dtype: str, engines: Tuple[str, str],
                                pq_kw=None):
    """main ∪ delta for one batch over a sharded main (a collective): the
    masked ``ShardedSearcher`` (every rank's keyed scan, one allgather,
    the keyed fold, squared distances), then the delta's scan and the
    fold of :func:`_merged_search_impl` (:data:`_fold_aot`, this rank's
    own program)."""
    d, i = main_searcher.dispatch(q, tomb_main)
    return _fold_aot(q, d, i, main_searcher.sharded.metric, delta,
                     tomb_delta, k, n_probes, lut_dtype, engines,
                     pq_kw or {})


def _fold_delta(q, d, i, metric, delta, tomb_delta, k: int, n_probes: int,
                lut_dtype: str, engines: Tuple[str, str], pq_kw):
    if delta is not None:
        dd, di = _family_scan(q, delta, k, n_probes, lut_dtype, engines,
                              tomb_delta, pq_kw)
        d, i = merge_sorted_parts(
            torch.stack([d, dd]), torch.stack([i, di]), k=k,
            select_min=metric != DistanceType.InnerProduct)
    if metric == DistanceType.L2SqrtExpanded:
        d = torch.sqrt(torch.clamp_min(d, 0.0))
    return d, i


#: a sharded main's delta scan and fold on this rank, keyed per signature
#: (the reference's delta-only ``_merged_aot`` and ``_merge_aot`` pair)
_fold_aot = aot(_fold_delta, static_argnums=(3, 6, 7, 8, 9))


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
                 "tomb_delta_bits", "ready", "searchers")

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
        #: a sharded main's masked searchers by serving key (each reads
        #: this core's shard blocks)
        self.searchers: Dict[tuple, object] = {}

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


def _leaf_shapes(core: _Core):
    """What of *core* the read's signature keys on and a write can change:
    the bitmap words and the delta's tensor shapes (reference :233)."""
    delta = None if core.delta is None else tuple(
        tuple(t.shape) for t in _tensors(core.delta))
    return core.n_words, delta


class MutableIndex:
    """(main index, delta segment, tombstones) with writes while serving.

    *main* is an ``ivf_flat.Index`` or ``ivf_pq.Index``, or this rank's
    ``ann_mnmg.ShardedIndex`` of one of them (then the communicator is the
    main's; *comms*, if passed, must be it); *dataset* / *ids* are the
    rows it was built from (kept on the main's device: compaction
    re-encodes the live rows from them; every rank of a sharded main
    passes all of them); *build_params* is the family ``IndexParams``
    compaction rebuilds with.  State changes only through :meth:`upsert`,
    :meth:`delete` and :meth:`compact`; reads go through :func:`search`
    or a :meth:`searcher` (what ``serve.ServeEngine``'s mutable backends
    dispatch).  Over a sharded main every one of these is a collective
    (module doc)."""

    def __init__(self, main, dataset, ids=None, *, build_params=None,
                 comms=None):
        from raft_tpu_torch.neighbors import ann_mnmg

        self._comms = self._compact_comms = None
        if isinstance(main, ann_mnmg.ShardedIndex):
            kind = main.kind
            expects(kind in ("ivf_flat", "ivf_pq"),
                    "MutableIndex needs an IVF kind (brute force has no "
                    "id-carrying probe scan to mask)")
            expects(comms is None or comms is main.comms,
                    "MutableIndex: a sharded main brings its communicator")
            self._comms = main.comms
        else:
            expects(comms is None, "MutableIndex: comms= goes with a "
                    "sharded main (an ann_mnmg.ShardedIndex)")
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
        #: the control plane of the engine that leads this (sharded)
        #: index, on its leader: writes and compactions reach every rank
        #: through it; and a follower's compaction in flight
        self._wire = None
        self._follower_compaction = None
        self._push_tombstones(self._mut_core)
        if self._comms is not None:
            self._compact_comms = self._comms.dup()

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
    def sharded(self) -> bool:
        """True when the main is an ``ann_mnmg.ShardedIndex``."""
        return self._comms is not None

    @property
    def comms(self):
        """The communicator of a sharded main (None otherwise)."""
        return self._comms

    @property
    def dataset_dtype(self) -> str:
        main = self._mut_core.main
        return (main.aux["dataset_dtype"] if self.sharded
                else main.dataset_dtype)

    def _model(self, core: "_Core"):
        """A single-device index holding the main's trained model (a
        sharded main: this rank's shard as ``local_index``)."""
        return core.main.local_index() if self.sharded else core.main

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
        other lists); over a sharded main, ``build_sharded`` over its
        communicator (a collective)."""
        expects(self.build_params is not None,
                "to_index()/compact() need build_params")
        x, ids = self.live_rows()
        return self._build(x, ids, self._comms, engine)

    def _build(self, x: torch.Tensor, ids: np.ndarray, comms,
               engine: Optional[str] = None):
        family = _family(self.kind)
        ids_t = torch.as_tensor(ids, dtype=torch.int32, device=x.device)
        if comms is not None:
            return family.build_sharded(self.build_params, x, comms,
                                        ids=ids_t, device=self.device,
                                        engine=engine)
        return family.build(self.build_params, x, ids=ids_t,
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

    def _capture_locked(self):
        core = self._mut_core
        return (core, core.delta, core.tomb_main_bits,
                None if core.delta is None else core.tomb_delta_bits,
                core.ready)

    def _capture(self):
        """(core, delta, main bitmap, delta bitmap, event of the last
        write) of the current core, taken under the lock: every write
        makes new tensors, so these stay one consistent state."""
        with self._lock:
            return self._capture_locked()

    def _snapshot(self, captured=None):
        """(core, delta, main bitmap, delta bitmap) of *captured* (default:
        the current core, taken under the write lock), the current stream
        made to wait for its last write and marked on every tensor of the
        snapshot."""
        if captured is None:
            with self._lock:
                captured = self._capture_locked()
        core, delta, tm, td, ready = captured
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        if self.device.type == "cuda":
            main = core.main
            tensors = (list(main.replicated) + list(main.stacked)
                       if self.sharded else _tensors(main))
            _mark_used(tensors + [tm, td]
                       + (_tensors(delta) if delta is not None else []))
        return core, delta, tm, td

    # -- write side ---------------------------------------------------------

    def delete(self, ids) -> int:
        """Tombstone *ids*; unknown or already-dead ids are a no-op.
        Returns the rows newly tombstoned.  On the leader of an engine
        over a sharded main the delete reaches every rank."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._fanned("write") as post:
            n = self._apply_delete(ids)
            post(WRITE_DELETE, ids, None)
        return n

    def upsert(self, x, ids) -> None:
        """Insert or replace rows: tombstone any old row of these ids (in
        main or delta) and append the new rows into the delta.  Upserting
        an id still packed in the delta first repacks the delta without
        it (an append-only segment cannot mask one of two rows of one
        id).  On the leader of an engine over a sharded main the upsert
        reaches every rank."""
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
        with self._fanned("write") as post:
            self._apply_upsert(x, ids)
            post(WRITE_UPSERT, ids, x)

    def _apply_delete(self, ids: np.ndarray) -> int:
        with self._lock:
            if self._journal is not None:
                self._journal.append(("delete", ids.copy()))
            n = self._delete_core(self._mut_core, ids)
            self._record_state(self._mut_core)
            return n

    def _apply_upsert(self, x: torch.Tensor, ids: np.ndarray) -> None:
        with self._lock:
            if self._journal is not None:
                # compaction replays it on its own stream after the clone
                self._journal.append(("upsert", x.clone(), ids.copy(),
                                      _record_event(self.device)))
            before = _leaf_shapes(self._mut_core)
            self._upsert_core(self._mut_core, x, ids)
            if _leaf_shapes(self._mut_core) != before:
                self._rewarm_locked()
            self._record_state(self._mut_core)

    def _rewarm_locked(self) -> None:
        """A write changed the delta's or the bitmaps' shapes: run every
        signature the searchers have served at the new shapes before the
        write returns (reference :589), so the first calls ride the write
        path and the reads make none.  Rank-local over a sharded main (no
        collective: each rank's keyed programs alone)."""
        for s in list(self._searchers.values()):
            s._warm_core(self._mut_core)
        mutable_counters.inc("rewarms")

    # -- the leader/follower fan-out of a served sharded main ---------------

    def _attach(self, wire) -> None:
        """Route this rank's writes and compactions through *wire* (the
        control plane of the engine it leads)."""
        expects(self.sharded, "only a sharded main fans its writes out")
        with self._lock:
            expects(self._wire in (None, wire), "a sharded MutableIndex "
                    "is served by one engine at a time")
            self._wire = wire

    def _detach(self, wire) -> None:
        """Stop routing through *wire*; a compaction in flight finishes
        first, so its swap reaches the followers before the engine
        releases them."""
        with self._compact_lock, self._lock:
            if self._wire is wire:
                self._wire = None

    @contextlib.contextmanager
    def _fanned(self, op: str):
        """Hold the wire's lane lock (when an engine leads this index)
        around one write or compaction step, so it takes its place in the
        order of the dispatches; yields ``post(...)``, which sends the
        step to the followers (``op`` "write": ``LaneWire.post_write``,
        "compact": ``post_compact``).  The sends are waited on after the
        lock is released."""
        wire = self._wire
        if wire is None:
            yield lambda *a: None
            return
        send = wire.post_write if op == "write" else wire.post_compact
        works = []
        with wire.locks[wire.lane]:
            yield lambda *a: works.extend(send(*a))
        for w, _ in works:
            w.wait()

    def _apply_remote_write(self, op_arg: int, ids: np.ndarray,
                            rows: Optional[torch.Tensor]) -> None:
        """A follower's share of the leader's write (``serve.spmd``
        WRITE)."""
        ids = np.asarray(ids, np.int64)
        if op_arg == WRITE_DELETE:
            self._apply_delete(ids)
        elif ids.size:
            self._apply_upsert(rows.to(self.device), ids)

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
                                           device=x.device), ladder=True)
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
        m = self._model(core)
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
        ``build`` (``build_sharded`` over the index's compaction
        communicator, for a sharded main) runs outside it (on its own
        stream on the card) while the old core serves, the writes that
        came meanwhile are replayed from a journal, the core is swapped
        under the lock, and — with *engine* — promoted through
        ``ServeEngine.refresh`` (its only door for a swap).  On the leader
        of an engine over a sharded main every rank compacts with it:
        COMPACT starts each follower's share at the leader's snapshot,
        and the swap lands at one point of the write and dispatch order
        on every rank."""
        expects(self.build_params is not None, "compact() needs build_params")
        with self._compact_lock:
            t0 = time.perf_counter()
            with self._fanned("compact") as post:
                begun = self._compact_begin()
                post(COMPACT_START)
            try:
                built = self._compact_build(*begun)
                with self._fanned("compact") as post:
                    self._compact_swap(built)
                    post(COMPACT_SWAP)
            except BaseException:
                with self._fanned("compact") as post:
                    with self._lock:
                        self._journal = None
                    post(COMPACT_ABORT)
                raise
            _compactions_counter.inc(1)
            compaction_seconds.observe(time.perf_counter() - t0)
        if engine is not None:
            engine.refresh(self)

    def _compact_begin(self):
        """Start the journal and take the live rows: (core, rows, ids)."""
        with self._lock:
            self._journal = []
            core = self._mut_core
            x, ids = self._live_rows_locked(core)
        return core, x, ids

    def _compact_build(self, core: _Core, x: torch.Tensor, ids: np.ndarray):
        """The new core of the live rows, on the compaction stream, with
        the journal chased until its tail is short."""
        stream = self._compaction_stream()
        if stream is not None:
            _mark_used([x])
        try:
            with _on(stream):
                main = self._build(x, ids, self._compact_comms)
                if self.sharded:
                    # built over the compaction communicator, served over
                    # the index's own
                    main = type(main)(main.kind, self._comms, main.replicated,
                                      main.stacked, main.aux)
                order = np.argsort(ids, kind="stable")
                new_core = _Core(core.kind, main, ids[order], order, x,
                                 _tomb_words(int(ids.max())
                                             if ids.size else 0))
                self._push_tombstones(new_core)
                applied = 0
                while True:
                    with self._lock:
                        pending = list(self._journal[applied:])
                    if len(pending) <= 4:
                        break
                    for op in pending:
                        self._apply_op(new_core, op)
                    applied += len(pending)
            # the new core's signatures, warmed while the old serves, on
            # this thread's stream after the build's work (the warm runs'
            # transients stay out of the compaction stream's pool)
            _after(stream, self.device)
            self._warm_for_core(new_core)
        except BaseException:
            with self._lock:
                self._journal = None
            raise
        return new_core, applied, stream

    def _compaction_stream(self):
        dev = self.device
        if dev.type != "cuda":
            return None
        if self._compact_stream is None:
            self._compact_stream = torch.cuda.Stream(dev)
        stream = self._compact_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        return stream

    def _compact_swap(self, built) -> None:
        """Replay the journal's tail into the new core and swap it in."""
        new_core, applied, stream = built
        with self._lock:
            with _on(stream):
                for op in self._journal[applied:]:
                    self._apply_op(new_core, op)
            # a tail that changed the shapes: warm them (no run where the
            # signatures are warm)
            _after(stream, self.device)
            self._warm_for_core(new_core)
            if stream is not None:
                stream.synchronize()
            self._journal = None
            self._mut_core = new_core
            self._record_state(new_core)

    def _follow_compact(self, phase: int) -> None:
        """A follower's share of the leader's compaction (``serve.spmd``
        COMPACT): START takes the live rows at this point of the write
        order and builds on a thread of its own, so the follower keeps
        serving the old core; SWAP waits for the build (bounded by the
        communicator's timeout) and swaps at the leader's point; ABORT
        drops it."""
        if phase == COMPACT_START:
            expects(self._follower_compaction is None,
                    "COMPACT: a compaction is already in flight")
            begun = self._compact_begin()
            box: Dict[str, object] = {}

            def build():
                try:
                    box["built"] = self._compact_build(*begun)
                except BaseException as e:   # raised at SWAP
                    box["error"] = e

            t = threading.Thread(target=build, daemon=True,
                                 name="raft-tpu-torch-compaction")
            t.start()
            self._follower_compaction = (t, box)
            return
        expects(self._follower_compaction is not None,
                "COMPACT: no compaction in flight")
        t, box = self._follower_compaction
        self._follower_compaction = None
        t.join(self._comms.timeout_s)
        expects(not t.is_alive(), "COMPACT: this rank's share of the "
                "compaction did not finish within the communicator's "
                "timeout")
        if phase == COMPACT_ABORT:
            with self._lock:
                self._journal = None
            return
        if "error" in box:
            raise box["error"]
        self._compact_swap(box["built"])

    def _warm_for_core(self, core: _Core) -> None:
        for s in list(self._searchers.values()):
            s._warm_core(core)

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


def _after(stream, device: torch.device) -> None:
    """Make the current stream wait for the work queued on *stream*."""
    if stream is not None:
        torch.cuda.current_stream(device).wait_stream(stream)


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
    ``serve.ServeEngine``'s mutable backends dispatch: one pre-bucketed
    batch against a snapshot of the core (:data:`_merged_aot`, or
    :func:`_sharded_merged_search_impl` over a sharded main, a
    collective).  Every bucket it dispatches is recorded; a write that
    changes the core's shapes re-runs them (:meth:`_warm_core`)."""

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
        self.device = mutable.device
        #: the program a dispatch runs (the engine's telemetry label)
        self.fn = _merged_aot
        #: the buckets dispatched so far: what a rewarm re-runs
        self._warmed: set = set()

    def _main_searcher(self, core: _Core):
        """The masked ``ShardedSearcher`` over *core*'s main, made once per
        core (it reads that core's shard blocks)."""
        from raft_tpu_torch.neighbors import ann_mnmg

        key = (self.k, repr(self.params), self.engine)
        s = core.searchers.get(key)
        if s is None:
            s = ann_mnmg.ShardedSearcher(core.main, self.k, self.params,
                                         engine=self.engine, masked=True)
            core.searchers[key] = s
        return s

    def batch_cap(self) -> Optional[int]:
        """The compressed-LUT batch cap of IVF-PQ, sized by the main (a
        sharded main: by its shard's scan budget)."""
        if self.kind != "ivf_pq":
            return None
        core = self.mutable._mut_core
        if self.mutable.sharded:
            from raft_tpu_torch.neighbors import ann_mnmg

            return ann_mnmg.batch_cap(core.main, self._main_searcher(core))
        return ivf_pq.hoisted_batch_cap(core.main, self.n_probes,
                                        self.lut_dtype,
                                        self.pq_kw["hoisted"])

    def warm(self, bucket: int, dtype=torch.float32) -> None:
        """Run one batch of *bucket* zero rows (float32: the backends cast
        every request type to it) against the current core and record the
        bucket, so a write that changes the core's shapes re-runs it."""
        self.dispatch(torch.zeros((int(bucket), self.dim),
                                  dtype=torch.float32, device=self.device))

    def _warm_core(self, core: _Core) -> None:
        """Run every recorded bucket whose signature against *core* is not
        warm yet (this rank's keyed programs only: over a sharded main the
        shard scan and the folds, never a collective)."""
        tm = core.tomb_main_bits
        td = None if core.delta is None else core.tomb_delta_bits
        for bucket in sorted(self._warmed):
            q = TensorSpec((bucket, self.dim), torch.float32, self.device)
            if not self.mutable.sharded:
                args = (q, core.main, core.delta, tm, td, self.k,
                        self.n_probes, self.lut_dtype, self.engines,
                        self.pq_kw)
                if not _merged_aot.is_warm(*args):
                    _merged_aot.compiled(*args)
                continue
            self._main_searcher(core).warm_local(bucket, tm)
            run_d = TensorSpec((bucket, self.k), torch.float32, self.device)
            run_i = TensorSpec((bucket, self.k), torch.int32, self.device)
            args = (q, run_d, run_i, self.metric, core.delta, td, self.k,
                    self.n_probes, self.lut_dtype, self.engines, self.pq_kw)
            if not _fold_aot.is_warm(*args):
                _fold_aot.compiled(*args)

    def dispatch(self, qb: torch.Tensor, captured=None):
        """One batch against *captured* (``MutableIndex._capture``; default
        the core as it is now, snapshotted under the write lock)."""
        self._warmed.add(int(qb.shape[0]))
        core, delta, tm, td = self.mutable._snapshot(captured)
        if self.mutable.sharded:
            return _sharded_merged_search_impl(
                qb, self._main_searcher(core), delta, tm, td, self.k,
                self.n_probes, self.lut_dtype, self.engines, self.pq_kw)
        return _merged_aot(qb, core.main, delta, tm, td, self.k,
                           self.n_probes, self.lut_dtype, self.engines,
                           self.pq_kw)

    def solo(self, q, batch: int = 1024):
        return search(self.mutable, q, self.k, params=self.params,
                      engine=self.engine, batch_size_query=batch)


def _ingest(mutable: MutableIndex, queries) -> torch.Tensor:
    """Float32 queries on the index's device, as the family ``search``
    converts them (cosine rows normalized)."""
    if mutable.kind == "ivf_pq":
        q, q_dtype = ivf_pq._ingest_dataset(queries, mutable.device)
        expects(q_dtype in (mutable.dataset_dtype, "float32"),
                f"query dtype {q_dtype} != index dataset dtype "
                f"{mutable.dataset_dtype}")
    else:
        q = ivf_flat._ingest(queries, mutable.device).float()
        if mutable.metric == DistanceType.CosineExpanded:
            q = ivf_flat._normalize_rows(q)
    expects(q.ndim == 2 and q.shape[1] == mutable.dim, "query dim mismatch")
    return q


def search(mutable: MutableIndex, queries, k: int, params=None,
           engine: Optional[str] = None, *, batch_size_query: int = _BATCH
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search main ∪ delta minus tombstones: (distances (nq, k) f32,
    indices (nq, k) int32) on the index's device.  Batches of
    *batch_size_query* queries (IVF-PQ's batch cap below that), the tail
    padded to the power-of-two bucket ladder, as the family searches.
    Over a sharded main a collective; a sharded index that an engine
    leads is searched through that engine."""
    expects(mutable._wire is None, "mutable.search: an engine leads this "
            "sharded index — search through the engine")
    s = mutable.searcher(int(k), params, engine)
    q = _ingest(mutable, queries)
    nq = q.shape[0]
    if nq == 0:
        return empty_result(0, int(k), torch.float32, mutable.device)
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
