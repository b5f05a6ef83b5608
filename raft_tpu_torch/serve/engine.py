"""Batched query serving over brute force, IVF-Flat, IVF-PQ, the mutable
index, the tiered index and the sharded and replicated indexes of
``ann_mnmg`` (port of ``raft_tpu/serve/engine.py``: the backends
:110-291, ``_ShardedBackend`` :294 and ``_ReplicaBackend`` :392 with
``_sharded_ingest`` :341 and ``_sharded_batch_cap`` :376 as their shared
``ingest`` / ``batch_cap``, ``_TieredBackend`` :442 and
``_MutableBackend`` :474 (over a sharded main: ``_ShardedMutableBackend``
here), ``_make_backend`` :527,
``ServeEngine`` :544-1633, with the autotuner's hooks :823-892, replica
routing :1539-1615).

* **Request coalescing** — concurrent ragged requests are grouped by
  type and packed in arrival order into super-batches of at most
  ``max_batch`` rows of ONE type, each padded on the host to its
  power-of-two bucket and searched as ONE batch; results are sliced back
  per request.  Every query row's result is independent of the other
  rows of its batch, so a request's answer equals what the solo
  ``search`` of its index type (``knn`` for a dense index) returns for
  it.  A request larger than the largest warmed bucket is served solo.
  An IVF-PQ engine with a compressed LUT clamps its super-batch to
  ``ivf_pq.hoisted_batch_cap``.
* **Per-type ladders** — ``warmup(dtypes=...)`` warms every bucket for
  each type; ``warmed_signatures()`` maps each type's name (``float32``,
  ``bfloat16``, ``float16``, …) to its buckets, and the cost rows are per
  (type, bucket).  A request keeps its type where its backend's solo
  search would: brute force keeps it (the scan widens it to the index's
  type on the device), IVF-Flat keeps float types and widens int8 /
  uint8 exactly, IVF-PQ widens every type to float32 after its
  dataset-type check.  A request arrives as a numpy array or a tensor; a
  bfloat16 one as a tensor or as ``ml_dtypes`` bits, and it is never
  carried through a numpy bfloat16.
* **Continuous batching** (ON by default) — the telemetry-steered
  chooser (``schedule.choose_batches``) cuts the queue where the measured
  per-bucket costs say; cold, it packs as the drain-all planner does.
  :meth:`ServeEngine.submit` feeds a quantum-paced scheduler thread that
  coalesces submissions across callers (``schedule.should_dispatch``).
  ``scheduler=False`` pins the drain-all planner.
* **Admission** (ON by default) — requests may carry deadlines
  (:class:`~raft_tpu_torch.serve.admission.ServeRequest`); a request whose
  budget cannot cover its projected completion is shed with a typed
  :class:`~raft_tpu_torch.serve.admission.RejectedError` in its slot.
  With no deadlines and no queue bound nothing is shed.
* **Supervised dispatch** — super-batches alternate over the handle's two
  stream lanes, so the host assembles batch i+1 while the card runs batch
  i.  Collection waits on each lane's event under a
  :class:`~raft_tpu_torch.serve.supervise.DispatchSupervisor` (watchdog,
  bounded retry with backoff for transient failures, fail-fast for logic
  bugs and device errors).  A re-dispatch goes to the other lane: a CUDA
  kernel cannot be cancelled, so it must not queue behind stalled work.
  A request that fails ingest fails alone; a failed multi-member
  super-batch is split and re-dispatched member by member.  Nothing
  falls back to the plain PyTorch versions.
* ``refresh()`` swaps the index atomically (the old backend keeps serving
  until the new one has run every warmed signature), ``close()`` is
  bounded and idempotent.
* **Telemetry** — ``serve.*`` spans (host wall time only, no device
  synchronisation), a per-engine latency histogram
  (:meth:`ServeEngine.latency_quantiles`), each submitted request's wait
  in the queue (``raft_tpu_serve_queue_wait_seconds{engine}``, and a
  ``serve.hold`` span while the scheduler holds work back for a fuller
  bucket), ``stats`` as a registry-backed
  counter view, per-dispatch host time into
  ``raft_tpu_aot_dispatch_seconds{fn,sig}`` (``sig`` =
  ``"{type}[bucket,dim]"``) and sampled device time (CUDA events on the
  lane, read after collection has waited anyway) into
  ``raft_tpu_device_seconds{fn}`` — the costs admission and the chooser
  read.  :meth:`ServeEngine.serve_http` serves ``/metrics``, ``/healthz``,
  ``/varz`` and ``/debug/slow``.

A ``mutable.MutableIndex`` is served by the mutable backend (main ∪
delta, tombstones masked in the scan) while ``upsert`` / ``delete`` run
on it; its compaction promotes the new core through :meth:`refresh`.
Over a sharded main it is a distributed index (below): the leader's
``upsert`` / ``delete`` and its compactions (a ``Compactor`` driving
``compact(engine=...)``) reach every rank as the control plane's WRITE
and COMPACT ops, and every dispatch sees the index as it stands at its
place in the order of those ops.  A
``tiering.TieredIndex`` is served by the tiered backend (hot block on
the device, cold tiles staged per batch, optional exact re-rank);
``refresh(tiering.retier(t, searcher.hotness()))`` re-tiers it, and
``/healthz`` reports its residency.

**Distributed serving.**  An ``ann_mnmg.ShardedIndex`` is served by the
sharded backend: every super-batch runs on every rank of the index's
communicator (one allgather each).  An ``ann_mnmg.ReplicaSet`` is served
by the replica backend: each super-batch runs on ONE replica group, the
one the :class:`~raft_tpu_torch.serve.schedule.ReplicaRouter` picks
(least estimated completion time); a lane whose dispatch fails is
drained and the same block re-routes to a live lane
(``stats["replica_faults"]`` / ``stats["replica_reroutes"]``), and
``/healthz`` carries the router's ``replicas`` object.  The engine is
made on every rank with that rank's part of the index, in the same order
on every rank.  Rank 0 leads: it owns the public API; every other rank
calls :meth:`ServeEngine.follow`, which returns when the leader closes
the engine (``"close"``) or refreshes it to a new index (``"refresh"``:
the rank passes its own part of the new index to :meth:`refresh`, then
follows again).  The protocol between them, its control groups and what
it stages through the host are set out in :mod:`raft_tpu_torch.serve.
spmd`.

The autotuner (:mod:`raft_tpu_torch.serve.autotune`) reads the bounded
shadow ring of recent requests (:meth:`ServeEngine.shadow_samples`),
applies its host knobs through :meth:`ServeEngine.apply_tuning` and shows
in ``/healthz`` (:meth:`ServeEngine.attach_tuner`).  With a cost store
installed (:mod:`raft_tpu_torch.core.coststore`), ``close()`` persists the
scheduler's cost rows and a new engine over the same backend program
seeds its cost model from them.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from concurrent import futures
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.core import coststore
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import Handle, resolve_device
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import as_float_tensor
from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.neighbors import (ann_mnmg, brute_force, ivf_flat,
                                      ivf_pq, mutable, tiering)
from raft_tpu_torch.serve import spmd
from raft_tpu_torch.serve.admission import (AdmissionController,
                                            RejectedError, ServeRequest)
from raft_tpu_torch.serve.schedule import (CostModel, ReplicaRouter,
                                           SchedulerConfig, choose_batches,
                                           should_dispatch)
from raft_tpu_torch.serve.supervise import DispatchSupervisor, retryable
from raft_tpu_torch.testing import faults as _faults

#: Bound on the per-call latency list (``last_latencies``) and on the
#: latency histogram's reservoir.
LATENCY_RESERVOIR = 4096

#: bounded live-request shadow ring (the autotuner's shadow traffic): a
#: representative mix, a few MB of retained request arrays at most
_SHADOW_RING = 64

#: the types a ladder may be warmed in, by name (the control plane's
#: wire types)
DTYPES = {str(dt).replace("torch.", ""): dt for dt in spmd.DTYPES}

#: the serving statistics every engine reports (the reference's keys)
_STAT_KEYS = ("requests", "queries", "super_batches", "solo_fallbacks",
              "coalesced_requests", "refreshes", "admitted", "sheds",
              "expired", "retries", "watchdog_timeouts", "isolation_splits",
              "ingest_errors", "dispatch_errors", "sched_dispatches",
              "sched_waits", "replica_faults", "replica_reroutes")

#: per-instance ordinal labeling each engine's metrics in the registry
_ENGINE_IDS = itertools.count()


def dtype_name(dtype) -> str:
    """The ladder key of a type: ``"float32"``, ``"bfloat16"``, … for a
    torch or numpy type, a JAX type or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def _request_tensor(q) -> torch.Tensor:
    """A request on the host in its own type: a tensor (on any device)
    as it is, a numpy array as it is — a bfloat16 one (``ml_dtypes``,
    or its two-byte raw items) through its bits, since the host that
    serves may have no numpy bfloat16; float64 becomes float32, as
    everywhere in the port."""
    if isinstance(q, torch.Tensor):
        # exempt(hot-path-host-transfer): request assembly: a tensor joins the host block
        t = q.detach().cpu()
    else:
        # exempt(hot-path-host-transfer): request assembly: a numpy request
        a = np.asarray(q)
        if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2):
            t = torch.from_numpy(np.ascontiguousarray(a).view(
                np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
    # exempt(dtype-drift): the check that turns a float64 request into float32
    return t.float() if t.dtype == torch.float64 else t


def _check_shape(t: torch.Tensor, dim: int) -> torch.Tensor:
    expects(t.ndim == 2 and t.shape[1] == dim,
            "query must be (n, dim) with the index's dim")
    return t


def _float_ingest(q, dim: int, kind: str) -> torch.Tensor:
    """Brute force: the request keeps its (floating) type."""
    t = _check_shape(_request_tensor(q), dim)
    expects(t.dtype.is_floating_point,
            f"{kind}: unsupported query dtype {t.dtype}")
    return t


def _flat_ingest(q, dim: int, metric, device) -> torch.Tensor:
    """An IVF-Flat request in its compute form, as the solo path makes
    it: float types stay, int8/uint8 widen exactly to float32; cosine
    queries are normalized in float32 on the device as the solo path
    does."""
    t = _check_shape(_request_tensor(q), dim)
    if t.dtype in (torch.int8, torch.uint8):
        t = t.float()
    expects(t.dtype in (torch.float32, torch.bfloat16, torch.float16),
            f"ivf_flat: unsupported query dtype {t.dtype}")
    if metric == DistanceType.CosineExpanded and t.shape[0]:
        # exempt(hot-path-host-transfer): cosine rows normalized as solo, back to the block
        return ivf_flat._normalize_rows(t.to(device).float()).cpu()
    return t


def _pq_ingest(q, dim: int, dataset_dtype: str) -> torch.Tensor:
    """An IVF-PQ request widened to float32 (exact for every type the
    family takes) after its dataset-type check, as the solo path's
    cast."""
    t = _request_tensor(q)
    if t.dtype in (torch.int8, torch.uint8):
        q_dtype = dtype_name(t.dtype)
    else:
        expects(t.dtype.is_floating_point,
                f"ivf_pq: unsupported query dtype {t.dtype}")
        q_dtype = "float32"
    expects(q_dtype in (dataset_dtype, "float32"),
            f"query dtype {q_dtype} != index dataset dtype {dataset_dtype}")
    return _check_shape(t, dim).float()


class _Backend:
    """What the single-device backends share: the warm run."""

    #: a backend that runs across ranks takes the host block itself
    distributed = False

    def warm(self, bucket: int, dtype=torch.float32) -> None:
        """Run one batch of *bucket* zero rows of *dtype*."""
        self.dispatch(torch.zeros((bucket, self.dim), dtype=dtype,
                                  device=self.device))


class _BruteForceBackend(_Backend):
    """Adapter: a dense (n, dim) array or tensor, placed on *device* (the
    card by default) → ``brute_force._knn_scan_aot``."""

    name = "brute_force"
    #: the backend's program: its ``__qualname__`` labels the telemetry
    #: the admission and scheduler cost models read
    fn = staticmethod(brute_force._knn_scan_aot)

    def __init__(self, index, k: int, metric, metric_arg: float,
                 batch_size_index: int, device, engine: Optional[str]):
        self.device = resolve_device(device)
        self.index = as_float_tensor(index, self.device)
        expects(self.index.ndim == 2, "brute-force index must be (n, dim)")
        expects(1 <= k <= self.index.shape[0],
                f"k={k} must be in [1, n_index={self.index.shape[0]}]")
        self.k = int(k)
        self.metric = brute_force._resolve_metric(metric)
        self.metric_arg = float(metric_arg)
        self.tile = int(min(batch_size_index, self.index.shape[0]))
        self.select_min = self.metric != DistanceType.InnerProduct
        self.dim = int(self.index.shape[1])
        self.engine = engine

    def ingest(self, q) -> torch.Tensor:
        """The request in its own type; the batch takes the index's type
        on the device, as ``knn`` converts a solo request."""
        return _float_ingest(q, self.dim, "brute force")

    def dispatch(self, qb: torch.Tensor):
        return self.fn(
            self.index, qb.to(self.index.dtype), self.k, self.metric,
            self.metric_arg, self.tile, self.select_min, self.engine)

    def solo(self, q, batch: int = 4096):
        # the bodies of the public entry points (``__wrapped__``): a solo
        # request runs on the engine's lane, with no host wait of its own
        return brute_force.knn.__wrapped__(
            self.index, q, self.k, self.metric, self.metric_arg,
            batch_size_index=self.tile, batch_size_query=batch,
            device=self.device, engine=self.engine)


class _IvfFlatBackend(_Backend):
    """Adapter: ``ivf_flat.Index`` → ``ivf_flat._search_batch_aot``."""

    name = "ivf_flat"
    fn = staticmethod(ivf_flat._search_batch_aot)

    def __init__(self, index: ivf_flat.Index, k: int,
                 params: Optional[ivf_flat.SearchParams],
                 engine: Optional[str]):
        expects(isinstance(index, ivf_flat.Index),
                "ServeEngine: only ivf_flat.Index is ported")
        expects(k >= 1, "k must be >= 1")
        self.index = index
        self.params = params or ivf_flat.SearchParams()
        self.k = int(k)
        self.n_probes = int(min(self.params.n_probes, index.n_lists))
        self.sqrt = index.metric == DistanceType.L2SqrtExpanded
        self.dim = int(index.dim)
        self.engine = resolve_engine("select_k", index.device, engine=engine)
        self.device = index.device

    def ingest(self, q) -> torch.Tensor:
        return _flat_ingest(q, self.dim, self.index.metric, self.device)

    def dispatch(self, qb: torch.Tensor):
        return self.fn(qb.float(), self.index, self.k, self.n_probes,
                       self.sqrt, self.engine)

    def solo(self, q, batch: int = 1024):
        return ivf_flat.search.__wrapped__(
            self.params, self.index, q, self.k, batch_size_query=batch,
            engine=self.engine)


class _IvfPqBackend(_Backend):
    """Adapter: ``ivf_pq.Index`` → ``ivf_pq._full_search_aot`` (coarse +
    select + probe scan of one batch)."""

    name = "ivf_pq"
    fn = staticmethod(ivf_pq._full_search_aot)

    def __init__(self, index: ivf_pq.Index, k: int,
                 params: Optional[ivf_pq.SearchParams],
                 engine: Optional[str]):
        expects(k >= 1, "k must be >= 1")
        self.index = index
        self.params = params or ivf_pq.SearchParams()
        ivf_pq.check_search_params(self.params)
        self.k = int(k)
        self.n_probes = int(min(self.params.n_probes, index.n_lists))
        self.dim = int(index.dim)
        self.engines = ivf_pq._resolve_engines(index, engine)
        self.engine = engine
        self.device = index.device
        self.hoisted = ivf_pq._resolve_hoisted(self.params)

    def ingest(self, q) -> torch.Tensor:
        return _pq_ingest(q, self.dim, self.index.dataset_dtype)

    def batch_cap(self) -> Optional[int]:
        return ivf_pq.hoisted_batch_cap(self.index, self.n_probes,
                                        self.params.lut_dtype, self.hoisted)

    def dispatch(self, qb: torch.Tensor):
        return self.fn(qb.float(), self.index, self.k, self.n_probes,
                       self.params.lut_dtype, self.engines,
                       int_dtype=self.params.internal_distance_dtype,
                       hoisted=self.hoisted)

    def solo(self, q, batch: int = 1024):
        return ivf_pq.search.__wrapped__(
            self.params, self.index, q, self.k, batch_size_query=batch,
            engine=self.engine)


class _MutableBackend(_Backend):
    """Adapter: ``mutable.MutableIndex`` → its searcher (main ∪ delta,
    tombstones masked in the scan).  Writes land on the same MutableIndex
    while it serves; each dispatch searches a snapshot of it, and
    compaction promotes its new core through ``engine.refresh(mutable)``."""

    fn = staticmethod(mutable._merged_aot)

    def __init__(self, mut, k: int, params, engine: Optional[str]):
        self.mutable = mut
        self.searcher = mut.searcher(int(k), params, engine)
        self.name = self.searcher.name
        self.k = int(k)
        self.dim = mut.dim
        self.device = mut.device

    def ingest(self, q) -> torch.Tensor:
        core = self.mutable._mut_core
        if self.mutable.kind == "ivf_pq":
            return _pq_ingest(q, self.dim, core.main.dataset_dtype)
        return _flat_ingest(q, self.dim, core.main.metric, self.device)

    def batch_cap(self) -> Optional[int]:
        return self.searcher.batch_cap()

    def dispatch(self, qb: torch.Tensor):
        return self.searcher.dispatch(qb.float())

    def solo(self, q, batch: int = 1024):
        return self.searcher.solo(q, batch)


class _TieredBackend(_Backend):
    """Adapter: ``tiering.TieredIndex`` → its two-phase searcher (hot
    block, staged cold tiles, optional exact re-rank).  The searcher owns
    the staging lanes and the per-list probe counter that
    ``refresh(tiering.retier(t, searcher.hotness()))`` re-tiers from."""

    #: the telemetry label of the backend's program (``_backend_fn``)
    fn = staticmethod(tiering.TieredSearcher.dispatch)

    def __init__(self, tiered, k: int, params, engine: Optional[str]):
        self.tiered = tiered
        self.searcher = tiered.searcher(int(k), params, engine)
        self.name = self.searcher.name
        self.k = int(k)
        self.dim = tiered.dim
        self.device = tiered.device

    def ingest(self, q) -> torch.Tensor:
        if self.tiered.kind == "ivf_pq":
            return _pq_ingest(q, self.dim, self.tiered.aux["dataset_dtype"])
        return _flat_ingest(q, self.dim, self.tiered.metric, self.device)

    def batch_cap(self) -> Optional[int]:
        return self.searcher.batch_cap()

    def warm(self, bucket: int, dtype=torch.float32) -> None:
        # a warm run that counts no probes; every type the tiered family
        # takes reaches the scan as float32
        self.searcher.warm(bucket)

    def dispatch(self, qb: torch.Tensor):
        return self.searcher.dispatch(qb.float())

    def solo(self, q, batch: int = 1024):
        return self.searcher.solo(q, batch)


class _DistributedBackend:
    """What the sharded and replica backends share: a searcher over this
    rank's shard, the engine's :class:`~raft_tpu_torch.serve.spmd.
    LaneWire`, and the generation the leader's ops name.  ``dispatch``
    takes the HOST block: the leader sends it to the lane's followers,
    then queues its own shard on its dispatch thread when the lane holds
    it, or returns the lane's result in flight — a ``spmd.Pending`` either
    way (device (d, i), inline, in a world of one)."""

    distributed = True

    def _setup(self, local: "ann_mnmg.ShardedIndex", k: int, params,
               engine: Optional[str], wire: spmd.LaneWire) -> None:
        expects(k >= 1, "k must be >= 1")
        expects(local.kind != "brute_force" or params is None,
                "sharded brute-force serving takes no SearchParams "
                "(metric/metric_arg ride the index)")
        self._local = local
        self.params = params
        self.searcher = local.searcher(int(k), params, engine)
        self.fn = self.searcher.fn
        self.k = int(k)
        self.dim = int(local.dim)
        self.device = local.device
        self.wire = wire
        self.gen = 0

    def ingest(self, q) -> torch.Tensor:
        """Each kind's single-device ingest rule."""
        sh = self._local
        if sh.kind == "brute_force":
            return _float_ingest(q, self.dim, "brute force")
        if sh.kind == "ivf_pq":
            return _pq_ingest(q, self.dim, sh.aux["dataset_dtype"])
        return _flat_ingest(q, self.dim, sh.metric, self.device)

    def batch_cap(self) -> Optional[int]:
        return ann_mnmg.batch_cap(self._local, self.searcher)

    def _capture(self):
        """What a dispatch must see of the served state, taken in the
        order of the lane's ops (under its lock, when the op is posted);
        none here: a sharded index does not change."""
        return None

    def _search(self, block: torch.Tensor, captured):
        return self.searcher.dispatch(block)

    def _run(self, lane: int, block: torch.Tensor):
        wire = self.wire
        with wire.locks[lane]:
            posted = wire.post(lane, self.gen, block, self.k)
            if lane != wire.lane:
                return posted
            captured = self._capture()

            def search():
                # as the single-device path copies: a blocking copy from
                # pageable memory would wait for the lane's earlier work
                d, i = self._search(block.to(self.device, non_blocking=True),
                                    captured)
                for w, _ in posted:
                    w.wait()
                return d, i

            if not wire.async_local:
                return search()
            return wire.run_local(search, block.shape[0], self.k,
                                  self.device)

    @staticmethod
    def _wait(out):
        return out.result() if isinstance(out, spmd.Pending) else out

    def warm(self, bucket: int, dtype=torch.float32) -> float:
        """Run *bucket* zero rows of *dtype* on every lane and wait, so a
        re-route to any lane runs a warmed signature.  Returns the
        fastest lane's seconds (what the engine's router books a batch of
        that signature at, at least)."""
        block = torch.zeros((bucket, self.dim), dtype=dtype)
        secs = []
        for lane in range(self.wire.n_lanes):
            t0 = telemetry.now()
            self._wait(self._run(lane, block))
            if self.device.type == "cuda":
                # exempt(hot-path-host-transfer): a distributed warm run waits for its stream
                torch.cuda.current_stream(self.device).synchronize()
            secs.append(telemetry.now() - t0)
        return min(secs)

    def run_follower(self, block: torch.Tensor):
        """A follower's share of one dispatch: its shard's search."""
        return self._search(block.to(self.device, non_blocking=True),
                            self._capture())

    def solo(self, q, replica: int = 0):
        """The request as ``ann_mnmg.search`` batches it — bucketed
        batches of at most its batch size — each dispatched on lane
        *replica*, so the result is ``search``'s."""
        cap = self.batch_cap()
        bs = ann_mnmg._QUERY_BATCH if cap is None else min(
            ann_mnmg._QUERY_BATCH, cap)
        d, i = ann_mnmg.bucketed(
            self.ingest(q), bs,
            lambda qb: self._wait(self._run(replica, qb)))
        # exempt(hot-path-host-transfer): a solo replica search returns host results
        return d.cpu(), i.cpu()


class _ShardedBackend(_DistributedBackend):
    """Adapter: ``ann_mnmg.ShardedIndex`` → its ``ShardedSearcher``; each
    super-batch runs on every rank of the index's communicator (one
    lane)."""

    def __init__(self, sharded, k: int, params, engine: Optional[str],
                 wire: spmd.LaneWire):
        self.sharded = sharded
        self.name = f"sharded_{sharded.kind}"
        self._setup(sharded, k, params, engine, wire)

    def dispatch(self, block: torch.Tensor, replica: int = 0):
        return self._run(0, block)


class _ReplicaBackend(_DistributedBackend):
    """Adapter: ``ann_mnmg.ReplicaSet`` → one lane per replica group;
    ``dispatch(block, replica)`` runs a batch on that group only.  The
    engine's :class:`ReplicaRouter` owns lane choice, draining and
    re-routing."""

    def __init__(self, rep, k: int, params, engine: Optional[str],
                 wire: spmd.LaneWire):
        self.rep = rep
        self.name = f"replica_{rep.kind}"
        self.n_replicas = rep.n_replicas
        self._setup(rep.local, k, params, engine, wire)

    def dispatch(self, block: torch.Tensor, replica: int = 0):
        # the fault plane's comms site, per replica lane, checked on the
        # leader before anything is sent: `comms:op=replica_dispatch:
        # rank=1:raise` faults lane 1
        _faults.check("comms", op="replica_dispatch", rank=int(replica))
        return self._run(int(replica), block)


class _ShardedMutableBackend(_DistributedBackend):
    """Adapter: a ``mutable.MutableIndex`` over an ``ann_mnmg.ShardedIndex``
    → its searcher on every rank of the main's communicator (one lane):
    the masked sharded main and the delta, folded.  A dispatch sees the
    index as it stands at the dispatch's place in the lane's order: the
    leader captures the core when it posts the dispatch, under the lane's
    lock, where it also applies and posts its writes (WRITE) and its
    compaction's phases (COMPACT), so every rank searches the same
    state.  The leader's backend routes the index's writes through the
    engine's control plane until the engine closes."""

    def __init__(self, mut, k: int, params, engine: Optional[str],
                 wire: spmd.LaneWire):
        self.mutable = mut
        self.name = f"sharded_mutable_{mut.kind}"
        self.params = params
        self.searcher = mut.searcher(int(k), params, engine)
        self.fn = mutable._sharded_merged_search_impl
        self.k = int(k)
        self.dim = mut.dim
        self.device = mut.device
        self.wire = wire
        self.gen = 0
        if wire.is_leader:
            mut._attach(wire)

    def ingest(self, q) -> torch.Tensor:
        if self.mutable.kind == "ivf_pq":
            return _pq_ingest(q, self.dim, self.mutable.dataset_dtype)
        return _flat_ingest(q, self.dim, self.mutable.metric, self.device)

    def batch_cap(self) -> Optional[int]:
        return self.searcher.batch_cap()

    def _capture(self):
        return self.mutable._capture()

    def _search(self, block: torch.Tensor, captured):
        return self.searcher.dispatch(block.float(), captured)

    def dispatch(self, block: torch.Tensor, replica: int = 0):
        return self._run(0, block)


def _sharded_mutable(index) -> bool:
    return isinstance(index, mutable.MutableIndex) and index.sharded


def _lanes(index) -> Optional[List[List[int]]]:
    """The lanes of a distributed index (None for a single-device one)."""
    if isinstance(index, ann_mnmg.ReplicaSet):
        return [list(index.ranks(r)) for r in range(index.n_replicas)]
    if isinstance(index, ann_mnmg.ShardedIndex) or _sharded_mutable(index):
        return [list(index.comms.ranks)]
    return None


def _make_backend(index, k, params, engine, metric, metric_arg,
                  batch_size_index, device, wire=None):
    if isinstance(index, ann_mnmg.ReplicaSet):
        return _ReplicaBackend(index, k, params, engine, wire)
    if isinstance(index, ann_mnmg.ShardedIndex):
        return _ShardedBackend(index, k, params, engine, wire)
    if _sharded_mutable(index):
        return _ShardedMutableBackend(index, k, params, engine, wire)
    if isinstance(index, tiering.TieredIndex):
        return _TieredBackend(index, k, params, engine)
    if isinstance(index, ivf_flat.Index):
        return _IvfFlatBackend(index, k, params, engine)
    if isinstance(index, ivf_pq.Index):
        return _IvfPqBackend(index, k, params, engine)
    if isinstance(index, mutable.MutableIndex):
        return _MutableBackend(index, k, params, engine)
    return _BruteForceBackend(index, k, metric, metric_arg,
                              batch_size_index, device, engine)


def _warm(backend, buckets, dtype=torch.float32) -> Dict[int, Any]:
    """Run *backend* once at every bucket in *dtype* on the caller's
    current stream and wait for that stream, so kernels are built and the
    allocator has seen each shape before the backend serves.  Returns
    what each warm run returned (a distributed backend: its seconds)."""
    out = {b: backend.warm(b, dtype) for b in sorted(buckets)}
    if backend.device.type == "cuda":
        # exempt(hot-path-host-transfer): warmup waits for its warm runs, before serving
        torch.cuda.current_stream(backend.device).synchronize()
    return out


def _rows(q) -> int:
    return int(q.shape[0]) if hasattr(q, "shape") else len(q)


class _KeepParams:
    """Sentinel type — :data:`KEEP_PARAMS` is its only instance."""

    def __repr__(self) -> str:
        return "KEEP_PARAMS"


#: :meth:`ServeEngine.refresh`'s ``params`` default: keep the current
#: serving params.  Any OTHER value — including ``None`` — is applied
#: verbatim (``None`` rebuilds the backend with its default params).
KEEP_PARAMS = _KeepParams()


class ServeEngine:
    """Coalescing query server for one (index, k, params) serving key.

    ``index`` picks the backend by type: an ``ivf_flat.Index``, an
    ``ivf_pq.Index``, a ``mutable.MutableIndex``, a
    ``tiering.TieredIndex`` of either, an ``ann_mnmg.ShardedIndex`` or
    ``ReplicaSet`` (*params* its family's ``SearchParams``), else a dense
    (n, dim) array or tensor served by exact brute force under ``metric``
    / ``metric_arg`` in index tiles of ``batch_size_index`` rows, placed
    on ``device`` (default: the card).  ``max_batch`` bounds one
    coalesced super-batch (clamped to the backend's batch cap, if it has
    one) and is the largest bucket :meth:`warmup` runs by default;
    ``handle`` supplies the stream pool (default: two lanes on the
    index's device).

    Serving knobs, as in the reference: ``admission`` (an
    :class:`AdmissionController`, default one, or ``False``),
    ``scheduler`` (a :class:`SchedulerConfig`, default one, or ``False``
    for the drain-all planner), and the supervisor's ``watchdog_s``,
    ``max_retries``, ``retry_backoff_s``, ``retry_backoff_cap_s`` and
    ``retry_seed``.  :meth:`search` and :meth:`submit` may be called from
    several threads; dispatch is serialized under a lock.

    A distributed index is served by an engine made on every rank (see
    the module doc); every wait of its control plane is bounded by the
    index communicator's timeout (its session's)."""

    def __init__(self, index, k: int, params=None, *,
                 metric=DistanceType.L2SqrtExpanded, metric_arg: float = 2.0,
                 max_batch: int = 1024, batch_size_index: int = 16384,
                 handle: Optional[Handle] = None,
                 engine: Optional[str] = None, device=None,
                 admission=None, watchdog_s: Optional[float] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.05,
                 retry_backoff_cap_s: float = 1.0, retry_seed: int = 0,
                 scheduler=None):
        expects(max_batch >= 8, "max_batch must be >= 8")
        self._engine_id = str(next(_ENGINE_IDS))
        #: the control plane of a distributed index (None otherwise)
        self._wire = self._make_wire(index)
        self._backend = _make_backend(index, k, params, engine, metric,
                                      metric_arg, batch_size_index, device,
                                      self._wire)
        #: generation of the serving backend (the control plane's key);
        #: a follower keeps every generation the leader has not retired
        self._gen = 0
        self._gens: Dict[int, Any] = {0: self._backend}
        self._follow_refresh: Optional[Tuple[int, Any]] = None
        #: the replica-lane router (replica backends only), and the
        #: warm-up's seconds per (type, bucket), the least a routed batch
        #: books on its lane: the cost rows start from the host's
        #: dispatch time, which says nothing of how long a lane is busy
        self._router = self._make_router(self._backend)
        self._warm_cost: Dict[Tuple[str, int], float] = {}
        self._index = index
        # refresh() rebuilds a backend with the same serving knobs, and
        # re-derives the batch cap from the new index
        self._ctor = dict(k=int(k), params=params, engine=engine,
                          metric=metric, metric_arg=metric_arg,
                          batch_size_index=batch_size_index, device=device)
        self._requested_max_batch = int(max_batch)
        self.max_batch = self._capped_max_batch(self._backend)
        self._device = self._backend.device
        self._handle = (handle if handle is not None
                        else Handle(self._device, n_streams=2))
        self._warmed: Dict[str, set] = {}   # dtype -> {buckets}
        self._lock = threading.Lock()
        # guards _warmed against the LOCKLESS /healthz reader; writers hold
        # self._lock first, so the order is always _lock → this
        self._warmed_mut = threading.Lock()
        self._refreshing = False   # /healthz: refresh in flight
        self._closed = False       # close(): new requests reject typed
        self._recorder = None      # slow-request flight recorder
        self._http = None          # the live scrape server, if started
        #: the autotuner's shadow traffic: the last _SHADOW_RING ingested
        #: requests with rows, overwritten round-robin
        self._shadow_ring: List[Optional[np.ndarray]] = [None] * _SHADOW_RING
        self._shadow_pos = 0
        self._tuner = None         # attached AutoTuner (/healthz autotune)
        #: Serving statistics: a counter view over the registry
        #: (``raft_tpu_serve_engine_stats{engine,key}``) — reads like a
        #: dict (``dict(stats)`` for a plain one), increments are atomic.
        self.stats: telemetry.LegacyCounterView = telemetry.legacy_counter(
            "raft_tpu_serve_engine_stats", "ServeEngine serving statistics",
            labelnames=("engine", "key"), fixed=(self._engine_id,))
        for key in _STAT_KEYS:
            self.stats[key] = 0
        if scheduler is False:
            self._sched_cfg: Optional[SchedulerConfig] = None
        else:
            self._sched_cfg = (scheduler if isinstance(
                scheduler, SchedulerConfig) else SchedulerConfig())
        #: per-(dtype, bucket) cost EWMA, fed after every collected
        #: super-batch, registry-seeded
        self._cost = CostModel(
            fn=self._backend_fn(),
            static_batch_s=(self._sched_cfg.static_batch_s
                            if self._sched_cfg is not None else 0.05),
            use_telemetry=(self._sched_cfg.use_telemetry
                           if self._sched_cfg is not None else True))
        # cold start: the rows a previous engine over the same backend
        # program persisted at close()
        self._seed_cost_from_store()
        #: submit(): pending (request, future, arrival) envelopes and the
        #: scheduler thread, started lazily
        self._pending: List[Any] = []
        self._pending_cv = threading.Condition()
        self._sched_thread: Optional[threading.Thread] = None
        if admission is False:
            self._admission: Optional[AdmissionController] = None
        else:
            self._admission = (admission if admission is not None
                               else AdmissionController())
            self._admission.bind(self._engine_id)
        self._supervisor = DispatchSupervisor(
            watchdog_s=watchdog_s, max_retries=max_retries,
            backoff_s=retry_backoff_s, backoff_cap_s=retry_backoff_cap_s,
            seed=retry_seed, on_event=self._sup_event)
        #: per-request completion latency (from ``search()`` entry to the
        #: request's results on the host): fixed-memory histogram plus a
        #: bounded reservoir
        self.latency_hist: telemetry.Histogram = telemetry.histogram(
            "raft_tpu_serve_request_latency_seconds",
            "per-request completion latency within one search() call",
            labelnames=("engine",), reservoir=LATENCY_RESERVOIR)
        #: per-request wait in the submit() queue: from submit() to the
        #: moment the scheduler thread or flush() takes the request out
        self.queue_wait_hist: telemetry.Histogram = telemetry.histogram(
            "raft_tpu_serve_queue_wait_seconds",
            "per-request wait in the submit() queue",
            labelnames=("engine",))
        self._last_latencies: List[float] = []

    @property
    def backend(self) -> str:
        return self._backend.name

    @property
    def k(self) -> int:
        return self._backend.k

    @property
    def index(self):
        """The served index, as last constructed or refreshed."""
        return self._index

    @property
    def is_leader(self) -> bool:
        """True unless this is a follower rank of a distributed index."""
        return self._wire is None or self._wire.is_leader

    def _make_wire(self, index) -> Optional[spmd.LaneWire]:
        lanes = _lanes(index)
        if lanes is None:
            return None
        comms = (index.layout.parent if isinstance(index, ann_mnmg.ReplicaSet)
                 else index.comms)
        return spmd.LaneWire(comms, lanes, self._engine_id)

    def _make_router(self, backend) -> Optional[ReplicaRouter]:
        n = getattr(backend, "n_replicas", 0)
        return ReplicaRouter(n, self._engine_id) if n > 1 else None

    def _leader_only(self, what: str) -> None:
        expects(self.is_leader, f"{what}: rank 0 leads a distributed "
                "engine; the other ranks call follow()")

    def _capped_max_batch(self, backend) -> int:
        cap = getattr(backend, "batch_cap", lambda: None)()
        if cap is None:
            return self._requested_max_batch
        return max(8, min(self._requested_max_batch, cap))

    def _sup_event(self, kind: str) -> None:
        self.stats.inc({"retry": "retries",
                        "watchdog_timeout": "watchdog_timeouts"}[kind])

    def _backend_fn(self) -> Optional[str]:
        """The backend program's telemetry label — the cost models' key."""
        return getattr(getattr(self._backend, "fn", None), "__qualname__",
                       None)

    # -- latency telemetry --------------------------------------------------
    @property
    def last_latencies(self) -> List[float]:
        """Per-request completion latencies (seconds) of the LAST
        ``search()`` call, at most :data:`LATENCY_RESERVOIR` of them."""
        return list(self._last_latencies)

    def latency_quantiles(self, qs: Sequence[float] = (0.5, 0.99)
                          ) -> List[Optional[float]]:
        """Completion-latency quantile estimates over the engine's WHOLE
        serving history, from the fixed-memory log-bucketed histogram
        (within ~one bucket ratio of exact).  ``None`` entries when
        nothing was recorded (e.g. telemetry disabled)."""
        return [self.latency_hist.quantile(q, (self._engine_id,))
                for q in qs]

    # -- warmup -------------------------------------------------------------
    def warmup(self, buckets: Optional[Sequence[int]] = None,
               dtypes: Sequence[Any] = (torch.float32,)) -> int:
        """Run one search at every (bucket, type) signature — every power
        of two from 8 up to ``max_batch`` by default, in each of *dtypes*
        (torch, numpy or JAX types, or their names) — so the kernels are
        built and the allocator has seen each shape before traffic
        arrives; a distributed engine warms every signature on every lane.
        Explicit *buckets* narrow the range: requests too large for the
        largest warmed bucket of their type are served solo.  Returns the
        number of signatures warmed."""
        expects(not self._closed, "warmup() on a closed engine")
        self._leader_only("warmup()")
        if buckets is None:
            buckets, b = [], 8
            while b < self.max_batch:
                buckets.append(b)
                b <<= 1
            buckets.append(self.max_batch)
        buckets = sorted(set(int(b) for b in buckets))
        names = [dtype_name(dt) for dt in dtypes]
        for name in names:
            expects(name in DTYPES, f"warmup: unsupported type {name!r}")
        with self._lock:
            for b in buckets:
                expects(8 <= b <= self.max_batch,
                        f"bucket {b} outside [8, max_batch={self.max_batch}]")
            for name in names:
                secs = _warm(self._backend, buckets, DTYPES[name])
                if self._backend.distributed:
                    self._warm_cost.update({(name, b): s
                                            for b, s in secs.items()})
                with self._warmed_mut:
                    self._warmed.setdefault(name, set()).update(buckets)
        return len(buckets) * len(names)

    def warmed_buckets(self, dtype="float32") -> List[int]:
        name = dtype_name(dtype)
        with self._warmed_mut:
            return sorted(self._warmed.get(name, ()))

    def warmed_signatures(self) -> Dict[str, List[int]]:
        """The warmed buckets as a plain mapping (type name → sorted
        buckets)."""
        with self._warmed_mut:
            return {dt: sorted(bs) for dt, bs in self._warmed.items()}

    # -- autotuning hooks --------------------------------------------------
    def shadow_samples(self) -> List[np.ndarray]:
        """A snapshot of the shadow ring: up to ``_SHADOW_RING`` recently
        ingested request arrays (the autotuner's live shadow traffic)."""
        return [q for q in list(self._shadow_ring) if q is not None]

    def attach_tuner(self, tuner) -> None:
        """Attach (or detach with None) an autotuner: its state shows in
        the ``/healthz`` body as the ``autotune`` sub-object."""
        self._tuner = tuner

    def apply_tuning(self, *, quantum_s: Optional[float] = None,
                     max_batch: Optional[int] = None) -> Dict[str, Any]:
        """Atomically apply host-side tuner knobs; returns the PREVIOUS
        values (the tuner's rollback token).  ``max_batch`` must be a
        warmed bucket or the construction cap, so the planner's ladder
        stays inside the warmed shapes."""
        expects(not self._closed, "apply_tuning() on a closed engine")
        with self._lock:
            prev: Dict[str, Any] = {
                "quantum_s": (self._sched_cfg.quantum_s
                              if self._sched_cfg is not None else None),
                "max_batch": self.max_batch}
            if quantum_s is not None:
                expects(self._sched_cfg is not None,
                        "quantum tuning needs the scheduler enabled")
                expects(quantum_s > 0.0, "quantum_s must be positive")
                self._sched_cfg = dataclasses.replace(
                    self._sched_cfg, quantum_s=float(quantum_s))
            if max_batch is not None:
                b = int(max_batch)
                with self._warmed_mut:
                    warmed_any = {x for bs in self._warmed.values()
                                  for x in bs}
                expects(b in warmed_any
                        or b == self._capped_max_batch(self._backend),
                        f"max_batch={b} is neither a warmed bucket nor "
                        "the construction cap — tuning must stay inside "
                        "the warmed ladder")
                self.max_batch = b
            return prev

    def _seed_cost_from_store(self) -> None:
        """Seed the scheduler cost model from the installed cost store's
        rows for this backend program (a no-op without a store)."""
        store = coststore.installed()
        fn = self._backend_fn()
        if store is None or not fn:
            return
        self._cost.seed_rows(store.load_costs(fn, self._backend.device))

    def _persist_cost_rows(self) -> None:
        """Persist the cost model's observed rows into the installed cost
        store (close()-time): the next engine's construction seeds from
        them."""
        store = coststore.installed()
        fn = self._backend_fn()
        if store is None or not fn:
            return
        rows = self._cost.rows()
        if rows:
            store.save_costs(fn, rows, self._backend.device)

    # -- index refresh ------------------------------------------------------
    def refresh(self, index, params=KEEP_PARAMS) -> None:
        """Swap the served index for *index* without cold-serving a single
        request.  The replacement backend (same k; *params* defaults to
        :data:`KEEP_PARAMS`, any other value — ``None`` too — is applied
        verbatim) is built and run at EVERY warmed bucket, and that work is
        complete on the card, BEFORE the swap, all outside the engine lock;
        the swap itself is atomic under the lock.  ``max_batch`` re-derives
        from the requested bound and the new index's cap; warmed buckets
        above it are dropped.  Both indexes are on the device until the
        old one's last reference goes.

        A distributed engine's leader tells every follower first; a new
        index must span the same lanes, and a replica engine gets a fresh
        router.  On a follower, ``refresh(index)`` is the answer to
        ``follow()`` returning ``"refresh"``: *index* is this rank's part
        of the leader's new index, and the params are the leader's."""
        expects(not self._closed, "refresh() on a closed engine")
        if not self.is_leader:
            return self._follower_refresh(index)
        self._refreshing = True   # /healthz reports the swap in flight
        try:
            with telemetry.span("serve.refresh"):
                self._refresh(index, params)
        finally:
            self._refreshing = False

    def _refresh(self, index, params):
        # crash window 1: nothing built yet
        _faults.check("refresh", stage="pre_warm")
        with self._lock:   # snapshot under the lock: warmup() mutates it
            c = dict(self._ctor)
            snapshot = {dt: set(bs) for dt, bs in self._warmed.items()}
        if params is KEEP_PARAMS:
            params = c["params"]
        gen = self._gen + 1
        if self._wire is not None:
            expects(_lanes(index) == self._wire.lanes,
                    "refresh: a distributed index must span the served "
                    "index's lanes")
            self._wire.refresh(gen, params, index is self._index)
        backend = _make_backend(index, c["k"], params, c["engine"],
                                c["metric"], c["metric_arg"],
                                c["batch_size_index"], c["device"],
                                self._wire)
        backend.gen = gen
        max_batch = self._capped_max_batch(backend)
        warmed = {dt: {b for b in bs if b <= max_batch}
                  for dt, bs in snapshot.items()}
        warm_cost = {}
        for dt, bs in warmed.items():
            secs = _warm(backend, bs, DTYPES[dt])
            if backend.distributed:
                warm_cost.update({(dt, b): v for b, v in secs.items()})
        # crash window 2: BETWEEN warm and swap — a crash here discards
        # the warmed replacement and the OLD backend keeps serving
        _faults.check("refresh", stage="pre_swap")
        with self._lock:
            # signatures a concurrent warmup() added since the snapshot
            # are warmed here, under the lock (rare; blocks briefly)
            for dt, bs in self._warmed.items():
                late = {b for b in bs if b <= max_batch} - warmed.get(
                    dt, set())
                if late:
                    _warm(backend, late, DTYPES[dt])
                    warmed.setdefault(dt, set()).update(late)
            if self._index is not index and _sharded_mutable(self._index):
                self._index._detach(self._wire)
            self._backend = backend
            self._gen = gen
            self._index = index
            self._ctor = dict(c, params=params)
            self.max_batch = max_batch
            with self._warmed_mut:
                self._warmed = warmed
            self._cost.bind_fn(self._backend_fn())
            # a new replica set's lanes are new replicas: drained state
            # does not carry over the swap
            self._router = self._make_router(backend)
            self._warm_cost = warm_cost
            if self._wire is not None:
                self._wire.retire(gen)
            self.stats.inc("refreshes")

    # -- a follower rank ------------------------------------------------------
    def follow(self) -> str:
        """A follower rank's one call: run the leader's ops on this rank's
        shard until the leader closes the engine (returns ``"close"``) or
        refreshes it to a new index (returns ``"refresh"``; pass this
        rank's part of that index to :meth:`refresh`, then call
        ``follow()`` again).  A params-only refresh is handled inside."""
        expects(self._wire is not None and not self._wire.is_leader,
                "follow() is for the ranks other than the leader of a "
                "distributed engine")
        expects(not self._closed, "follow() on a closed engine")
        why = self._wire.serve(self._on_dispatch, self._on_refresh,
                               self._on_retire, self._on_write,
                               self._on_compact)
        if why == "close":
            self._closed = True
        return why

    def _on_dispatch(self, gen: int, block: torch.Tensor):
        return self._gens[gen].run_follower(block)

    def _follower_backend(self, index, params, gen: int):
        c = self._ctor
        backend = _make_backend(index, c["k"], params, c["engine"],
                                c["metric"], c["metric_arg"],
                                c["batch_size_index"], c["device"],
                                self._wire)
        backend.gen = gen
        self._gens[gen] = backend
        self._ctor = dict(c, params=params)
        return backend

    def _on_refresh(self, gen: int, params, same_index: bool) -> bool:
        if same_index:
            self._follower_backend(self._index, params, gen)
            return True
        self._follow_refresh = (gen, params)
        return False

    def _served_mutable(self, op: str):
        expects(_sharded_mutable(self._index),
                f"{op}: this engine serves no sharded MutableIndex")
        return self._index

    def _on_write(self, arg: int, ids: torch.Tensor, rows) -> None:
        self._served_mutable("WRITE")._apply_remote_write(
            # exempt(hot-path-host-transfer): WRITE ids arrive as host tensors
            arg, ids.numpy(), rows)

    def _on_compact(self, phase: int) -> None:
        self._served_mutable("COMPACT")._follow_compact(phase)

    def _on_retire(self, gen: int) -> None:
        for g in [g for g in self._gens if g < gen]:
            del self._gens[g]
        if gen in self._gens:
            self._backend, self._gen = self._gens[gen], gen

    def _follower_refresh(self, index) -> None:
        expects(self._follow_refresh is not None,
                "refresh() on a follower answers follow() returning "
                "'refresh'")
        gen, params = self._follow_refresh
        self._follow_refresh = None
        expects(_lanes(index) == self._wire.lanes,
                "refresh: a distributed index must span the served "
                "index's lanes")
        self._follower_backend(index, params, gen)
        self._index = index
        self.stats.inc("refreshes")

    # -- live scrape surface ------------------------------------------------
    def _health(self) -> Dict[str, Any]:
        """The /healthz body: ready iff at least one bucket is warmed, no
        refresh is mid-swap and the engine is open.  Takes no engine lock
        (a probe must not queue behind an in-flight search)."""
        with self._warmed_mut:
            warmed = {dt: sorted(bs) for dt, bs in self._warmed.items()}
        ready = (any(warmed.values()) and not self._refreshing
                 and not self._closed)
        body = {"ready": bool(ready), "backend": self.backend, "k": self.k,
                "max_batch": self.max_batch, "warmed": warmed,
                "refresh_in_flight": bool(self._refreshing),
                "closed": bool(self._closed),
                "stats": dict(self.stats)}
        # overload is DEGRADED, not down: recent shedding flags the body
        # while the probe stays 200
        adm = self._admission
        body["degraded"] = (adm.degraded(telemetry.now())
                            if adm is not None else False)
        if adm is not None:
            body["admission"] = adm.health(telemetry.now())
        # replica routing: a drained lane marks the body degraded — the
        # engine still serves on the survivors
        router = self._router
        if router is not None:
            rh = router.health()
            body["replicas"] = rh
            if rh["degraded"]:
                body["degraded"] = True
        if self._sched_cfg is not None:
            body["scheduler"] = {"quantum_s": self._sched_cfg.quantum_s,
                                 "pending": len(self._pending)}
        # the autotuner: decisions, promotion and the rollback guard
        tuner = self._tuner
        if tuner is not None:
            body["autotune"] = tuner.health()
        # tiered residency: the hot/cold split and the staging tile
        stats_fn = getattr(getattr(self._backend, "searcher", None),
                           "tier_stats", None)
        if stats_fn is not None:
            body["tiering"] = stats_fn()
        return body

    def serve_http(self, port: int = 0, host: str = "127.0.0.1", *,
                   slow_threshold_s: Optional[float] = None,
                   slow_cap: Optional[int] = None):
        """Start the live scrape surface for this engine: ``/metrics``
        (Prometheus text over the process registry), ``/healthz`` (503
        until :meth:`warmup` ran, during a refresh and once closed),
        ``/varz`` (snapshot JSON) and ``/debug/slow`` (a bounded ring of
        span trees of ``search()`` calls slower than *slow_threshold_s*).
        ``port=0`` binds an ephemeral port — read it from the returned
        server's ``.port``.  Idempotent; ``close()`` stops it."""
        from raft_tpu_torch.telemetry import http as telemetry_http

        expects(not self._closed, "serve_http() on a closed engine")
        with self._lock:
            if self._http is None:
                self._recorder = telemetry_http.FlightRecorder(
                    telemetry_http.DEFAULT_SLOW_THRESHOLD_S
                    if slow_threshold_s is None else slow_threshold_s,
                    telemetry_http.DEFAULT_SLOW_CAP
                    if slow_cap is None else slow_cap)
                self._http = telemetry_http.TelemetryServer(
                    port, host, health=self._health,
                    recorder=self._recorder).start()
            return self._http

    def close(self, timeout_s: float = 5.0) -> None:
        """Bounded, idempotent shutdown: later requests reject with
        ``RejectedError(reason="closed")``; requests queued by
        :meth:`submit` reject the same way; an in-flight ``search()``
        drains (close waits up to *timeout_s* for the engine lock); the
        scrape server stops.  ``/healthz`` reports ``ready: false``.  A
        distributed engine's leader then releases every follower."""
        if self._closed:
            return
        self._closed = True
        # the next engine over this backend program seeds its scheduler
        # from these rows
        self._persist_cost_rows()
        with self._pending_cv:
            pending, self._pending = list(self._pending), []
            self._pending_cv.notify_all()
        for _r, f, _t in pending:
            if not f.done():
                f.set_exception(RejectedError(
                    "closed", "engine closed with the request still "
                    "queued in the scheduler"))
        t = self._sched_thread
        if t is not None:
            t.join(timeout=min(1.0, timeout_s))
        acquired = self._lock.acquire(timeout=timeout_s)   # drain in-flight
        try:
            http, self._http, self._recorder = self._http, None, None
            if self._wire is not None and self._wire.is_leader:
                if _sharded_mutable(self._index):
                    self._index._detach(self._wire)
                self._wire.close()
        finally:
            if acquired:
                self._lock.release()
        if http is not None:
            http.close()

    # -- the request path ---------------------------------------------------
    def _plan(self, sizes: List[int], max_bucket: int
              ) -> Tuple[List[List[Tuple[int, int, int]]], List[int]]:
        """Greedy in-order packing: (super_batches, solo) where each
        super-batch is [(request_idx, start_row, n_rows), ...] with total
        rows <= *max_bucket*, and *solo* lists requests too large for it."""
        batches: List[List[Tuple[int, int, int]]] = []
        solo: List[int] = []
        cur: List[Tuple[int, int, int]] = []
        cur_n = 0
        for j, n in enumerate(sizes):
            if n > max_bucket:
                solo.append(j)
                continue
            if cur_n + n > max_bucket:
                batches.append(cur)
                cur, cur_n = [], 0
            cur.append((j, cur_n, n))
            cur_n += n
        if cur:
            batches.append(cur)
        return batches, solo

    def _bucket_for(self, total: int, warmed: set) -> int:
        """The power-of-two bucket of *total*, clamped to max_batch; with an
        explicit warmed set, the smallest warmed bucket >= total."""
        b = min(bucket_dim(total), self.max_batch)
        if warmed and b not in warmed:
            bigger = [w for w in warmed if w >= total]
            if bigger:
                b = min(bigger)
        return b

    def search(self, requests: Sequence[Any]
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Serve a batch of concurrent requests: one (n_j, dim) query
        matrix each (ragged, n_j >= 0), optionally wrapped in a
        :class:`ServeRequest` carrying a deadline.  Returns one
        ``(distances (n_j, k), indices (n_j, k))`` numpy pair per request,
        in request order.  A request that is shed, fails ingest or whose
        dispatch fails after supervision gets ITS EXCEPTION in its slot,
        while the other requests are served; ``search()`` itself raises
        only on a closed engine.

        Each phase runs under a span (``serve.request`` →
        ``serve.ingest`` / ``serve.admit`` / ``serve.coalesce`` /
        ``serve.assemble`` / ``serve.dispatch`` / ``serve.deliver``)."""
        if self._closed:
            raise RejectedError("closed", "ServeEngine is closed — new "
                                "requests reject; see close()")
        self._leader_only("search()")
        rec = self._recorder
        if rec is None or not telemetry.enabled():
            with self._lock:
                with telemetry.span("serve.request"):
                    return self._search_locked(requests)
        with self._lock:
            t0 = telemetry.now()
            with telemetry.collect_spans() as col:
                with telemetry.span("serve.request"):
                    out = self._search_locked(requests)
            dur = telemetry.now() - t0
            if dur >= rec.threshold_s:
                rec.record(col.events, dur_s=round(dur, 6),
                           requests=len(requests),
                           queries=sum(
                               _rows(q.q if isinstance(q, ServeRequest)
                                     else q) for q in requests))
            return out

    # -- streaming continuous batching (submit/flush) -----------------------
    def submit(self, request) -> "futures.Future":
        """Enqueue ONE request (an array or a :class:`ServeRequest`) for
        continuous batching; returns a ``concurrent.futures.Future``
        resolving to the same ``(distances, indices)`` pair ``search()``
        gives for it, or raising its typed rejection / ingest / dispatch
        error.

        The scheduler thread dispatches the pending requests as one
        ``search()`` call when they fill the largest warmed bucket, when
        the oldest has waited one quantum, or when waiting longer would
        jeopardize an admitted deadline; otherwise it waits one quantum
        (``stats["sched_dispatches"]`` / ``stats["sched_waits"]``, the
        wait under a ``serve.hold`` span).  Each request's time in the
        queue goes to ``raft_tpu_serve_queue_wait_seconds{engine}``.  A
        scheduler thread that dies fails the pending futures with its
        error; the next ``submit()`` starts a new one."""
        expects(self._sched_cfg is not None,
                "submit() requires the continuous-batching scheduler "
                "(engine constructed with scheduler=False)")
        self._leader_only("submit()")
        if self._closed:
            raise RejectedError("closed", "ServeEngine is closed — new "
                                "requests reject; see close()")
        fut: futures.Future = futures.Future()
        with self._pending_cv:
            self._pending.append((request, fut, telemetry.now()))
            if self._sched_thread is None \
                    or not self._sched_thread.is_alive():
                self._sched_thread = threading.Thread(
                    target=self._sched_loop, daemon=True,
                    name=f"raft-tpu-torch-serve-sched-{self._engine_id}")
                self._sched_thread.start()
            self._pending_cv.notify_all()
        return fut

    def flush(self) -> None:
        """Dispatch everything pending in the submit() queue NOW, in the
        caller's thread, without waiting out the quantum."""
        with self._pending_cv:
            batch, self._pending = list(self._pending), []
        if batch:
            self._serve_pending(batch)

    @staticmethod
    def _fail_futures(batch, exc: BaseException) -> None:
        for _r, f, _t in batch:
            if not f.done():
                f.set_exception(exc)

    def _serve_pending(self, batch) -> None:
        """Serve envelopes just taken out of the submit() queue, after
        recording each one's wait there."""
        taken = telemetry.now()
        eng = (self._engine_id,)
        for _r, _f, t_submit in batch:
            self.queue_wait_hist.observe(taken - t_submit, eng)
        try:
            outs = self.search([r for r, _f, _t in batch])
        except Exception as e:   # engine-level (e.g. closed)
            self._fail_futures(batch, e)
            return
        for (_r, f, _t), out in zip(batch, outs):
            if f.done():
                continue
            if isinstance(out, BaseException):
                f.set_exception(out)
            else:
                f.set_result(out)

    def _sched_loop(self) -> None:
        """The scheduler thread behind :meth:`submit`.  If it fails, the
        requests it holds and every pending one get its error, so no
        future is left unresolved."""
        batch: List[Any] = []
        try:
            while True:
                batch = []
                with self._pending_cv:
                    if not self._pending:
                        if self._closed:
                            return
                        self._pending_cv.wait(
                            timeout=self._sched_cfg.quantum_s)
                        if not self._pending:
                            if self._closed:
                                return
                            continue
                    # read at every decision, after any wait:
                    # apply_tuning() may retune the quantum meanwhile
                    cfg = self._sched_cfg
                    now = telemetry.now()
                    rows = 0
                    dls: List[float] = []
                    for r, _f, _t in self._pending:
                        rows += _rows(r.q if isinstance(r, ServeRequest)
                                      else r)
                        if isinstance(r, ServeRequest):
                            dl = r.resolve_deadline(now)
                            if dl is not None:
                                dls.append(dl)
                    oldest = now - self._pending[0][2]
                    with self._warmed_mut:
                        largest = max((max(bs) for bs in
                                       self._warmed.values() if bs),
                                      default=self.max_batch)
                        types = list(self._warmed) or ["float32"]
                    est = max(self._cost.batch_cost_s(dt, largest)
                              for dt in types)
                    if self._closed or should_dispatch(
                            rows, largest, oldest, cfg.quantum_s, dls, now,
                            est):
                        batch, self._pending = list(self._pending), []
                        self.stats.inc("sched_dispatches")
                    else:
                        # wait one quantum to fill a larger bucket
                        self.stats.inc("sched_waits")
                        with telemetry.span("serve.hold"):
                            self._pending_cv.wait(timeout=cfg.quantum_s)
                        continue
                self._serve_pending(batch)
        except Exception as e:
            with self._pending_cv:
                pending, self._pending = list(self._pending), []
            self._fail_futures(batch + pending, e)

    def _dispatch(self, block: torch.Tensor, lane: int, bucket: int,
                  cold: bool, replica: Optional[int] = None):
        """Dispatch one padded host block on stream lane *lane* (a replica
        engine: on replica lane *replica*); never raises.  Returns ``(out,
        start)``: *out* is ``(distances, indices, done)`` — host tensors
        the lane copies into and its end-of-work mark — or the exception
        the dispatch raised (collection raises it, so it is retried or
        isolated like a failure on the card); *start* is the timing event
        of a device-time sample, else None."""
        be = self._backend
        fn = self._backend_fn() or be.name
        timed = not cold and telemetry.device_sample_due(fn)
        stream = self._handle.get_next_usable_stream(lane)
        start = None
        remote = False
        t0 = telemetry.now()
        try:
            with stream.context():
                if timed and self._device.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                if be.distributed:
                    r = be.dispatch(block, replica or 0)
                else:
                    r = be.dispatch(block.to(self._device, non_blocking=True))
                if isinstance(r, spmd.Pending):
                    out, start, remote = r.out(), None, True
                else:
                    d, i = r
                    out = (d.to("cpu", non_blocking=True),
                           i.to("cpu", non_blocking=True),
                           stream.record(timing=start is not None))
        except Exception as e:
            return e, None
        host_s = telemetry.now() - t0
        sig = self._sig(block, bucket)
        telemetry.record_dispatch(fn, sig, cold, host_s)
        if timed and self._device.type != "cuda" and not remote:
            # the CPU runs the dispatch to its end before it returns
            telemetry.record_device_sample(fn, sig, host_s)
        return out, start

    def _dispatch_solo(self, q, lane: int, replica: Optional[int] = None):
        """The backend's solo entry on lane *lane* (same contract as
        :meth:`_dispatch`, never timed)."""
        stream = self._handle.get_next_usable_stream(lane)
        try:
            with stream.context():
                if self._backend.distributed:
                    # as ``ann_mnmg.search`` batches it: one allgather a
                    # batch of up to its batch size
                    d, i = self._backend.solo(q, replica or 0)
                else:
                    # in batches of the largest bucket: the signatures
                    # the warmup ran
                    d, i = self._backend.solo(q, batch=self.max_batch)
                return (d.to("cpu", non_blocking=True),
                        i.to("cpu", non_blocking=True), stream.record())
        except Exception as e:
            return e

    def _sig(self, block: torch.Tensor, bucket: int) -> str:
        """The dispatch signature label: request type and block shape."""
        return f"{dtype_name(block.dtype)}[{bucket},{self._backend.dim}]"

    def _record_device_time(self, out, start, block, bucket) -> None:
        """A sampled dispatch's device time, read once its end-of-work
        event has completed — collection waited on it already, so this
        adds no synchronisation (skipped if a retry on the other lane
        served the batch before it completed)."""
        done = out[2] if isinstance(out, tuple) else None
        if start is None or done is None or not done.query():
            return
        telemetry.record_device_sample(self._backend_fn() or
                                       self._backend.name,
                                       self._sig(block, bucket),
                                       start.elapsed_time(done) / 1e3)

    def _search_locked(self, requests):
        t_entry = telemetry.now()
        be = self._backend
        sup = self._supervisor
        adm = self._admission
        raw = [r.q if isinstance(r, ServeRequest) else r for r in requests]
        results: List[Any] = [None] * len(raw)
        latencies = [0.0] * len(raw)
        ingested: List[Optional[torch.Tensor]] = [None] * len(raw)
        with telemetry.span("serve.ingest"):
            for j, q in enumerate(raw):
                try:
                    ingested[j] = be.ingest(q)
                except Exception as e:   # a poisoned request fails alone
                    results[j] = e
                    self.stats.inc("ingest_errors")
        self.stats.inc("requests", len(raw))
        self.stats.inc("queries", sum(int(q.shape[0]) for q in ingested
                                      if q is not None))
        # the shadow ring: one slot store per request with rows
        for q in ingested:
            if q is not None and q.shape[0]:
                self._shadow_ring[self._shadow_pos % _SHADOW_RING] = q
                self._shadow_pos += 1

        # deadline-aware admission in arrival order, BEFORE planning
        deadlines: List[Optional[float]] = [None] * len(raw)
        if adm is not None:
            with telemetry.span("serve.admit"):
                est = adm.batch_cost_s(self._backend_fn())
                queued = 0
                for j, r in enumerate(requests):
                    if results[j] is not None or ingested[j] is None:
                        continue
                    n = int(ingested[j].shape[0])
                    if n == 0:
                        continue
                    now = telemetry.now()
                    if isinstance(r, ServeRequest):
                        deadlines[j] = r.resolve_deadline(now)
                    rej = adm.admit(n, deadlines[j], now, queued,
                                    queued // self.max_batch, est)
                    if rej is not None:
                        results[j] = rej
                        self.stats.inc("sheds")
                    else:
                        self.stats.inc("admitted")
                        queued += n

        # group by type: a super-batch has ONE type, its ladder's
        with telemetry.span("serve.coalesce"):
            by_dtype: Dict[str, List[int]] = {}
            for j, q in enumerate(ingested):
                if results[j] is not None or q is None:
                    continue
                if q.shape[0] == 0:
                    results[j] = (np.zeros((0, be.k), np.float32),
                                  np.full((0, be.k), -1, np.int32))
                    continue
                by_dtype.setdefault(dtype_name(q.dtype), []).append(j)
            plans = []
            for dt, idxs in by_dtype.items():
                warmed = self._warmed.get(dt, set())
                max_bucket = (min(max(warmed), self.max_batch) if warmed
                              else self.max_batch)
                sizes = [int(ingested[j].shape[0]) for j in idxs]
                if self._sched_cfg is not None:
                    # the continuous-batching chooser: buckets come ONLY
                    # from the _bucket_for ladder, so it stays on warmed
                    # shapes
                    batches, solo = choose_batches(
                        sizes, [deadlines[j] for j in idxs],
                        lambda total, w=warmed: self._bucket_for(total, w),
                        max_bucket, self._cost, dt, telemetry.now())
                else:
                    batches, solo = self._plan(sizes, max_bucket)
                plans.append((dt, idxs, warmed, batches, solo))

        # (kind, members, out, start, redo, t0, bucket, dt, warmed, block,
        #  replica)
        inflight = []
        lane = 0
        for dt, idxs, warmed, batches, solo in plans:
            for batch in batches:
                members = [(idxs[jj], start, n) for jj, start, n in batch]
                members = self._drop_expired(members, deadlines, results)
                if not members:
                    continue
                total = members[-1][1] + members[-1][2]
                bucket = self._bucket_for(total, warmed)
                with telemetry.span("serve.assemble"):
                    block = torch.zeros((bucket, be.dim),
                                        dtype=ingested[members[0][0]].dtype)
                    for j, start, n in members:
                        block[start:start + n] = ingested[j]
                t0 = telemetry.now()
                cold = bucket not in warmed
                with telemetry.span("serve.dispatch"):
                    if self._router is None:
                        out, start = self._dispatch(block, lane, bucket, cold)
                        replica = None
                        # a retry goes to the OTHER stream lane: a stalled
                        # kernel cannot be cancelled
                        redo = (lambda blk=block, ln=lane + 1, b=bucket:
                                self._dispatch(blk, ln, b, False)[0])
                    else:
                        # replica routing: the least-loaded live lane; a
                        # dispatch-time lane fault drains the lane and
                        # re-routes the block
                        out, start, replica = self._dispatch_routed(
                            block, lane, bucket, cold,
                            max(self._cost.batch_cost_s(dt, bucket),
                                self._warm_cost.get((dt, bucket), 0.0)))
                        if replica is None:
                            done = telemetry.now() - t_entry
                            self.stats.inc("dispatch_errors")
                            for j, _s, _n in members:
                                results[j] = out
                                latencies[j] = done
                            continue
                        redo = (lambda blk=block, ln=lane + 1, b=bucket,
                                r=replica:
                                self._dispatch(blk, ln, b, False, r)[0])
                lane += 1
                inflight.append(("coalesced", members, out, start, redo, t0,
                                 bucket, dt, warmed, block, replica))
                self.stats.inc("super_batches")
                self.stats.inc("coalesced_requests", len(members))
            for jj in solo:
                j = idxs[jj]
                if not self._drop_expired([(j, 0, 0)], deadlines, results):
                    continue
                # the request as it came, on the host: the solo entry
                # applies its own ingest
                q = _request_tensor(raw[j])
                replica = (None if self._router is None
                           else (self._router.alive_lanes() or [0])[0])
                with telemetry.span("serve.dispatch"):
                    out = self._dispatch_solo(q, lane, replica)
                redo = (lambda q=q, ln=lane + 1, r=replica:
                        self._dispatch_solo(q, ln, r))
                lane += 1
                inflight.append(("solo", [(j, 0, int(ingested[j].shape[0]))],
                                 out, None, redo, telemetry.now(), None, dt,
                                 warmed, None, None))
                self.stats.inc("solo_fallbacks")

        # collect in dispatch order; later batches keep running meanwhile
        with telemetry.span("serve.deliver"):
            for (kind, members, out, start, redo, t0, bucket, dt, warmed,
                 block, replica) in inflight:
                try:
                    d, i = sup.collect(out, redo=redo, label=kind)
                except Exception as e:
                    collected = None
                    if replica is not None:
                        # a replica lane's failure drains the lane and
                        # re-routes the SAME block to a live lane
                        collected = self._reroute(block, bucket, replica, e)
                    if collected is None:
                        self.stats.inc("dispatch_errors")
                        if kind == "coalesced" and len(members) > 1:
                            self.stats.inc("isolation_splits")
                            self._isolate(members, ingested, warmed,
                                          results, latencies, t_entry)
                        else:
                            done = telemetry.now() - t_entry
                            for j, _start, _n in members:
                                results[j] = e
                                latencies[j] = done
                        continue
                    d, i = collected
                self._record_device_time(out, start, block, bucket)
                now = telemetry.now()
                if kind == "coalesced":
                    # per-(type, bucket) service time → the chooser's cost
                    # model; per-lane → the router's
                    self._cost.observe(dt, bucket, now - t0)
                    if replica is not None:
                        self._router.note_done(replica, now, now - t0)
                for j, start_row, n in members:
                    results[j] = (d[start_row:start_row + n],
                                  i[start_row:start_row + n])
                    latencies[j] = now - t_entry
        n_batches = sum(1 for kind, *_ in inflight if kind == "coalesced")
        if adm is not None and n_batches:
            adm.observe_batches(n_batches, telemetry.now() - t_entry)
        eng = (self._engine_id,)
        for j, v in enumerate(latencies):
            if isinstance(results[j], tuple):   # served: record latency
                self.latency_hist.observe(v, eng)
        self._last_latencies = latencies[:LATENCY_RESERVOIR]
        return results

    def _drop_expired(self, members, deadlines, results):
        """Dispatch-time deadline pass over one planned batch: admitted
        requests whose deadline already passed are counted expired (and,
        under shed-over-deadline, dropped — their slots get the typed
        rejection and the survivors re-pack contiguously)."""
        adm = self._admission
        if adm is None:
            return members
        live, start = [], 0
        for j, _start, n in members:
            dl = deadlines[j]
            now = telemetry.now()
            if dl is not None and now > dl:
                self.stats.inc("expired")
                rej = adm.expire(dl, now)
                if rej is not None:
                    results[j] = rej
                    continue
            live.append((j, start, n))
            start += n
        return live

    def _dispatch_routed(self, block, lane: int, bucket: int, cold: bool,
                         est_s: float):
        """Replica-lane dispatch with dispatch-time fault draining: pick
        the least-loaded live replica lane and dispatch; a retryable
        failure (the comms fault site, a transient error) DRAINS that
        lane and the same block goes to the next live lane — no failed
        request while a lane lives.  Returns ``(out, start, replica)``;
        ``replica`` is None when no lane took the block (``out`` is then
        the error)."""
        tried: List[int] = []
        last: Optional[BaseException] = None
        while True:
            r = self._router.pick(telemetry.now(), est_s, exclude=tried)
            if r is None:
                return (last if last is not None else RejectedError(
                    "overload", "no live replica lane to dispatch to"),
                    None, None)
            out, start = self._dispatch(block, lane, bucket, cold, r)
            if isinstance(out, BaseException):
                if not retryable(out):
                    return out, None, None
                self._router.fault(r)
                self.stats.inc("replica_faults")
                tried.append(r)
                last = out
                continue
            if tried:   # a drained lane's traffic landed elsewhere
                self.stats.inc("replica_reroutes")
            return out, start, r

    def _reroute(self, block, bucket: int, replica: int, exc):
        """Collect-time replica failure: drain *replica* and re-dispatch
        the SAME block on a surviving lane (every lane warmed every
        signature).  Returns the collected (d, i), or None when no lane
        can serve it (the caller isolates or fails the members)."""
        if not retryable(exc):
            return None
        self._router.fault(replica)
        self.stats.inc("replica_faults")
        tried = [replica]
        while True:
            alt = self._router.pick(telemetry.now(), 0.0, exclude=tried)
            if alt is None:
                return None
            try:
                out, _ = self._dispatch(block, 0, bucket, False, alt)
                d, i = self._supervisor.collect(
                    out, redo=lambda a=alt: self._dispatch(
                        block, 1, bucket, False, a)[0],
                    label="rerouted")
                self.stats.inc("replica_reroutes")
                return d, i
            except Exception:
                self._router.fault(alt)
                self.stats.inc("replica_faults")
                tried.append(alt)

    def _isolate(self, members, ingested, warmed, results, latencies,
                 t_entry):
        """Per-request isolation: re-dispatch each member of a failed
        super-batch ALONE through the warmed bucket ladder (a replica
        engine: on its first live lane).  Members that fail alone get
        their error; the rest are served."""
        sup = self._supervisor
        for lane, (j, _start, n) in enumerate(members):
            bucket = self._bucket_for(n, warmed)
            block = torch.zeros((bucket, self._backend.dim),
                                dtype=ingested[j].dtype)
            block[:n] = ingested[j]
            extra = (() if self._router is None
                     else ((self._router.alive_lanes() or [0])[0],))
            out, _ = self._dispatch(block, lane, bucket, False, *extra)
            redo = (lambda blk=block, ln=lane + 1, b=bucket:
                    self._dispatch(blk, ln, b, False, *extra)[0])
            try:
                d, i = sup.collect(out, redo=redo, label="isolated")
                results[j] = (d[:n], i[:n])
            except Exception as e:
                self.stats.inc("dispatch_errors")
                results[j] = e
            latencies[j] = telemetry.now() - t_entry

    def sync(self) -> None:
        """Wait for every recorded in-flight dispatch (delegates to the
        handle; ``search`` already collected its own results)."""
        self._handle.sync()

    def __repr__(self) -> str:   # pragma: no cover - cosmetic
        return (f"ServeEngine(backend={self.backend}, k={self.k}, "
                f"max_batch={self.max_batch}, "
                f"warmed={self.warmed_signatures()}, "
                f"stats={dict(self.stats)})")
