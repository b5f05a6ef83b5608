"""Batched query serving over IVF-Flat and IVF-PQ (port of
``raft_tpu/serve/engine.py``: ``_IvfFlatBackend`` :155, ``_IvfPqBackend``
:214, ``_make_backend`` :527, ``ServeEngine`` :544 with ``warmup`` :777,
the drain-all planner ``_plan`` :1104, ``_bucket_for`` :1126 and
``search`` :1138).

The ported engine behaves as the JAX one does with ``scheduler=False,
admission=False``: concurrent ragged requests are packed in arrival order
into super-batches of at most ``max_batch`` rows, each padded on the host
to its power-of-two bucket and searched as ONE batch; results are sliced
back per request.  Every query row's result is independent of the other
rows of its batch, so a request's answer equals what the solo
``search`` of its index type returns for it.  A request larger than the
largest bucket is served solo.  An IVF-PQ engine with a compressed LUT
clamps its super-batch to ``ivf_pq.hoisted_batch_cap`` (32 queries at
fp8 on sift-128 with the default index), bounding the per-batch
combined-LUT transients.  Super-batches alternate over the handle's
stream pool, so the host assembles batch i+1 while the card still runs
batch i; collection waits on each lane's event.

Not ported yet: the brute-force, sharded, replica, tiered and mutable
backends, admission, the continuous-batching scheduler, supervision and
retries, autotuning, telemetry, the HTTP surface, ``submit``/``flush``
and ``refresh``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import Handle
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq


class _IvfFlatBackend:
    """Adapter: ``ivf_flat.Index`` → ``ivf_flat._search_batch_impl``."""

    name = "ivf_flat"

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

    def ingest(self, q) -> np.ndarray:
        """Host-side compute-form conversion, matching what the solo path
        does before batching: int8/uint8 widen exactly to float32; cosine
        queries are normalized on the device as the solo path does."""
        q = np.asarray(q)
        expects(q.ndim == 2 and q.shape[1] == self.dim, "query dim mismatch")
        if q.dtype in (np.int8, np.uint8):
            q = q.astype(np.float32)
        expects(q.dtype == np.float32, f"query dtype {q.dtype}: the port "
                "serves float32")
        if self.index.metric == DistanceType.CosineExpanded and q.shape[0]:
            qt = torch.as_tensor(q, device=self.index.device)
            return ivf_flat._normalize_rows(qt).cpu().numpy()
        return q

    def dispatch(self, qb: torch.Tensor):
        return ivf_flat._search_batch_impl(qb, self.index, self.k,
                                           self.n_probes, self.sqrt,
                                           self.engine)

    def solo(self, q):
        return ivf_flat.search(self.params, self.index,
                               np.asarray(q).astype(np.float32, copy=False),
                               self.k, engine=self.engine)


class _IvfPqBackend:
    """Adapter: ``ivf_pq.Index`` → ``ivf_pq._full_search_impl`` (coarse +
    select + probe scan of one batch)."""

    name = "ivf_pq"

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

    def ingest(self, q) -> np.ndarray:
        """Host-side float32 ingest, the same conversion as the solo
        path's cast (int8/uint8 and half types widen exactly)."""
        q = np.asarray(q)
        if q.dtype in (np.int8, np.uint8):
            q_dtype = str(q.dtype)
        else:
            expects(np.issubdtype(q.dtype, np.floating),
                    f"ivf_pq: unsupported query dtype {q.dtype}")
            q_dtype = "float32"
        expects(q_dtype in (self.index.dataset_dtype, "float32"),
                f"query dtype {q_dtype} != index dataset dtype "
                f"{self.index.dataset_dtype}")
        expects(q.ndim == 2 and q.shape[1] == self.dim, "query dim mismatch")
        return q.astype(np.float32)

    def batch_cap(self) -> Optional[int]:
        return ivf_pq.hoisted_batch_cap(self.index, self.n_probes,
                                        self.params.lut_dtype)

    def dispatch(self, qb: torch.Tensor):
        return ivf_pq._full_search_impl(qb, self.index, self.k,
                                        self.n_probes, self.params.lut_dtype,
                                        self.engines)

    def solo(self, q):
        return ivf_pq.search(self.params, self.index, q, self.k,
                             engine=self.engine)


def _make_backend(index, k, params, engine):
    if isinstance(index, ivf_flat.Index):
        return _IvfFlatBackend(index, k, params, engine)
    if isinstance(index, ivf_pq.Index):
        return _IvfPqBackend(index, k, params, engine)
    raise TypeError(f"ServeEngine: {type(index).__name__} is not ported "
                    "yet (ivf_flat.Index and ivf_pq.Index are)")


class ServeEngine:
    """Coalescing query server for one (index, k, params) serving key.

    ``max_batch`` bounds one coalesced super-batch (clamped to the
    backend's batch cap, if it has one) and is the largest bucket
    :meth:`warmup` runs by default; ``handle`` supplies the stream
    pool (default: two lanes on the index's device).  :meth:`search` may be
    called from several threads; calls are serialized under a lock."""

    def __init__(self, index, k: int, params=None, *, max_batch: int = 1024,
                 handle: Optional[Handle] = None,
                 engine: Optional[str] = None):
        expects(max_batch >= 8, "max_batch must be >= 8")
        self._backend = _make_backend(index, k, params, engine)
        self.max_batch = int(max_batch)
        cap = getattr(self._backend, "batch_cap", lambda: None)()
        if cap is not None:
            self.max_batch = max(8, min(self.max_batch, cap))
        self._handle = (handle if handle is not None
                        else Handle(index.device, n_streams=2))
        self._device = index.device
        self._warmed: set = set()
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            key: 0 for key in ("requests", "queries", "super_batches",
                               "solo_fallbacks", "coalesced_requests",
                               "ingest_errors", "dispatch_errors")}
        self._last_latencies: List[float] = []

    @property
    def last_latencies(self) -> List[float]:
        """Per-request completion latency (seconds, from ``search()``
        entry to the request's results on the host) of the last call."""
        return list(self._last_latencies)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> int:
        """Run one search at every bucket — every power of two from 8 up to
        ``max_batch`` by default — so the kernels are built and the
        allocator has seen each shape before traffic arrives.  Explicit
        *buckets* narrow the range: requests too large for the largest
        warmed bucket are served solo.  Returns the number of buckets
        warmed."""
        if buckets is None:
            buckets, b = [], 8
            while b < self.max_batch:
                buckets.append(b)
                b <<= 1
            buckets.append(self.max_batch)
        buckets = sorted(set(int(b) for b in buckets))
        with self._lock:
            for b in buckets:
                expects(8 <= b <= self.max_batch,
                        f"bucket {b} outside [8, max_batch={self.max_batch}]")
                self._backend.dispatch(torch.zeros(
                    (b, self._backend.dim), dtype=torch.float32,
                    device=self._device))
                self._warmed.add(b)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        return len(buckets)

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

    @staticmethod
    def _to_host(out):
        d, i = out
        return (d.to("cpu", non_blocking=True), i.to("cpu", non_blocking=True))

    def search(self, requests: Sequence[Any]
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Serve a batch of concurrent requests: one (n_j, dim) query
        matrix each (ragged, n_j >= 0).  Returns one ``(distances (n_j, k),
        indices (n_j, k))`` numpy pair per request, in request order; a
        request that fails ingest or dispatch gets its exception in its
        slot instead, while the other requests are served."""
        with self._lock:
            return self._search_locked(requests)

    def _search_locked(self, requests):
        t_entry = time.perf_counter()
        be = self._backend
        results: List[Any] = [None] * len(requests)
        latencies = [0.0] * len(requests)
        ingested: List[Optional[np.ndarray]] = [None] * len(requests)
        for j, q in enumerate(requests):
            try:
                ingested[j] = be.ingest(q)
            except Exception as e:  # a poisoned request fails alone
                results[j] = e
                self.stats["ingest_errors"] += 1
        self.stats["requests"] += len(requests)
        self.stats["queries"] += sum(int(q.shape[0]) for q in ingested
                                     if q is not None)

        idxs = []   # the requests to serve (all float32 after ingest)
        for j, q in enumerate(ingested):
            if q is None:
                continue
            if q.shape[0] == 0:
                results[j] = (np.zeros((0, be.k), np.float32),
                              np.full((0, be.k), -1, np.int32))
                continue
            idxs.append(j)

        warmed = self._warmed
        max_bucket = (min(max(warmed), self.max_batch) if warmed
                      else self.max_batch)
        batches, solo = self._plan(
            [int(ingested[j].shape[0]) for j in idxs], max_bucket)
        inflight = []   # (members, host results, end-of-work event)
        lane = 0
        for batch in batches:
            members = [(idxs[jj], start, n) for jj, start, n in batch]
            total = members[-1][1] + members[-1][2]
            bucket = self._bucket_for(total, warmed)
            # host-side assembly: one padded block, one transfer
            block = np.zeros((bucket, be.dim), np.float32)
            for j, start, n in members:
                block[start:start + n] = ingested[j]
            stream = self._handle.get_next_usable_stream(lane)
            lane += 1
            try:
                with stream.context():
                    qb = torch.from_numpy(block).to(self._device,
                                                    non_blocking=True)
                    out = self._to_host(be.dispatch(qb))
                    done = stream.record()
            except Exception as e:
                self.stats["dispatch_errors"] += 1
                for j, _s, _n in members:
                    results[j] = e
                continue
            inflight.append((members, out, done))
            self.stats["super_batches"] += 1
            self.stats["coalesced_requests"] += len(members)
        for jj in solo:
            j = idxs[jj]
            stream = self._handle.get_next_usable_stream(lane)
            lane += 1
            try:
                with stream.context():
                    # the RAW request: the solo entry applies its own
                    # ingest prologue
                    out = self._to_host(be.solo(requests[j]))
                    done = stream.record()
            except Exception as e:
                results[j] = e
                self.stats["dispatch_errors"] += 1
                continue
            inflight.append(([(j, 0, int(ingested[j].shape[0]))], out, done))
            self.stats["solo_fallbacks"] += 1

        for members, (d, i), done in inflight:
            if done is not None:
                done.synchronize()
            d, i = d.numpy(), i.numpy()
            t_done = time.perf_counter() - t_entry
            for j, start, n in members:
                results[j] = (d[start:start + n], i[start:start + n])
                latencies[j] = t_done
        self._last_latencies = latencies
        return results
