"""The leader-driven control plane of a distributed serving engine — a
``ServeEngine`` over an ``ann_mnmg.ShardedIndex`` or ``ReplicaSet``.

The port runs one process per rank, so one engine is one object per
rank.  Rank 0, the **leader**, owns the public API (``search``,
``submit``, ``flush``, ``warmup``, ``refresh``, ``close``,
``serve_http``); every other rank makes one blocking call,
``ServeEngine.follow()``, and runs what the leader sends until the leader
closes the engine.

**Lanes.**  A sharded index is one lane (all its ranks); a replica set has
one lane per replica group.  Each lane has a **control group**: a gloo
group over the leader and the lane's ranks, with the communicator's
timeout (its session's).  ``dist.new_group`` is a collective, so every
rank makes every control group, in lane order, when the first engine over
those lanes is made; later engines over the same lanes and communicator
share them, with one lock per group, and ``CommsSession.destroy``
releases them.

**Ops.**  For each op the leader broadcasts a header on the lane's control
group — eight int64: op, generation, bucket, type code, payload bytes,
argument — then the payload:

* ``DISPATCH`` — the padded (bucket, dim) block as bytes, in its own
  type.  The lane's ranks run their backend's searcher on it (its one
  allgather runs on the lane's own communicator).  When the lane's first
  rank is not the leader, it broadcasts the (bucket + 1, 2k) float32
  result back on the control group: distances, ids bit-cast, and a
  status row (non-zero: the dispatch failed on that rank, which the
  leader re-routes).  Any other follower rank cannot report in band —
  the lane's first rank waits for it in the allgather — so a failure
  there is logged and raised out of ``follow()`` at once.  The argument
  is k.
* ``REFRESH`` — the new serving params, pickled.  Argument 1: the index
  stays, each follower rebuilds its backend over its own shard; 0:
  ``follow()`` returns ``"refresh"`` and the caller passes this rank's
  new index to ``ServeEngine.refresh``.  Backends are keyed by the
  generation, so the old one serves while the new one warms.
* ``RETIRE`` — backends older than the generation are dropped.
* ``CLOSE`` — ``follow()`` returns ``"close"``.
* ``WRITE`` — a write to a served ``mutable.MutableIndex`` over a sharded
  main: the argument says upsert or delete, the bucket field the rows,
  the type code their type; the payload is the ids (int64) and, for an
  upsert, the rows, as host bytes.  Every follower applies the leader's
  writes in the order they stand between its dispatches.
* ``COMPACT`` — a phase of the leader's compaction of that index (the
  argument): start (each follower takes its live rows at this point of
  the write order and builds its share of ``build_sharded`` on a thread
  of its own, serving the old core meanwhile), swap (the follower waits
  for its build, bounded by the communicator's timeout, and swaps at this
  point) or abort.  The engine's refresh that promotes the compacted
  index follows, with its REFRESH / RETIRE generation.

**Staging.**  The control plane carries host tensors only (gloo's
point-to-point of CUDA tensors broke the world; its collectives take
them, but a block starts on the host anyway): the block and the result
are staged through the host, and :attr:`LaneWire.calls` counts every
header, block and result with their bytes.

**Concurrency.**  The leader posts another lane's header, block and
result receive as asynchronous work on that lane's control group and
returns, so the lane runs on its own processes while the leader
dispatches the next batch.  The leader's own shard runs on one dispatch
thread of its own (inline in a world of one), which also copies its
result to the host, so the leader's lane is busy exactly as long as its
search and the router sees it so.  A group's lock is held while its ops
are posted and its own-lane search is queued, so on every rank the
collectives of a group are issued in one order, by one thread.

**Faults.**  A replica dispatch's fault site (``comms``,
``op=replica_dispatch``, ``rank=<lane>``) is checked on the leader before
anything is sent, so a drained lane's ranks simply receive nothing.  A
dead process is out of scope (the fault site models it); every wait on a
control group is bounded by the group's timeout.
"""

from __future__ import annotations

import datetime
import logging
import pickle
import threading
from concurrent import futures
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from raft_tpu_torch import telemetry
from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.core.error import expects

_log = logging.getLogger(__name__)

#: the rank that owns the engine's public API
LEADER = 0

OP_DISPATCH, OP_REFRESH, OP_RETIRE, OP_CLOSE, OP_WRITE, OP_COMPACT = (
    1, 2, 3, 4, 5, 6)
_HEADER = 8

#: the block types the wire carries, by code (the engine's ladder types)
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8,
          torch.uint8)
_CODE = {dt: j for j, dt in enumerate(DTYPES)}

_GROUPS_LOCK = threading.Lock()


def _control_groups(comms: Comms, lanes: Sequence[Sequence[int]]):
    """The control groups over *lanes* and their locks, made once per
    communicator (every rank makes every group, in lane order)."""
    key = tuple(tuple(lane) for lane in lanes)
    with _GROUPS_LOCK:
        if key not in comms._control:
            td = datetime.timedelta(seconds=comms.timeout_s)
            groups = []
            for ranks in lanes:
                members = sorted({LEADER, *ranks})
                pg = (dist.new_group(members, backend="gloo", timeout=td)
                      if len(members) > 1 else None)
                if pg is not None:
                    comms._made.append(pg)
                groups.append(pg)
            comms._control[key] = (groups,
                                   [threading.Lock() for _ in lanes])
        return comms._control[key]


class Pending:
    """A batch in flight.  :meth:`out` is the engine's ``(distances,
    indices, done)`` triple — host tensors filled once the batch is done;
    ``done`` is this object: :meth:`synchronize` waits and raises when the
    batch failed."""

    def out(self):
        return self.d, self.i, self

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        # exempt(hot-path-host-transfer): a lane's result waits for its broadcast
        self.synchronize()
        return self.d, self.i


class _Remote(Pending):
    """A batch on another lane: the views of the lane's result broadcast
    (bounded by the group's timeout); a non-zero status row is the lane's
    failure."""

    def __init__(self, res: torch.Tensor, k: int, works: List, lane: int):
        self.res = res
        self.d = res[:-1, :k]
        self.i = res[:-1, k:].view(torch.int32)
        self.works = works
        self.lane = lane

    def synchronize(self) -> None:
        for w, _ in self.works:
            w.wait()
        if float(self.res[-1, 0]) != 0.0:
            raise RuntimeError(f"replica lane {self.lane}: the dispatch "
                               "failed on the lane's ranks")


class _Local(Pending):
    """A batch on the leader's own lane, run by its dispatch thread."""

    def __init__(self, fut: futures.Future, d: torch.Tensor,
                 i: torch.Tensor):
        self.fut = fut
        self.d = d
        self.i = i

    def synchronize(self) -> None:
        self.fut.result()


class LaneWire:
    """The control plane over *lanes* (lists of global ranks) of the
    served index's communicator *comms*, for one engine; ``label`` names
    its counters.  On the leader :meth:`post` sends ops; on a follower
    :meth:`serve` runs them."""

    def __init__(self, comms: Comms, lanes: Sequence[Sequence[int]],
                 label: str):
        self.lanes = [[int(r) for r in lane] for lane in lanes]
        self.rank = dist.get_rank()
        expects(any(self.rank in lane for lane in self.lanes),
                f"rank {self.rank} is in no lane of the served index")
        self.groups, self.locks = _control_groups(comms, self.lanes)
        #: this rank's lane (the leader's: the lane holding rank 0)
        self.lane = next(r for r, lane in enumerate(self.lanes)
                         if self.rank in lane)
        self.is_leader = self.rank == LEADER
        #: the leader's own-lane dispatch thread (made at first use); a
        #: world of one runs its batches inline
        self.async_local = dist.get_world_size() > 1
        self._local: Optional[futures.ThreadPoolExecutor] = None
        #: headers, blocks and results sent or received on the control
        #: plane, with their bytes — everything here is staged through
        #: the host
        self.calls: telemetry.LegacyCounterView = telemetry.legacy_counter(
            "raft_tpu_serve_wire_calls",
            "control-plane ops and bytes of a distributed serving engine",
            labelnames=("engine", "key"), fixed=(label,))

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)

    # -- the leader's side ---------------------------------------------------
    def _header(self, lane: int, op: int, gen: int = 0, bucket: int = 0,
                dtype=torch.float32, nbytes: int = 0, arg: int = 0):
        hdr = torch.tensor([op, gen, bucket, _CODE[dtype], nbytes, arg, 0, 0],
                           dtype=torch.int64)
        self.calls.inc("header")
        # exempt(collective-discipline): control plane: host header on the lane's group
        return (dist.broadcast(hdr, src=LEADER, group=self.groups[lane],
                               async_op=True), hdr)

    def _payload(self, lane: int, data: torch.Tensor, key: str):
        self.calls.inc(key)
        self.calls.inc(f"{key}_bytes", data.numel())
        # exempt(collective-discipline): control plane: host block on the lane's group
        return (dist.broadcast(data, src=LEADER, group=self.groups[lane],
                               async_op=True), data)

    def post(self, lane: int, gen: int, block: torch.Tensor, k: int):
        """Send one dispatch to *lane*'s followers (the caller holds
        ``locks[lane]``).  Returns a :class:`_Remote` when the lane's
        result comes back over the wire, else the posted work (the lane
        holds the leader, whose own search completes the exchange), a
        list to wait on after it."""
        if self.groups[lane] is None:
            return []
        raw = block.contiguous().view(torch.uint8).reshape(-1)
        works = [self._header(lane, OP_DISPATCH, gen, block.shape[0],
                              block.dtype, raw.numel(), k),
                 self._payload(lane, raw, "block")]
        src = self.lanes[lane][0]
        if src == LEADER:
            return works
        res = torch.empty((block.shape[0] + 1, 2 * k), dtype=torch.float32)
        # exempt(collective-discipline): control plane: host result on the lane's group
        works.append((dist.broadcast(res, src=src, group=self.groups[lane],
                                     async_op=True), res))
        self.calls.inc("result")
        self.calls.inc("result_bytes", res.numel() * 4)
        return _Remote(res, k, works, lane)

    def run_local(self, search: Callable[[], Tuple], bucket: int, k: int,
                  device: torch.device) -> _Local:
        """Queue *search* — the leader's own shard of one batch — on the
        dispatch thread, which copies its (bucket, k) result to the host
        (the caller holds the lane's lock)."""
        if self._local is None:
            init = ((lambda: torch.cuda.set_device(device))
                    if device.type == "cuda" else None)
            self._local = futures.ThreadPoolExecutor(
                1, thread_name_prefix="raft-tpu-torch-lane",
                initializer=init)
        d = torch.empty((bucket, k), dtype=torch.float32)
        i = torch.empty((bucket, k), dtype=torch.int32)

        def run():
            dd, ii = search()
            d.copy_(dd)
            i.copy_(ii)

        return _Local(self._local.submit(run), d, i)

    def post_write(self, arg: int, ids, rows: Optional[torch.Tensor]):
        """Send one write to the followers of the leader's lane (the
        caller holds the lane's lock): the ids and, with *rows*, the rows,
        staged through the host.  Returns the posted work to wait on once
        the lock is released."""
        lane = self.lane
        if self.groups[lane] is None:
            return []
        ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1)
        parts = [ids.view(torch.uint8)]
        dtype = torch.float32
        if rows is not None:
            # exempt(hot-path-host-transfer): control plane stages rows through the host
            rows = rows.detach().cpu().contiguous()
            expects(rows.dtype in _CODE, f"WRITE: rows of type {rows.dtype} "
                    "do not travel on the control plane")
            dtype = rows.dtype
            parts.append(rows.view(torch.uint8).reshape(-1))
        raw = torch.cat(parts)
        return [self._header(lane, OP_WRITE, bucket=ids.numel(), dtype=dtype,
                             nbytes=raw.numel(), arg=arg),
                self._payload(lane, raw, "write")]

    def post_compact(self, phase: int):
        """Send one phase of a compaction to the followers of the leader's
        lane (the caller holds the lane's lock); returns the posted
        work."""
        lane = self.lane
        if self.groups[lane] is None:
            return []
        self.calls.inc("compact")
        return [self._header(lane, OP_COMPACT, arg=phase)]

    def _to_all(self, op: int, gen: int = 0, payload: bytes = b"",
                arg: int = 0) -> None:
        for lane in range(self.n_lanes):
            if self.groups[lane] is None:
                continue
            with self.locks[lane]:
                works = [self._header(lane, op, gen, nbytes=len(payload),
                                      arg=arg)]
                if payload:
                    works.append(self._payload(
                        lane, torch.frombuffer(bytearray(payload),
                                               dtype=torch.uint8),
                        "params"))
            for w, _ in works:
                w.wait()

    def refresh(self, gen: int, params, same_index: bool) -> None:
        """Tell every follower that generation *gen* comes with *params*
        (over its own current index when *same_index*)."""
        self._to_all(OP_REFRESH, gen, pickle.dumps(params),
                     arg=int(bool(same_index)))

    def retire(self, gen: int) -> None:
        self._to_all(OP_RETIRE, gen)

    def close(self) -> None:
        if self._local is not None:
            self._local.shutdown(wait=True)
        self._to_all(OP_CLOSE)

    # -- a follower's side ---------------------------------------------------
    def serve(self, dispatch: Callable[[int, torch.Tensor], Tuple],
              refresh: Callable[[int, object, bool], bool],
              retire: Callable[[int], None],
              write: Callable[[int, torch.Tensor, Optional[torch.Tensor]],
                              None],
              compact: Callable[[int], None]) -> str:
        """Run the leader's ops until it closes (``"close"``) or sends a
        new index (``"refresh"``, after ``refresh(gen, params, False)``
        recorded it).  ``dispatch(gen, block)`` runs one block, ``refresh
        (gen, params, same_index)`` returns True when it rebuilt the
        backend itself, ``retire(gen)`` drops older backends, ``write(arg,
        ids, rows)`` applies a write (rows None for a delete) and
        ``compact(phase)`` a compaction phase."""
        expects(not self.is_leader, "follow() is for the ranks other than "
                "the leader (rank 0)")
        g = self.groups[self.lane]
        src = self.lanes[self.lane][0]
        while True:
            hdr = torch.empty(_HEADER, dtype=torch.int64)
            # exempt(collective-discipline): control plane: host header on the lane's group
            dist.broadcast(hdr, src=LEADER, group=g)
            # exempt(hot-path-host-transfer): the control header is a host tensor
            head = hdr[:6].tolist()
            op, gen, bucket, code, nbytes, arg = (int(v) for v in head)
            self.calls.inc("header")
            if op == OP_CLOSE:
                return "close"
            if op == OP_RETIRE:
                retire(gen)
                continue
            if op == OP_COMPACT:
                self.calls.inc("compact")
                compact(arg)
                continue
            buf = torch.empty(nbytes, dtype=torch.uint8)
            # exempt(collective-discipline): control plane: host bytes on the lane's group
            dist.broadcast(buf, src=LEADER, group=g)
            if op == OP_WRITE:
                self.calls.inc("write")
                self.calls.inc("write_bytes", nbytes)
                ids = buf[:8 * bucket].view(torch.int64)
                rows = (buf[8 * bucket:].view(DTYPES[code]).reshape(
                    bucket, -1) if nbytes > 8 * bucket else None)
                write(arg, ids, rows)
                continue
            if op == OP_REFRESH:
                self.calls.inc("params")
                # exempt(hot-path-host-transfer): pickled params arrive as host bytes
                if not refresh(gen, pickle.loads(buf.numpy().tobytes()),
                               bool(arg)):
                    return "refresh"
                continue
            self.calls.inc("block")
            self.calls.inc("block_bytes", nbytes)
            block = buf.view(DTYPES[code]).reshape(bucket, -1)
            k = arg
            if self.rank != src:
                try:
                    dispatch(gen, block)
                except Exception:
                    _log.exception("rank %d: a dispatch of lane %d failed; "
                                   "leaving follow()", self.rank, self.lane)
                    raise
                if src != LEADER:   # the lane's first rank sends
                    # exempt(collective-discipline): control plane: host result on the lane's group
                    dist.broadcast(torch.empty((bucket + 1, 2 * k),
                                               dtype=torch.float32),
                                   src=src, group=g)
                continue
            res = torch.zeros((bucket + 1, 2 * k), dtype=torch.float32)
            try:
                d, i = dispatch(gen, block)
                # exempt(hot-path-host-transfer): a follower's result goes back as a host tensor
                res[:-1, :k] = d.float().cpu()
                # exempt(hot-path-host-transfer): a follower's result goes back as a host tensor
                res[:-1, k:] = i.to(torch.int32).cpu().view(torch.float32)
            except Exception:   # reported to the leader, which re-routes
                _log.warning("rank %d: a dispatch of lane %d failed; the "
                             "leader re-routes it", self.rank, self.lane,
                             exc_info=True)
                res[-1, 0] = 1.0
            self.calls.inc("result")
            self.calls.inc("result_bytes", res.numel() * 4)
            # exempt(collective-discipline): control plane: host result on the lane's group
            dist.broadcast(res, src=src, group=g)
