"""The communicator: the ``comms_t`` surface over ``torch.distributed``
(port of ``raft_tpu/comms/comms.py``; reference raft/core/comms.hpp:108-216
``comms_iface``, :218-648 the typed ``comms_t`` façade, and the NCCL/UCX
``std_comms`` backend, comms/detail/std_comms.hpp:55).

The port distributes the way PyTorch does: **one process per rank, each
rank one device**, collectives from ``torch.distributed`` — NCCL on the
card, gloo on the CPU.  A :class:`Comms` binds a process group and this
process's place in it, so ``get_size`` / ``get_rank`` /
``get_global_rank`` are plain ints and every collective runs eagerly on
this rank's tensors.  The JAX package's ``shard_map`` plumbing
(``shard_map_compat``, ``globalize``, ``run``) has no counterpart: there
every rank lives inside one traced program, here each process already is
one rank (so :meth:`Comms.is_multiprocess` is true whenever the group
has more than one member).

* **Device plane** — ``allreduce`` / ``bcast`` / ``reduce`` /
  ``allgather(v)`` / ``gather(v)`` / ``reducescatter`` and the device p2p
  pair ``device_sendrecv`` / ``device_multicast_sendrecv``.
  ``comm_split`` is ``dist.new_group`` for every color group, called by
  every rank in the same order (it is a collective).  Between
  ``group_start()`` and ``group_end()`` the device p2p operations are
  queued and go out together as one ``batch_isend_irecv`` (reference
  ``group_start``, core/comms.hpp:270).
* **Host plane** — tagged ``isend`` / ``irecv`` / ``waitall`` for control
  messages (UCX's role) over a TCP mailbox when a coordinator is set
  (:mod:`.hostcomm`), else over process-local queues.
* ``sync_stream`` returns a :class:`Status` and maps device failure →
  ABORT, which stays set (the reference's ncclCommAbort).

NCCL takes one rank per device, so several ranks on one card run over
gloo.  Where gloo does not take a CUDA tensor for an operation
(:data:`GLOO_CUDA_OPS` lists the ones it takes), that payload goes to the
host and back for the operation, and the call is counted under
``<op>_host_staged`` in :attr:`Comms.collective_calls`.  The backend is
never changed behind the caller's back.

Usage (every rank runs the same program)::

    session = CommsSession(multihost=dict(init_method="file:///tmp/w",
                                          world_size=2, rank=r)).init()
    comms = session.comms
    total = comms.allreduce(torch.ones(3, device=comms.device))
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from raft_tpu_torch import telemetry
from raft_tpu_torch.comms.comms_types import ReduceOp, Request, Status
from raft_tpu_torch.core.error import LogicError, expects
from raft_tpu_torch.testing import faults as _faults

_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.MAX: dist.ReduceOp.MAX}

#: the operations gloo runs on CUDA tensors itself (``tools/
#: gloo_cuda_probe.py`` on an H100 with PyTorch 2.11.0+cu128: all four
#: reductions, bool broadcast, all_gather and reduce_scatter_tensor gave
#: the right values; a batch_isend_irecv of CUDA tensors broke the
#: world's connection); every other operation of a gloo communicator
#: with a CUDA payload — the device p2p pair — is staged through the host
GLOO_CUDA_OPS = frozenset({"allreduce", "bcast", "allgather",
                           "reducescatter"})


class _Mailboxes:
    """Process-local tagged mailboxes for the host p2p plane."""

    def __init__(self):
        self._boxes = {}
        self._lock = threading.Lock()

    def box(self, key):
        with self._lock:
            if key not in self._boxes:
                self._boxes[key] = queue.Queue()
            return self._boxes[key]


_mailboxes = _Mailboxes()

#: per-instance ordinal labeling each communicator's collective counters in
#: the registry
_COMM_IDS = itertools.count()


class Comms:
    """``comms_t``-shaped communicator bound to a ``torch.distributed``
    process group.

    Parameters
    ----------
    group: the process group (None: the default world group).
    ranks: the global ranks of the members in rank-within-communicator
      order (None: the group's own order).
    device: where the payloads of this rank live (None: this process's
      card under NCCL, the CPU under gloo).
    groups: every group of a :meth:`comm_split`, in global ranks (None for
      an unsplit communicator).
    session_id / host_rank / host_world / coordinator: the host p2p plane
      (``host_rank`` / ``host_world`` default to this process's global
      rank and the world size).
    timeout_s: the bound on every wait of the groups made on this
      communicator's behalf (its session's process-group timeout).
    """

    def __init__(self, group=None, *, ranks: Optional[Sequence[int]] = None,
                 device=None, groups: Optional[List[List[int]]] = None,
                 session_id: str = "default",
                 host_rank: Optional[int] = None,
                 coordinator: Optional[str] = None,
                 host_world: Optional[int] = None,
                 timeout_s: float = 600.0):
        expects(dist.is_available() and dist.is_initialized(),
                "Comms needs a torch.distributed process group: "
                "CommsSession(...).init() or init_process_group first")
        self.group = group
        # a rank outside the group holds torch's NON_GROUP_MEMBER marker,
        # which has no backend of its own: it is the world's
        self.backend = dist.get_backend(
            None if group is not None
            and group == dist.GroupMember.NON_GROUP_MEMBER else group)
        if ranks is None:
            ranks = dist.get_process_group_ranks(
                group if group is not None else dist.group.WORLD)
        self.ranks = [int(r) for r in ranks]
        self._global_rank = dist.get_rank()
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if self.backend == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)
        self.groups = groups
        self.session_id = session_id
        self.timeout_s = float(timeout_s)
        self._host_rank = (host_rank if host_rank is not None
                           else self._global_rank)
        self._host_world = (host_world if host_world is not None
                            else dist.get_world_size())
        self._aborted = False
        # Per-call collective counter (the JAX package counts per trace):
        # one increment per collective this rank issues, and its payload
        # bytes under "<name>_bytes"; a payload staged through the host
        # is counted under "<name>_host_staged".
        self.collective_calls: telemetry.LegacyCounterView = (
            telemetry.legacy_counter(
                "raft_tpu_comms_collective_calls",
                "collective calls, payload bytes and host-staged calls",
                labelnames=("comm", "key"),
                fixed=(next(_COMM_IDS),)))
        # the process groups this communicator created (comm_split, a
        # serving engine's control groups), for CommsSession.destroy; and
        # the serving control groups by lanes — both shared by every
        # communicator carved from this one
        self._made: List[object] = []
        self._control: Dict[Tuple, Any] = {}
        from raft_tpu_torch.comms import hostcomm

        coordinator = coordinator or hostcomm.default_coordinator()
        self._mailbox = (hostcomm.TcpMailbox(coordinator, session_id,
                                             self._host_rank)
                         if coordinator is not None else None)
        if groups is not None:
            expects(sorted(r for g in groups for r in g)
                    == list(range(dist.get_world_size())),
                    "groups must cover every rank exactly once")
            self._equal = len({len(g) for g in groups}) == 1
        else:
            self._equal = True
        # group rank (torch's order: sorted global ranks) of each member
        # position, for the operations whose order is the group's
        order = sorted(self.ranks)
        self._pos_to_grank = [order.index(r) for r in self.ranks]
        # the open p2p group: its depth, queued operations and the
        # copies that finish its receives (group_start / group_end)
        self._group_depth = 0
        self._group_ops: List[Any] = []
        self._group_finish: List[Callable[[], None]] = []

    # -- introspection (reference core/comms.hpp:229-237) --------------------
    @property
    def is_member(self) -> bool:
        return self._global_rank in self.ranks

    def get_size(self) -> int:
        """Size of this rank's group."""
        return len(self.ranks)

    def get_group_size(self) -> int:
        """Size of this rank's group (the JAX package's per-rank value for
        unequal splits; each rank here knows its own group)."""
        return len(self.ranks)

    def is_multiprocess(self) -> bool:
        """True when the group spans more than one process — every member
        is a process of its own."""
        return len(self.ranks) > 1

    def get_rank(self) -> int:
        """This rank's position in its group (key order after a split)."""
        expects(self.is_member, "this rank is not a member of the group")
        return self.ranks.index(self._global_rank)

    def get_global_rank(self) -> int:
        return self._global_rank

    # -- split (reference comm_split, std_comms.hpp:107-171) -----------------
    def comm_split(self, colors: Sequence[int],
                   keys: Optional[Sequence[int]] = None) -> "Comms":
        """Split into sub-communicators by color; order within each by key.

        As in the JAX package, the full color and key vectors (one entry
        per global rank) are passed on every rank.  Every rank creates
        every group (``dist.new_group``, in color order) and gets back the
        communicator of its own group."""
        n = dist.get_world_size()
        colors = list(colors)
        expects(len(colors) == n, f"need one color per rank ({n})")
        keys = list(keys) if keys is not None else list(range(n))
        by_color = {}
        for r, (c, k) in enumerate(zip(colors, keys)):
            by_color.setdefault(c, []).append((k, r))
        group_list = [[r for _, r in sorted(v)]
                      for _, v in sorted(by_color.items())]
        made = [dist.new_group(ranks=g) for g in group_list]
        self._made.extend(made)
        mine = next(i for i, g in enumerate(group_list)
                    if self._global_rank in g)
        sub = Comms(made[mine], ranks=group_list[mine], device=self.device,
                    groups=group_list, session_id=self.session_id,
                    host_rank=self._host_rank, host_world=self._host_world,
                    timeout_s=self.timeout_s)
        sub._mailbox = self._mailbox  # one host-plane connection a process
        sub._made = self._made
        sub._control = self._control
        sub._split_pgs = made
        return sub

    def dup(self) -> "Comms":
        """A communicator over the same ranks on a process group of its own
        (MPI's ``Comm_dup``): its collectives never interleave with this
        one's, so another thread may issue them while this one serves (a
        sharded mutable index compacts on one).  A collective: every
        member makes it, in the same order.  It has its own
        ``collective_calls`` rows, waits as long as this one and is
        released by ``CommsSession.destroy``."""
        members = sorted(self.ranks)
        pg = dist.new_group(
            ranks=members, backend=self.backend,
            timeout=datetime.timedelta(seconds=self.timeout_s),
            use_local_synchronization=len(members) < dist.get_world_size())
        self._made.append(pg)
        twin = Comms(pg, ranks=self.ranks, device=self.device,
                     groups=self.groups, session_id=self.session_id,
                     host_rank=self._host_rank, host_world=self._host_world,
                     timeout_s=self.timeout_s)
        twin._mailbox = self._mailbox
        twin._made = self._made
        twin._control = self._control
        return twin

    def replica_split(self, n_replicas: int) -> "ReplicaLayout":
        """Carve the world into a 2D (shard × replica) layout:
        *n_replicas* equal groups of contiguous ranks, each a full shard
        axis for one model copy.  ``split`` is the grouped communicator
        (``comm_split(colors=[rank // group_size])``); ``groups[r]`` is an
        unsplit communicator over replica r's ranks, with its own
        ``collective_calls`` rows, on the same process groups.  A rank
        runs collectives only on its own replica's entry."""
        expects(self.groups is None,
                "replica_split: already-split communicators cannot be "
                "re-split (carve the world communicator)")
        n_replicas = int(n_replicas)
        world = dist.get_world_size()
        expects(n_replicas >= 1, "replica_split: n_replicas must be >= 1")
        expects(world % n_replicas == 0,
                f"replica_split: world {world} not divisible by "
                f"n_replicas {n_replicas} (replica groups must be "
                "congruent — each holds a full index copy)")
        gsz = world // n_replicas
        split = self.comm_split([r // gsz for r in range(world)])
        groups = []
        for r, pg in enumerate(split._split_pgs):
            g = Comms(pg, ranks=list(range(r * gsz, (r + 1) * gsz)),
                      device=self.device,
                      session_id=f"{self.session_id}/replica{r}",
                      host_rank=self._host_rank,
                      host_world=self._host_world, timeout_s=self.timeout_s)
            g._mailbox = self._mailbox
            g._made = self._made
            g._control = self._control
            groups.append(g)
        return ReplicaLayout(parent=self, split=split, groups=tuple(groups),
                             n_replicas=n_replicas, group_size=gsz)

    # -- device collectives --------------------------------------------------
    def _count_collective(self, name: str, x: torch.Tensor) -> None:
        """Count one collective call and its payload bytes per rank."""
        # fault-injection site: a chosen collective (op=<name>) or rank
        # can be made to fail before anything is sent
        _faults.check("comms", op=name, rank=self._host_rank)
        expects(self.is_member,
                f"{name}: this rank is not a member of the communicator")
        self.collective_calls.inc(name)
        self.collective_calls.inc(f"{name}_bytes",
                                  x.element_size() * x.numel())

    def _payload(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=self.device)
        return x

    def _wire(self, name: str, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Callable[[torch.Tensor],
                                                torch.Tensor]]:
        """A private, contiguous copy of *x* to hand to the backend, and
        the function that turns the backend's result back into *x*'s
        device and type.  Bools travel as uint8; a CUDA payload of a gloo
        communicator travels through the host unless gloo takes it for
        *name* (counted under ``<name>_host_staged``)."""
        dev, dt = x.device, x.dtype
        staged = (self.backend == "gloo" and dev.type == "cuda"
                  and name not in GLOO_CUDA_OPS)
        if staged:
            self.collective_calls.inc(f"{name}_host_staged")
            w = x.cpu()
        else:
            w = x.clone()
        if dt == torch.bool:
            w = w.to(torch.uint8)
        w = w.contiguous()

        def back(r: torch.Tensor) -> torch.Tensor:
            if staged:
                r = r.to(dev)
            return r.to(torch.bool) if dt == torch.bool else r

        return w, back

    def allreduce(self, x, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        """reference comms_t::allreduce (core/comms.hpp:322)."""
        x = self._payload(x)
        self._count_collective("allreduce", x)
        w, back = self._wire("allreduce", x)
        dist.all_reduce(w, op=_TORCH_OPS[op], group=self.group)
        return back(w)

    def bcast(self, x, root: int = 0) -> torch.Tensor:
        """reference comms_t::bcast (core/comms.hpp:340,358): every rank
        returns its group root's value (*root* is a rank-within-group)."""
        x = self._payload(x)
        self._count_collective("bcast", x)
        w, back = self._wire("bcast", x)
        dist.broadcast(w, src=self.ranks[root], group=self.group)
        return back(w)

    def reduce(self, x, root: int = 0, op: ReduceOp = ReduceOp.SUM):
        """reference comms_t::reduce (core/comms.hpp:376): non-roots get the
        reduction too (the reference leaves their recvbuff undefined)."""
        return self.allreduce(x, op)

    def _require_equal_groups(self, name: str, why: str) -> None:
        if not self._equal:
            raise LogicError(f"{name} requires equal-sized groups: {why}")

    def allgather(self, x) -> torch.Tensor:
        """reference comms_t::allgather (core/comms.hpp:395) — stacked
        along a new leading axis of size group_size, group members in key
        order.  Refused on a split with unequal groups, as in the JAX
        package (its output shape would differ between groups)."""
        x = self._payload(x)
        self._count_collective("allgather", x)
        self._require_equal_groups(
            "allgather", "the output shape is group-size-dependent")
        w, back = self._wire("allgather", x)
        parts = [torch.empty_like(w) for _ in range(self.get_size())]
        dist.all_gather(parts, w, group=self.group)
        return back(torch.stack([parts[g] for g in self._pos_to_grank]))

    def allgatherv(self, x, counts: Sequence[int],
                   pad_to: Optional[int] = None):
        """reference comms_t::allgatherv (core/comms.hpp:413): each rank's
        rows padded to max(counts) (or *pad_to*); returns (gathered
        [size, pad, ...], counts) — callers slice with the counts, the
        information NCCL's displacement vector carries."""
        counts = list(counts)
        expects(len(counts) == self.get_size(), "one count per rank")
        x = self._payload(x)
        pad = pad_to if pad_to is not None else max(counts)
        expects(x.shape[0] <= pad, "shard larger than pad_to")
        if x.shape[0] < pad:
            x = torch.cat([x, x.new_zeros((pad - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        return self.allgather(x), counts

    def gather(self, x, root: int = 0) -> torch.Tensor:
        """reference comms_t::gather (core/comms.hpp:437): every rank gets
        the gathered value, as in the JAX package."""
        return self.allgather(x)

    def gatherv(self, x, counts: Sequence[int], root: int = 0):
        return self.allgatherv(x, counts)

    def reducescatter(self, x, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        """reference comms_t::reducescatter (core/comms.hpp:481): reduce,
        then rank p (key order) keeps chunk p; x's leading dim must be
        divisible by the group size.  Refused on unequal groups."""
        x = self._payload(x)
        self._count_collective("reducescatter", x)
        self._require_equal_groups("reducescatter",
                                   "chunk shapes are group-size-dependent")
        size = self.get_size()
        expects(x.shape[0] % size == 0,
                "reducescatter requires leading dim divisible by group size")
        w, back = self._wire("reducescatter", x)
        chunks = w.reshape((size, -1) + tuple(w.shape[1:]))
        # torch hands chunk j to group rank j: put chunk p where the
        # member at key position p sits
        order = [0] * size
        for pos, g in enumerate(self._pos_to_grank):
            order[g] = pos
        w = chunks[order].reshape(w.shape).contiguous()
        out = w.new_empty((x.shape[0] // size,) + tuple(w.shape[1:]))
        dist.reduce_scatter_tensor(out, w, op=_TORCH_OPS[op],
                                   group=self.group)
        return back(out)

    # -- device p2p (reference core/comms.hpp:498-648) -----------------------
    class _Group:
        """``with comms.group_start(): ...`` closes the group on exit."""

        def __init__(self, comms: "Comms"):
            self._comms = comms

        def __enter__(self):
            return self._comms

        def __exit__(self, exc_type, exc, tb):
            self._comms.group_end()
            return False

    def group_start(self) -> "Comms._Group":
        """Open a p2p group (reference ``comms_t::group_start``,
        core/comms.hpp:270; groups nest).  Until the matching
        :meth:`group_end`, ``device_sendrecv`` queues its operations and
        returns its output unfilled; the output holds the received value
        once the group ends.  Usable as a context manager too."""
        self._group_depth += 1
        return Comms._Group(self)

    def group_end(self) -> None:
        """Close the innermost group; the outermost sends every queued
        operation as one ``batch_isend_irecv`` (under gloo, of the host
        copies of CUDA payloads) and fills the group's outputs."""
        expects(self._group_depth > 0, "group_end without group_start")
        self._group_depth -= 1
        if self._group_depth:
            return
        ops, finish = self._group_ops, self._group_finish
        self._group_ops, self._group_finish = [], []
        self._run_p2p(ops, finish)

    @staticmethod
    def _run_p2p(ops, finish) -> None:
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for f in finish:
            f()

    def device_sendrecv(self, x, perm: Sequence[Tuple[int, int]]
                        ) -> torch.Tensor:
        """reference comms_t::device_sendrecv (core/comms.hpp:602): exchange
        with explicit (src, dst) pairs of global ranks, each rank at most
        once a source and once a destination.  Ranks no pair sends to
        receive zeros; a pair (r, r) is a local copy (torch.distributed
        has no send to self).  Inside a group (:meth:`group_start`) the
        operations wait for the group's end."""
        x = self._payload(x)
        me = self._global_rank
        out = torch.zeros_like(x)
        ops = []
        finish = []
        w = back = None
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(x)
                continue
            if src == me or dst == me:
                if w is None:
                    w, back = self._wire("device_sendrecv", x)
            if src == me:
                ops.append(dist.P2POp(dist.isend, w, dst))
            elif dst == me:
                buf = torch.zeros_like(w)
                ops.append(dist.P2POp(dist.irecv, buf, src))
                finish.append(lambda buf=buf: out.copy_(back(buf)))
        if self._group_depth:
            self._group_ops += ops
            self._group_finish += finish
        else:
            self._run_p2p(ops, finish)
        return out

    def device_multicast_sendrecv(self, x, dsts: Sequence[int],
                                  srcs: Sequence[int]) -> torch.Tensor:
        """reference comms_t::device_multicast_sendrecv (core/comms.hpp:628):
        the values of *srcs* stacked in list order.  A rotation ring over
        the participant set (srcs ∪ dsts): |P| − 1 rounds of |x| bytes per
        link, as in the JAX package; a set of one is a local copy.  Ranks
        outside the set receive zeros in every slot.  Ranks are global."""
        expects(not self._group_depth,
                "device_multicast_sendrecv runs rounds that each need the "
                "last one's result: call it outside group_start/group_end")
        x = self._payload(x)
        participants = sorted(set(dsts) | set(srcs))
        p = len(participants)
        pos = {r: i for i, r in enumerate(participants)}
        me = self._global_rank
        if me not in pos:
            return torch.zeros((len(srcs),) + tuple(x.shape), dtype=x.dtype,
                               device=x.device)
        perm = [(participants[i], participants[(i + 1) % p])
                for i in range(p)]
        parts = [x]
        y = x
        for _ in range(p - 1):
            y = self.device_sendrecv(y, perm)
            parts.append(y)
        # parts[t] = the value of participant (my_pos - t) % p
        return torch.stack([parts[(pos[me] - pos[s]) % p] for s in srcs])

    def barrier(self) -> None:
        """reference comms_t::barrier (core/comms.hpp:255): a rendezvous of
        the group, then a drain of this rank's device."""
        try:
            dist.barrier(group=self.group)
        except (RuntimeError, TimeoutError) as e:
            self._aborted = True  # the clique is broken; poison it
            raise LogicError(f"comms barrier failed: {e}") from e
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host p2p plane (UCX's role; reference isend/irecv/waitall) ----------
    # Control-plane traffic only — besides library algorithms, this is the
    # plane ``raft_tpu_torch.telemetry.gather`` rides for the fleet
    # snapshot exchange (tag 0x7E1E, reserved).
    def isend(self, obj, dst: int, tag: int = 0) -> Request:
        # host-plane fault site: a chosen rank's sends can be made to fail,
        # the dead-host case telemetry.gather degrades around
        _faults.check("comms", op="isend", rank=self._host_rank)
        if self._mailbox is not None:
            try:
                self._mailbox.put(dst, tag, obj)
            except (TimeoutError, ConnectionError, OSError) as e:
                self._aborted = True  # host plane broken → poison the clique
                raise LogicError(
                    f"comms isend to rank {dst} tag {tag} failed: {e}") from e
        else:
            _mailboxes.box((self.session_id, self._host_rank, dst,
                            tag)).put(obj)
        return Request("send", dst, tag, obj, done=True)

    def irecv(self, src: int, tag: int = 0) -> Request:
        return Request("recv", src, tag)

    def waitall(self, requests: Sequence[Request], timeout: float = 60.0):
        for r in requests:
            if r.kind == "recv" and not r.done:
                _faults.check("comms", op="waitall", rank=self._host_rank)
                try:
                    if self._mailbox is not None:
                        r.payload = self._mailbox.get(r.peer, r.tag, timeout)
                    else:
                        r.payload = _mailboxes.box(
                            (self.session_id, r.peer, self._host_rank,
                             r.tag)).get(timeout=timeout)
                except (queue.Empty, TimeoutError, ConnectionError,
                        OSError) as e:
                    self._aborted = True
                    detail = f": {e}" if str(e) else ""
                    raise LogicError(
                        f"comms waitall: failed after {timeout}s waiting for "
                        f"recv from rank {r.peer} tag {r.tag} "
                        f"(session {self.session_id}){detail}") from None
                r.done = True
        return [r.payload for r in requests if r.kind == "recv"]

    # -- sync (reference sync_stream) ----------------------------------------
    def sync_stream(self, *tensors, stream=None) -> Status:
        """Wait for this rank's outstanding device work; ABORT once the
        communicator is aborted or the device fails, and ever after
        (reference comms_t::sync_stream → status_t)."""
        if self._aborted:
            return Status.ABORT
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if stream is not None:
                stream.synchronize()
            return Status.SUCCESS
        except KeyboardInterrupt:
            raise
        except Exception:  # device failure → abort the clique
            self._aborted = True
            return Status.ABORT

    def abort(self) -> None:
        """reference ncclCommAbort path."""
        self._aborted = True


@dataclasses.dataclass(frozen=True)
class ReplicaLayout:
    """The two views of one 2D (shard × replica) carve — produced by
    :meth:`Comms.replica_split`: ``split`` is the grouped communicator,
    ``groups`` the per-replica unsplit communicators."""

    parent: Comms
    split: Comms
    groups: Tuple[Comms, ...]
    n_replicas: int
    group_size: int

    def __iter__(self):
        return iter(self.groups)


def as_comms(comms_or_handle) -> Comms:
    """Accept a :class:`Comms` or a Handle carrying one (reference
    convention: MNMG entry points take handle_t and call
    ``handle.get_comms()``)."""
    if hasattr(comms_or_handle, "get_comms"):
        return comms_or_handle.get_comms()
    return comms_or_handle


def build_comms(group=None, *, device=None, session_id: str = "default",
                coordinator: Optional[str] = None,
                host_rank: Optional[int] = None,
                host_world: Optional[int] = None,
                timeout_s: float = 600.0) -> Comms:
    """The world communicator of an initialized process group (reference
    ``build_comms_nccl_only``, comms/std_comms.hpp:42).  *coordinator*
    ("host:port" of a :class:`~raft_tpu_torch.comms.hostcomm.MailboxServer`)
    enables the cross-process host p2p plane (``build_comms_nccl_ucx``'s
    role).  *timeout_s* is the process group's timeout."""
    return Comms(group, device=device, session_id=session_id,
                 coordinator=coordinator, host_rank=host_rank,
                 host_world=host_world, timeout_s=timeout_s)
