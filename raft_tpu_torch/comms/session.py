"""Session-scoped MNMG bootstrap — the raft-dask equivalent (port of
``raft_tpu/comms/session.py``; reference
python/raft-dask/raft_dask/common/comms.py:37-245 the ``Comms`` session
class, :247-326 per-worker state and ``local_handle``).

:class:`CommsSession` creates the ``torch.distributed`` process group —
NCCL when the session's device is the card (the default), gloo when
``device="cpu"`` is asked for — builds the world :class:`Comms` and injects
it into a session :class:`~raft_tpu_torch.core.handle.Handle` that callers
fetch with ``local_handle(session_id)``.  One process is one rank: every
rank of a world runs its own session with ``multihost=`` carrying the
rendezvous (``init_method``, ``world_size``, ``rank``).  Without
``multihost`` the session is a world of one, rendezvoused through a
``FileStore`` in a fresh temporary directory.
"""

from __future__ import annotations

import datetime
import shutil
import tempfile
import threading
import uuid
from typing import Dict, Optional

import torch
import torch.distributed as dist

from raft_tpu_torch.comms.comms import Comms, build_comms
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import Handle, resolve_device

_state_lock = threading.Lock()
_session_state: Dict[str, dict] = {}

#: the keys ``multihost=`` takes
_MULTIHOST_KEYS = frozenset({"init_method", "world_size", "rank",
                             "timeout_s"})


def get_comms_state(session_id: str) -> dict:
    """Per-process session state dict (reference
    ``get_raft_comm_state(sessionId)``, comms.py:247)."""
    with _state_lock:
        return _session_state.setdefault(session_id, {})


def local_handle(session_id: str) -> Optional[Handle]:
    """The session's injected handle (reference ``local_handle``,
    comms.py:247)."""
    return get_comms_state(session_id).get("handle")


class CommsSession:
    """Session bootstrap (reference raft-dask ``Comms`` class, comms.py:37).

    Parameters
    ----------
    n_devices: devices this process drives — None or 1 (one process per
      rank; start one process per device for more).
    multihost: the rendezvous of a world of several processes:
      ``init_method`` (``file://`` or ``tcp://host:port``), ``world_size``,
      ``rank`` and optionally ``timeout_s`` (default 600).
    session_id: the same on every rank when the host p2p plane (mailbox)
      is in use.  Default: a fresh uuid.
    device: this rank's device (None: the card, raising without one).
    backend: ``"nccl"`` (the default on the card) or ``"gloo"`` (the
      default on the CPU; on the card only when asked for, e.g. for
      several ranks on one card, which NCCL refuses).
    coordinator: "host:port" of a ``MailboxServer`` for the host plane
      (default ``RAFT_TPU_COORD_ADDR``).

    The JAX session's ``axis_name`` names a mesh axis, which the port has
    no counterpart of.
    """

    def __init__(self, n_devices: Optional[int] = None,
                 multihost: Optional[dict] = None,
                 session_id: Optional[str] = None, *, device=None,
                 backend: Optional[str] = None,
                 coordinator: Optional[str] = None):
        self.session_id = session_id or uuid.uuid4().hex  # reference sessionId
        self._n_devices = n_devices
        self._multihost = dict(multihost or {})
        self._device = device
        self._backend = backend
        self._coordinator = coordinator
        self._owns_world = False
        self._store_dir: Optional[str] = None
        self.comms: Optional[Comms] = None
        self.initialized = False

    def init(self) -> "CommsSession":
        """Create the process group (unless one exists), the world
        communicator and the session handle (reference ``Comms.init``,
        comms.py:171-218)."""
        device = resolve_device(self._device)
        expects(self._n_devices in (None, 1),
                f"n_devices={self._n_devices}: the port runs one process "
                "per rank, each rank one device — start one process per "
                "device, each with multihost=dict(init_method=..., "
                "world_size=..., rank=...)")
        unknown = set(self._multihost) - _MULTIHOST_KEYS
        expects(not unknown, f"multihost: unknown keys {sorted(unknown)}")
        backend = self._backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
        expects(backend in ("nccl", "gloo"), f"unknown backend {backend!r}")
        expects(backend == "gloo" or device.type == "cuda",
                "backend='nccl' needs a CUDA device")
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(device)
        timeout_s = float(self._multihost.get("timeout_s", 600))
        if dist.is_initialized():
            expects(not self._multihost,
                    "multihost= given, but this process already has a "
                    "process group")
            expects(dist.get_backend() == backend,
                    f"the existing process group is "
                    f"{dist.get_backend()!r}, not {backend!r}")
        else:
            mh = self._multihost
            if mh:
                init_method = mh["init_method"]
                world, rank = int(mh["world_size"]), int(mh["rank"])
            else:
                self._store_dir = tempfile.mkdtemp(prefix="raft_comms_")
                init_method = f"file://{self._store_dir}/store"
                world, rank = 1, 0
            dist.init_process_group(
                backend, init_method=init_method, world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
            self._owns_world = True
        self.comms = build_comms(device=device, session_id=self.session_id,
                                 coordinator=self._coordinator,
                                 timeout_s=timeout_s)
        handle = Handle(device=device)
        handle.set_comms(self.comms)  # reference handle.set_comms
        st = get_comms_state(self.session_id)
        st["handle"] = handle
        st["comms"] = self.comms
        st["nranks"] = dist.get_world_size()
        self.initialized = True
        return self

    def worker_info(self) -> dict:
        """reference ``Comms.worker_info`` (comms.py:154): the rank map,
        {rank: {"rank", "device"}} — a collective every rank calls."""
        expects(self.initialized, "session not initialized")
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, str(self.comms.device))
        return {r: {"rank": r, "device": d} for r, d in enumerate(got)}

    def destroy(self) -> None:
        """Tear down the session (reference ``Comms.destroy``, comms.py:220):
        the process groups it made — the world, if this session created
        it, else the groups its communicator's splits and serving engines
        created."""
        with _state_lock:
            _session_state.pop(self.session_id, None)
        if self.comms is not None:
            if self._owns_world:
                dist.destroy_process_group()
            else:
                for pg in self.comms._made:
                    if pg != dist.GroupMember.NON_GROUP_MEMBER:
                        dist.destroy_process_group(pg)
            self.comms._made.clear()
            self.comms._control.clear()
            if self.comms._mailbox is not None:
                self.comms._mailbox.close()
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None
        self._owns_world = False
        self.comms = None
        self.initialized = False

    def __enter__(self):
        return self.init()

    def __exit__(self, *exc):
        self.destroy()
        return False
