"""Device resolution and the resource handle (port of
``raft_tpu/core/handle.py`` ``Stream`` / ``Handle``; reference
``raft::handle_t``, core/handle.hpp:54,88-130,231-262).

A :class:`Handle` is a device plus a pool of streams.  On a CUDA device a
:class:`Stream` wraps a ``torch.cuda.Stream``; on the CPU it is a lane
with nothing to order (host work is synchronous), so the same serving code
runs on both.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
from typing import Dict, List, Optional

import torch

from raft_tpu_torch.core.error import expects


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``torch.device("cuda")``.  Raises when no
    card is present and none was asked for — the port never carries on
    quietly on the CPU; pass ``device="cpu"`` for the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "raft_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the host")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("raft_tpu_torch: device='cuda' asked for, but no "
                           "CUDA device is available")
    return device


class Stream:
    """One dispatch lane.  ``context()`` makes it the current stream for
    the work issued inside; ``record()`` marks the end of that work and
    ``synchronize()`` waits for the last recorded mark."""

    def __init__(self, device: torch.device, name: str = "main"):
        self.name = name
        self.device = device
        self._stream = (torch.cuda.Stream(device=device)
                        if device.type == "cuda" else None)
        self._event: Optional[torch.cuda.Event] = None

    @contextlib.contextmanager
    def context(self):
        """Issue the enclosed work on this lane.  The lane first waits for
        the work already queued on the current stream (the index and the
        inputs were made there)."""
        if self._stream is None:
            yield self
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            yield self

    def record(self, timing: bool = False) -> Optional[torch.cuda.Event]:
        """Mark the end of the work issued so far; returns the mark (None
        on the CPU, where work is already done).  A *timing* mark can be
        read with ``elapsed_time`` against another timing mark."""
        if self._stream is None:
            return None
        self._event = torch.cuda.Event(enable_timing=timing)
        self._event.record(self._stream)
        return self._event

    def synchronize(self) -> None:
        if self._event is not None:
            self._event.synchronize()
            self._event = None


class Handle:
    """Device plus stream pool (pylibraft ``Handle(n_streams=...)``), and
    the communicator slots of the reference's ``comms_t`` (handle.hpp:
    231-262) that MNMG entry points read."""

    def __init__(self, device=None, n_streams: int = 0):
        expects(n_streams >= 0, "n_streams must be >= 0")
        self.device = resolve_device(device)
        self._stream = Stream(self.device, "main")
        self._pool: List[Stream] = [Stream(self.device, f"pool{i}")
                                    for i in range(n_streams)]
        self._comms = None
        self._subcomms: Dict[str, object] = {}

    def get_next_usable_stream(self, idx: Optional[int] = None) -> Stream:
        """Pool stream ``idx`` (mod pool size) if a pool exists, else the
        main stream (reference handle.hpp:117-130)."""
        if self._pool:
            return self._pool[(idx or 0) % len(self._pool)]
        return self._stream

    def sync(self) -> None:
        for s in [self._stream] + self._pool:
            s.synchronize()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- comms (reference core/handle.hpp:231-262) ---------------------------
    def set_comms(self, comms) -> None:
        self._comms = comms

    def get_comms(self):
        expects(self._comms is not None,
                "ERROR: Communicator was not initialized on the handle")
        return self._comms

    def comms_initialized(self) -> bool:
        return self._comms is not None

    def set_subcomm(self, key: str, comms) -> None:
        self._subcomms[key] = comms

    def get_subcomm(self, key: str):
        expects(key in self._subcomms,
                f"ERROR: Subcommunicator {key} was never initialized")
        return self._subcomms[key]


@contextlib.contextmanager
def issued_on(handle: Optional[Handle]):
    """Issue the enclosed work on *handle*'s next usable stream and mark
    its end there; yields the handle's device (None without a handle, when
    the work goes to the current stream).  As in the reference's
    handle-first calling convention, a caller that passes a handle syncs
    it (``handle.sync()``) before it reads the outputs elsewhere."""
    if handle is None:
        yield None
        return
    stream = handle.get_next_usable_stream()
    with stream.context():
        yield handle.device
    stream.record()


#: the newer reference's name of the handle (``device_resources``)
DeviceResources = Handle

_default_handle: Optional[Handle] = None
_default_lock = threading.Lock()


def default_handle() -> Handle:
    """The process-wide default handle on the card, made on first use."""
    global _default_handle
    with _default_lock:
        if _default_handle is None:
            _default_handle = Handle()
        return _default_handle


def auto_sync_handle(fn):
    """Decorator of a function with a ``handle`` parameter (pylibraft's
    ``auto_sync_handle``, used at distance/pairwise_distance.pyx:94): a
    call without a handle runs on :func:`default_handle` and waits for it
    before returning; a caller that passes its own handle syncs it
    itself (``handle.sync()``)."""
    sig = inspect.signature(fn)
    if "handle" not in sig.parameters:
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind_partial(*args, **kwargs)
        supplied = bound.arguments.get("handle")
        h = supplied if supplied is not None else default_handle()
        bound.arguments["handle"] = h
        out = fn(*bound.args, **bound.kwargs)
        if supplied is None:
            h.sync()
        return out

    return wrapper
