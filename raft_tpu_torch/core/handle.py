"""Device resolution and the resource handle (port of
``raft_tpu/core/handle.py`` ``Stream`` / ``Handle``; reference
``raft::handle_t``, core/handle.hpp:54,88-130,190,231-262).

A :class:`Handle` is a device, a main stream, an optional pool of streams
and the communicator slots.  On a CUDA device a :class:`Stream` wraps a
``torch.cuda.Stream``; on the CPU it is a lane with nothing to order (host
work is synchronous), so the same code runs on both.

Where the JAX package's handle only tracks arrays (one TPU core runs one
program at a time), here the handle decides which CUDA stream runs the
kernels: every kernel launches on ``torch.cuda.current_stream()``, and a
public entry point called with ``handle=`` issues its work inside the
handle's main stream (:func:`auto_sync_handle`), while ``ivf_pq.search``
spreads its query batches over the pool.

Lifetimes across streams: :meth:`Stream.record` holds strong references
to the tensors the recorded work reads and writes until the lane observes
its mark completed (:meth:`Stream.query`, :meth:`Stream.record`) or waits
for it (:meth:`Stream.synchronize`).  A caller that drops an input before
``handle.sync()`` therefore cannot hand its block back to the caching
allocator while the handle's stream still reads it.

The JAX handle's ``mesh`` / ``set_mesh`` are dropped: each rank of the
port is a process of its own, and the handle's comms slot carries the
world.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from raft_tpu_torch.core import interruptible
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


def tensors_of(tree: Any) -> List[torch.Tensor]:
    """The tensors in *tree*: nested tuples (named ones too), lists, dicts
    and dataclasses (an index, a CSR matrix)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in tensors_of(item)]
    if isinstance(tree, dict):
        return [t for item in tree.values() for t in tensors_of(item)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors_of(getattr(tree, f.name, None))]
    return []


class Stream:
    """One dispatch lane.  ``context()`` makes it the current stream for
    the work issued inside; ``record()`` marks the end of that work and
    keeps what it reads and writes alive until the mark completes;
    ``query()`` and ``synchronize()`` look at, or wait for, every mark."""

    def __init__(self, device: torch.device, name: str = "main"):
        self.name = name
        self.device = device
        self._stream = (torch.cuda.Stream(device=device)
                        if device.type == "cuda" else None)
        # (mark, the tensors it keeps alive), oldest first
        self._inflight: List[Tuple[Any, Tuple[torch.Tensor, ...]]] = []
        self._lock = threading.Lock()

    def _mark(self, timing: bool = False):
        """A new event at the lane's current end (None on the CPU)."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=timing)
        ev.record(self._stream)
        return ev

    def _prune_locked(self) -> None:
        self._inflight = [e for e in self._inflight if not e[0].query()]

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

    def record(self, *trees: Any, timing: bool = False):
        """Mark the end of the work issued so far and keep the tensors of
        *trees* alive until the mark completes; returns the mark (None on
        the CPU, where work is already done).  A *timing* mark can be read
        with ``elapsed_time`` against another timing mark.  Completed
        marks are dropped on every record, so the held references stay
        bounded by the work in flight."""
        ev = self._mark(timing)
        if ev is None:
            return None
        held = tuple(t for tree in trees for t in tensors_of(tree))
        with self._lock:
            self._prune_locked()
            self._inflight.append((ev, held))
        return ev

    def query(self) -> bool:
        """True when every recorded mark has completed (``cudaStreamQuery``
        of the recorded work; never blocks).  Completed marks release
        their tensors."""
        with self._lock:
            self._prune_locked()
            return not self._inflight

    def synchronize(self) -> None:
        """Wait, interruptibly, for the work issued on this lane so far
        (reference ``handle.sync_stream`` → ``interruptible::synchronize``):
        a cancel from another thread raises ``InterruptedError_``, and the
        marks that had not completed stay owned, so a second call still
        waits for them."""
        ev = self._mark()
        with self._lock:
            pending = self._inflight
            if ev is not None:
                pending = pending + [(ev, ())]
            self._inflight = []
        try:
            interruptible.synchronize(*[e for e, _ in pending])
        except BaseException:
            with self._lock:
                self._inflight = [e for e in pending
                                  if not e[0].query()] + self._inflight
            raise

    def join(self) -> None:
        """Make the current stream wait for the work issued on this lane
        so far, without blocking the host."""
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def stage(self, tree: Any, device=None) -> Any:
        """Copy the host tensors of *tree* (a tensor, or tuples, lists and
        dicts of them) to *device* (default: the lane's) on this lane:
        from pinned memory, ``non_blocking``, recorded on the lane so the
        sources and copies stay alive until the copy is done.  The lane
        does not wait for the current stream (a host source needs no
        device work first): a consumer calls :meth:`join` before it reads
        the copies."""
        device = torch.device(device) if device is not None else self.device

        def copy(x):
            if isinstance(x, (list, tuple)):
                return type(x)(copy(v) for v in x)
            if isinstance(x, dict):
                return {k: copy(v) for k, v in x.items()}
            x = torch.as_tensor(x)
            if self._stream is None or x.device.type != "cpu":
                return x.to(device)
            src = x if x.is_pinned() else x.pin_memory()
            return src.to(device, non_blocking=True)

        if self._stream is None:
            return copy(tree)
        with torch.cuda.stream(self._stream):
            staged = copy(tree)
        self.record(tree, staged)
        return staged


class Handle:
    """Device, main stream, stream pool (pylibraft
    ``Handle(n_streams=...)``) and the communicator slots of the
    reference's ``comms_t`` (handle.hpp:231-262) that MNMG entry points
    read."""

    def __init__(self, device=None, n_streams: int = 0):
        expects(n_streams >= 0, "n_streams must be >= 0")
        self.device = resolve_device(device)
        self._stream = Stream(self.device, "main")
        self._pool: List[Stream] = [Stream(self.device, f"pool{i}")
                                    for i in range(n_streams)]
        self._comms = None
        self._subcomms: Dict[str, object] = {}
        self._resources: Dict[str, Any] = {}
        self._resource_lock = threading.Lock()

    def get_device(self) -> torch.device:
        return self.device

    # -- streams (reference core/handle.hpp:70,88-130,190) -------------------
    def get_stream(self) -> Stream:
        """The main stream: the work of an entry point called with this
        handle runs here."""
        return self._stream

    @property
    def stream_pool_size(self) -> int:
        return len(self._pool)

    def is_stream_pool_initialized(self) -> bool:
        return bool(self._pool)

    def get_stream_from_stream_pool(self, idx: Optional[int] = None
                                    ) -> Stream:
        """Pool stream ``idx`` (mod pool size; default 0)."""
        expects(self._pool, "ERROR: rmm stream pool does not exist")
        return self._pool[(idx or 0) % len(self._pool)]

    def get_next_usable_stream(self, idx: Optional[int] = None) -> Stream:
        """Pool stream ``idx`` (mod pool size) if a pool exists, else the
        main stream (reference handle.hpp:117-130)."""
        if self._pool:
            return self.get_stream_from_stream_pool(idx)
        return self._stream

    def sync_stream(self, stream: Optional[Stream] = None) -> None:
        """Wait for the work issued on *stream* (default: the main
        stream)."""
        (stream or self._stream).synchronize()

    def sync_stream_pool(self) -> None:
        for s in self._pool:
            s.synchronize()

    def wait_stream_pool_on_stream(self) -> None:
        """Order the pool's later work after the main stream's work so far
        (reference handle.hpp:190); the host does not wait."""
        main = self._stream._stream
        if main is None:
            return
        for s in self._pool:
            s._stream.wait_stream(main)

    def sync(self) -> None:
        """Wait for the handle's own streams, the main one and the pool's
        (pylibraft ``Handle.sync()``) — never for other streams of the
        device.  Interruptible, as :meth:`Stream.synchronize`."""
        self.sync_stream()
        self.sync_stream_pool()

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

    # -- lazily made per-handle resources ------------------------------------
    def get_resource(self, key: str, factory: Callable[[], Any]) -> Any:
        """The resource under *key*, made by *factory* on first use (the
        role of the reference's lazily made cuBLAS / cuSOLVER handles)."""
        with self._resource_lock:
            if key not in self._resources:
                self._resources[key] = factory()
            return self._resources[key]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Handle(device={self.device}, n_pool_streams="
                f"{len(self._pool)}, comms="
                f"{'yes' if self._comms else 'no'})")


def device_of(handle: Optional[Handle], device=None) -> torch.device:
    """Where an entry point's array inputs go: the handle's device, else
    *device* (``None``: the card)."""
    return handle.device if handle is not None else resolve_device(device)


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


#: depth of :func:`auto_sync_handle` calls on this thread: a call nested
#: in another (``fit_predict``'s ``fit``) leaves the wait to the outermost
_nesting = threading.local()


def _wait_for_current(out: Any) -> None:
    """Wait, interruptibly, for the work queued on the current stream of
    each CUDA device *out*'s tensors lie on — the call's own work, on the
    caller's stream."""
    devices = {t.device for t in tensors_of(out) if t.device.type == "cuda"}
    if not devices:
        return      # host work is done when it returns
    marks = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        marks.append(ev)
    interruptible.synchronize(*marks)


def auto_sync_handle(fn):
    """Decorator of a function with a ``handle`` parameter (pylibraft's
    ``auto_sync_handle``, used at distance/pairwise_distance.pyx:94).

    With a handle the caller supplied, the work is issued on the handle's
    main stream, its outputs and tensor inputs are recorded there (kept
    alive until the handle observes the work done), and the call returns
    without waiting: the caller calls ``handle.sync()`` before it reads
    the outputs on another stream or the host.  Without one, the work
    runs on the current stream and the call waits, interruptibly, for
    that work only before it returns (not for the device, not for other
    streams); a call nested inside another decorated call leaves that
    wait to the outermost.  ``fn.__wrapped__`` is the body, which neither
    switches streams nor waits (the serving engine's lanes call it)."""
    sig = inspect.signature(fn)
    if "handle" not in sig.parameters:
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind_partial(*args, **kwargs)
        handle = bound.arguments.get("handle")
        depth = getattr(_nesting, "depth", 0)
        if handle is None and depth:
            return fn(*args, **kwargs)
        _nesting.depth = depth + 1
        try:
            if handle is None:
                out = fn(*args, **kwargs)
                _wait_for_current(out)
                return out
            stream = handle.get_stream()
            with stream.context():
                out = fn(*args, **kwargs)
            stream.record(out, tuple(bound.arguments.values()))
            return out
        finally:
            _nesting.depth = depth

    return wrapper
