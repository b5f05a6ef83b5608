"""Cooperative cancellation of host threads that wait on the card (port of
``raft_tpu/core/interruptible.py``; reference core/interruptible.hpp:
34-270).

Each thread has a token in a registry.  :func:`synchronize` polls CUDA
events (``torch.cuda.Event.query``, the reference's ``cudaStreamQuery``
poll at interruptible.hpp:256) with exponential back-off and yields
between polls, so another thread's :func:`cancel` ends the wait with
:class:`InterruptedError_` within one poll interval.  ``torch.cuda.
synchronize`` and ``Event.synchronize`` cannot be interrupted; this
wait can.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from raft_tpu_torch.core.error import InterruptedError_

_registry_lock = threading.Lock()
_registry: Dict[int, "Token"] = {}


class Token:
    """The cancellation token of one thread (reference
    interruptible.hpp:205 ``get_token``)."""

    __slots__ = ("_flag",)

    def __init__(self):
        self._flag = threading.Event()

    def cancel(self) -> None:
        """Ask the thread to stop (reference interruptible.hpp:126)."""
        self._flag.set()

    def cancelled(self) -> bool:
        return self._flag.is_set()

    def yield_(self) -> None:
        """Raise if cancelled, clearing the flag (reference ``yield``,
        interruptible.hpp:110)."""
        if self._flag.is_set():
            self._flag.clear()
            raise InterruptedError_("interruptible::yield: cancelled")

    def yield_no_throw(self) -> bool:
        if self._flag.is_set():
            self._flag.clear()
            return True
        return False


def get_token(thread_id: Optional[int] = None) -> Token:
    """The token of *thread_id* (default: the calling thread), made on
    first use (reference interruptible.hpp:205,214)."""
    tid = threading.get_ident() if thread_id is None else thread_id
    with _registry_lock:
        tok = _registry.get(tid)
        if tok is None:
            tok = Token()
            _registry[tid] = tok
        return tok


def cancel(thread_id: int) -> None:
    """Cancel whatever interruptible wait thread *thread_id* is in."""
    get_token(thread_id).cancel()


def yield_() -> None:
    """Raise :class:`InterruptedError_` if the calling thread was
    cancelled."""
    get_token().yield_()


def yield_no_throw() -> bool:
    return get_token().yield_no_throw()


def _leaves(x: Any) -> List[Any]:
    if isinstance(x, (list, tuple)):
        return [leaf for item in x for leaf in _leaves(item)]
    if isinstance(x, dict):
        return [leaf for item in x.values() for leaf in _leaves(item)]
    return [x]


def _events(items) -> List[Any]:
    """What to poll: a CUDA tensor becomes an event recorded on its
    device's current stream (it is ready when the work queued so far is);
    an event or a stream is polled itself (anything with ``query()``);
    host tensors and other values are ready."""
    out = []
    for x in _leaves(list(items)):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(x.device))
                out.append(ev)
        elif callable(getattr(x, "query", None)):
            out.append(x)
    return out


def synchronize(*items: Any, poll_interval: float = 1e-5,
                max_interval: float = 1e-3) -> None:
    """Wait, interruptibly, until every item is ready: CUDA tensors (the
    work queued on their stream so far), ``torch.cuda.Event``s and
    ``Stream``s, nested in lists, tuples or dicts (reference
    ``interruptible::synchronize(stream)``, interruptible.hpp:78,256).
    Polls with back-off from *poll_interval* to *max_interval* seconds and
    checks the calling thread's token before each sleep."""
    tok = get_token()
    interval = poll_interval
    pending = [e for e in _events(items) if not e.query()]
    while pending:
        tok.yield_()
        time.sleep(interval)
        interval = min(interval * 2.0, max_interval)
        pending = [e for e in pending if not e.query()]
    tok.yield_()


class interruptible:
    """Context manager that turns a KeyboardInterrupt into cancellation of
    the other threads' waits (pylibraft's ``cuda_interruptible``,
    python/pylibraft/common/interruptible.pyx:32-77): the interrupt has
    already unwound this thread's own wait, so on exit every other
    registered thread's token is cancelled.  Leaves this thread's token
    clean."""

    def __init__(self):
        self._token: Optional[Token] = None

    def __enter__(self):
        self._token = get_token()
        return self._token

    def __exit__(self, exc_type, exc, tb):
        if exc_type is KeyboardInterrupt:
            me = threading.get_ident()
            with _registry_lock:
                others = [t for tid, t in _registry.items() if tid != me]
            for t in others:
                t.cancel()
        if self._token is not None:
            self._token.yield_no_throw()
        return False
