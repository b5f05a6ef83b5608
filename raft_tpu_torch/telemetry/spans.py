"""Host-side span tracing (port of ``raft_tpu/telemetry/spans.py``).

A span is a nested host-side wall-time range that does three things:

* records its wall time into ``raft_tpu_span_seconds{span=<name>}``
  (whose count, exported as ``_count``, counts the completed spans);
* while a ``torch.profiler`` trace is running, on whichever thread,
  opens a ``torch.profiler.record_function`` range of the same name, so
  the spans show up in the trace beside the kernels (the reference emits
  ``jax.profiler.TraceAnnotation`` there).  The gate is the profiler's
  process-wide flag: the thread-local ``torch.autograd._profiler_enabled``
  reads False on every thread but the one that started the profiler, so
  the serving engine's scheduler thread would record nothing even under
  a profiler of all threads (``profile_all_threads=True``; a profiler of
  one thread drops the other threads' ranges);
* optionally appends one JSON line per completed span to the opt-in JSONL
  sink (:func:`set_jsonl_sink`) and to an open :class:`collect_spans`.

Spans nest per thread (a thread-local stack) and are exception-safe.  A
span costs nothing on the device: no CUDA synchronisation, no event —
two ``perf_counter`` reads, a list push/pop and one histogram
observation.  With telemetry disabled (``RAFT_TPU_TELEMETRY=0``)
:func:`span` returns a shared no-op context manager.

``record_function`` and the profiler's module are resolved ONCE at first
use and cached; the range is entered only while a profiler is active, so
an untraced span never calls into PyTorch.
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, List, Optional, Union

from raft_tpu_torch.telemetry import registry as _registry

#: the monotonic clock every serving timing site routes through (deadlines
#: in ``ServeRequest`` are on this clock)
now = time.perf_counter

# -- cached profiler import
_PROFILER_RANGE = None
#: ``torch.autograd.profiler``, whose ``_is_profiler_enabled`` is set by
#: every profiler start and stop, for all threads
_PROFILER_MODULE = None
_PROFILER_TRIED = False


def _trace_annotation_cls():
    """``torch.profiler.record_function`` or None, resolved once per
    process; None also while no profiler is running (the range would
    record nothing)."""
    global _PROFILER_RANGE, _PROFILER_MODULE, _PROFILER_TRIED
    if not _PROFILER_TRIED:
        _PROFILER_TRIED = True
        try:
            import torch.autograd.profiler as profiler_module
            from torch.profiler import record_function

            _PROFILER_RANGE = record_function
            _PROFILER_MODULE = profiler_module
        except Exception:  # pragma: no cover - profiler unavailable
            _PROFILER_RANGE = None
    if (_PROFILER_RANGE is None
            or not _PROFILER_MODULE._is_profiler_enabled):
        return None
    return _PROFILER_RANGE


# -- the per-thread span stack ----------------------------------------------

_TLS = threading.local()


def _stack() -> List[str]:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def current_span() -> Optional[str]:
    """Name of the innermost open span on this thread, or None."""
    s = _stack()
    return s[-1] if s else None


class collect_spans:
    """Capture completed span EVENTS on this thread (context manager) —
    the same dicts the JSONL sink receives, appended to ``self.events`` in
    completion order (children before parents).  The serve engine's slow-
    request flight recorder wraps each request in one of these and keeps
    the event list only when the request breaches its latency threshold
    (:class:`raft_tpu_torch.telemetry.http.FlightRecorder`).  Nests: an inner
    collector shadows the outer one for its duration."""

    __slots__ = ("events", "_prev")

    def __enter__(self) -> "collect_spans":
        self.events: List[dict] = []
        self._prev = getattr(_TLS, "collect", None)
        _TLS.collect = self.events
        return self

    def __exit__(self, *exc) -> bool:
        _TLS.collect = self._prev
        return False


# -- the JSONL event sink ----------------------------------------------------

_SINK_LOCK = threading.Lock()
_SINK: Optional[IO[str]] = None
_SINK_OWNED = False


def set_jsonl_sink(sink: Union[None, str, IO[str]]) -> None:
    """Install (or with None, remove) the opt-in span event sink.

    *sink* is a path (opened append, line-buffered writes, closed on
    replacement) or an open text file-like.  Each completed span appends
    one JSON object::

        {"span": "serve.dispatch", "parent": "serve.request", "depth": 1,
         "thread": 140211, "start": 1722772800.123, "dur_s": 0.0042,
         "error": false}

    Span completion order is exit order (children before parents), the
    natural order for rebuilding the tree from parent back-pointers."""
    global _SINK, _SINK_OWNED
    with _SINK_LOCK:
        if _SINK is not None and _SINK_OWNED:
            try:
                _SINK.close()
            except Exception:  # pragma: no cover - best-effort close
                pass
        if sink is None:
            _SINK, _SINK_OWNED = None, False
        elif isinstance(sink, str):
            _SINK, _SINK_OWNED = open(sink, "a"), True
        else:
            _SINK, _SINK_OWNED = sink, False


def _emit_event(event: dict) -> None:
    with _SINK_LOCK:
        if _SINK is None:
            return
        _SINK.write(json.dumps(event) + "\n")
        _SINK.flush()


# -- the span metrics (created lazily so import stays cheap) -----------------

_span_seconds = None


def _metrics():
    global _span_seconds
    if _span_seconds is None:
        _span_seconds = _registry.REGISTRY.histogram(
            "raft_tpu_span_seconds", "wall time of host-side spans",
            labelnames=("span",))
    return _span_seconds


class Span:
    """One live span — returned by :func:`span`; use as a context manager.

    Re-entrant use of a single instance is not supported (make a new span);
    the object is deliberately tiny (``__slots__``) because the serve path
    creates a handful per request batch."""

    __slots__ = ("name", "_t0", "_start_wall", "_ann", "_parent", "_depth")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0
        self._start_wall = 0.0
        self._ann = None
        self._parent: Optional[str] = None
        self._depth = 0

    def __enter__(self) -> "Span":
        stack = _stack()
        self._parent = stack[-1] if stack else None
        self._depth = len(stack)
        stack.append(self.name)
        cls = _trace_annotation_cls()
        if cls is not None:
            try:
                self._ann = cls(self.name)
                self._ann.__enter__()
            except Exception:  # pragma: no cover - profiler unavailable
                self._ann = None
        # wall-clock start is only consumed by the event path (JSONL sink
        # / span collector) — skip the third clock read otherwise
        self._start_wall = (
            time.time()
            if _SINK is not None or getattr(_TLS, "collect", None) is not None
            else 0.0)
        self._t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # EXCEPTION SAFETY: every recording step runs regardless of exc and
        # none may raise past this frame; the stack pop is unconditional.
        dur = now() - self._t0
        stack = _stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        elif self.name in stack:  # pragma: no cover - misnested defensive
            stack.remove(self.name)
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # pragma: no cover - profiler teardown
                pass
        _metrics().observe(dur, (self.name,))
        collect = getattr(_TLS, "collect", None)
        if _SINK is not None or collect is not None:
            event = {
                "span": self.name, "parent": self._parent,
                "depth": self._depth,
                "thread": threading.get_ident(),
                "start": round(self._start_wall, 6),
                "dur_s": round(dur, 9),
                "error": exc_type is not None,
            }
            if collect is not None:
                collect.append(event)
            if _SINK is not None:
                _emit_event(event)
        return False  # never swallow


class _NoopSpan:
    """Shared do-nothing span for the disabled mode — one instance, zero
    per-call work."""

    __slots__ = ()
    name = "<disabled>"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def span(name: str) -> Union[Span, _NoopSpan]:
    """Open a nested host-side span (context manager) — see the module
    docstring for what a span records.  With telemetry disabled this is a
    shared no-op object."""
    if not _registry.enabled():
        return _NOOP
    return Span(name)
