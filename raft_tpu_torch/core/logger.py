"""Library logger with levels, pattern and callback sinks (port of
``raft_tpu/core/logger.py``; reference cpp/include/raft/core/logger.hpp:56,
118 — ``raft::logger``, ``RAFT_LOG_*``, the callback sink of
core/detail/callback_sink.hpp).

Built on the stdlib ``logging`` module; the spdlog-style ``%v`` pattern is
translated to a ``logging`` format string.  :class:`time_range` and
:func:`traced` are the NVTX ranges' counterpart, put over the port's
:func:`raft_tpu_torch.telemetry.span` (a host span that also opens a
``torch.profiler`` range while a trace runs).
"""

from __future__ import annotations

import functools
import logging
import sys
from typing import Callable, Optional

from raft_tpu_torch import telemetry

# Level values mirror reference core/logger.hpp:36-46 (RAFT_LEVEL_*).
OFF = 0
CRITICAL = 1
ERROR = 2
WARN = 3
INFO = 4
DEBUG = 5
TRACE = 6

_LEVEL_TO_PY = {
    OFF: logging.CRITICAL + 10,
    CRITICAL: logging.CRITICAL,
    ERROR: logging.ERROR,
    WARN: logging.WARNING,
    INFO: logging.INFO,
    DEBUG: logging.DEBUG,
    TRACE: logging.DEBUG - 5,
}

_DEFAULT_PATTERN = "[%L] [%H:%M:%S.%f] %v"


def _spdlog_pattern_to_fmt(pattern: str) -> str:
    """The commonly used subset of spdlog's pattern language as a
    ``logging`` format string."""
    out = pattern
    for spd, py in (("%v", "%(message)s"), ("%n", "%(name)s"),
                    ("%L", "%(levelname).1s"), ("%l", "%(levelname)s"),
                    ("%t", "%(thread)d"), ("%P", "%(process)d")):
        out = out.replace(spd, py)
    # time specifiers are handled by datefmt
    return out.replace("%H:%M:%S.%f", "%(asctime)s").replace("%H:%M:%S",
                                                             "%(asctime)s")


class _CallbackHandler(logging.Handler):
    """Callback sink: forwards every formatted record to a user callback;
    optional flush callback."""

    def __init__(self, callback: Callable[[int, str], None],
                 flush: Optional[Callable[[], None]] = None):
        super().__init__()
        self._callback = callback
        self._flush = flush

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._callback(record.levelno, self.format(record))
        except Exception:  # never raise from logging
            self.handleError(record)

    def flush(self) -> None:
        if self._flush is not None:
            self._flush()


class Logger:
    """The process's logger (``raft::logger::get()``, reference
    core/logger.hpp:129); direct construction returns the same instance,
    so handlers are never duplicated on the shared stdlib logger."""

    _instance: Optional["Logger"] = None

    def __new__(cls, name: str = "raft_tpu_torch"):
        if cls._instance is None:
            inst = super().__new__(cls)
            inst._initialized = False
            cls._instance = inst
        return cls._instance

    def __init__(self, name: str = "raft_tpu_torch"):
        if getattr(self, "_initialized", False):
            return
        self._initialized = True
        self._logger = logging.getLogger(name)
        self._logger.propagate = False
        self._level = INFO
        self._pattern = _DEFAULT_PATTERN
        self._stream_handler = logging.StreamHandler(sys.stderr)
        self._logger.addHandler(self._stream_handler)
        self._callback_handler: Optional[_CallbackHandler] = None
        self.set_level(INFO)
        self.set_pattern(_DEFAULT_PATTERN)

    @classmethod
    def get(cls) -> "Logger":
        return cls()

    def set_level(self, level: int) -> None:
        expects_level(level)
        self._level = level
        self._logger.setLevel(_LEVEL_TO_PY[level])

    def get_level(self) -> int:
        return self._level

    def should_log_for(self, level: int) -> bool:
        return level <= self._level and self._level != OFF

    def set_pattern(self, pattern: str) -> None:
        self._pattern = pattern
        fmt = logging.Formatter(_spdlog_pattern_to_fmt(pattern),
                                datefmt="%H:%M:%S")
        self._stream_handler.setFormatter(fmt)
        if self._callback_handler is not None:
            self._callback_handler.setFormatter(fmt)

    def get_pattern(self) -> str:
        return self._pattern

    def set_callback(self, callback: Optional[Callable[[int, str], None]],
                     flush: Optional[Callable[[], None]] = None) -> None:
        """Install (or, with None, remove) a callback sink; while one is
        installed the stderr sink is off."""
        if self._callback_handler is not None:
            self._logger.removeHandler(self._callback_handler)
            self._callback_handler = None
        if callback is not None:
            self._callback_handler = _CallbackHandler(callback, flush)
            self._callback_handler.setFormatter(self._stream_handler.formatter)
            self._logger.addHandler(self._callback_handler)
            self._logger.removeHandler(self._stream_handler)
        elif self._stream_handler not in self._logger.handlers:
            self._logger.addHandler(self._stream_handler)

    def flush(self) -> None:
        for h in list(self._logger.handlers):
            h.flush()

    def log(self, level: int, msg: str, *args) -> None:
        if self.should_log_for(level):
            self._logger.log(_LEVEL_TO_PY[level], msg % args if args else msg)


def expects_level(level: int) -> None:
    if level not in _LEVEL_TO_PY:
        raise ValueError(f"invalid log level {level}")


def log_trace(msg: str, *args) -> None:
    Logger.get().log(TRACE, msg, *args)


def log_debug(msg: str, *args) -> None:
    Logger.get().log(DEBUG, msg, *args)


def log_info(msg: str, *args) -> None:
    Logger.get().log(INFO, msg, *args)


def log_warn(msg: str, *args) -> None:
    Logger.get().log(WARN, msg, *args)


def log_error(msg: str, *args) -> None:
    Logger.get().log(ERROR, msg, *args)


def log_critical(msg: str, *args) -> None:
    Logger.get().log(CRITICAL, msg, *args)


class time_range:
    """A named range (reference core/nvtx.hpp:95 ``common::nvtx::range``):
    a :func:`raft_tpu_torch.telemetry.span`, which records the range's wall
    time in the span histogram and opens a ``torch.profiler`` range while
    a trace runs.  ``log=True`` adds a TRACE line with the elapsed time.
    Under ``RAFT_TPU_TELEMETRY=0`` the span is a no-op."""

    def __init__(self, name: str, log: bool = False):
        self._name = name
        self._log = log
        self._span = None
        self._t0 = 0.0

    def __enter__(self):
        self._span = telemetry.span(self._name)
        self._span.__enter__()
        self._t0 = telemetry.now()
        return self

    def __exit__(self, *exc):
        if self._log:
            log_trace("%s: %.3f ms", self._name,
                      (telemetry.now() - self._t0) * 1e3)
        self._span.__exit__(*exc)
        return False


def traced(name: str):
    """Decorator form of :class:`time_range` for an algorithm's entry
    point (the reference places NVTX ranges the same way, e.g.
    cluster/detail/kmeans.cuh:371)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with time_range(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
