"""Device time per serving program (port of the sampled half of
``raft_tpu/telemetry/device.py``).

A CUDA dispatch returns as soon as its kernels are enqueued, so the host's
dispatch time says nothing about the card's.  Every Nth WARM dispatch of
each program (``RAFT_TPU_DEVICE_SAMPLE``, default 1/64; the FIRST warm
dispatch is always sampled so every program reports promptly) is timed
on the card — a CUDA event recorded on the lane before the dispatch, read
against the lane's end-of-work event once the engine has waited on that
anyway, so sampling adds no synchronisation — and recorded into
``raft_tpu_device_seconds{fn}`` and, per dispatch signature (request
type and block shape), ``raft_tpu_device_signature_seconds{fn,sig}``.  On
the CPU, where a dispatch runs to its end before it returns, the
dispatch's own wall time is the sample.

The compile-time half is dropped, not ported: ``program_costs`` and the
``raft_tpu_program_*`` gauges read XLA's cost analysis of a compiled
program, and the port compiles none (PyTorch runs eagerly; the kernels
are ``nvcc`` libraries).  Nothing on the serving path read them; the
smoke derives each kernel's bound from its shapes instead.

The not-sampled cost is one enabled() check, one locked add and a modulo.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from raft_tpu_torch.core.error import fail
from raft_tpu_torch.telemetry import registry as _registry

#: default sampling period: one device-timed dispatch per this many warm
#: dispatches of each function
DEFAULT_SAMPLE_EVERY = 64

_sample_every: Optional[int] = None

#: guards the per-fn dispatch counters (NOT the metrics — those take the
#: registry lock themselves)
_LOCK = threading.Lock()
_dispatch_counts: Dict[str, int] = {}

_device_seconds = None
_signature_seconds = None


def sample_every() -> int:
    """The device-sampling period N (one timed dispatch per N warm
    dispatches per function).  ``RAFT_TPU_DEVICE_SAMPLE`` at first use, or
    :func:`set_sample_every`; ``0`` disables sampling."""
    global _sample_every
    if _sample_every is None:
        try:
            _sample_every = int(os.environ.get(
                "RAFT_TPU_DEVICE_SAMPLE", str(DEFAULT_SAMPLE_EVERY)))
        except ValueError:
            _sample_every = DEFAULT_SAMPLE_EVERY
    return _sample_every


def set_sample_every(n: int) -> int:
    """Set the sampling period at runtime (0 disables).  Returns the
    previous value."""
    global _sample_every
    prev = sample_every()
    _sample_every = max(0, int(n))
    return prev


def _metrics():
    global _device_seconds, _signature_seconds
    if _device_seconds is None:
        _device_seconds = _registry.REGISTRY.histogram(
            "raft_tpu_device_seconds",
            "sampled device execution time per serving program",
            labelnames=("fn",))
        _signature_seconds = _registry.REGISTRY.histogram(
            "raft_tpu_device_signature_seconds",
            "sampled device execution time per serving program and "
            "dispatch signature",
            labelnames=("fn", "sig"))
    return _device_seconds, _signature_seconds


def program_costs(compiled) -> Dict[str, Optional[float]]:
    """The reference harvests XLA's ``cost_analysis`` of a compiled
    program here; the port compiles no programs, so the name stays only
    to say so."""
    fail("telemetry.program_costs is not ported yet and is dropped: it "
         "reads XLA's cost analysis, which PyTorch has no counterpart of")


def sample_due(fn: str) -> bool:
    """Per-WARM-dispatch gate: bump *fn*'s dispatch count and return True
    when this dispatch should be timed on the device (count 0, then every
    Nth).  False whenever telemetry is disabled or sampling is off."""
    if not _registry.enabled():
        return False
    n = sample_every()
    if n <= 0:
        return False
    with _LOCK:
        c = _dispatch_counts.get(fn, 0)
        _dispatch_counts[fn] = c + 1
    return c % n == 0


def record_sample(fn: str, sig: str, seconds: float) -> None:
    """Record one device-time sample of *fn* at signature *sig* (the JAX
    package's ``(fn, sig)`` pair; its sig also keys XLA's static costs,
    which the port has none of)."""
    by_fn, by_sig = _metrics()
    by_fn.observe(seconds, (fn,))
    by_sig.observe(seconds, (fn, sig))
