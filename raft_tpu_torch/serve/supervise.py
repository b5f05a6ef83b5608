"""Dispatch supervision: watchdog, bounded retry, failure classification
(port of ``raft_tpu/serve/supervise.py``).

A super-batch dispatch is asynchronous — its failure (or its hang)
surfaces when the engine COLLECTS the host copy of the results.  The
supervisor owns that collection:

* **Watchdog** — with ``watchdog_s`` set, the host fetch runs on a helper
  thread and the caller waits at most the wall-clock budget; a hung
  dispatch raises :class:`WatchdogTimeout` instead of blocking the engine
  forever.  A CUDA kernel cannot be cancelled, so the abandoned daemon
  thread stays (it ends when the lane's work does), and the engine's
  re-dispatch goes to the OTHER stream lane instead of queueing behind
  the stalled work.  ``watchdog_s=None`` (the default) fetches inline
  with zero per-batch thread cost.
* **Bounded retry with backoff + jitter** — RETRYABLE failures (transient
  ``RuntimeError``s — ``torch.OutOfMemoryError`` is one — injected
  :class:`~raft_tpu_torch.testing.faults.InjectedFault` faults, and
  watchdog timeouts) are retried up to ``max_retries`` times: exponential
  backoff from ``backoff_s`` capped at ``backoff_cap_s``, multiplied by
  seeded jitter.  The re-dispatch goes through the caller's ``redo``
  closure over the SAME assembled block and warmed bucket.
* **Fail-fast classification** — NON-retryable failures (``LogicError``,
  the port's ``DeviceError`` for a failed kernel launch — a sticky CUDA
  error poisons the context, so a retry would fail the same way —
  ``TypeError``/``ValueError``, anything that is not a ``RuntimeError``)
  are raised immediately.

The fault plane's ``dispatch`` site is consulted INSIDE the fetch (once
per collection attempt), so injected raises/stalls flow through exactly
the path real failures take.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np

from raft_tpu_torch.core.error import LogicError, RaftError
from raft_tpu_torch.testing import faults as _faults


class DispatchError(RaftError):
    """Base of the supervisor's own failure types."""


class WatchdogTimeout(DispatchError):
    """The wall-clock watchdog fired before the dispatch produced its
    results.  Classified RETRYABLE: a hang is indistinguishable from an
    arbitrarily slow transient, and the retry dispatches fresh buffers."""


def retryable(exc: BaseException) -> bool:
    """The documented classification: watchdog timeouts and transient
    ``RuntimeError``s retry; logic/shape/dtype bugs and device errors
    (``RaftError``s that are not ``RuntimeError``s) never do."""
    if isinstance(exc, WatchdogTimeout):
        return True
    if isinstance(exc, LogicError):  # InjectedLogicFault included
        return False
    return isinstance(exc, RuntimeError)


class DispatchSupervisor:
    """Supervised collection of in-flight dispatch results for one engine.

    ``on_event(kind)`` (kind ∈ {"retry", "watchdog_timeout"}) lets the
    owning engine mirror supervisor events into its ``stats`` without the
    supervisor knowing about engines."""

    def __init__(self, watchdog_s: Optional[float] = None,
                 max_retries: int = 2, backoff_s: float = 0.05,
                 backoff_cap_s: float = 1.0, jitter: float = 0.25,
                 seed: int = 0,
                 on_event: Optional[Callable[[str], None]] = None):
        if watchdog_s is not None and watchdog_s <= 0:
            raise LogicError("watchdog_s must be positive (or None)")
        self.watchdog_s = watchdog_s
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.jitter = float(jitter)
        self._rng = np.random.default_rng(seed)
        self._on_event = on_event or (lambda kind: None)

    # -- one attempt --------------------------------------------------------
    @staticmethod
    def _pull(out) -> Tuple[np.ndarray, np.ndarray]:
        """*out* is ``(distances, indices, done)`` — host tensors the lane
        copies into and the lane's end-of-work event (None on the CPU) —
        or the exception the dispatch itself raised, which surfaces
        here like a failure on the card."""
        # the injected-fault site: raises/stalls surface here, exactly
        # where a real async dispatch's failure does
        _faults.check("dispatch")
        if isinstance(out, BaseException):
            raise out
        d, i, done = out
        if done is not None:
            # exempt(hot-path-host-transfer): collection waits on the lane's done event
            done.synchronize()
        # exempt(hot-path-host-transfer): results go to the caller as numpy
        return d.numpy(), i.numpy()

    def fetch(self, out, label: str = "") -> Tuple[np.ndarray, np.ndarray]:
        """Collect one dispatch's results, under the watchdog if armed."""
        if self.watchdog_s is None:
            return self._pull(out)
        box: dict = {}

        def run():
            try:
                box["value"] = self._pull(out)
            except BaseException as e:  # relayed to the caller below
                box["error"] = e

        t = threading.Thread(target=run, daemon=True,
                             name=f"raft-tpu-torch-serve-fetch-{label}")
        t.start()
        t.join(self.watchdog_s)
        if t.is_alive():
            self._on_event("watchdog_timeout")
            raise WatchdogTimeout(
                f"dispatch {label or '<super-batch>'} produced no results "
                f"within the {self.watchdog_s}s watchdog budget")
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _backoff(self, attempt: int) -> float:
        base = min(self.backoff_s * (2.0 ** attempt), self.backoff_cap_s)
        return base * (1.0 + self.jitter * float(self._rng.random()))

    def collect(self, out, redo: Optional[Callable[[], object]] = None,
                label: str = "") -> Tuple[np.ndarray, np.ndarray]:
        """Collect with bounded retry: on a retryable failure, back off,
        re-dispatch via ``redo()`` (the caller's closure over the SAME
        block and warmed bucket) and fetch again.
        Non-retryable failures and exhausted retries raise to the caller,
        which isolates them per request."""
        attempt = 0
        while True:
            try:
                return self.fetch(out, label)
            except Exception as e:
                if redo is None or attempt >= self.max_retries \
                        or not retryable(e):
                    raise
                time.sleep(self._backoff(attempt))
                attempt += 1
                self._on_event("retry")
                out = redo()
