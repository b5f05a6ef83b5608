"""Deadline-aware admission control and load shedding for the serving
engine (port of ``raft_tpu/serve/admission.py``; the same decisions on
the same inputs).

An overloaded queue with no admission policy has unbounded latency: every
request is eventually served, and every request is eventually late.  The
production contract is the opposite — requests that cannot meet their
deadline are REJECTED at admission with a typed error (cheap, immediate,
actionable for the caller) so the requests that ARE admitted keep a
bounded p99.  Three pieces:

* :class:`ServeRequest` — the request envelope: a query batch plus an
  optional absolute ``deadline_s`` (on the ``telemetry.now()`` clock) or
  relative ``timeout_s`` (resolved against admission time).  Plain arrays
  remain valid requests (no deadline, never shed on deadline).
* :class:`RejectedError` — the typed rejection every shed request
  receives IN ITS RESULT SLOT (``reason`` ∈ {"deadline", "overload",
  "expired", "closed"}); other requests in the same call are unaffected.
* :class:`AdmissionController` — the policy object one engine owns.  The
  per-super-batch cost estimate is seeded from LIVE telemetry: the
  sampled device seconds of the backend's program
  (``raft_tpu_device_seconds{fn}`` p50, CUDA events on the card), falling
  back to the host-side dispatch-latency histogram
  (``raft_tpu_aot_dispatch_seconds{fn,sig}`` rows merged across
  signatures), falling back to a static estimate when cold.  A
  request's projected completion is (batches ahead of it + its
  own) × that estimate; a deadline that cannot cover the projection sheds
  at admission.

Overload policy (``policy=``, the documented choice):

* ``"shed-newest"`` (default) — when the bounded queue
  (``max_queue`` queries per call) would overflow, the NEWEST arrival is
  shed (``reason="overload"``).  Admission is a promise: admitted
  requests are always dispatched, and ones that complete past their
  deadline are merely COUNTED expired.
* ``"shed-over-deadline"`` — additionally, an admitted request whose
  deadline has already passed when its super-batch assembles is dropped
  there (``reason="expired"``) instead of burning device time on an
  answer nobody is waiting for.

Counters (``telemetry``-registered, labeled per engine):
``raft_tpu_serve_admitted_total{engine}``,
``raft_tpu_serve_shed_total{engine,reason}``,
``raft_tpu_serve_expired_total{engine}`` — plus mirror keys in
``ServeEngine.stats``.  Recent shedding/expiry flips the engine's
``/healthz`` body to ``degraded: true`` (still HTTP 200 — the engine IS
serving; a load balancer that wants to route away can read the flag).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from raft_tpu_torch import telemetry
from raft_tpu_torch.core.error import RaftError, expects

#: fallback per-super-batch service-time estimate before any telemetry
#: exists (cold start) — deliberately conservative; deployments converge
#: onto measured values after the first batches
DEFAULT_STATIC_BATCH_S = 0.05

#: /healthz reports ``degraded: true`` for this long after a shed/expiry
DEGRADED_WINDOW_S = 30.0

POLICIES = ("shed-newest", "shed-over-deadline")


class RejectedError(RaftError):
    """A request shed by admission control (or refused by a closed
    engine).  ``reason`` is machine-readable: ``"deadline"`` (projected
    completion past the deadline), ``"overload"`` (bounded queue full),
    ``"expired"`` (admitted, but the deadline passed before dispatch —
    shed-over-deadline policy), ``"closed"`` (engine shut down)."""

    def __init__(self, reason: str, message: str = ""):
        super().__init__(message or f"request rejected: {reason}")
        self.reason = reason


@dataclasses.dataclass
class ServeRequest:
    """The deadline-carrying request envelope.

    ``deadline_s`` is ABSOLUTE on the ``telemetry.now()`` clock (i.e.
    ``telemetry.now() + budget``); ``timeout_s`` is RELATIVE and resolves
    to ``now + timeout_s`` at admission.  Passing both takes the tighter
    one.  With neither, the request is never deadline-shed (it can still
    be overload-shed by the queue bound)."""

    q: Any
    deadline_s: Optional[float] = None
    timeout_s: Optional[float] = None

    def resolve_deadline(self, now: float) -> Optional[float]:
        cands = []
        if self.deadline_s is not None:
            cands.append(float(self.deadline_s))
        if self.timeout_s is not None:
            cands.append(now + float(self.timeout_s))
        return min(cands) if cands else None


def _batch_cost_from_telemetry(fn: Optional[str]) -> Optional[float]:
    """The live per-super-batch cost estimate for program *fn*: sampled
    device seconds p50 first (the truest number), host-side dispatch
    latency second (always populated once serving)."""
    if not fn:
        return None
    dev = telemetry.REGISTRY.get("raft_tpu_device_seconds")
    if dev is not None:
        q = dev.quantile(0.5, (fn,))
        if q is not None:
            return float(q)
    disp = telemetry.REGISTRY.get("raft_tpu_aot_dispatch_seconds")
    if disp is not None:
        # (fn, sig)-labeled: merge every signature row of this fn — ONE
        # implementation, shared with the scheduler's cost model
        est = telemetry.merged_quantile(disp, 0.5, (fn,))
        if est is not None:
            return float(est)
    return None


class AdmissionController:
    """Deadline-aware admission + bounded-queue load shedding for ONE
    engine (the engine constructs a default controller; pass your own to
    tune policy/bounds, or ``admission=False`` to disable the layer)."""

    def __init__(self, policy: str = "shed-newest",
                 max_queue: Optional[int] = None,
                 static_batch_s: float = DEFAULT_STATIC_BATCH_S,
                 degraded_window_s: float = DEGRADED_WINDOW_S,
                 use_telemetry: bool = True):
        expects(policy in POLICIES,
                f"admission policy {policy!r} (want one of {POLICIES})")
        expects(max_queue is None or max_queue >= 1,
                "max_queue must be >= 1 (or None for unbounded)")
        self.policy = policy
        self.max_queue = max_queue
        self.static_batch_s = float(static_batch_s)
        self.degraded_window_s = float(degraded_window_s)
        #: False pins the cost model to static_batch_s (deterministic
        #: tests / bench scenarios); True (default) prefers live signals
        self.use_telemetry = bool(use_telemetry)
        #: EWMA of the OWNING engine's observed end-to-end per-batch wall
        #: time (engine feeds it after each call) — the most faithful
        #: planning number, since the registry's device/dispatch
        #: histograms see device or host-dispatch time but not the full
        #: assemble→deliver service time a queued request actually waits
        self._observed_batch_s: Optional[float] = None
        self._last_event = float("-inf")  # last shed/expiry, now() clock
        self._engine = "?"
        self._admitted = telemetry.counter(
            "raft_tpu_serve_admitted_total",
            "requests admitted by deadline-aware admission control",
            labelnames=("engine",))
        self._shed = telemetry.counter(
            "raft_tpu_serve_shed_total",
            "requests shed at admission (deadline/overload) or refused "
            "closed", labelnames=("engine", "reason"))
        self._expired = telemetry.counter(
            "raft_tpu_serve_expired_total",
            "admitted requests whose deadline passed before dispatch "
            "(dropped under shed-over-deadline, served late otherwise)",
            labelnames=("engine",))

    def bind(self, engine_label: str) -> "AdmissionController":
        """Pin the engine label the counters record under (called by the
        owning engine; one controller serves one engine)."""
        self._engine = str(engine_label)
        return self

    # -- cost model ---------------------------------------------------------
    def observe_batches(self, n_batches: int, wall_s: float) -> None:
        """Feed one serving call's observed (super-batches, wall seconds)
        back into the cost model (EWMA) — the engine calls this after
        every call that dispatched coalesced batches, so the estimate
        self-corrects from SERVED traffic instead of trusting the
        device-time histogram's lower bound forever."""
        if n_batches <= 0 or wall_s <= 0.0:
            return
        per = float(wall_s) / float(n_batches)
        if self._observed_batch_s is None:
            self._observed_batch_s = per
        else:
            self._observed_batch_s = (0.7 * self._observed_batch_s
                                      + 0.3 * per)

    def reset_observed(self) -> None:
        """Drop the observed per-batch EWMA (the autotuner's promotion
        hook): after a config swap the old observations describe the OLD
        config, so the estimate re-converges from the telemetry seed."""
        self._observed_batch_s = None

    def batch_cost_s(self, fn: Optional[str]) -> float:
        """Estimated seconds to serve ONE coalesced super-batch of program
        *fn*: the engine's own observed end-to-end per-batch time first,
        then the registry telemetry (sampled device seconds p50 /
        dispatch-latency rows), then the static estimate when cold.
        ``use_telemetry=False`` pins to static (deterministic tests)."""
        if not self.use_telemetry:
            return self.static_batch_s
        if self._observed_batch_s is not None:
            return self._observed_batch_s
        est = _batch_cost_from_telemetry(fn)
        return self.static_batch_s if est is None else est

    # -- admission decisions (engine-driven; engine owns its stats mirror) --
    def admit(self, n_queries: int, deadline: Optional[float], now: float,
              queued_queries: int, batches_ahead: int,
              est_batch_s: float) -> Optional[RejectedError]:
        """One admission decision.  Returns None (admitted — counted) or
        the :class:`RejectedError` to place in the request's result slot
        (counted shed).  ``batches_ahead`` is how many super-batches are
        already planned ahead of this request in the call."""
        if self.max_queue is not None \
                and queued_queries + n_queries > self.max_queue:
            return self._reject(
                "overload", now,
                f"bounded queue full ({queued_queries} queries queued, "
                f"bound {self.max_queue}) — overload policy "
                f"{self.policy} sheds the newest arrival")
        if deadline is not None:
            projected = (batches_ahead + 1) * est_batch_s
            if now + projected > deadline:
                return self._reject(
                    "deadline", now,
                    f"remaining budget {max(0.0, deadline - now):.4f}s < "
                    f"projected completion {projected:.4f}s "
                    f"({batches_ahead} batch(es) ahead at "
                    f"~{est_batch_s:.4f}s each) — shed at admission")
        self._admitted.inc(1, (self._engine,))
        return None

    def expire(self, deadline: float, now: float) -> Optional[RejectedError]:
        """Dispatch-time deadline check for an ADMITTED request: count it
        expired; under ``shed-over-deadline`` also return the rejection to
        drop it from the super-batch (None = serve it anyway, late)."""
        self._expired.inc(1, (self._engine,))
        self._last_event = now
        if self.policy != "shed-over-deadline":
            return None
        return RejectedError(
            "expired",
            f"deadline passed {now - deadline:.4f}s before dispatch "
            "(admitted under estimate; dropped by shed-over-deadline)")

    def reject_closed(self) -> RejectedError:
        """The rejection of a request that reaches a closed engine (not
        counted as shed: the engine refused it, admission did not)."""
        return RejectedError("closed", "engine is closed")

    def _reject(self, reason: str, now: float, msg: str) -> RejectedError:
        self._shed.inc(1, (self._engine, reason))
        self._last_event = now
        return RejectedError(reason, msg)

    # -- /healthz surface ---------------------------------------------------
    def degraded(self, now: float) -> bool:
        """True while the engine shed or expired a request within the
        degraded window — the non-503 overload flag /healthz exposes."""
        return (now - self._last_event) < self.degraded_window_s

    def health(self, now: float) -> dict:
        eng = (self._engine,)
        shed = sum(v for labels, v in self._shed.items()
                   if labels and labels[0] == self._engine)
        return {
            "policy": self.policy,
            "max_queue": self.max_queue,
            "degraded": self.degraded(now),
            "admitted_total": int(self._admitted.get(eng)),
            "shed_total": int(shed),
            "expired_total": int(self._expired.get(eng)),
        }
