"""Deterministic fault-injection plane (port of
``raft_tpu/testing/faults.py``; the same grammar, counters and seeded
streams, so one plan string injects the same fault sequence in both
packages).

A seeded, declarative plan of fault directives that library hooks consult
at well-defined sites.  OFF by default; when no plan is installed every
hook is a single ``is None`` check.

Sites (each hook names its site; directives select by site):

* ``dispatch`` — consulted by the serve supervisor once per super-batch
  COLLECTION attempt (where an asynchronous dispatch's failure surfaces),
  so ``raise`` models a failed device dispatch and ``stall`` a hung one.
  Retries and isolation re-dispatches are attempts too: a directive with
  ``times=1`` (the default) injects exactly one failure and the retry
  then succeeds.
* ``comms`` — consulted by :class:`raft_tpu_torch.comms.Comms` at every
  counted collective (``op=<name>``: allreduce, bcast, allgather,
  reducescatter) and on the host plane at each ``isend`` and each pending
  ``waitall`` receive (``op=isend`` / ``op=waitall``); ``rank=`` is the
  communicator's host rank.  A directive fires before anything is sent —
  the dead-host case ``telemetry.gather`` degrades around.
* ``refresh`` — consulted by ``ServeEngine._refresh`` at two stages:
  ``pre_warm`` (before the replacement backend warms anything) and
  ``pre_swap`` (after every warmed bucket ran on it, immediately before
  the atomic swap) — the crash window that proves swap atomicity.

Plan grammar (``RAFT_TPU_FAULT_PLAN`` or :func:`install_plan` /
:func:`plan`): directives separated by ``;``, fields by ``:``; the first
field is the site, the rest are ``key=value`` matchers and ONE action::

    dispatch:n=2:raise              # 2nd collection attempt raises (transient)
    dispatch:n=1:raise=logic        # non-retryable (LogicError) injected
    dispatch:n=1:stall=3.0          # 1st attempt hangs 3 s (watchdog fodder)
    dispatch:p=0.1:seed=7:raise     # seeded Bernoulli faults, deterministic
    refresh:stage=pre_swap:raise    # crash between warm and swap

Matchers: ``n=K`` fires on the K-th MATCHING event (1-based; ``times=T``
extends it to events K..K+T-1, ``times=0`` = every event from K on),
``p=F``/``seed=S`` fires per-event with seeded probability (deterministic
sequence), ``rank=R``/``op=O``/``stage=G`` filter events by attribute
before counting.  A directive with neither ``n`` nor ``p`` fires on EVERY
matching event.  Actions: ``raise[=transient|logic]`` (``fail`` and
``crash`` are aliases of ``raise``) and ``stall=SECONDS``.

The hooks are host-side Python: they add nothing to the device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch.core.error import LogicError


class InjectedFault(RuntimeError):
    """A TRANSIENT injected failure — deliberately a ``RuntimeError`` so
    the serve supervisor's retryable classification treats it exactly like
    a transient runtime error (``torch.OutOfMemoryError`` is one)."""


class InjectedLogicFault(LogicError):
    """A NON-RETRYABLE injected failure — a ``LogicError`` (the shape/
    dtype-bug family), which the supervisor must fail fast on, never
    retry."""


_ACTIONS = ("raise", "stall")
_KINDS = ("transient", "logic")


@dataclasses.dataclass(frozen=True)
class Directive:
    """One parsed fault directive (see the module grammar)."""

    site: str
    action: str = "raise"            # "raise" | "stall"
    kind: str = "transient"          # raise flavor: transient | logic
    stall_s: float = 0.0
    n: Optional[int] = None          # fire on the n-th matching event
    times: int = 1                   # ... for this many events (0 = forever)
    p: float = 0.0                   # seeded per-event probability
    seed: int = 0
    rank: Optional[int] = None       # comms: host-rank filter
    op: Optional[str] = None         # comms: operation filter
    stage: Optional[str] = None      # refresh: stage filter

    def matches_attrs(self, attrs: Dict[str, object]) -> bool:
        for field in ("rank", "op", "stage"):
            want = getattr(self, field)
            if want is not None and attrs.get(field) != want:
                return False
        return True


def _parse_directive(text: str) -> Directive:
    parts = [p.strip() for p in text.strip().split(":") if p.strip()]
    if not parts:
        raise ValueError(f"empty fault directive in {text!r}")
    site = parts[0]
    if site not in ("dispatch", "comms", "refresh"):
        raise ValueError(
            f"unknown fault site {site!r} (want dispatch|comms|refresh)")
    kw: Dict[str, object] = {"site": site}
    action_seen = False
    for field in parts[1:]:
        key, eq, value = field.partition("=")
        if key in ("raise", "fail", "crash"):
            action_seen = True
            kw["action"] = "raise"
            if eq:
                if value not in _KINDS:
                    raise ValueError(
                        f"raise kind {value!r} (want transient|logic)")
                kw["kind"] = value
        elif key == "stall":
            action_seen = True
            kw["action"] = "stall"
            kw["stall_s"] = float(value)
        elif key in ("n", "times", "seed", "rank"):
            kw[key] = int(value)
        elif key == "p":
            kw[key] = float(value)
        elif key in ("op", "stage"):
            kw[key] = value
        else:
            raise ValueError(f"unknown fault directive field {key!r} "
                             f"in {text!r}")
    if not action_seen:
        raise ValueError(f"fault directive {text!r} declares no action "
                         "(raise/fail/crash/stall=T)")
    return Directive(**kw)


class FaultPlan:
    """A parsed, stateful fault plan: per-directive event counters and a
    seeded RNG stream, so a given plan string injects the SAME fault
    sequence on every run (the determinism the bit-identity tests need)."""

    def __init__(self, directives: List[Directive]):
        self.directives = list(directives)
        self._lock = threading.Lock()
        self._counts = [0] * len(self.directives)
        self._rngs = [np.random.default_rng(d.seed) for d in self.directives]
        self.fired: List[Tuple[str, str]] = []  # (site, action) log

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        directives = [_parse_directive(t)
                      for t in str(text).split(";") if t.strip()]
        if not directives:
            raise ValueError(f"fault plan {text!r} holds no directives")
        return cls(directives)

    def _due(self, i: int, d: Directive) -> bool:
        # caller holds the lock; the event already matched site + attrs
        self._counts[i] += 1
        c = self._counts[i]
        if d.n is not None:
            if c < d.n:
                return False
            return d.times == 0 or c < d.n + d.times
        if d.p > 0.0:
            return bool(self._rngs[i].random() < d.p)
        return True  # no n, no p: every matching event

    def check(self, site: str, **attrs) -> None:
        """Consult the plan at *site*; stalls sleep, raises raise."""
        fire: Optional[Directive] = None
        with self._lock:
            for i, d in enumerate(self.directives):
                if d.site != site or not d.matches_attrs(attrs):
                    continue
                if self._due(i, d):
                    fire = d
                    self.fired.append((site, d.action))
                    break
        if fire is None:
            return
        if fire.action == "stall":
            time.sleep(fire.stall_s)
            return
        detail = ", ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        msg = (f"injected fault at site {site!r}"
               + (f" ({detail})" if detail else ""))
        if fire.kind == "logic":
            raise InjectedLogicFault(msg)
        raise InjectedFault(msg)


#: the installed plan — None means OFF, and every hook is one attr read
_PLAN: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def install_plan(plan_or_text) -> Optional[FaultPlan]:
    """Install a plan (string or :class:`FaultPlan`); returns the previous
    one so callers can restore it.  ``None`` clears."""
    global _PLAN
    prev = _PLAN
    if plan_or_text is None:
        _PLAN = None
    elif isinstance(plan_or_text, FaultPlan):
        _PLAN = plan_or_text
    else:
        _PLAN = FaultPlan.parse(plan_or_text)
    return prev



def clear_plan() -> None:
    """Remove the installed plan."""
    install_plan(None)


@contextlib.contextmanager
def plan(text):
    """Context-manager install: the plan is active inside the block and the
    previous plan (usually None) is restored on exit — the test battery's
    entry point."""
    prev = install_plan(text)
    try:
        yield _PLAN
    finally:
        install_plan(prev)


def check(site: str, **attrs) -> None:
    """The hook the library calls: free when no plan is installed."""
    p = _PLAN
    if p is None:
        return
    p.check(site, **attrs)


_env = os.environ.get("RAFT_TPU_FAULT_PLAN")
if _env:
    install_plan(_env)
del _env
