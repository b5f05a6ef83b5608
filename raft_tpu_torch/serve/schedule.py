"""Telemetry-steered continuous batching + replica routing policy (port
of ``raft_tpu/serve/schedule.py``; the same decisions on the same
inputs).

The drain-all coalescer packs whatever is queued into maximal
super-batches — a fixed heuristic that is optimal only when per-batch cost is flat in
the bucket size.  The live telemetry the runtime already exports
(``raft_tpu_device_seconds{fn}`` p50, per-signature dispatch-latency
rows, the admission layer's end-to-end per-batch EWMA) says otherwise:
per-bucket cost has a fixed dispatch overhead plus a rows term, so
sometimes one padded 1024-bucket beats two 512s (overhead dominates) and
sometimes a 512 + an 8 beats a padded 1024 (padding waste dominates).
This module makes that choice explicitly, per dispatch, from measured
costs.  Four policy objects, all host-side arithmetic (no device work):

* :class:`CostModel` — per-(dtype, bucket) service-time estimates:
  an EWMA fed by the engine after every collected super-batch, seeded
  from the registry (device-seconds p50 / merged dispatch-latency rows —
  ``telemetry.registry.merged_quantile``) and falling back to the
  admission layer's static estimate when cold.  Unobserved buckets
  interpolate from the nearest observed bucket's fixed+per-row split.
* :func:`choose_batches` — the chooser: a dynamic program over arrival-
  order cut points that minimizes the estimated total service time of
  the call's queue, with DEADLINE PRESSURE breaking ties (packings
  within one cost epsilon prefer fewer estimated deadline overruns,
  then earlier completion of deadline-carrying requests).  Buckets are
  chosen ONLY through the engine-supplied ``bucket_for`` callable (the
  engine's ``_bucket_for`` ladder), so the chooser never emits a batch
  shape ``warmup()`` did not run.
* :func:`should_dispatch` — the streaming quantum rule for
  ``ServeEngine.submit()``: dispatch the pending partial batch NOW when
  it fills the largest warmed bucket, when the oldest request has waited
  a full quantum, or when one more quantum of waiting would jeopardize
  an admitted deadline; otherwise wait one quantum to fill a larger
  bucket.
* :class:`ReplicaRouter` — least-estimated-completion-time routing
  across replica groups: each lane tracks an estimated busy-until
  horizon; a faulted lane is DRAINED (marked degraded, removed from
  routing, visible in ``/healthz``) and its traffic re-routes to
  surviving lanes.  No backend of the port has replicas yet; the router
  comes with its module.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch import telemetry
from raft_tpu_torch.core.error import expects

#: default scheduler quantum: how long a partial batch may wait for more
#: arrivals before it dispatches anyway (streaming ``submit()`` path)
DEFAULT_QUANTUM_S = 0.002

#: EWMA blend for per-bucket cost observations (matches the admission
#: controller's per-batch EWMA so the two models converge alike)
EWMA_KEEP = 0.7

#: two packings within this relative cost of each other are "tied" —
#: deadline pressure (overruns, then completion of deadline-carrying
#: requests) breaks the tie, per the scheduler contract
COST_TIE_REL = 0.05


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching knobs (``ServeEngine(scheduler=...)``).

    ``use_telemetry=False`` pins the cost model to *static_batch_s* for
    every bucket — the chooser then degenerates to the drain-all packing
    (fewest batches), which is what makes deterministic tests and A/B
    baselines possible."""

    quantum_s: float = DEFAULT_QUANTUM_S
    static_batch_s: float = 0.05
    use_telemetry: bool = True


class CostModel:
    """Per-(dtype, bucket) super-batch service-time estimates for ONE
    engine's backend program.

    Estimate precedence per bucket: the bucket's own observed EWMA →
    interpolation from observed buckets (fixed + per-row decomposition
    when two buckets are observed, proportional scaling from one) → the
    registry seed (``raft_tpu_device_seconds{fn}`` p50, then the merged
    per-signature dispatch-latency rows) → the static fallback.  The
    engine feeds :meth:`observe` after every collected super-batch, so
    the model self-corrects from served traffic exactly like the
    admission EWMA does."""

    def __init__(self, fn: Optional[str] = None,
                 static_batch_s: float = 0.05,
                 use_telemetry: bool = True):
        self._fn = fn
        self.static_batch_s = float(static_batch_s)
        self.use_telemetry = bool(use_telemetry)
        self._ewma: Dict[Tuple[str, int], float] = {}

    def bind_fn(self, fn: Optional[str]) -> None:
        """Re-point the registry seed at a new backend program (refresh)."""
        self._fn = fn

    def rows(self) -> Dict[Tuple[str, int], float]:
        """The observed per-(dtype, bucket) EWMA rows — what the engine
        persists through ``core.coststore`` at close() so the next
        process's first scheduler decisions use real costs."""
        return dict(self._ewma)

    def seed_rows(self, rows: Dict[Tuple[str, int], float]) -> int:
        """Seed ABSENT per-(dtype, bucket) rows from a persisted snapshot;
        live observations already made take precedence, rows that are not
        positive are dropped.  Returns the number of rows seeded."""
        n = 0
        for (dt, b), v in rows.items():
            key = (str(dt), int(b))
            if key not in self._ewma and float(v) > 0.0:
                self._ewma[key] = float(v)
                n += 1
        return n

    def observe(self, dtype: str, bucket: int, wall_s: float) -> None:
        """One collected super-batch's end-to-end wall time."""
        if wall_s <= 0.0:
            return
        key = (str(dtype), int(bucket))
        prev = self._ewma.get(key)
        self._ewma[key] = (wall_s if prev is None
                           else EWMA_KEEP * prev + (1 - EWMA_KEEP) * wall_s)

    def _seed(self) -> Optional[float]:
        """The registry's per-batch estimate for the backend program —
        sampled device seconds p50 first, merged host dispatch-latency
        rows second (the admission controller's precedence)."""
        if not self._fn:
            return None
        dev = telemetry.REGISTRY.get("raft_tpu_device_seconds")
        if dev is not None:
            q = dev.quantile(0.5, (self._fn,))
            if q is not None:
                return float(q)
        disp = telemetry.REGISTRY.get("raft_tpu_aot_dispatch_seconds")
        if disp is not None:
            q = telemetry.merged_quantile(disp, 0.5, (self._fn,))
            if q is not None:
                return float(q)
        return None

    def batch_cost_s(self, dtype: str, bucket: int) -> float:
        """Estimated seconds to serve one *bucket*-shaped super-batch."""
        if not self.use_telemetry:
            return self.static_batch_s
        dtype = str(dtype)
        bucket = int(bucket)
        exact = self._ewma.get((dtype, bucket))
        if exact is not None:
            return exact
        # list(): one atomic copy, since the scheduler thread reads while
        # a search() observes
        observed = sorted((b, v) for (dt, b), v in list(self._ewma.items())
                          if dt == dtype)
        if len(observed) >= 2:
            # fixed + per-row decomposition from the two nearest buckets
            (b0, c0), (b1, c1) = observed[0], observed[-1]
            per_row = max(0.0, (c1 - c0) / float(b1 - b0))
            fixed = max(0.0, c0 - per_row * b0)
            return fixed + per_row * bucket
        if len(observed) == 1:
            b0, c0 = observed[0]
            # one observation: scale the rows term, keep half as overhead
            return c0 * (0.5 + 0.5 * bucket / float(b0))
        seed = self._seed()
        return self.static_batch_s if seed is None else seed


def choose_batches(sizes: Sequence[int],
                   deadlines: Sequence[Optional[float]],
                   bucket_for: Callable[[int], int],
                   max_bucket: int,
                   cost: CostModel,
                   dtype: str,
                   now: float,
                   ) -> Tuple[List[List[Tuple[int, int, int]]], List[int]]:
    """The continuous-batching chooser: partition the arrival-order queue
    into super-batches minimizing estimated total service time under the
    live cost model, deadlines breaking ties.

    Same contract as the drain-all planner it replaces: returns
    ``(batches, solo)`` where each batch is ``[(request_idx, start_row,
    n_rows), ...]`` with total rows ≤ *max_bucket* and ``solo`` lists
    requests too large for any warmed bucket.  Requests stay in arrival
    order and batches are contiguous cuts of it, so per-request results
    remain bit-identical to solo dispatch regardless of where the cuts
    land (every row's result is independent of its batch).  Every
    batch's bucket is chosen through *bucket_for* — the engine's ladder —
    never computed here, which keeps the chooser inside the warmed
    buckets.

    The DP is over cut points: ``best[i]`` is the cheapest dispatch plan
    for the first *i* packable requests, compared by (total cost, then —
    within ``COST_TIE_REL`` — deadline overrun, then deadline-weighted
    completion).  With a flat cost model (cold start, or
    ``use_telemetry=False``) minimizing total cost minimizes the number
    of batches, which is exactly the drain-all packing.
    """
    expects(len(sizes) == len(deadlines),
            "choose_batches: one deadline slot per request")
    items: List[Tuple[int, int]] = []   # (request_idx, rows), packable
    solo: List[int] = []
    for j, n in enumerate(sizes):
        if n > max_bucket:
            solo.append(j)
        else:
            items.append((j, int(n)))
    if not items:
        return [], solo

    n_items = len(items)
    bucket_cost: Dict[int, float] = {}  # per-plan memo of the ladder costs

    def cost_of(total: int) -> Tuple[int, float]:
        bucket = bucket_for(total)
        c = bucket_cost.get(bucket)
        if c is None:
            c = cost.batch_cost_s(dtype, bucket)
            bucket_cost[bucket] = c
        return bucket, c

    # best[i] = (cost_s, overrun_s, weighted_s, cut_index)
    best: List[Tuple[float, float, float, int]] = [(0.0, 0.0, 0.0, -1)]
    for i in range(1, n_items + 1):
        cand: Optional[Tuple[float, float, float, int]] = None
        total = 0
        window_dls: List[float] = []  # deadlines within items[cut:i]
        for cut in range(i - 1, -1, -1):
            j, rows = items[cut]
            total += rows
            if total > max_bucket:
                break
            dl = deadlines[j]
            if dl is not None:
                window_dls.append(dl)
            _bucket, batch_cost = cost_of(total)
            prev = best[cut]
            cost_s = prev[0] + batch_cost
            overrun = 0.0
            weighted = 0.0
            for dl in window_dls:  # empty for deadline-less traffic
                weighted += cost_s
                late = (now + cost_s) - dl
                if late > 0.0:
                    overrun += late
            entry = (cost_s, prev[1] + overrun, prev[2] + weighted, cut)
            if cand is None:
                cand = entry
            else:
                # primary: total cost; within the tie epsilon the
                # deadline terms decide (pressure breaks ties)
                if entry[0] < cand[0] * (1.0 - COST_TIE_REL):
                    cand = entry
                elif entry[0] <= cand[0] * (1.0 + COST_TIE_REL):
                    if (entry[1], entry[2], entry[0]) < (cand[1], cand[2],
                                                         cand[0]):
                        cand = entry
        best.append(cand)

    # reconstruct the cuts back-to-front
    cuts: List[Tuple[int, int]] = []
    i = n_items
    while i > 0:
        cut = best[i][3]
        cuts.append((cut, i))
        i = cut
    cuts.reverse()
    batches: List[List[Tuple[int, int, int]]] = []
    for lo, hi in cuts:
        start = 0
        members = []
        for j, rows in items[lo:hi]:
            members.append((j, start, rows))
            start += rows
        batches.append(members)
    return batches, solo


def should_dispatch(pending_rows: int, largest_bucket: int,
                    oldest_age_s: float, quantum_s: float,
                    deadlines: Sequence[Optional[float]], now: float,
                    est_batch_s: float) -> bool:
    """The streaming quantum decision (``ServeEngine.submit()`` loop):
    dispatch the pending partial batch NOW, or wait one more quantum to
    fill a larger bucket?

    Dispatch now when (a) the queue already fills the largest warmed
    bucket (waiting cannot improve the packing), (b) the oldest pending
    request has waited a full quantum (bounded added latency — the
    continuous-batching contract), or (c) one more quantum of waiting
    plus the estimated batch service time would push any admitted
    deadline past its budget (deadline pressure overrides batching
    greed).  Otherwise wait."""
    if pending_rows <= 0:
        return False
    if pending_rows >= largest_bucket:
        return True
    if oldest_age_s >= quantum_s:
        return True
    for dl in deadlines:
        if dl is not None and now + quantum_s + est_batch_s > dl:
            return True
    return False


class ReplicaRouter:
    """Least-estimated-completion-time routing over the replica lanes of
    a 2D (shard × replica) backend, with fault draining.

    Each lane tracks a host-clock ``busy_until`` horizon: picking a lane
    for a batch of estimated cost *est_s* extends its horizon, so
    concurrent super-batches spread across groups instead of convoying
    on one (the in-call analogue of least-outstanding-requests LB).  A
    lane marked :meth:`fault`-ed is DRAINED: it stops receiving traffic,
    ``/healthz`` lists it degraded, and :meth:`pick` routes only over
    survivors — zero failed requests as long as one lane lives.
    :meth:`drain` marks a lane degraded WITHOUT counting a fault (the
    operator/autotuner canary action).

    Between those extremes, each lane also keeps an observed service-time
    EWMA (fed by the engine's collect via :meth:`note_done`/
    :meth:`observe`): a SLOW-but-alive lane (a stalled host, a noisy
    neighbor) books its batches at ``est_s × slowness`` — its relative
    EWMA against the fastest live lane — so it sheds load GRADUALLY as it
    degrades and wins it back as it recovers, instead of flapping between
    the binary live/drained states.  Counters export per-lane
    dispatch/fault totals
    (``raft_tpu_serve_replica_{dispatch,faults}_total{engine,replica}``),
    the per-lane cost EWMA
    (``raft_tpu_serve_replica_cost_seconds{engine,replica}``) and a
    live-lane gauge (``raft_tpu_serve_replicas_live{engine}``)."""

    def __init__(self, n_lanes: int, engine_label: str = "?"):
        expects(n_lanes >= 1, "ReplicaRouter needs at least one lane")
        self.n_lanes = int(n_lanes)
        self._engine = str(engine_label)
        self._busy_until = [0.0] * self.n_lanes
        self._degraded = [False] * self.n_lanes
        #: per-lane observed service-time EWMA (None until first observed)
        self._cost_ewma: List[Optional[float]] = [None] * self.n_lanes
        self._cost_g = telemetry.gauge(
            "raft_tpu_serve_replica_cost_seconds",
            "per-lane observed super-batch service-time EWMA",
            labelnames=("engine", "replica"))
        self._dispatches = telemetry.counter(
            "raft_tpu_serve_replica_dispatch_total",
            "super-batches routed to each replica lane",
            labelnames=("engine", "replica"))
        self._faults = telemetry.counter(
            "raft_tpu_serve_replica_faults_total",
            "replica-lane dispatch failures observed by the router",
            labelnames=("engine", "replica"))
        self._live = telemetry.gauge(
            "raft_tpu_serve_replicas_live",
            "replica lanes currently routable", labelnames=("engine",))
        self._live.set(self.n_lanes, (self._engine,))

    def alive_lanes(self) -> List[int]:
        return [i for i in range(self.n_lanes) if not self._degraded[i]]

    def pick(self, now: float, est_s: float,
             exclude: Sequence[int] = ()) -> Optional[int]:
        """The lane with the least estimated completion time for one more
        batch (None when every lane is drained/excluded).  Picking books
        the batch onto the lane's horizon."""
        best_lane, best_done = None, 0.0
        for i in self.alive_lanes():
            if i in exclude:
                continue
            done = max(self._busy_until[i], now) + est_s * self.slowness(i)
            if best_lane is None or done < best_done:
                best_lane, best_done = i, done
        if best_lane is not None:
            self._busy_until[best_lane] = best_done
            self._dispatches.inc(1, (self._engine, str(best_lane)))
        return best_lane

    def slowness(self, lane: int) -> float:
        """The lane's observed cost relative to the FASTEST live lane
        (≥ 1.0; 1.0 while unobserved) — the gradual-shedding weight
        :meth:`pick` books batches at."""
        mine = self._cost_ewma[lane]
        if mine is None:
            return 1.0
        floor = min((self._cost_ewma[i] for i in self.alive_lanes()
                     if self._cost_ewma[i] is not None),
                    default=None)
        if floor is None or floor <= 0.0:
            return 1.0
        return max(1.0, mine / floor)

    def observe(self, lane: int, wall_s: float) -> None:
        """One collected batch's observed service time on *lane* → the
        lane's cost EWMA (the gradual-shedding signal)."""
        if wall_s <= 0.0:
            return
        prev = self._cost_ewma[lane]
        self._cost_ewma[lane] = (
            wall_s if prev is None
            else EWMA_KEEP * prev + (1 - EWMA_KEEP) * wall_s)
        self._cost_g.set(self._cost_ewma[lane],
                         (self._engine, str(lane)))

    def note_done(self, lane: int, now: float,
                  wall_s: Optional[float] = None) -> None:
        """A lane's batch collected: clamp its horizon to the present so
        stale over-estimates do not starve it; *wall_s* (when the caller
        measured it) feeds the lane's cost EWMA."""
        if self._busy_until[lane] > now:
            self._busy_until[lane] = now
        if wall_s is not None:
            self.observe(lane, wall_s)

    def drain(self, lane: int) -> None:
        """Administratively drain *lane* (no fault counted): the
        autotuner's shadow-canary lane, an operator's maintenance drain.
        :meth:`restore` un-drains."""
        if not self._degraded[lane]:
            self._degraded[lane] = True
            self._live.set(len(self.alive_lanes()), (self._engine,))

    def fault(self, lane: int) -> None:
        """Drain *lane*: no further traffic routes to it; visible as
        degraded in the router's health view."""
        self._faults.inc(1, (self._engine, str(lane)))
        if not self._degraded[lane]:
            self._degraded[lane] = True
            self._live.set(len(self.alive_lanes()), (self._engine,))

    def restore(self, lane: int) -> None:
        """Un-drain *lane* (an operator action after replacing the
        replica; the engine never restores on its own)."""
        if self._degraded[lane]:
            self._degraded[lane] = False
            self._live.set(len(self.alive_lanes()), (self._engine,))

    def degraded_lanes(self) -> List[int]:
        return [i for i in range(self.n_lanes) if self._degraded[i]]

    def health(self) -> Dict[str, object]:
        """The ``/healthz`` replicas sub-object."""
        return {"total": self.n_lanes,
                "live": len(self.alive_lanes()),
                "degraded": self.degraded_lanes()}
