"""Online serving autotuner: shadow-canary knob search with atomic
promotion and guarded rollback (port of ``raft_tpu/serve/autotune.py``;
the same candidate space, schedule seeds, coverage rule, recall floor,
successive halving and paired-win rule, so the same seed and the same
measurements give the same decisions).

* **Nothing built or warmed while exploring.**  The candidate space comes
  from the engine's warmed ladder (:meth:`ServeEngine.warmed_signatures`):
  bucket-cap candidates are warmed buckets, and params candidates
  (``n_probes``, ``refine_ratio``, …) get their own backend, run once at
  every warmed bucket by :meth:`AutoTuner.warm_candidates` before any
  shadow traffic flows.  On the card that means: from
  ``warm_candidates()`` on no kernel library is built or loaded
  (``kernels.native.BUILDS``), and ``explore()``, ``promote()`` and
  ``maybe_rollback()`` add no warmed signature.
* **Shadow evaluation off the serving path.**  Candidates replay shadow
  traffic — a seeded sample of the engine's shadow ring of recent
  requests, topped up from the traffic-plan DSL
  (:mod:`raft_tpu_torch.serve.traffic`) — through their own warmed
  backend, or, for knob candidates, through the live backend with each
  super-batch dispatched and fetched under the engine lock, so a live
  ``search()`` waits behind at most one shadow super-batch and is never
  shed or failed.  Each replay fetches its results to the host, so its
  qps and p99 are wall times of finished work.  A replica engine's tuner
  may take a ``shadow_lane``: :meth:`AutoTuner.explore` drains that lane
  through the engine's router (live requests route around it and none
  fails), replays knob candidates on it through the leader's protocol,
  and restores it after.  Scores are qps and p99
  under a recall-probe floor (:func:`exact_reference` for an exact
  oracle; the live config's own ids by default).
* **Atomic promotion, guarded rollback.**  A winner of successive halving
  is promoted only on a paired win in every pair; params swap through
  ``ServeEngine.refresh``, host knobs through
  ``ServeEngine.apply_tuning``.  Within ``rollback_window_s`` a live p99
  above ``rollback_p99_rel`` × the pre-promotion p99 reverts the whole
  decision, the warmed ladder included.  With no pre-promotion p99 the
  guard cannot arm: the promotion applies and
  ``raft_tpu_autotune_guard_disarmed_total`` counts it.

Every decision exports through the ``raft_tpu_autotune_*`` counters and
gauges and through the engine's ``/healthz`` ``autotune`` object.  The
replay groups requests by type and replays each type on its own ladder.
Params candidates need a backend of their own, which a distributed
engine's followers do not build: over a sharded or replica engine only
knob candidates are explored (params promote through ``refresh``, which
every rank runs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.serve import spmd
from raft_tpu_torch.serve.schedule import choose_batches

#: decision labels exported via raft_tpu_autotune_decisions_total
DECISIONS = ("promote", "reject", "rollback")


@dataclasses.dataclass(frozen=True)
class TunerConfig:
    """The autotuner's knobs (all decisions derive from ``seed``)."""

    #: candidate-schedule and shadow-sampling seed
    seed: int = 0
    #: shadow requests per evaluation in round 0 (grows ×eta per round)
    shadow_requests: int = 24
    #: successive-halving factor: keep len//eta candidates per round and
    #: multiply the shadow budget by eta
    eta: int = 2
    #: paired candidate/baseline replays per evaluation (each pair
    #: replays the SAME request set through both configs back to back)
    pairs: int = 3
    #: the candidate must beat the baseline objective by this relative
    #: margin in EVERY pair to promote
    min_win_rel: float = 0.10
    #: "equal p99 / equal qps" tolerance for the win rule's held axis
    slack_rel: float = 0.10
    #: a candidate whose probe recall drops below this is rejected
    recall_floor: float = 0.95
    #: requests spot-checked against the recall reference per evaluation
    recall_probes: int = 4
    #: bound on the derived candidate set (seeded subsample above it)
    max_candidates: int = 16
    #: live-p99 guard window after a promotion
    rollback_window_s: float = 30.0
    #: rollback when live p99 exceeds this multiple of the pre-promotion
    #: p99 inside the window
    rollback_p99_rel: float = 1.5


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the bounded knob space.  ``params`` is a backend
    ``SearchParams`` variant (promoted through ``refresh``);
    ``max_batch`` caps the planner's ladder at a warmed bucket;
    ``quantum_s`` retunes the streaming scheduler; ``engine`` is a kernel
    engine for a params candidate's backend, which must be the live one
    (the plain ``"torch"`` versions never serve on the card).  ``None``
    fields keep the serving value."""

    name: str
    params: Any = None
    max_batch: Optional[int] = None
    quantum_s: Optional[float] = None
    engine: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Score:
    """One shadow evaluation's measurements.  ``served`` is the fraction
    of the request set the candidate could serve inside its warmed
    ladder (the coverage rule)."""

    qps: float
    p99_s: float
    recall: float
    served: float = 1.0


#: the no-change candidate every pair measures against
BASELINE = Candidate("baseline")


def exact_reference(dataset, k: int, device=None
                    ) -> Callable[[np.ndarray], np.ndarray]:
    """An exact brute-force recall oracle over *dataset*, on *device*
    (default: the card): the port's ``brute_force.knn``, ids on the
    host."""
    from raft_tpu_torch.core.handle import resolve_device
    from raft_tpu_torch.distance.pairwise import as_input
    from raft_tpu_torch.neighbors import brute_force

    index = as_input(dataset, resolve_device(device))

    def _ref(q: np.ndarray) -> np.ndarray:
        _d, i = brute_force.knn(index, q, k, device=index.device)
        # exempt(hot-path-host-transfer): reference ids of a shadow replay, off the path
        return i.cpu().numpy()
    return _ref


class AutoTuner:
    """Online shadow-canary tuner for one :class:`ServeEngine`.

    Lifecycle: :meth:`warm_candidates` (the only stage that may build or
    warm) → :meth:`explore` (successive halving over shadow replays) →
    :meth:`promote` on a paired win → :meth:`maybe_rollback` while the
    guard window is open.  :meth:`run` chains the first three.
    Constructing the tuner attaches it to the engine's ``/healthz``."""

    def __init__(self, engine, config: Optional[TunerConfig] = None, *,
                 param_variants: Sequence[Any] = (),
                 extra_candidates: Sequence[Candidate] = (),
                 shadow_plan: Optional[Any] = None,
                 shadow_lane: Optional[int] = None,
                 reference: Optional[Callable[[np.ndarray],
                                              np.ndarray]] = None,
                 measure: Optional[Callable[[Candidate, List[np.ndarray]],
                                            Score]] = None):
        if shadow_lane is not None:
            router = getattr(engine, "_router", None)
            expects(router is not None
                    and 0 <= int(shadow_lane) < router.n_lanes,
                    f"shadow_lane={shadow_lane}: needs a replica engine "
                    "with that lane")
        #: replica engines: the drained lane shadow replays dispatch to
        self._shadow_lane = (None if shadow_lane is None
                             else int(shadow_lane))
        self.engine = engine
        self.cfg = config or TunerConfig()
        expects(self.cfg.eta >= 2, "TunerConfig.eta must be >= 2")
        expects(self.cfg.pairs >= 1, "TunerConfig.pairs must be >= 1")
        self._variants = tuple(param_variants)
        self._extra = tuple(extra_candidates)
        #: a traffic-plan string (serve.traffic) or a callable
        #: ``(seed, n, dim, dtype) -> [arrays]`` supplying synthetic fill
        self._plan = shadow_plan
        self._reference = reference
        self._measure = measure or self._measure_real
        #: name -> warmed off-path backend (params candidates only)
        self._shadow: Dict[str, Any] = {}
        #: the evaluation order actually executed: (round, candidate)
        self.schedule: List[Tuple[int, str]] = []
        #: every decision taken: (candidate, decision, why)
        self.decisions: List[Tuple[str, str, str]] = []
        self._promoted: Optional[Candidate] = None
        self._previous: Optional[Dict[str, Any]] = None
        self._promoted_at = 0.0
        self._pre_p99: Optional[float] = None
        #: the warmed ladder before the promotion (a rollback restores it)
        self._pre_warmed: Dict[str, List[int]] = {}
        #: True iff the open rollback window has a live pre-promotion p99
        self._guard_armed = False
        self._label = (getattr(engine, "_engine_id", "?"),)
        self._evals = telemetry.counter(
            "raft_tpu_autotune_evals_total",
            "shadow evaluations executed per candidate",
            labelnames=("engine", "candidate"))
        self._decisions_c = telemetry.counter(
            "raft_tpu_autotune_decisions_total",
            "tuner decisions by kind (promote/reject/rollback)",
            labelnames=("engine", "decision"))
        self._rounds = telemetry.counter(
            "raft_tpu_autotune_rounds_total",
            "successive-halving rounds executed",
            labelnames=("engine",))
        self._skipped = telemetry.counter(
            "raft_tpu_autotune_shadow_skipped_total",
            "shadow requests skipped (rows above the warmed ladder cap)",
            labelnames=("engine",))
        self._guard_disarmed = telemetry.counter(
            "raft_tpu_autotune_guard_disarmed_total",
            "promotions with no live pre-promotion p99 baseline: the "
            "rollback guard could not arm",
            labelnames=("engine",))
        self._exploring = telemetry.gauge(
            "raft_tpu_autotune_exploring",
            "1 while a tune cycle's explore phase is running",
            labelnames=("engine",))
        self._qps_g = telemetry.gauge(
            "raft_tpu_autotune_qps",
            "best-pair shadow qps per candidate",
            labelnames=("engine", "candidate"))
        self._p99_g = telemetry.gauge(
            "raft_tpu_autotune_p99_seconds",
            "best-pair shadow p99 per candidate",
            labelnames=("engine", "candidate"))
        self._recall_g = telemetry.gauge(
            "raft_tpu_autotune_recall",
            "worst-pair probe recall per candidate",
            labelnames=("engine", "candidate"))
        engine.attach_tuner(self)

    # -- candidate space ----------------------------------------------------
    def candidates(self) -> List[Candidate]:
        """The bounded candidate space, from the engine's warmed ladder:
        the baseline, one cap per warmed bucket other than the serving
        cap, one candidate per ``param_variants`` entry, then
        ``extra_candidates``; above ``max_candidates`` a seeded
        subsample."""
        eng = self.engine
        sigs = eng.warmed_signatures()
        buckets = sorted({b for bs in sigs.values() for b in bs})
        expects(buckets, "candidates() before warmup(): the ladder is "
                         "empty, there is nothing warmed to explore")
        out: List[Candidate] = [BASELINE]
        for b in buckets:
            if b != eng.max_batch:
                out.append(Candidate(f"cap{b}", max_batch=b))
        for i, p in enumerate(self._variants):
            out.append(Candidate(f"params{i}", params=p))
        out.extend(self._extra)
        if len(out) > self.cfg.max_candidates:
            rng = np.random.default_rng(self.cfg.seed)
            tail = out[1:]
            keep = rng.choice(len(tail), size=self.cfg.max_candidates - 1,
                              replace=False)
            out = [out[0]] + [tail[i] for i in sorted(keep)]
        return out

    # -- pre-warm -----------------------------------------------------------
    def _candidate_engine(self, cand: Candidate) -> Optional[str]:
        """The kernel engine of a params candidate's backend: the live
        engine's, and only that one (LogicError otherwise)."""
        from raft_tpu_torch.kernels.engine import resolve_engine

        eng = self.engine
        live = eng._ctor["engine"]
        if cand.engine is None:
            return live
        dev = eng._backend.device
        expects(not (cand.engine == "torch" and dev.type == "cuda"),
                f"candidate {cand.name}: engine='torch' would serve the "
                "plain versions on the card")
        expects(cand.engine == resolve_engine("select_k", dev, engine=live),
                f"candidate {cand.name}: engine={cand.engine!r} differs "
                "from the live engine's")
        return live

    def warm_candidates(self) -> int:
        """Build every params candidate's backend and run it at every
        warmed bucket — the ONE tuner stage allowed to build or warm, as
        ``warmup()`` and ``refresh()`` are, off the request path.  Returns
        the number of signatures warmed."""
        from raft_tpu_torch.serve.engine import DTYPES, _make_backend, _warm

        eng = self.engine
        sigs = eng.warmed_signatures()
        c = dict(eng._ctor)
        n = 0
        for cand in self.candidates():
            if cand.params is None or cand.name in self._shadow:
                continue
            expects(not eng._backend.distributed,
                    f"candidate {cand.name}: params candidates of a "
                    "distributed engine would need a backend on every "
                    "rank — explore knob candidates there")
            be = _make_backend(eng.index, c["k"], cand.params,
                               self._candidate_engine(cand), c["metric"],
                               c["metric_arg"], c["batch_size_index"],
                               c["device"])
            for dt, bs in sigs.items():
                _warm(be, bs, DTYPES[dt])
                n += len(bs)
            self._shadow[cand.name] = be
        return n

    # -- shadow traffic -----------------------------------------------------
    def shadow_traffic(self, n: int, seed: int) -> List[np.ndarray]:
        """*n* shadow request arrays: a seeded sample of the engine's
        shadow ring (without replacement), topped up from the traffic
        plan when the ring cannot fill the budget."""
        from raft_tpu_torch.serve.traffic import traffic_requests

        rng = np.random.default_rng(seed)
        live = self.engine.shadow_samples()
        reqs: List[np.ndarray] = []
        if live:
            take = min(n, len(live))
            idx = rng.choice(len(live), size=take, replace=False)
            reqs = [live[i] for i in idx]
        fill = n - len(reqs)
        if fill > 0 and self._plan is not None:
            dim = self.engine._backend.dim
            if callable(self._plan):
                reqs.extend(self._plan(seed, fill, dim, "float32"))
            else:
                reqs.extend(traffic_requests(str(self._plan), seed, fill,
                                             dim, "float32"))
        return reqs

    # -- measurement --------------------------------------------------------
    @staticmethod
    def objective(s: Score) -> float:
        """The scalar ranking objective within a halving round: qps per
        unit p99."""
        return s.qps / max(s.p99_s, 1e-9)

    def paired_win(self, cand: Sequence[Score],
                   base: Sequence[Score]) -> bool:
        """In EVERY pair the candidate must win qps by ``min_win_rel`` at
        no-worse p99 (within ``slack_rel``), or win p99 by
        ``min_win_rel`` at no-worse qps."""
        cfg = self.cfg
        for cs, bs in zip(cand, base):
            qps_win = (cs.qps >= (1.0 + cfg.min_win_rel) * bs.qps
                       and cs.p99_s <= bs.p99_s * (1.0 + cfg.slack_rel))
            p99_win = (cs.p99_s * (1.0 + cfg.min_win_rel) <= bs.p99_s
                       and cs.qps >= bs.qps * (1.0 - cfg.slack_rel))
            if not (qps_win or p99_win):
                return False
        return True

    def _dispatch(self, be, block: torch.Tensor,
                  lane: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """One shadow super-batch: the host block dispatched (a
        distributed backend's on replica lane *lane*, through the leader's
        protocol) and its results fetched to the host.  A params
        candidate's own backend runs unlocked; the LIVE backend runs under
        the engine lock, dispatch and fetch together, so a live
        ``search()`` waits behind at most this one super-batch."""
        eng = self.engine

        def run():
            if be.distributed:
                r = be.dispatch(block, lane or 0)
            else:
                r = be.dispatch(block.to(be.device))
            d, i = r.result() if isinstance(r, spmd.Pending) else r
            # exempt(hot-path-host-transfer): shadow replay results, fetched off the path
            return d.cpu().numpy(), i.cpu().numpy()

        if be is not eng._backend:
            return run()
        with eng._lock:
            return run()

    def _measure_real(self, cand: Candidate, requests: List[Any]) -> Score:
        """Replay *requests* through the candidate's lane — its own warmed
        backend for a params candidate, the live backend's warmed buckets
        otherwise (on the drained ``shadow_lane`` of a replica engine) —
        and measure (qps, p99, probe recall), never through admission or
        the router."""
        expects(requests, "no shadow traffic: serve some requests first "
                          "or pass shadow_plan=")
        eng = self.engine
        be = self._shadow.get(cand.name)
        lane = None
        if be is None:
            be = eng._backend
            lane = self._shadow_lane
        cap = cand.max_batch if cand.max_batch is not None \
            else eng.max_batch
        qps, p99, results, served = self._replay(be, requests, cap, lane)
        recall = self._recall_probe(requests, results, served)
        return Score(qps=qps, p99_s=p99, recall=recall,
                     served=len(served) / len(requests))

    def _replay(self, be, requests: List[Any], cap: int,
                lane: Optional[int] = None):
        """Coalesce and dispatch *requests* as the engine's plan stage
        does — per type, buckets only through ``_bucket_for`` over that
        type's warmed set capped at *cap* — each super-batch's results on
        the host before its requests count as done."""
        from raft_tpu_torch.serve.engine import dtype_name

        eng = self.engine
        sigs = eng.warmed_signatures()
        ingested = [be.ingest(q) for q in requests]
        results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = \
            [None] * len(requests)
        lat = [0.0] * len(requests)
        by_dtype: Dict[str, List[int]] = {}
        skipped = 0
        for j, q in enumerate(ingested):
            dt = dtype_name(q.dtype)
            warmed = {b for b in sigs.get(dt, ()) if b <= cap}
            if not warmed or q.shape[0] > max(warmed) or q.shape[0] == 0:
                skipped += 1   # never solo off-path
                continue
            by_dtype.setdefault(dt, []).append(j)
        if skipped:
            self._skipped.inc(skipped, self._label)
        t_start = telemetry.now()
        n_served = 0
        for dt, idxs in by_dtype.items():
            warmed = {b for b in sigs.get(dt, ()) if b <= cap}
            max_bucket = max(warmed)
            sizes = [int(ingested[j].shape[0]) for j in idxs]
            batches, _solo = choose_batches(
                sizes, [None] * len(sizes),
                lambda total, w=warmed: eng._bucket_for(total, w),
                max_bucket, eng._cost, dt, telemetry.now())
            for batch in batches:
                members = [(idxs[jj], start, n) for jj, start, n in batch]
                total = members[-1][1] + members[-1][2]
                bucket = eng._bucket_for(total, warmed)
                block = torch.zeros((bucket, be.dim),
                                    dtype=ingested[members[0][0]].dtype)
                for j, start, n in members:
                    block[start:start + n] = ingested[j]
                d, i = self._dispatch(be, block, lane)
                done = telemetry.now() - t_start
                for j, start, n in members:
                    results[j] = (d[start:start + n], i[start:start + n])
                    lat[j] = done
                    n_served += 1
        wall = max(telemetry.now() - t_start, 1e-9)
        served = [j for j in range(len(requests))
                  if results[j] is not None]
        expects(served, "shadow replay served nothing: every request "
                        "exceeded the warmed ladder cap")
        p99 = float(np.percentile([lat[j] for j in served], 99.0))
        return n_served / wall, p99, results, served

    def _recall_probe(self, requests, results, served) -> float:
        """Spot-check the first ``recall_probes`` served requests against
        the reference oracle (the live config's own ids by default)."""
        probes = served[:self.cfg.recall_probes]
        if not probes:
            return 1.0
        hit = tot = 0
        for j in probes:
            ids = results[j][1]
            if self._reference is not None:
                # exempt(hot-path-host-transfer): numpy reference ids
                ref_ids = np.asarray(self._reference(requests[j]))
            else:
                ref_ids = self._live_ids(requests[j])
            for row in range(ids.shape[0]):
                # exempt(hot-path-host-transfer): numpy ids of a recall count
                hit += len(set(ids[row].tolist())
                           # exempt(hot-path-host-transfer): numpy ids of a recall count
                           & set(ref_ids[row].tolist()))
                tot += ids.shape[1]
        return hit / max(tot, 1)

    def _live_ids(self, q) -> np.ndarray:
        """The serving config's own ids for one request, through the live
        backend's warmed ladder (on the shadow lane of a replica
        engine)."""
        from raft_tpu_torch.serve.engine import dtype_name

        eng = self.engine
        be = eng._backend
        qi = be.ingest(q)
        warmed = set(eng.warmed_signatures().get(dtype_name(qi.dtype), ()))
        bucket = eng._bucket_for(int(qi.shape[0]), warmed)
        block = torch.zeros((bucket, be.dim), dtype=qi.dtype)
        block[:qi.shape[0]] = qi
        return self._dispatch(be, block, self._shadow_lane)[1][:qi.shape[0]]

    # -- explore (successive halving) ---------------------------------------
    def explore(self) -> Optional[Candidate]:
        """Successive halving over the candidate set: every survivor is
        evaluated on the round's shadow budget, paired against the
        baseline on the SAME request sets; candidates below the recall
        floor or the baseline's coverage are rejected, the top ``1/eta``
        by min-over-pairs objective ratio survive, the budget grows
        ×eta.  Returns the winner iff it passes :meth:`paired_win`."""
        cands = [c for c in self.candidates() if c.name != BASELINE.name]
        for c in cands:
            expects(c.params is None or c.name in self._shadow,
                    "explore() before warm_candidates(): candidate "
                    f"{c.name} has no warmed shadow backend")
        if not cands:
            return None
        # the shadow lane takes no live traffic while the tuner replays
        # on it; a lane the router had drained already stays drained
        router = getattr(self.engine, "_router", None)
        drained = (self._shadow_lane is not None and router is not None
                   and self._shadow_lane not in router.degraded_lanes())
        if drained:
            router.drain(self._shadow_lane)
        self._exploring.set(1, self._label)
        try:
            return self._halve(cands)
        finally:
            self._exploring.set(0, self._label)
            if drained:
                router.restore(self._shadow_lane)

    def _halve(self, survivors: List[Candidate]) -> Optional[Candidate]:
        cfg = self.cfg
        budget = cfg.shadow_requests
        rnd = 0
        while survivors:
            self._rounds.inc(1, self._label)
            scored = []
            for ci, cand in enumerate(survivors):
                pc: List[Score] = []
                pb: List[Score] = []
                for p in range(cfg.pairs):
                    seed = (cfg.seed * 1000003 + rnd * 8191
                            + ci * 131 + p)
                    reqs = self.shadow_traffic(budget, seed)
                    pb.append(self._measure(BASELINE, reqs))
                    pc.append(self._measure(cand, reqs))
                self.schedule.append((rnd, cand.name))
                self._evals.inc(1, (self._label[0], cand.name))
                best = max(pc, key=self.objective)
                self._qps_g.set(best.qps, (self._label[0], cand.name))
                self._p99_g.set(best.p99_s, (self._label[0], cand.name))
                worst_recall = min(s.recall for s in pc)
                self._recall_g.set(worst_recall,
                                   (self._label[0], cand.name))
                ratio = min(self.objective(c)
                            / max(self.objective(b), 1e-12)
                            for c, b in zip(pc, pb))
                # the coverage rule: qps over a shrunken (skip-heavy)
                # request set is not a win
                covers = all(c.served >= b.served - 1e-9
                             for c, b in zip(pc, pb))
                recall_ok = worst_recall >= cfg.recall_floor
                why = ("recall floor" if not recall_ok
                       else "coverage" if not covers else "")
                scored.append((cand, pc, pb, recall_ok and covers,
                               ratio, why))
            for cand, _pc, _pb, ok, _r, why in scored:
                if not ok:
                    self._decide("reject", cand.name, why)
            viable = [t for t in scored if t[3]]
            if not viable:
                return None
            viable.sort(key=lambda t: (-t[4], t[0].name))
            if len(viable) == 1:
                return self._final(viable[0])
            keep = max(1, len(viable) // cfg.eta)
            for cand, *_ in viable[keep:]:
                self._decide("reject", cand.name, "halved")
            survivors = [t[0] for t in viable[:keep]]
            if len(survivors) == 1:
                return self._final(viable[0])
            budget *= cfg.eta
            rnd += 1
        return None

    def _final(self, entry) -> Optional[Candidate]:
        cand, pc, pb, _ok, _ratio, _why = entry
        if not self.paired_win(pc, pb):
            self._decide("reject", cand.name, "no paired win")
            return None
        return cand

    # -- promotion / rollback ------------------------------------------------
    def promote(self, cand: Candidate) -> Dict[str, Any]:
        """Apply *cand*: params through ``ServeEngine.refresh`` (its
        backend's buckets were warmed by :meth:`warm_candidates`), host
        knobs through ``ServeEngine.apply_tuning``.  Records the rollback
        token and the live p99 baseline and opens the guard window (with
        no baseline the guard cannot arm: counted and reported).  The
        admission controller's observed cost resets.  Returns the
        previous config (the rollback token)."""
        eng = self.engine
        pre_p99 = eng.latency_quantiles((0.99,))[0]
        prev_params = eng._ctor["params"]
        pre_cap = eng.max_batch
        pre_warmed = eng.warmed_signatures()
        cap = cand.max_batch
        if cand.params is not None:
            eng.refresh(eng.index, params=cand.params)
            if cap is None:
                # refresh() re-derives the cap from the construction
                # bound: a cap an earlier cycle promoted survives, unless
                # the new params' batch cap (IVF-PQ's
                # hoisted_batch_cap) lies below it
                cap = min(pre_cap, eng.max_batch)
        prev = eng.apply_tuning(quantum_s=cand.quantum_s,
                                max_batch=cap if cap is not None
                                else pre_cap)
        prev["max_batch"] = pre_cap   # the true pre-promotion cap
        adm = eng._admission
        if adm is not None:
            adm.reset_observed()
        self._promoted = cand
        self._previous = dict(prev, params=prev_params)
        self._pre_warmed = pre_warmed
        self._promoted_at = telemetry.now()
        self._pre_p99 = pre_p99
        self._guard_armed = pre_p99 is not None and pre_p99 > 0.0
        if not self._guard_armed:
            self._guard_disarmed.inc(1, self._label)
        self._decide("promote", cand.name, "paired win")
        return dict(self._previous)

    def maybe_rollback(self, live_p99_s: Optional[float] = None) -> bool:
        """Within ``rollback_window_s`` of a promotion, a live p99 above
        ``rollback_p99_rel`` × the pre-promotion p99 reverts it: params
        back through ``refresh`` (the token's params verbatim, ``None``
        included), buckets a params promotion dropped warmed again, knobs
        back through ``apply_tuning``.  *live_p99_s* defaults to the p99
        of the engine's last ``search()`` call.  Returns True iff a
        rollback happened; once the window closes, or for a promotion
        whose guard never armed, the promotion is accepted."""
        cfg = self.cfg
        eng = self.engine
        if self._promoted is None:
            return False
        if not self._guard_armed:
            self._promoted = None   # unguarded promotion: accepted as-is
            return False
        now = telemetry.now()
        if now - self._promoted_at > cfg.rollback_window_s:
            self._promoted = None   # window closed: promotion accepted
            return False
        if live_p99_s is None:
            lats = eng.last_latencies
            if not lats:
                return False
            live_p99_s = float(np.percentile(lats, 99.0))
        pre = self._pre_p99
        if live_p99_s <= cfg.rollback_p99_rel * pre:
            return False
        prev = self._previous or {}
        name = self._promoted.name
        if self._promoted.params is not None:
            eng.refresh(eng.index, params=prev.get("params"))
            # a variant whose batch cap lay below the ladder made refresh
            # drop the buckets above it: warm them again, so the ladder
            # is the pre-promotion one
            now_warmed = eng.warmed_signatures()
            for dt, bs in self._pre_warmed.items():
                lost = sorted(set(bs) - set(now_warmed.get(dt, ())))
                if lost:
                    eng.warmup(lost, dtypes=(dt,))
        eng.apply_tuning(quantum_s=prev.get("quantum_s"),
                         max_batch=prev.get("max_batch"))
        adm = eng._admission
        if adm is not None:
            adm.reset_observed()
        self._promoted = None
        self._decide("rollback", name,
                     f"live p99 {live_p99_s:.4f}s > "
                     f"{cfg.rollback_p99_rel}x pre-promotion {pre:.4f}s")
        return True

    def run(self) -> Dict[str, Any]:
        """One full tune cycle: warm → explore → promote on a paired win.
        Returns a report (winner, schedule, decisions)."""
        self.warm_candidates()
        winner = self.explore()
        if winner is not None:
            self.promote(winner)
        return {"winner": winner.name if winner is not None else None,
                "schedule": list(self.schedule),
                "decisions": list(self.decisions)}

    # -- reporting ----------------------------------------------------------
    def _decide(self, decision: str, candidate: str, why: str = "") -> None:
        self.decisions.append((candidate, decision, why))
        self._decisions_c.inc(1, (self._label[0], decision))

    def health(self) -> Dict[str, Any]:
        """The engine ``/healthz`` ``autotune`` sub-object (JSON-safe)."""
        return {
            "seed": self.cfg.seed,
            "evaluations": len(self.schedule),
            "decisions": [list(d) for d in self.decisions[-8:]],
            "promoted": (self._promoted.name
                         if self._promoted is not None else None),
            # open means ARMED: an unguarded promotion must not advertise
            # a guard window it cannot enforce
            "rollback_window_open": (self._promoted is not None
                                     and self._guard_armed),
        }
