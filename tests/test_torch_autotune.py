"""The port's online autotuner against ``raft_tpu.serve.autotune``.

Parity (exact, no tolerance): over one IVF-Flat index the JAX package
built and the port carries across, two engines with the same warmed
buckets and the same served requests give, from the same seed and the
same injected ``measure=``, the same candidate space, the same shadow
traffic, the same halving schedule and the same decisions; ``objective``
and ``paired_win`` agree with the JAX functions on seeded scores;
``traffic_requests`` equals ``bench/common.py``'s array for array.

Then the cases of ``tests/test_serve_autotune.py`` that need no replicas,
on CPU engines: the candidate space, determinism and the coverage rule,
exploration and promotion that build and warm nothing (results bit for
bit the solo search under the promoted config), shadow dispatch under
the engine lock, promote/rollback of caps and params with the guard
armed and disarmed, ``apply_tuning``'s refusals, a params variant whose
IVF-PQ batch cap lies below the warmed ladder, ``/healthz``'s
``autotune`` object, the router's cost EWMA, ``CostModel.seed_rows`` and
the close/reseed round trip through ``core.coststore``.
"""

import json
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import common as bench_common
from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.serve import AutoTuner as JaxTuner
from raft_tpu.serve import ServeEngine as JaxEngine
from raft_tpu.serve import TunerConfig as JaxConfig
from raft_tpu.serve.autotune import Score as JaxScore
from raft_tpu_torch import telemetry
from raft_tpu_torch.core import coststore
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.kernels import native
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.serve import (AutoTuner, Candidate, ServeEngine,
                                  TunerConfig)
from raft_tpu_torch.serve.autotune import BASELINE, Score, exact_reference
from raft_tpu_torch.serve.schedule import CostModel, ReplicaRouter
from raft_tpu_torch.serve.traffic import (BURST_PLAN, DIURNAL_PLAN,
                                          HEAVY_TAIL_PLAN, traffic_requests)

_DIM = 16
_K = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: with parallel test workers on the cores,
    PyTorch's spinning thread pool runs these small ops ~30× slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    return rng.normal(0, 1, (1024, _DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_index(corpus):
    return jax_ivf.build(jax_ivf.IndexParams(n_lists=8, kmeans_n_iters=4),
                         jnp.asarray(corpus))


@pytest.fixture(scope="module")
def fl_index(jax_index):
    arrays = {name: np.asarray(getattr(jax_index, name))
              for name in tivf.ARRAY_FIELDS}
    return tivf.index_from_arrays(arrays, int(jax_index.metric),
                                  device="cpu")


def _reqs(seed=1, sizes=(3, 7, 2, 6, 1, 5)):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (n, _DIM)).astype(np.float32) for n in sizes]


def _bf_engine(corpus, max_batch=32, **kw):
    eng = ServeEngine(corpus, _K, max_batch=max_batch, device="cpu", **kw)
    eng.warmup()
    return eng


def _knn_ids(corpus, q):
    return tbf.knn(corpus, q, _K, device="cpu")[1].numpy()


# ---------------------------------------------------------------------------
# parity with raft_tpu.serve.autotune

#: the injected measurements: (qps, p99, recall, served) per candidate; two
#: candidates fail the floors, four survive round 0, two round 1
_TABLE = {"baseline": (100.0, 0.010, 1.0, 1.0),
          "cap8": (300.0, 0.002, 0.5, 1.0),      # recall floor
          "cap16": (400.0, 0.002, 1.0, 0.5),     # coverage
          "params0": (120.0, 0.010, 1.0, 1.0),   # halved in round 0
          "params1": (160.0, 0.010, 1.0, 1.0),   # the winner
          "q0": (140.0, 0.010, 1.0, 1.0),        # halved in round 0
          "q1": (150.0, 0.010, 1.0, 1.0)}        # halved in round 1


def _table_measure(log, score_cls):
    """Scores from :data:`_TABLE`, their qps nudged by the sampled
    traffic, so the decisions follow the shadow sampling too."""
    def measure(cand, requests):
        fp = tuple(round(float(q[0, 0]), 5) for q in requests)
        log.append((cand.name, len(requests), fp))
        qps, p99, recall, served = _TABLE[cand.name]
        nudge = 1.0 + 1e-3 * abs(sum(fp))
        return score_cls(qps=qps * nudge, p99_s=p99, recall=recall,
                         served=served)
    return measure


def test_schedule_and_decisions_match_jax(jax_index, fl_index):
    from raft_tpu.serve import Candidate as JaxCandidate

    buckets = [8, 16, 32]
    reqs = _reqs(seed=2, sizes=(3, 7, 2, 6, 1, 5, 4, 8, 2, 9))
    cfg = dict(seed=5, pairs=2, shadow_requests=6)
    jeng = JaxEngine(jax_index, _K, jax_ivf.SearchParams(n_probes=4),
                     max_batch=32)
    teng = ServeEngine(fl_index, _K, tivf.SearchParams(n_probes=4),
                       max_batch=32, device="cpu")
    try:
        jeng.warmup(buckets)
        teng.warmup(buckets)
        jeng.search(reqs)
        teng.search(reqs)
        jlog, tlog = [], []
        jt = JaxTuner(jeng, JaxConfig(**cfg),
                      param_variants=[jax_ivf.SearchParams(n_probes=p)
                                      for p in (2, 6)],
                      extra_candidates=[JaxCandidate("q0", quantum_s=0.001),
                                        JaxCandidate("q1", quantum_s=0.004)],
                      measure=_table_measure(jlog, JaxScore))
        tt = AutoTuner(teng, TunerConfig(**cfg),
                       param_variants=[tivf.SearchParams(n_probes=p)
                                       for p in (2, 6)],
                       extra_candidates=[Candidate("q0", quantum_s=0.001),
                                         Candidate("q1", quantum_s=0.004)],
                       measure=_table_measure(tlog, Score))
        assert ([c.name for c in tt.candidates()]
                == [c.name for c in jt.candidates()])
        jr, tr = jt.run(), tt.run()
        assert tr == jr
        assert tlog == jlog                 # the same shadow sampling
        assert tr["winner"] == "params1"
        assert {r for r, _ in tr["schedule"]} == {0, 1}
        assert teng.max_batch == jeng.max_batch == 32
        assert teng._ctor["params"].n_probes == 6
        assert teng._health()["autotune"] == jeng._health()["autotune"]
    finally:
        jeng.close()
        teng.close()


def test_objective_and_paired_win_match_jax(corpus):
    eng = _bf_engine(corpus)
    jeng = JaxEngine(corpus, _K, max_batch=32)
    try:
        jeng.warmup([8])
        cfg = dict(min_win_rel=0.1, slack_rel=0.1)
        tt, jt = AutoTuner(eng, TunerConfig(**cfg)), JaxTuner(
            jeng, JaxConfig(**cfg))
        rng = np.random.default_rng(11)
        wins = 0
        for _ in range(300):
            n = int(rng.integers(1, 4))
            raw = rng.uniform(0.8, 1.4, (2, n, 2)) * [100.0, 0.01]
            cand = [(q, p) for q, p in raw[0]]
            base = [(q, p) for q, p in raw[1]]
            got = tt.paired_win([Score(q, p, 1.0) for q, p in cand],
                                [Score(q, p, 1.0) for q, p in base])
            want = jt.paired_win([JaxScore(q, p, 1.0) for q, p in cand],
                                 [JaxScore(q, p, 1.0) for q, p in base])
            assert got == want
            wins += got
            q, p = cand[0]
            assert (AutoTuner.objective(Score(q, p, 1.0))
                    == JaxTuner.objective(JaxScore(q, p, 1.0)))
        assert 0 < wins < 300
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("plan", [HEAVY_TAIL_PLAN, DIURNAL_PLAN,
                                  BURST_PLAN])
def test_traffic_requests_equal_bench_common(plan):
    got = traffic_requests(plan, 3, 120, 8)
    want = bench_common.traffic_requests(plan, 3, 120, 8)
    assert len(got) == len(want) == 120
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        traffic_requests("band:p=1:lo=1:hi=4;storm:at=1", 0, 1, 8)


def test_shadow_traffic_ring_and_plan_match_jax(corpus):
    """A ring of 6 topped up to 10 from a plan, and a plan alone on an
    empty ring: the same arrays as the JAX tuner's."""
    plan = "band:p=0.7:lo=1:hi=9;band:p=0.3:lo=9:hi=40"
    eng = _bf_engine(corpus)
    jeng = JaxEngine(corpus, _K, max_batch=32)
    empty = _bf_engine(corpus)
    try:
        jeng.warmup([8])
        tt = AutoTuner(eng, shadow_plan=plan)
        jt = JaxTuner(jeng, shadow_plan=plan)
        for n, seed in ((10, 3), (4, 9)):
            assert ([q.shape for q in tt.shadow_traffic(n, seed)]
                    == [q.shape for q in jt.shadow_traffic(n, seed)])
        eng.search(_reqs(seed=2))
        jeng.search(_reqs(seed=2))
        for n, seed in ((10, 3), (4, 9)):
            got, want = tt.shadow_traffic(n, seed), jt.shadow_traffic(n, seed)
            assert len(got) == len(want) == n
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, np.asarray(b))
        ring = AutoTuner(empty).shadow_traffic(5, 0)
        assert ring == []          # no ring, no plan: nothing to replay
        fill = AutoTuner(empty, shadow_plan=lambda s, n, d, t: [
            np.full((2, d), s, np.float32)] * n).shadow_traffic(3, 7)
        assert [q[0, 0] for q in fill] == [7.0] * 3
    finally:
        eng.close()
        jeng.close()
        empty.close()


# ---------------------------------------------------------------------------
# the candidate space and determinism

class TestCandidateSpace:
    def test_candidates_derive_from_warmed_ladder(self, corpus):
        eng = _bf_engine(corpus)
        try:
            tuner = AutoTuner(eng, TunerConfig(seed=3))
            assert [c.name for c in tuner.candidates()] == [
                "baseline", "cap8", "cap16"]
            warmed = {b for bs in eng.warmed_signatures().values()
                      for b in bs}
            for c in tuner.candidates():
                if c.max_batch is not None:
                    assert c.max_batch in warmed
        finally:
            eng.close()

    def test_candidates_before_warmup_raise(self, corpus):
        eng = ServeEngine(corpus, _K, max_batch=32, device="cpu")
        try:
            with pytest.raises(LogicError):
                AutoTuner(eng).candidates()
        finally:
            eng.close()

    def test_overbound_subsample_is_seeded(self, corpus):
        eng = _bf_engine(corpus, max_batch=64)
        try:
            extra = tuple(Candidate(f"q{i}", quantum_s=0.001 * (i + 1))
                          for i in range(8))
            cfg = TunerConfig(seed=11, max_candidates=4)
            a = [c.name for c in
                 AutoTuner(eng, cfg, extra_candidates=extra).candidates()]
            b = [c.name for c in
                 AutoTuner(eng, cfg, extra_candidates=extra).candidates()]
            assert a == b and len(a) == 4 and a[0] == "baseline"
        finally:
            eng.close()

    def test_shadow_lane_not_ported_yet(self, corpus):
        """Ported since (the test keeps its name): the shadow lane is a
        replica engine's lane, so a brute-force engine refuses one."""
        eng = _bf_engine(corpus)
        try:
            with pytest.raises(LogicError, match="replica engine"):
                AutoTuner(eng, shadow_lane=1)
        finally:
            eng.close()


def _fake_measure(log, winner="cap16"):
    def measure(cand, requests):
        fp = tuple(round(float(q[0, 0]), 5) for q in requests)
        log.append((cand.name, len(requests), fp))
        if cand.name == winner:
            return Score(qps=150.0, p99_s=0.010, recall=1.0)
        if cand.name == BASELINE.name:
            return Score(qps=100.0, p99_s=0.010, recall=1.0)
        return Score(qps=90.0, p99_s=0.012, recall=1.0)
    return measure


class TestDeterminism:
    def _run_once(self, corpus, seed=5):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=2))
            log = []
            tuner = AutoTuner(eng, TunerConfig(seed=seed, pairs=2,
                                               shadow_requests=6),
                              measure=_fake_measure(log))
            return tuner.run(), log, eng.max_batch
        finally:
            eng.close()

    def test_same_seed_same_schedule_and_decisions(self, corpus):
        r1, log1, mb1 = self._run_once(corpus)
        r2, log2, mb2 = self._run_once(corpus)
        assert r1 == r2 and log1 == log2
        assert mb1 == mb2 == 16
        assert r1["winner"] == "cap16"
        assert ("cap16", "promote", "paired win") in r1["decisions"]

    def test_different_seed_different_stream(self, corpus):
        _, log1, _ = self._run_once(corpus, seed=5)
        _, log2, _ = self._run_once(corpus, seed=6)
        assert [t[:2] for t in log1] == [t[:2] for t in log2]
        assert log1 != log2

    def test_coverage_rule_rejects_skip_heavy_candidates(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=2))

            def measure(cand, requests):
                if cand.name == "cap8":
                    return Score(qps=500.0, p99_s=0.001, recall=1.0,
                                 served=0.5)
                return Score(qps=100.0, p99_s=0.010, recall=1.0)

            report = AutoTuner(eng, TunerConfig(seed=0, pairs=2,
                                                shadow_requests=6),
                               measure=measure).run()
            assert report["winner"] != "cap8"
            assert ("cap8", "reject", "coverage") in report["decisions"]
            assert eng.max_batch == 32
        finally:
            eng.close()

    def test_losing_candidates_are_rejected_not_promoted(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=2))
            report = AutoTuner(eng, TunerConfig(seed=1, pairs=2,
                                                shadow_requests=6),
                               measure=_fake_measure([], winner="nobody")
                               ).run()
            assert report["winner"] is None
            assert all(d[1] == "reject" for d in report["decisions"])
            assert eng.max_batch == 32
        finally:
            eng.close()


# ---------------------------------------------------------------------------
# nothing built, nothing warmed

def _frozen(eng):
    return dict(native.BUILDS), eng.warmed_signatures()


class TestNothingBuiltOrWarmed:
    def test_explore_and_promote_build_and_warm_nothing(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=3))
            tuner = AutoTuner(eng, TunerConfig(seed=0, pairs=1,
                                               shadow_requests=8))
            assert tuner.warm_candidates() == 0   # no params variants
            before = _frozen(eng)
            tuner.explore()
            tuner.promote(Candidate("cap16", max_batch=16))
            outs = eng.search(_reqs(seed=4))
            assert eng.max_batch == 16
            assert _frozen(eng) == before
            for q, (d, i) in zip(_reqs(seed=4), outs):
                np.testing.assert_array_equal(i, _knn_ids(corpus, q))
        finally:
            eng.close()

    def test_params_promotion_through_refresh(self, fl_index):
        sp0 = tivf.SearchParams(n_probes=2)
        sp1 = tivf.SearchParams(n_probes=6)
        eng = ServeEngine(fl_index, _K, sp0, max_batch=16, device="cpu")
        eng.warmup()
        try:
            eng.search(_reqs(seed=5))
            tuner = AutoTuner(eng, TunerConfig(seed=0, pairs=1,
                                               shadow_requests=6),
                              param_variants=[sp1])
            assert tuner.warm_candidates() == 2   # buckets 8 and 16
            before = _frozen(eng)
            score = tuner._measure_real(Candidate("params0", params=sp1),
                                        _reqs(seed=6))
            assert score.qps > 0 and 0.0 <= score.recall <= 1.0
            tuner.promote(Candidate("params0", params=sp1))
            outs = eng.search(_reqs(seed=7))
            assert _frozen(eng) == before
            for q, (d, i) in zip(_reqs(seed=7), outs):
                _, i1 = tivf.search(sp1, fl_index, q, _K)
                np.testing.assert_array_equal(i, i1.numpy())
        finally:
            eng.close()

    def test_recall_probe_against_exact_reference(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=8))
            tuner = AutoTuner(eng, TunerConfig(seed=0, pairs=1,
                                               shadow_requests=6),
                              reference=exact_reference(corpus, _K,
                                                        device="cpu"))
            score = tuner._measure_real(Candidate("cap16", max_batch=16),
                                        _reqs(seed=9))
            assert score.recall == 1.0
        finally:
            eng.close()

    def test_plain_engine_candidate_is_refused(self, fl_index):
        """On the CPU the live engine is the plain one, so a "cuda"
        candidate differs from it; the card test holds the "torch" case."""
        eng = ServeEngine(fl_index, _K, max_batch=16, device="cpu")
        eng.warmup()
        try:
            sp = tivf.SearchParams(n_probes=6)
            ok = AutoTuner(eng, extra_candidates=[
                Candidate("same", params=sp, engine="torch")])
            assert ok.warm_candidates() == 2
            bad = AutoTuner(eng, extra_candidates=[
                Candidate("other", params=sp, engine="cuda")])
            with pytest.raises(LogicError, match="differs"):
                bad.warm_candidates()
        finally:
            eng.close()


class TestShadowIsolation:
    def test_shadow_dispatch_serializes_under_engine_lock(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=2))
            tuner = AutoTuner(eng, TunerConfig(seed=0, pairs=1,
                                               shadow_requests=4))
            done = threading.Event()
            out = {}

            def shadow():
                out["score"] = tuner._measure_real(
                    Candidate("cap16", max_batch=16), _reqs(seed=3))
                done.set()

            with eng._lock:   # a live search() in flight
                t = threading.Thread(target=shadow)
                t.start()
                assert not done.wait(0.2)
            t.join(10.0)
            assert done.is_set()
            assert out["score"].qps > 0 and out["score"].served == 1.0
        finally:
            eng.close()

    def test_live_search_racing_shadow_replay(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=2))
            tuner = AutoTuner(eng, TunerConfig(seed=0, pairs=1,
                                               shadow_requests=4))
            stop = threading.Event()
            errs = []

            def shadow():
                while not stop.is_set():
                    try:
                        tuner._measure_real(
                            Candidate("cap16", max_batch=16), _reqs(seed=5))
                    except Exception as e:   # pragma: no cover
                        errs.append(e)
                        return

            t = threading.Thread(target=shadow)
            t.start()
            try:
                for s in range(5):
                    reqs = _reqs(seed=20 + s)
                    for q, (d, i) in zip(reqs, eng.search(reqs)):
                        np.testing.assert_array_equal(i, _knn_ids(corpus, q))
            finally:
                stop.set()
                t.join(10.0)
            assert not errs
        finally:
            eng.close()

    def test_shadow_ring_is_fed_by_submit_and_bounded(self, corpus):
        eng = _bf_engine(corpus)
        try:
            futs = [eng.submit(q) for q in _reqs(seed=2)]
            eng.flush()
            for f in futs:
                f.result(10)
            assert len(eng.shadow_samples()) == 6
            eng.search([np.zeros((0, _DIM), np.float32)])   # no rows: no slot
            assert len(eng.shadow_samples()) == 6
            eng.search(_reqs(seed=3, sizes=(1,) * 70))
            assert len(eng.shadow_samples()) == 64
        finally:
            eng.close()

    def test_shadow_sampling_without_replacement(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=2))   # 6 ring entries
            tuner = AutoTuner(eng, TunerConfig(seed=0))
            reqs = tuner.shadow_traffic(4, seed=1)
            assert len(reqs) == 4 and len({id(q) for q in reqs}) == 4
            reqs = tuner.shadow_traffic(50, seed=1)
            assert len(reqs) == 6 and len({id(q) for q in reqs}) == 6
        finally:
            eng.close()


# ---------------------------------------------------------------------------
# promotion and rollback

class TestRollback:
    def test_live_p99_regression_rolls_back(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=3))
            tuner = AutoTuner(eng, TunerConfig(seed=0))
            tuner.promote(Candidate("cap16", max_batch=16))
            assert eng.max_batch == 16
            pre = tuner._pre_p99
            assert pre is not None and pre > 0.0
            assert tuner.maybe_rollback(live_p99_s=100.0 * pre) is True
            assert eng.max_batch == 32
            assert tuner.decisions[-1][1] == "rollback"
            assert tuner.maybe_rollback(live_p99_s=100.0 * pre) is False
        finally:
            eng.close()

    def test_params_rollback_on_params_none_engine(self, fl_index):
        sp1 = tivf.SearchParams(n_probes=6)
        eng = ServeEngine(fl_index, _K, max_batch=16, device="cpu")
        eng.warmup()
        try:
            eng.search(_reqs(seed=3))   # arm the guard with a baseline
            tuner = AutoTuner(eng, TunerConfig(seed=0),
                              param_variants=[sp1])
            tuner.warm_candidates()
            tuner.promote(Candidate("params0", params=sp1))
            assert eng._ctor["params"] is sp1
            assert eng._backend.n_probes == 6
            pre = tuner._pre_p99
            assert pre is not None and pre > 0.0
            assert tuner.maybe_rollback(live_p99_s=100.0 * pre) is True
            assert eng._ctor["params"] is None
            assert eng._backend.n_probes == min(
                tivf.SearchParams().n_probes, fl_index.n_lists)
            for q, (d, i) in zip(_reqs(seed=4), eng.search(_reqs(seed=4))):
                _, i0 = tivf.search(tivf.SearchParams(), fl_index, q, _K)
                np.testing.assert_array_equal(i, i0.numpy())
        finally:
            eng.close()

    def test_params_promotion_preserves_tuned_cap(self, fl_index):
        sp1 = tivf.SearchParams(n_probes=6)
        eng = ServeEngine(fl_index, _K, max_batch=16, device="cpu")
        eng.warmup()
        try:
            eng.search(_reqs(seed=3))
            tuner = AutoTuner(eng, TunerConfig(seed=0),
                              param_variants=[sp1])
            tuner.warm_candidates()
            tuner.promote(Candidate("cap8", max_batch=8))   # cycle 1
            assert eng.max_batch == 8
            prev = tuner.promote(Candidate("params0", params=sp1))
            assert eng.max_batch == 8
            assert prev["max_batch"] == 8
        finally:
            eng.close()

    def test_promotion_without_baseline_disarms_guard(self, corpus):
        eng = _bf_engine(corpus)
        try:
            tuner = AutoTuner(eng, TunerConfig(seed=0))
            tuner.promote(Candidate("cap16", max_batch=16))
            assert tuner._pre_p99 is None
            body = eng._health()
            assert body["autotune"]["promoted"] == "cap16"
            assert body["autotune"]["rollback_window_open"] is False
            disarmed = telemetry.REGISTRY.get(
                "raft_tpu_autotune_guard_disarmed_total")
            assert sum(v for labels, v in disarmed.items()
                       if labels == (eng._engine_id,)) == 1
            assert tuner.maybe_rollback(live_p99_s=1e9) is False
            assert eng.max_batch == 16
            assert tuner._promoted is None
        finally:
            eng.close()

    def test_healthy_p99_keeps_promotion(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=3))
            tuner = AutoTuner(eng, TunerConfig(seed=0))
            tuner.promote(Candidate("cap16", max_batch=16))
            assert tuner.maybe_rollback(live_p99_s=tuner._pre_p99) is False
            assert eng.max_batch == 16
            tuner._promoted_at -= (tuner.cfg.rollback_window_s + 1.0)
            assert tuner.maybe_rollback(live_p99_s=1e9) is False
            assert tuner._promoted is None
        finally:
            eng.close()

    def test_rollback_restores_quantum(self, corpus):
        eng = _bf_engine(corpus)
        try:
            eng.search(_reqs(seed=3))
            q0 = eng._sched_cfg.quantum_s
            tuner = AutoTuner(eng, TunerConfig(seed=0))
            tuner.promote(Candidate("q", quantum_s=4 * q0))
            assert eng._health()["scheduler"]["quantum_s"] == 4 * q0
            assert tuner.maybe_rollback(live_p99_s=100 * tuner._pre_p99)
            assert eng._sched_cfg.quantum_s == q0
        finally:
            eng.close()


def test_variant_batch_cap_below_the_warmed_ladder(monkeypatch):
    """A params variant whose IVF-PQ batch cap lies below the live cap:
    at the fp8 LUT, pq_dim 64 × 8 bits, ``hoisted_batch_cap`` is 128 at
    n_probes 4 and 32 at 16.  As the JAX tuner does, the variant's
    backend is warmed at EVERY warmed bucket and replays at the live
    ladder (a 100-row request is served); its promotion lands on the
    refreshed cap (32, where the JAX tuner's raises), and its rollback
    restores the cap, the params and the whole warmed ladder.  The
    engine runs on a small index with the cap of that configuration."""
    caps = {n_probes: tpq.hoisted_batch_cap_dims(
        DistanceType.L2Expanded, False, 32, 1, 32, 64, 8, n_probes,
        "float8_e4m3", True) for n_probes in (4, 16)}
    assert caps == {4: 128, 16: 32}
    monkeypatch.setattr(tpq, "hoisted_batch_cap",
                        lambda index, n_probes, lut, hoisted=True:
                        caps[16] if n_probes >= 16 else caps[4])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, _DIM)).astype(np.float32)
    index = tpq.build(tpq.IndexParams(n_lists=16, pq_dim=8,
                                      kmeans_n_iters=2), x, device="cpu")
    sp0 = tpq.SearchParams(n_probes=4, lut_dtype="float8_e4m3")
    sp1 = tpq.SearchParams(n_probes=16, lut_dtype="float8_e4m3")
    eng = ServeEngine(index, 4, sp0, max_batch=128, device="cpu")
    try:
        eng.warmup()
        ladder = eng.warmed_signatures()
        assert ladder == {"float32": [8, 16, 32, 64, 128]}
        eng.search([x[:3], x[3:40]])
        tuner = AutoTuner(eng, TunerConfig(seed=0), param_variants=[sp1])
        assert tuner.warm_candidates() == 5
        score = tuner._measure_real(Candidate("params0", params=sp1),
                                    [x[:100], x[100:103]])
        assert score.served == 1.0
        prev = tuner.promote(Candidate("params0", params=sp1))
        assert prev["max_batch"] == 128 and prev["params"] is sp0
        assert eng.max_batch == 32
        assert eng.warmed_signatures() == {"float32": [8, 16, 32]}
        assert tuner.maybe_rollback(live_p99_s=100 * tuner._pre_p99)
        assert eng.max_batch == 128 and eng._ctor["params"] is sp0
        assert eng.warmed_signatures() == ladder
    finally:
        eng.close()


class TestApplyTuning:
    def test_rejects_unwarmed_cap(self, corpus):
        eng = _bf_engine(corpus)
        try:
            with pytest.raises(LogicError):
                eng.apply_tuning(max_batch=24)
            assert eng.max_batch == 32
        finally:
            eng.close()

    def test_rejects_bad_quantum(self, corpus):
        eng = _bf_engine(corpus)
        drain = _bf_engine(corpus, scheduler=False)
        try:
            with pytest.raises(LogicError):
                eng.apply_tuning(quantum_s=0.0)
            with pytest.raises(LogicError, match="scheduler"):
                drain.apply_tuning(quantum_s=0.01)
        finally:
            eng.close()
            drain.close()

    def test_quantum_reaches_a_running_scheduler(self, corpus):
        """A retuned quantum applies to the scheduler thread already
        running (the JAX engine's thread keeps the quantum it started
        with): a lone small request now waits out the new quantum."""
        eng = _bf_engine(corpus)
        try:
            eng.submit(_reqs(seed=2)[0]).result(10)   # thread running
            eng.apply_tuning(quantum_s=0.5)
            t0 = time.monotonic()
            eng.submit(_reqs(seed=3)[4]).result(10)
            assert time.monotonic() - t0 >= 0.4
        finally:
            eng.close()

    def test_returns_previous_and_refuses_when_closed(self, corpus):
        eng = _bf_engine(corpus)
        q0 = eng._sched_cfg.quantum_s
        prev = eng.apply_tuning(quantum_s=0.01, max_batch=8)
        assert prev == {"quantum_s": q0, "max_batch": 32}
        assert eng.apply_tuning(max_batch=32) == {"quantum_s": 0.01,
                                                  "max_batch": 8}
        eng.close()
        with pytest.raises(LogicError, match="closed"):
            eng.apply_tuning(max_batch=16)


class TestHealthAndVarz:
    def test_decisions_visible_in_healthz_and_registry(self, corpus):
        eng = _bf_engine(corpus)
        try:
            assert "autotune" not in eng._health()
            eng.search(_reqs(seed=2))
            tuner = AutoTuner(eng, TunerConfig(seed=5, pairs=2,
                                               shadow_requests=6),
                              measure=_fake_measure([]))
            tuner.run()
            body = eng._health()
            assert body["autotune"] == {
                "seed": 5, "evaluations": len(tuner.schedule),
                "decisions": [list(d) for d in tuner.decisions],
                "promoted": "cap16", "rollback_window_open": True}
            json.dumps(body)
            text = telemetry.prometheus_text()
            for name in ("raft_tpu_autotune_decisions_total",
                         "raft_tpu_autotune_evals_total",
                         "raft_tpu_autotune_rounds_total",
                         "raft_tpu_autotune_qps",
                         "raft_tpu_autotune_p99_seconds",
                         "raft_tpu_autotune_recall",
                         "raft_tpu_autotune_exploring"):
                assert name in text
            dec = telemetry.REGISTRY.get("raft_tpu_autotune_decisions_total")
            assert sum(v for labels, v in dec.items()
                       if labels == (eng._engine_id, "promote")) == 1
            eng.attach_tuner(None)
            assert "autotune" not in eng._health()
        finally:
            eng.close()


class TestLaneCostShedding:
    def test_router_ewma_sheds_gradually(self):
        r = ReplicaRouter(2, "t-torch-ewma")
        assert r.slowness(0) == r.slowness(1) == 1.0
        for _ in range(4):
            r.observe(0, 0.001)
            r.observe(1, 0.010)
        assert r.slowness(0) == 1.0
        assert r.slowness(1) > 5.0
        picks = [r.pick(0.0, 0.001) for _ in range(10)]
        assert picks.count(0) > picks.count(1)
        assert picks.count(1) >= 1
        assert r.degraded_lanes() == []

    def test_drain_is_not_a_fault(self):
        r = ReplicaRouter(2, "t-torch-drain")
        r.drain(1)
        assert r.degraded_lanes() == [1]
        assert r.pick(0.0, 0.001) == 0
        faults_c = telemetry.REGISTRY.get(
            "raft_tpu_serve_replica_faults_total")
        assert all(labels[0] != "t-torch-drain"
                   for labels, v in faults_c.items() if v > 0)
        r.restore(1)
        assert r.degraded_lanes() == []


# ---------------------------------------------------------------------------
# cost rows across processes

class TestCostColdStart:
    def test_seed_rows_fills_absent_only(self):
        cm = CostModel(use_telemetry=False, static_batch_s=0.5)
        cm.observe("float32", 8, 0.001)
        n = cm.seed_rows({("float32", 8): 0.9, ("float32", 16): 0.002,
                          ("bfloat16", 8): -1.0})
        assert n == 1
        rows = cm.rows()
        assert rows[("float32", 8)] == pytest.approx(0.001)
        assert rows[("float32", 16)] == pytest.approx(0.002)
        assert ("bfloat16", 8) not in rows

    def test_engine_seeds_cost_model_from_store(self, corpus, tmp_path):
        prev = coststore.install(str(tmp_path))
        try:
            eng = _bf_engine(corpus)
            eng.search(_reqs(seed=2))
            fn = eng._backend_fn()
            observed = eng._cost.rows()
            assert observed
            eng.close()
            persisted = coststore.installed().load_costs(fn, "cpu")
            assert persisted
            for key, v in observed.items():
                assert persisted[key] == pytest.approx(v)
            eng2 = ServeEngine(corpus, _K, max_batch=32, device="cpu")
            try:
                seeded = eng2._cost.rows()
                for key, v in persisted.items():
                    assert seeded[key] == pytest.approx(v)
            finally:
                eng2.close()
        finally:
            coststore.install(prev)

    def test_save_merges_and_corrupt_reads_empty(self, tmp_path):
        store = coststore.CostStore(str(tmp_path))
        assert store.save_costs("f", {("float32", 8): 0.5}, "cpu")
        assert store.save_costs("f", {("float32", 16): 0.7,
                                      ("float32", 8): 0.25}, "cpu")
        assert store.load_costs("f", "cpu") == {("float32", 8): 0.25,
                                                ("float32", 16): 0.7}
        assert not store.save_costs("f", {("float32", 8): 0.0}, "cpu")
        assert store.load_costs("other", "cpu") == {}
        with open(store._file("f", "cpu"), "w") as fh:
            fh.write("{not json")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert store.load_costs("f", "cpu") == {}
            assert store.load_costs("f", "cpu") == {}
        assert len(caught) == 1   # warned once
        assert not list(tmp_path.glob("*.tmp"))

    def test_no_store_is_a_clean_noop(self, corpus):
        prev = coststore.install(None)
        try:
            eng = _bf_engine(corpus)
            assert eng._cost.rows() == {}
            eng.close()
        finally:
            coststore.install(prev)
