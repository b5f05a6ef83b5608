"""The port's failure-handling layer against ``raft_tpu``: the fault-plan
grammar, its nth/times counters and seeded probabilities, the
``retryable`` classification (plus the port's ``DeviceError``, which a
failed kernel launch raises and which never retries) and the admission
controller's decisions on a fixed clock are the reference's; and the
engine-level cases of ``tests/test_serve_faults.py`` — supervised
dispatch, admission, refresh atomicity, close — are mirrored on the CPU,
each request's result held bit for bit against the port's solo ``knn``."""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_tpu.core.error import LogicError as JaxLogicError
from raft_tpu.serve import AdmissionController as JaxAdmission
from raft_tpu.serve import WatchdogTimeout as JaxWatchdogTimeout
from raft_tpu.serve.supervise import retryable as jax_retryable
from raft_tpu.testing import faults as jfaults
from raft_tpu_torch.core.error import DeviceError, LogicError
from raft_tpu_torch.kernels import native
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.serve import (AdmissionController, RejectedError,
                                  ServeEngine, ServeRequest, WatchdogTimeout)
from raft_tpu_torch.serve.supervise import retryable
from raft_tpu_torch.testing import faults

_N, _DIM, _K = 2000, 16, 5
_X = np.random.default_rng(0).normal(0, 1, (_N, _DIM)).astype(np.float32)
_X2 = np.random.default_rng(7).normal(0, 1, (_N, _DIM)).astype(np.float32)


def _engine(max_batch=64, **kw):
    eng = ServeEngine(_X, _K, max_batch=max_batch, device="cpu", **kw)
    eng.warmup()
    eng.search([_X[:2]])
    return eng


def _solo(x, q):
    d, i = tbf.knn(x, q, _K, device="cpu")
    return d.numpy(), i.numpy()


def _assert_solo(out, x, q):
    d0, i0 = _solo(x, q)
    np.testing.assert_array_equal(out[1], i0)
    np.testing.assert_array_equal(out[0], d0)


# ---------------------------------------------------------------------------
# the plan grammar and classification, against the reference

PLAN = ("dispatch:n=3:raise; dispatch:n=5:stall=0.5;"
        "comms:rank=1:op=isend:fail; refresh:stage=pre_swap:crash;"
        "dispatch:p=0.25:seed=9:raise=logic")


def test_parse_equals_the_reference():
    got = faults.FaultPlan.parse(PLAN).directives
    ref = jfaults.FaultPlan.parse(PLAN).directives
    assert [vars(d) for d in got] == [vars(d) for d in ref]


@pytest.mark.parametrize("bad", ["", "bogus:n=1:raise", "dispatch:n=1",
                                 "dispatch:wat=1:raise",
                                 "dispatch:raise=wat"])
def test_parse_rejects(bad):
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(bad)


def _fire_sequence(mod, text, events):
    plan = mod.FaultPlan.parse(text)
    out = []
    for site, attrs in events:
        try:
            plan.check(site, **attrs)
            out.append(0)
        except mod.InjectedLogicFault:
            out.append(2)
        except mod.InjectedFault:
            out.append(1)
    return out


@pytest.mark.parametrize("text", [
    "dispatch:n=2:times=2:raise",
    "dispatch:n=3:times=0:raise=logic",
    "dispatch:p=0.4:seed=3:times=0:raise",
    "dispatch:p=0.1:seed=7:raise;dispatch:n=4:raise=logic",
    "comms:rank=1:n=1:fail",
    "refresh:stage=pre_swap:raise",
])
def test_fire_sequences_equal_the_reference(text):
    events = [("dispatch", {})] * 24 + [
        ("comms", {"rank": 0, "op": "isend"}),
        ("comms", {"rank": 1, "op": "isend"}),
        ("refresh", {"stage": "pre_warm"}),
        ("refresh", {"stage": "pre_swap"})]
    got = _fire_sequence(faults, text, events)
    assert got == _fire_sequence(jfaults, text, events)
    assert any(got)


def test_off_by_default_and_context_restores():
    assert faults.active_plan() is None
    with faults.plan("dispatch:n=1:raise") as p:
        assert faults.active_plan() is p
    assert faults.active_plan() is None
    faults.check("dispatch")   # free when off


@pytest.mark.parametrize("make", [
    lambda m: m["InjectedFault"]("x"),
    lambda m: m["WatchdogTimeout"]("x"),
    lambda m: RuntimeError("transient"),
    lambda m: m["InjectedLogicFault"]("x"),
    lambda m: m["LogicError"]("shape bug"),
    lambda m: TypeError("x"),
    lambda m: ValueError("x"),
], ids=["injected", "watchdog", "runtime", "injected_logic", "logic",
        "type", "value"])
def test_retryable_equals_the_reference(make):
    port = dict(InjectedFault=faults.InjectedFault,
                InjectedLogicFault=faults.InjectedLogicFault,
                WatchdogTimeout=WatchdogTimeout, LogicError=LogicError)
    ref = dict(InjectedFault=jfaults.InjectedFault,
               InjectedLogicFault=jfaults.InjectedLogicFault,
               WatchdogTimeout=JaxWatchdogTimeout, LogicError=JaxLogicError)
    assert retryable(make(port)) == jax_retryable(make(ref))


def test_failed_launch_raises_device_error_that_never_retries():
    lib = types.SimpleNamespace(
        raft_cuda_error_string=lambda err: b"an illegal memory access")
    native.check(lib, 0, "select_k_kernel")   # success is silent
    with pytest.raises(DeviceError, match="illegal memory access") as exc:
        native.check(lib, 700, "select_k_kernel")
    assert not isinstance(exc.value, RuntimeError)
    assert not retryable(exc.value)


def test_admission_decisions_equal_the_reference():
    rng = np.random.default_rng(11)
    for policy in ("shed-newest", "shed-over-deadline"):
        for max_queue in (None, 40):
            ctrls = (AdmissionController(policy=policy, max_queue=max_queue,
                                         static_batch_s=0.01,
                                         use_telemetry=False),
                     JaxAdmission(policy=policy, max_queue=max_queue,
                                  static_batch_s=0.01, use_telemetry=False))
            for c in ctrls:
                c.bind("t-torch-adm")
            for _ in range(200):
                n = int(rng.integers(1, 30))
                now = float(rng.uniform(0, 1))
                dl = (None if rng.random() < 0.3
                      else now + float(rng.uniform(-0.02, 0.1)))
                queued = int(rng.integers(0, 60))
                ahead = int(rng.integers(0, 6))
                est = ctrls[0].batch_cost_s("fn")
                assert est == ctrls[1].batch_cost_s("fn") == 0.01
                got = [c.admit(n, dl, now, queued, ahead, est)
                       for c in ctrls]
                assert [getattr(r, "reason", None) for r in got[:1]] == \
                    [getattr(r, "reason", None) for r in got[1:]]
                if dl is not None and now > dl:
                    exp = [c.expire(dl, now) for c in ctrls]
                    assert [getattr(r, "reason", None) for r in exp[:1]] \
                        == [getattr(r, "reason", None) for r in exp[1:]]
            ctrls[0].observe_batches(3, 0.03)
            ctrls[1].observe_batches(3, 0.03)
            with pytest.MonkeyPatch.context() as mp:
                for c in ctrls:
                    mp.setattr(c, "use_telemetry", True)
                assert ctrls[0].batch_cost_s("fn") == \
                    ctrls[1].batch_cost_s("fn")
            h = [c.health(1.0) for c in ctrls]
            assert h[0] == h[1]


# ---------------------------------------------------------------------------
# supervised dispatch: retry, watchdog, isolation


class TestSupervisedDispatch:
    def test_transient_fault_retried_bit_identical(self):
        eng = _engine()
        reqs = [_X[:3], _X[10:17], _X[40:41]]
        with faults.plan("dispatch:n=1:raise"):
            outs = eng.search(reqs)
        assert eng.stats["retries"] == 1
        for q, out in zip(reqs, outs):
            _assert_solo(out, _X, q)

    def test_watchdog_fires_and_engine_recovers(self):
        eng = _engine(watchdog_s=0.1, max_retries=1)
        t0 = time.monotonic()
        with faults.plan("dispatch:n=1:stall=0.8"):
            outs = eng.search([_X[:3]])
        assert time.monotonic() - t0 < 0.7, "engine waited the stall out"
        assert eng.stats["watchdog_timeouts"] == 1
        _assert_solo(outs[0], _X, _X[:3])
        _assert_solo(eng.search([_X[5:9]])[0], _X, _X[5:9])

    def test_persistent_hang_fails_typed_then_recovers(self):
        eng = _engine(watchdog_s=0.1, max_retries=0)
        with faults.plan("dispatch:n=1:times=0:stall=0.5"):
            outs = eng.search([_X[:3]])
        assert isinstance(outs[0], WatchdogTimeout)
        _assert_solo(eng.search([_X[:3]])[0], _X, _X[:3])

    def test_nonretryable_fails_fast_and_isolates(self):
        eng = _engine()
        r0 = eng.stats["retries"]
        reqs = [_X[:3], _X[10:17]]
        with faults.plan("dispatch:n=1:raise=logic"):
            outs = eng.search(reqs)
        assert eng.stats["retries"] == r0, "a logic fault was retried"
        assert eng.stats["isolation_splits"] == 1
        for q, out in zip(reqs, outs):
            _assert_solo(out, _X, q)

    def test_poisoned_request_fails_alone(self):
        eng = _engine()
        bad = np.zeros((3, _DIM + 2), np.float32)
        outs = eng.search([_X[:3], bad, _X[5:9]])
        assert isinstance(outs[1], LogicError)
        assert eng.stats["ingest_errors"] == 1
        _assert_solo(outs[0], _X, _X[:3])
        _assert_solo(outs[2], _X, _X[5:9])

    def test_exhausted_retries_surface_typed_and_engine_recovers(self):
        eng = _engine(max_retries=1)
        with faults.plan("dispatch:times=0:raise"):
            outs = eng.search([_X[:3], _X[5:9]])
        assert all(isinstance(o, faults.InjectedFault) for o in outs)
        assert eng.stats["dispatch_errors"] >= 1
        _assert_solo(eng.search([_X[:3]])[0], _X, _X[:3])

    @pytest.mark.parametrize("exc, retried", [
        (RuntimeError("out of memory"), True),
        (DeviceError("illegal address"), False)], ids=["transient", "device"])
    def test_dispatch_that_raises_is_supervised(self, monkeypatch, exc,
                                                retried):
        """A dispatch that raises on the host (a refused launch, an
        allocation failure) is collected as its error: a transient one is
        retried on the other lane, a device error never is and its batch
        is split and re-dispatched member by member."""
        eng = _engine()
        real = eng._backend.dispatch
        calls = []

        def flaky(qb):
            calls.append(qb.shape[0])
            if len(calls) == 1:
                raise exc
            return real(qb)

        monkeypatch.setattr(eng._backend, "dispatch", flaky)
        reqs = [_X[:3], _X[10:17]]
        outs = eng.search(reqs)
        assert eng.stats["retries"] == (1 if retried else 0)
        assert eng.stats["isolation_splits"] == (0 if retried else 1)
        for q, out in zip(reqs, outs):
            _assert_solo(out, _X, q)


# ---------------------------------------------------------------------------
# admission: deadlines, shedding, bounded queue, expiry


class TestAdmission:
    def test_deadline_shed_at_admission_typed(self):
        adm = AdmissionController(policy="shed-over-deadline",
                                  static_batch_s=10.0, use_telemetry=False)
        eng = ServeEngine(_X, _K, max_batch=16, admission=adm, device="cpu")
        eng.warmup()
        outs = eng.search([ServeRequest(_X[:10], timeout_s=100.0),
                           ServeRequest(_X[:10], timeout_s=1.0)])
        _assert_solo(outs[0], _X, _X[:10])
        assert isinstance(outs[1], RejectedError)
        assert outs[1].reason == "deadline"
        assert eng.stats["sheds"] == 1 and eng.stats["admitted"] == 1
        health = eng._health()
        assert health["ready"] and health["degraded"]
        assert health["admission"]["shed_total"] == 1

    def test_overload_keeps_admitted_latency_bounded(self):
        adm = AdmissionController(policy="shed-over-deadline",
                                  static_batch_s=0.004, use_telemetry=False)
        eng = ServeEngine(_X, _K, max_batch=16, admission=adm, device="cpu")
        eng.warmup()
        budget = 0.02
        reqs = [ServeRequest(_X[j * 10:j * 10 + 10], timeout_s=budget)
                for j in range(12)]
        outs = eng.search(reqs)
        served = [j for j, o in enumerate(outs) if isinstance(o, tuple)]
        assert any(isinstance(o, RejectedError) for o in outs)
        assert served, "admission shed everything"
        assert max(eng.last_latencies[j] for j in served) <= budget + 0.25
        for j in served:
            _assert_solo(outs[j], _X, _X[j * 10:j * 10 + 10])

    def test_bounded_queue_sheds_newest(self):
        adm = AdmissionController(policy="shed-newest", max_queue=20,
                                  use_telemetry=False)
        eng = ServeEngine(_X, _K, max_batch=64, admission=adm, device="cpu")
        eng.warmup()
        outs = eng.search([_X[:15], _X[20:30], _X[40:43]])
        assert isinstance(outs[0], tuple)
        assert isinstance(outs[1], RejectedError)
        assert outs[1].reason == "overload"
        _assert_solo(outs[2], _X, _X[40:43])

    @pytest.mark.parametrize("policy", ["shed-over-deadline", "shed-newest"])
    def test_admitted_but_expired(self, policy):
        """Under shed-over-deadline an admitted request whose deadline
        passed before its batch assembled is dropped ('expired'); under
        shed-newest it is served late and counted."""
        adm = AdmissionController(policy=policy, static_batch_s=0.0,
                                  use_telemetry=False)
        eng = ServeEngine(_X, _K, max_batch=16, admission=adm, device="cpu")
        eng.warmup()
        outs = eng.search([ServeRequest(_X[:16], timeout_s=100.0),
                           ServeRequest(_X[20:24], timeout_s=0.0)])
        _assert_solo(outs[0], _X, _X[:16])
        assert eng.stats["expired"] == 1
        if policy == "shed-over-deadline":
            assert isinstance(outs[1], RejectedError)
            assert outs[1].reason == "expired"
        else:
            _assert_solo(outs[1], _X, _X[20:24])

    def test_serve_request_without_deadline_is_plain(self):
        eng = _engine()
        outs = eng.search([ServeRequest(_X[:5]), _X[:5]])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
        np.testing.assert_array_equal(outs[0][0], outs[1][0])

    def test_admission_counters_exported(self):
        from raft_tpu_torch import telemetry

        _engine().search([_X[:3]])
        snap = telemetry.snapshot()
        for name in ("raft_tpu_serve_shed_total",
                     "raft_tpu_serve_admitted_total",
                     "raft_tpu_serve_expired_total"):
            assert name in snap


# ---------------------------------------------------------------------------
# refresh atomicity


class TestRefreshAtomicity:
    @pytest.mark.parametrize("stage", ["pre_swap", "pre_warm"])
    def test_crashed_refresh_leaves_old_backend_serving(self, stage):
        eng = _engine()
        with faults.plan(f"refresh:stage={stage}:raise"):
            with pytest.raises(faults.InjectedFault):
                eng.refresh(_X2)
        assert eng.stats["refreshes"] == 0
        health = eng._health()
        assert health["ready"] and not health["refresh_in_flight"]
        _assert_solo(eng.search([_X[:6]])[0], _X, _X[:6])
        eng.refresh(_X2)   # a later clean refresh lands the new index
        assert eng.stats["refreshes"] == 1
        _assert_solo(eng.search([_X[:6]])[0], _X2, _X[:6])
        assert eng.warmed_signatures() == {"float32": [8, 16, 32, 64]}

    def test_concurrent_refresh_and_search_single_generation(self):
        eng = _engine()
        q = _X[:7]
        old, new = _solo(_X, q), _solo(_X2, q)
        assert not np.array_equal(old[1], new[1]), "degenerate test data"
        saw_refreshing, errors = [], []

        def do_refresh():
            try:
                with faults.plan("refresh:stage=pre_swap:stall=0.3"):
                    eng.refresh(_X2)
            except Exception as e:   # surfaced below
                errors.append(e)

        t = threading.Thread(target=do_refresh)
        t.start()
        generations = set()
        deadline = time.monotonic() + 20
        while t.is_alive() and time.monotonic() < deadline:
            health = eng._health()
            if health["refresh_in_flight"]:
                saw_refreshing.append(health["ready"])
            (d, i), = eng.search([q])
            if np.array_equal(i, old[1]) and np.array_equal(d, old[0]):
                generations.add("old")
            elif np.array_equal(i, new[1]) and np.array_equal(d, new[0]):
                generations.add("new")
            else:
                generations.add("MIXED")
        t.join(10)
        assert not t.is_alive() and not errors, errors
        assert "MIXED" not in generations
        assert saw_refreshing and not any(saw_refreshing), \
            "/healthz stayed ready during the injected slow swap"
        _assert_solo(eng.search([q])[0], _X2, q)

    def test_refresh_under_submit_traffic(self):
        """Every future submitted across a refresh resolves without error,
        from one generation or the other."""
        eng = _engine()
        futs = []

        def feed():
            for j in range(40):
                futs.append((j, eng.submit(_X[j:j + 2])))
                time.sleep(0.002)

        t = threading.Thread(target=feed)
        t.start()
        eng.refresh(_X2)
        t.join(10)
        assert not t.is_alive()
        for j, f in futs:
            d, i = f.result(timeout=10)
            gens = [_solo(x, _X[j:j + 2])[1] for x in (_X, _X2)]
            assert any(np.array_equal(i, g) for g in gens)
        assert eng.stats["refreshes"] == 1
        eng.close()


# ---------------------------------------------------------------------------
# bounded, idempotent shutdown


class TestClose:
    def test_close_idempotent_and_rejects_typed(self):
        eng = _engine()
        eng.close()
        eng.close()
        with pytest.raises(RejectedError) as exc:
            eng.search([_X[:2]])
        assert exc.value.reason == "closed"
        with pytest.raises(LogicError):
            eng.warmup()
        with pytest.raises(LogicError):
            eng.refresh(_X2)
        assert eng._health()["ready"] is False

    def test_close_drains_in_flight_requests(self):
        eng = _engine()
        outs = {}
        started = threading.Event()

        def slow_search():
            with faults.plan("dispatch:n=1:stall=0.4"):
                started.set()
                outs["v"] = eng.search([_X[:3]])

        t = threading.Thread(target=slow_search)
        t.start()
        started.wait(5)
        time.sleep(0.1)   # let the search take the engine lock
        t0 = time.monotonic()
        eng.close(timeout_s=5.0)
        close_wall = time.monotonic() - t0
        t.join(10)
        assert not t.is_alive()
        _assert_solo(outs["v"][0], _X, _X[:3])
        assert close_wall < 5.0
        with pytest.raises(RejectedError):
            eng.search([_X[:2]])

    def test_close_stops_scrape_server(self):
        eng = _engine()
        srv = eng.serve_http(port=0)
        url = f"{srv.url}/healthz"
        with urllib.request.urlopen(url, timeout=5) as r:
            assert json.loads(r.read())["ready"] is True
        eng.close()
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(url, timeout=1)


@pytest.mark.parametrize("call", ["shadow_samples", "attach_tuner",
                                  "apply_tuning"])
def test_autotuning_hooks_not_ported_yet(call):
    """The autotuner's three engine hooks, which raised "not ported yet"
    until the autotuner was ported (the test keeps its name), now work on
    a CPU engine: the shadow ring holds the served requests, an attached
    tuner shows in /healthz, apply_tuning applies a warmed cap and
    returns the previous one."""
    eng = _engine(max_batch=16)
    try:
        if call == "shadow_samples":
            ring = eng.shadow_samples()
            assert len(ring) == 1
            np.testing.assert_array_equal(ring[0], _X[:2])
        elif call == "attach_tuner":
            tuner = types.SimpleNamespace(health=lambda: {"promoted": None})
            eng.attach_tuner(tuner)
            assert eng._health()["autotune"] == {"promoted": None}
            eng.attach_tuner(None)
            assert "autotune" not in eng._health()
        else:
            assert eng.apply_tuning(max_batch=8)["max_batch"] == 16
            assert eng.max_batch == 8
            _assert_solo(eng.search([_X[:12]])[0], _X, _X[:12])
    finally:
        eng.close()


def test_autotuner_shadow_lane_not_ported_yet():
    """The shadow lane, which raised "not ported yet" until the replica
    backend was ported (the test keeps its name), is a lane of a replica
    engine: a single-device engine has none, and the tuner refuses it
    (tests/test_torch_serve_sharded.py drives a real one)."""
    from raft_tpu_torch.serve import AutoTuner

    eng = _engine(max_batch=16)
    try:
        with pytest.raises(LogicError, match="replica engine"):
            AutoTuner(eng, shadow_lane=0)
    finally:
        eng.close()
