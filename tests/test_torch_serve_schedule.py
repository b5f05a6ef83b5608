"""The port's continuous-batching layer against ``raft_tpu.serve``: the
chooser, the streaming quantum rule, the cost model and the replica
router give the reference's outputs on the same inputs (hypothesis);
the engine's scheduler and ``submit()`` path are mirrored from
``tests/test_serve_schedule.py`` on the CPU; and an IVF-PQ index built by
``raft_tpu`` (read through ``load_ivf_pq``) and a dense brute-force index
served through both engines' ``submit()`` with the same requests and
deadlines give results within ``_assert_search_parity``'s tolerances
(distances rtol 1e-5, ids equal outside ties) and equal counters."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors import serialize as jax_ser
from raft_tpu.serve import AdmissionController as JaxAdmission
from raft_tpu.serve import SchedulerConfig as JaxSchedulerConfig
from raft_tpu.serve import ServeEngine as JaxServeEngine
from raft_tpu.serve import RejectedError as JaxRejectedError
from raft_tpu.serve import ServeRequest as JaxServeRequest
from raft_tpu.serve import schedule as jsched
from raft_tpu_torch import telemetry
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import serialize as tser
from raft_tpu_torch.serve import (AdmissionController, RejectedError,
                                  SchedulerConfig, ServeEngine, ServeRequest)
from raft_tpu_torch.serve import schedule as tsched
from test_torch_ivf_pq import _assert_search_parity

_DIM, _K = 16, 4
SETTINGS = settings(max_examples=60, deadline=None, database=None)


def _data(n=512, seed=0):
    return np.random.default_rng(seed).random((n, _DIM), dtype=np.float32)


def _bucket_for(total, max_batch=1024):
    return min(bucket_dim(total), max_batch)


def _solo(x, q):
    d, i = tbf.knn(x, q, _K, device="cpu")
    return d.numpy(), i.numpy()


# ---------------------------------------------------------------------------
# policy objects: identical outputs on identical inputs

_ladder = st.sampled_from([8, 16, 32, 64, 128, 256, 512, 1024])
_costs = st.lists(st.tuples(_ladder, st.floats(1e-5, 1.0)), max_size=6)


def _models(obs, static=0.05, use_telemetry=True):
    models = (tsched.CostModel(static_batch_s=static,
                               use_telemetry=use_telemetry),
              jsched.CostModel(static_batch_s=static,
                               use_telemetry=use_telemetry))
    for m in models:
        for b, c in obs:
            m.observe("float32", b, c)
    return models


@SETTINGS
@given(sizes=st.lists(st.sampled_from([1, 2, 5, 8, 16, 40, 130, 700, 1100]),
                      max_size=25),
       deadline_slots=st.lists(st.one_of(st.none(), st.floats(0.0, 2.0)),
                               min_size=25, max_size=25),
       obs=_costs, max_bucket=st.sampled_from([64, 1024]),
       now=st.floats(0.0, 1.0), use_telemetry=st.booleans())
def test_choose_batches_equals_the_reference(sizes, deadline_slots, obs,
                                             max_bucket, now, use_telemetry):
    dls = deadline_slots[:len(sizes)]
    tm, jm = _models(obs, use_telemetry=use_telemetry)

    def ladder(total):
        return _bucket_for(total, max_bucket)

    got = tsched.choose_batches(sizes, dls, ladder, max_bucket, tm,
                                "float32", now)
    ref = jsched.choose_batches(sizes, dls, ladder, max_bucket, jm,
                                "float32", now)
    assert got == ref


@SETTINGS
@given(rows=st.integers(0, 2000), largest=st.sampled_from([8, 64, 1024]),
       oldest=st.floats(0.0, 0.1), quantum=st.floats(1e-4, 0.05),
       dls=st.lists(st.one_of(st.none(), st.floats(-1.0, 1.0)), max_size=5),
       now=st.floats(-0.5, 0.5), est=st.floats(0.0, 0.2))
def test_should_dispatch_equals_the_reference(rows, largest, oldest, quantum,
                                              dls, now, est):
    assert tsched.should_dispatch(rows, largest, oldest, quantum, dls, now,
                                  est) == \
        jsched.should_dispatch(rows, largest, oldest, quantum, dls, now, est)


@SETTINGS
@given(obs=_costs, bucket=st.integers(1, 2048),
       dtype=st.sampled_from(["float32", "bfloat16"]),
       static=st.floats(1e-3, 1.0), use_telemetry=st.booleans())
def test_cost_model_equals_the_reference(obs, bucket, dtype, static,
                                         use_telemetry):
    tm, jm = _models(obs, static, use_telemetry)
    assert tm.batch_cost_s(dtype, bucket) == jm.batch_cost_s(dtype, bucket)


def test_cost_model_registry_seed():
    hist = telemetry.histogram("raft_tpu_aot_dispatch_seconds",
                               labelnames=("fn", "sig"))
    fn = "t_torch_sched_seed_fn"
    for sig in ("a", "a", "b"):
        hist.observe(0.02, (fn, sig))
    cm = tsched.CostModel(fn=fn)
    assert cm.batch_cost_s("float32", 32) == pytest.approx(0.02, rel=0.5)


_router_ops = st.lists(st.one_of(
    st.tuples(st.just("pick"), st.floats(0.0, 5.0), st.floats(0.0, 1.0),
              st.lists(st.integers(0, 3), max_size=2)),
    st.tuples(st.just("done"), st.integers(0, 3), st.floats(0.0, 5.0),
              st.one_of(st.none(), st.floats(0.0, 1.0))),
    st.tuples(st.sampled_from(["fault", "drain", "restore"]),
              st.integers(0, 3))), max_size=30)


@SETTINGS
@given(n_lanes=st.integers(1, 4), ops=_router_ops)
def test_replica_router_equals_the_reference(n_lanes, ops):
    routers = (tsched.ReplicaRouter(n_lanes, "t-torch-router"),
               jsched.ReplicaRouter(n_lanes, "t-torch-router"))
    for op in ops:
        outs = []
        for r in routers:
            if op[0] == "pick":
                outs.append(r.pick(op[1], op[2], exclude=op[3]))
            elif op[1] < n_lanes:
                if op[0] == "done":
                    r.note_done(op[1], op[2], op[3])
                else:
                    getattr(r, op[0])(op[1])
            outs.append((r.health(), [r.slowness(i)
                                      for i in range(n_lanes)]))
        assert outs[:len(outs) // 2] == outs[len(outs) // 2:]


# ---------------------------------------------------------------------------
# the engine's scheduler (mirrors tests/test_serve_schedule.py)


def test_scheduler_on_off_bit_identical():
    x = _data()
    rng = np.random.default_rng(3)
    reqs = [rng.random((n, _DIM), dtype=np.float32)
            for n in (3, 9, 1, 14, 6, 2)]
    eng_on = ServeEngine(x, _K, max_batch=32, device="cpu")
    eng_off = ServeEngine(x, _K, max_batch=32, device="cpu", scheduler=False)
    for e in (eng_on, eng_off):
        e.warmup()
    for q, (d1, i1), (d2, i2) in zip(reqs, eng_on.search(reqs),
                                     eng_off.search(reqs)):
        d0, i0 = _solo(x, q)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(i2, i0)
        np.testing.assert_array_equal(d1, d2)
    assert eng_on.stats["super_batches"] == eng_off.stats["super_batches"]


def test_chooser_uses_only_warmed_buckets_after_observations(monkeypatch):
    x = _data()
    eng = ServeEngine(x, _K, max_batch=64, device="cpu")
    eng.warmup()
    eng._cost.observe("float32", 8, 0.0001)
    eng._cost.observe("float32", 64, 1.0)
    rng = np.random.default_rng(4)
    reqs = [rng.random((n, _DIM), dtype=np.float32)
            for n in (30, 5, 3, 20, 8)]
    eng.search([reqs[0]])   # a measured cost at bucket 32
    buckets = []
    real = eng._dispatch

    def spy(block, lane, bucket, cold):
        buckets.append((bucket, cold))
        return real(block, lane, bucket, cold)

    monkeypatch.setattr(eng, "_dispatch", spy)
    sb0 = eng.stats["super_batches"]
    for q, (d, i) in zip(reqs, eng.search(reqs)):
        np.testing.assert_array_equal(i, _solo(x, q)[1])
    assert buckets and all(b in (8, 16, 32, 64) and not cold
                           for b, cold in buckets)
    # big buckets are expensive on this surface: more, smaller batches
    # than drain-all's single fill
    assert eng.stats["super_batches"] - sb0 >= 3


def test_submit_streaming_coalesces_and_matches():
    x = _data()
    eng = ServeEngine(x, _K, max_batch=32, device="cpu",
                      scheduler=SchedulerConfig(quantum_s=0.02))
    eng.warmup()
    rng = np.random.default_rng(5)
    reqs = [rng.random((n, _DIM), dtype=np.float32) for n in (2, 3, 4, 1, 5)]
    futs = [eng.submit(q) for q in reqs]
    outs = [f.result(timeout=30) for f in futs]
    for q, (d, i) in zip(reqs, outs):
        d0, i0 = _solo(x, q)
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_array_equal(d, d0)
    # the quantum coalesced the submissions: fewer batches than requests
    assert eng.stats["super_batches"] < len(reqs)
    assert eng.stats["sched_dispatches"] >= 1
    eng.close()


def test_submit_deadline_rides_through_admission():
    eng = ServeEngine(_data(), _K, max_batch=32, device="cpu",
                      scheduler=SchedulerConfig(quantum_s=0.01))
    eng.warmup()
    fut = eng.submit(ServeRequest(_data(3, seed=11),
                                  deadline_s=telemetry.now() - 1.0))
    eng.flush()
    with pytest.raises(RejectedError) as exc:
        fut.result(timeout=30)
    assert exc.value.reason == "deadline"
    eng.close()


def test_submit_after_close_rejects_and_pending_resolve():
    eng = ServeEngine(_data(), _K, max_batch=32, device="cpu",
                      scheduler=SchedulerConfig(quantum_s=30.0))
    eng.warmup()
    fut = eng.submit(_data(2, seed=12))   # parked behind a long quantum
    eng.close()
    with pytest.raises(RejectedError):
        fut.result(timeout=30)
    with pytest.raises(RejectedError):
        eng.submit(_data(2, seed=12))


def test_submit_requires_scheduler():
    eng = ServeEngine(_data(), _K, max_batch=32, device="cpu",
                      scheduler=False)
    with pytest.raises(Exception):
        eng.submit(_data(2, seed=13))
    eng.close()


def test_concurrent_submitters():
    x = _data()
    eng = ServeEngine(x, _K, max_batch=64, device="cpu",
                      scheduler=SchedulerConfig(quantum_s=0.05))
    eng.warmup()
    rng = np.random.default_rng(6)
    reqs = [rng.random((3, _DIM), dtype=np.float32) for _ in range(8)]
    futs = [None] * len(reqs)

    def worker(j):
        futs[j] = eng.submit(reqs[j])

    threads = [threading.Thread(target=worker, args=(j,))
               for j in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    for q, f in zip(reqs, futs):
        np.testing.assert_array_equal(f.result(timeout=30)[1], _solo(x, q)[1])
    eng.close()


def test_dead_scheduler_thread_fails_its_futures(monkeypatch):
    x = _data()
    eng = ServeEngine(x, _K, max_batch=32, device="cpu",
                      scheduler=SchedulerConfig(quantum_s=0.01))
    eng.warmup()

    def broken(dtype, bucket):
        raise RuntimeError("cost model failed")

    monkeypatch.setattr(eng._cost, "batch_cost_s", broken)
    futs = [eng.submit(_data(2, seed=s)) for s in (1, 2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="cost model failed"):
            f.result(timeout=10)
    eng._sched_thread.join(5)
    assert not eng._sched_thread.is_alive()
    monkeypatch.undo()
    q = _data(2, seed=3)   # the next submit starts a new thread
    np.testing.assert_array_equal(eng.submit(q).result(timeout=10)[1],
                                  _solo(x, q)[1])
    eng.close()


# ---------------------------------------------------------------------------
# submit() parity with the JAX engine

SIZES = (1, 7, 0, 3, 20, 9, 5, 100)   # 100 > max_batch: solo, and dispatches
KINDS = ("plain", "tight", "loose", "plain", "tight", "loose", "plain",
         "plain")
COUNTERS = ("requests", "queries", "admitted", "sheds", "super_batches",
            "coalesced_requests", "solo_fallbacks")


def _wrap(cls, kind, q):
    # admission's static estimate is 100 s a batch: a 50-s budget sheds at
    # admission, a 1,000-s one is admitted; neither makes the scheduler
    # dispatch early (quantum 30 s), so all eight go out in ONE search()
    # once the solo-sized last request fills the bucket
    if kind == "plain":
        return q
    return cls(q, timeout_s=50.0 if kind == "tight" else 1000.0)


def _stream(eng, request_cls, reqs):
    futs = [eng.submit(_wrap(request_cls, kind, q))
            for kind, q in zip(KINDS, reqs)]
    outs = []
    for f in futs:
        try:
            outs.append(f.result(timeout=60))
        except Exception as e:   # typed rejections, compared below
            outs.append(e)
    stats = {key: eng.stats[key] for key in COUNTERS}
    eng.close()
    return outs, stats


def _compare_submit(tindex, jindex, reqs, targs=(), jargs=(), tkw=None,
                    jkw=None):
    """Serve *reqs* through both engines' submit() under the same
    deterministic admission and scheduler settings; compare results and
    counters."""
    engines = []
    for cls, index, args, kw, sched, adm in (
            (ServeEngine, tindex, targs, tkw, SchedulerConfig,
             AdmissionController),
            (JaxServeEngine, jindex, jargs, jkw, JaxSchedulerConfig,
             JaxAdmission)):
        eng = cls(index, 10, *args, max_batch=64,
                  scheduler=sched(quantum_s=30.0, static_batch_s=0.001,
                                  use_telemetry=False),
                  admission=adm(static_batch_s=100.0, use_telemetry=False),
                  **(kw or {}))
        eng.warmup()
        engines.append(eng)
    got, gstats = _stream(engines[0], ServeRequest, reqs)
    ref, rstats = _stream(engines[1], JaxServeRequest, reqs)
    assert gstats == rstats
    assert gstats["sheds"] == 2 and gstats["solo_fallbacks"] == 1
    for kind, g, r in zip(KINDS, got, ref):
        if kind == "tight":
            assert isinstance(g, RejectedError) and g.reason == "deadline"
            assert isinstance(r, JaxRejectedError) and r.reason == "deadline"
        else:
            _assert_search_parity((torch.from_numpy(g[0]),
                                   torch.from_numpy(g[1])), r)


def _mixture(seed, dim):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (30, dim))

    def draw(n):
        return (c[rng.integers(0, 30, n)]
                + rng.standard_normal((n, dim))).astype(np.float32)

    return draw


def test_submit_parity_ivf_pq(tmp_path):
    draw = _mixture(1, 32)
    jidx = jax_pq.build(jax_pq.IndexParams(n_lists=20, pq_dim=8),
                        jnp.asarray(draw(3000)))
    path = tmp_path / "index.npz"
    jax_ser.save_ivf_pq(path, jidx)
    tidx = tser.load_ivf_pq(path, device="cpu")
    _compare_submit(tidx, jidx, [draw(n) for n in SIZES],
                    (tpq.SearchParams(n_probes=5),),
                    (jax_pq.SearchParams(n_probes=5),))


def test_submit_parity_brute_force():
    draw = _mixture(2, 16)
    x = draw(1500)
    _compare_submit(x, jnp.asarray(x), [draw(n) for n in SIZES],
                    tkw=dict(metric=DistanceType.L1, batch_size_index=512,
                             device="cpu"),
                    jkw=dict(metric=int(DistanceType.L1),
                             batch_size_index=512))
