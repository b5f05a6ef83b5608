"""Distributed serving on the CPU: a sharded engine at W = 2 (IVF-Flat,
IVF-PQ, brute force under L1) and a replica engine at W = 4 (R = 2 × S =
2, IVF-PQ), each a gloo world of processes, rank 0 leading and the other
ranks in ``ServeEngine.follow()``.

Coalesced results are bit for bit the solo ``ann_mnmg.search`` of each
request on the same ranks (the JAX side is held to it in
``test_torch_ann_mnmg.py``); every super-batch makes
one allgather on the data communicator; the router uses both replica
lanes; the fault plan ``comms:op=replica_dispatch:rank=1:raise`` drains
lane 1 with no failed request and re-routes its traffic; ``refresh`` to a
new ``ReplicaSet`` gets a fresh router; ``/healthz``'s ``replicas``
object has the JAX engine's keys; ``AutoTuner(shadow_lane=1)`` explores
on the drained lane while live requests run, none failing; ``close()``
releases every follower, and every wait is bounded (the session's
process-group timeout, which the control groups take, and
``run_world(timeout=)``)."""

import pathlib
import threading

import numpy as np
import pytest

N, D, K = 400, 16, 7
SIZES = (5, 15, 17, 3, 9, 40, 0, 22, 11, 30, 2)   # 40 > max_batch: solo
MAX_BATCH = 32
KINDS = ("ivf_flat", "ivf_pq", "brute_force")


def _data(seed=7):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (10, D))
    x = (c[rng.integers(0, 10, N)] + rng.standard_normal((N, D))
         ).astype(np.float32)
    reqs = [(c[rng.integers(0, 10, n)] + rng.standard_normal((n, D))
             ).astype(np.float32) for n in SIZES]
    return x, reqs


def _index(kind, seed=7):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    x, _ = _data(seed)
    if kind == "ivf_flat":
        return (ivf_flat.build(ivf_flat.IndexParams(n_lists=8), x,
                               device="cpu"),
                ivf_flat.SearchParams(n_probes=3))
    if kind == "ivf_pq":
        return (ivf_pq.build(ivf_pq.IndexParams(n_lists=8, pq_dim=8), x,
                             device="cpu"),
                ivf_pq.SearchParams(n_probes=3))
    return x, None


def _shard(kind, comms):
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors import ann_mnmg

    idx, p = _index(kind)
    if kind == "brute_force":
        return ann_mnmg.shard_brute_force(idx, comms, DistanceType.L1,
                                          device="cpu"), None
    return idx.shard(comms), p


def _solo_refs(sh, reqs, p):
    """Each request's solo ``ann_mnmg.search`` (a collective: every rank
    runs it, before the engine exists)."""
    from raft_tpu_torch.neighbors import ann_mnmg

    return [tuple(t.numpy() for t in ann_mnmg.search(sh, q, K, p))
            for q in reqs]


def _plain(outs):
    return [o if isinstance(o, Exception) else (o[0], o[1]) for o in outs]


def _sharded_battery(comms, payload):
    from raft_tpu_torch.serve import ServeEngine

    _, reqs = _data()
    out = {"control": []}
    for kind in KINDS:
        sh, p = _shard(kind, comms)
        refs = _solo_refs(sh, reqs, p)
        eng = ServeEngine(sh, K, p, max_batch=MAX_BATCH)
        out["control"].append(
            (comms.timeout_s, eng._wire.groups,
             all(g in comms._made for g in eng._wire.groups)))
        if not eng.is_leader:
            out[kind] = {"follow": eng.follow(),
                         "wire": dict(eng._wire.calls)}
            continue
        calls = comms.collective_calls
        eng.warmup()
        before = calls["allgather"]
        outs = eng.search(reqs)
        stats = dict(eng.stats)
        gathers = calls["allgather"] - before
        futs = [eng.submit(q) for q in reqs[:4]]
        eng.flush()
        streamed = [f.result(timeout=60) for f in futs]
        out[kind] = {"outs": _plain(outs), "refs": refs,
                     "streamed": streamed, "stats": stats,
                     "gathers": gathers,
                     "warmed": eng.warmed_signatures(),
                     "backend": eng.backend}
        eng.close()
        out[kind]["wire"] = dict(eng._wire.calls)
    out["control"] = [(t, groups is out["control"][0][1], made)
                      for t, groups, made in out["control"]]
    return out


def _replica_battery(comms, payload):
    from raft_tpu_torch.neighbors import ann_mnmg
    from raft_tpu_torch.serve import AutoTuner, ServeEngine, TunerConfig
    from raft_tpu_torch.testing import faults

    _, reqs = _data()
    idx, p = _index("ivf_pq")
    rep = ann_mnmg.replicate(idx, comms, 2)
    refs = _solo_refs(rep.local, reqs, p)
    idx2, _ = _index("ivf_pq", seed=11)
    rep2 = ann_mnmg.replicate(idx2, rep.layout)
    refs2 = _solo_refs(rep2.local, reqs, p)
    eng = ServeEngine(rep, K, p, max_batch=MAX_BATCH)
    if not eng.is_leader:
        refreshes = 0
        while (why := eng.follow()) == "refresh":
            eng.refresh(rep2)
            refreshes += 1
        return {"follow": why, "refreshes": refreshes, "refs": refs,
                "refs2": refs2, "wire": dict(eng._wire.calls)}
    out = {"refs": refs}
    eng.warmup()
    router = eng._router
    lanes = lambda: [router._dispatches.get((eng._engine_id, str(r)))  # noqa
                     for r in range(2)]
    out["outs"] = _plain(eng.search(reqs))
    out["lanes"] = lanes()
    out["healthz"] = eng._health()["replicas"]
    # the shadow-lane tune while live traffic runs
    failed = []

    def live():
        for _ in range(6):
            failed.extend(o for o in eng.search(reqs)
                          if isinstance(o, Exception))

    sigs = eng.warmed_signatures()
    t = threading.Thread(target=live)
    before_live = lanes()
    t.start()
    tuner = AutoTuner(eng, TunerConfig(seed=0, shadow_requests=6, pairs=1),
                      shadow_lane=1)
    out["tune"] = tuner.run()["winner"]
    t.join(timeout=120)
    out["tune_live_failed"] = len(failed)
    out["tune_degraded_after"] = router.degraded_lanes()
    out["tune_sigs_same"] = eng.warmed_signatures() == sigs
    out["live_lanes_during_tune"] = [a - b for a, b in
                                     zip(lanes(), before_live)]
    # the fault plan drains lane 1 with no failed request
    with faults.plan("comms:op=replica_dispatch:rank=1:raise"):
        outs = eng.search(reqs)
    out["fault_outs"] = _plain(outs)
    out["fault_stats"] = {k: eng.stats[k] for k in
                          ("replica_faults", "replica_reroutes",
                           "dispatch_errors")}
    out["fault_healthz"] = eng._health()
    # refresh to a new ReplicaSet over the same layout: a fresh router
    eng.refresh(rep2)
    out["refresh_healthz"] = eng._health()["replicas"]
    out["refresh_outs"] = _plain(eng.search(reqs))
    out["refresh_lanes"] = [eng._router._dispatches.get(
        (eng._engine_id, str(r))) for r in range(2)]
    eng.close()
    out["wire"] = dict(eng._wire.calls)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from raft_tpu_torch.testing.world import run_world

    here = [str(pathlib.Path(__file__).parent)]
    root = tmp_path_factory.mktemp("serve_sharded")
    return {
        "sharded": run_world("test_torch_serve_sharded:_sharded_battery", 2,
                             workdir=root / "w2", timeout=240,
                             sys_path=here),
        "replica": run_world("test_torch_serve_sharded:_replica_battery", 4,
                             workdir=root / "w4", timeout=240,
                             sys_path=here)}


def _assert_bits(outs, refs):
    for (d, i), (rd, ri) in zip(outs, refs):
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(i, ri)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_coalesced_equals_solo_search(worlds, kind):
    lead = worlds["sharded"][0][kind]
    assert all(isinstance(o, tuple) for o in lead["outs"])
    _assert_bits(lead["outs"], lead["refs"])
    _assert_bits(lead["streamed"], lead["refs"][:4])
    assert lead["backend"] == f"sharded_{kind}"
    assert lead["stats"]["solo_fallbacks"] == 1
    # every super-batch and the solo batch: one allgather each
    assert lead["gathers"] == (lead["stats"]["super_batches"]
                               + lead["stats"]["solo_fallbacks"])


def test_control_groups_take_the_session_timeout_and_are_shared(worlds):
    # every engine over the same lanes of one communicator shares its
    # control groups, made with the session's timeout and released with
    # the session (run_world's timeout is 240 s)
    for rank in worlds["sharded"]:
        assert rank["control"] == [(240.0, True, True)] * len(KINDS)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_close_releases_followers(worlds, kind):
    lead, follower = worlds["sharded"][0][kind], worlds["sharded"][1][kind]
    assert follower["follow"] == "close"
    # what the leader sent is what the follower took, all of it staged
    # through the host
    for key in ("header", "block", "block_bytes"):
        assert follower["wire"][key] == lead["wire"][key] > 0


def test_replica_coalesced_equals_solo_and_both_lanes_serve(worlds):
    lead = worlds["replica"][0]
    assert all(isinstance(o, tuple) for o in lead["outs"])
    _assert_bits(lead["outs"], lead["refs"])
    # every group answers with the same bits
    for r in worlds["replica"][1:]:
        _assert_bits(r["refs"], lead["refs"])
    assert all(n > 0 for n in lead["lanes"])
    # lane 1's results came back over the wire
    assert lead["wire"]["result"] > 0


def test_replica_fault_plan_drains_lane_one(worlds):
    lead = worlds["replica"][0]
    assert all(isinstance(o, tuple) for o in lead["fault_outs"])
    _assert_bits(lead["fault_outs"], lead["refs"])
    st = lead["fault_stats"]
    assert st["replica_faults"] >= 1 and st["replica_reroutes"] > 0
    assert st["dispatch_errors"] == 0
    h = lead["fault_healthz"]
    assert h["replicas"]["degraded"] == [1] and h["degraded"] is True


def test_replica_healthz_keys_equal_jax():
    from raft_tpu.serve.schedule import ReplicaRouter as JaxRouter
    from raft_tpu_torch.serve.schedule import ReplicaRouter

    assert set(ReplicaRouter(2, "t").health()) == set(
        JaxRouter(2, "t").health())


def test_replica_healthz_object(worlds):
    lead = worlds["replica"][0]
    assert lead["healthz"] == {"total": 2, "live": 2, "degraded": []}


def test_refresh_to_new_replica_set_gets_fresh_router(worlds):
    lead = worlds["replica"][0]
    assert lead["refresh_healthz"] == {"total": 2, "live": 2,
                                       "degraded": []}
    _assert_bits(lead["refresh_outs"], worlds["replica"][1]["refs2"])
    assert worlds["replica"][1]["refs2"][1][1].tolist() != \
        lead["refs"][1][1].tolist()
    assert all(n > 0 for n in lead["refresh_lanes"])
    assert all(r["refreshes"] == 1 for r in worlds["replica"][1:])


def test_autotuner_shadow_lane_explores_without_failing_live(worlds):
    lead = worlds["replica"][0]
    assert lead["tune_live_failed"] == 0
    assert lead["tune_degraded_after"] == []     # the lane is restored
    assert lead["tune_sigs_same"]
    # live traffic kept flowing (on lane 0) while the tuner replayed on
    # the drained lane 1
    assert lead["live_lanes_during_tune"][0] > 0


def test_replica_close_releases_followers(worlds):
    for r in worlds["replica"][1:]:
        assert r["follow"] == "close"
