"""The zero-compile serving contract on every serving path of the port:
after ``warmup()`` (or a first read that records the signature) traffic
makes no first call of a keyed program (``aot_compile_counters
["compiles"]`` flat).  The counterparts of the JAX package's 20 tests
that assert it on the mutable, tiered, autotuned, scheduled, faulted,
sharded, replica, build, eager IVF-Flat and telemetry paths; every newly
keyed program against the function it wraps, bit for bit; and one seeded
mutable churn through both packages on a JAX-built main, where the reads
after a shape-changing upsert compile nothing in either package and the
port's first calls land inside the upsert.

The JAX package's own tests assert its side of these paths; the sharded
and replica cases run in one gloo world of two processes
(``testing.world.run_world``)."""

import importlib
import pathlib
import threading

import numpy as np
import pytest
import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.neighbors import (_build, ann_mnmg, brute_force,
                                      ivf_flat, ivf_pq, mutable, tiering)
from raft_tpu_torch.serve import (AutoTuner, Candidate, SchedulerConfig,
                                  ServeEngine, TunerConfig)
from raft_tpu_torch.testing import faults

aot = importlib.import_module("raft_tpu_torch.core.aot")
counters = aot.aot_compile_counters

N, DIM, K = 2000, 16, 5


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    c = np.random.default_rng(99).uniform(-3, 3, (12, DIM))
    return (c[rng.integers(0, 12, n)]
            + rng.standard_normal((n, DIM))).astype(np.float32)


def _reqs(seed, sizes=(3, 7, 1, 12, 5)):
    return [_data(seed + j, n) for j, n in enumerate(sizes)]


@pytest.fixture(scope="module")
def x():
    return _data()


FLAT_PARAMS = ivf_flat.IndexParams(n_lists=16, kmeans_n_iters=4)
PQ_PARAMS = ivf_pq.IndexParams(n_lists=16, pq_dim=8, pq_bits=4,
                               kmeans_n_iters=4)


@pytest.fixture(scope="module")
def flat(x):
    return ivf_flat.build(FLAT_PARAMS, x, device="cpu")


@pytest.fixture(scope="module")
def pq(x):
    return ivf_pq.build(PQ_PARAMS, x, device="cpu")


def _knn_ids(x, q):
    return brute_force.knn(torch.as_tensor(x), torch.as_tensor(q), K,
                           device="cpu")[1].numpy()


def _flat_engine(x, **kw):
    eng = ServeEngine(torch.as_tensor(x), K, max_batch=32, device="cpu",
                      **kw)
    eng.warmup()
    return eng


# ---------------------------------------------------------------------------
# the mutable index


def test_warm_write_path_zero_compiles(x, flat):
    """``test_mutable.py::TestWritePath::test_warm_write_path_zero_
    compiles``: a delete is a bitmap value change, and an upsert that
    lands on shapes seen before (the same ids and rows: the delta's dedup
    repack) runs warm programs; the reads after them compile nothing."""
    mut = mutable.MutableIndex(flat, x, build_params=FLAT_PARAMS)
    rng = np.random.default_rng(3)
    v = rng.random((64, DIM)).astype(np.float32)
    ids = np.arange(300, 364, dtype=np.int64)
    q = rng.random((8, DIM)).astype(np.float32)
    sp = ivf_flat.SearchParams(n_probes=4)
    mut.upsert(v, ids)
    mutable.search(mut, q, K, params=sp)
    c0 = counters["compiles"]
    assert mut.delete(np.arange(400, 432, dtype=np.int64)) == 32
    mut.upsert(v, ids)
    d, i = mutable.search(mut, q, K, params=sp)
    assert counters["compiles"] == c0, dict(counters)
    assert d.shape == (8, K)
    assert not (set(i.numpy().ravel().tolist()) & set(range(400, 432)))


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_engine_reads_across_writes_and_compaction(x, flat, pq, kind):
    """The mutable backend after ``warmup()``: shape-changing upserts
    rewarm on the write path (``mutable_counters["rewarms"]``), a delete
    changes no shape, compaction (IVF-Flat's) warms its new core before
    the swap, and no read in between makes a first call."""
    fam = ivf_flat if kind == "ivf_flat" else ivf_pq
    main = flat if kind == "ivf_flat" else pq
    bp = FLAT_PARAMS if kind == "ivf_flat" else PQ_PARAMS
    mut = mutable.MutableIndex(main, x, build_params=bp)
    eng = ServeEngine(mut, K, fam.SearchParams(n_probes=4), max_batch=16,
                      device="cpu", scheduler=False, admission=False)
    try:
        eng.warmup()
        reqs = _reqs(5)
        r0 = mutable.mutable_counters["rewarms"]
        write_compiles = 0
        for b in range(2):
            c = counters["compiles"]
            mut.upsert(_data(40 + b, 150),
                       np.arange(N + 150 * b, N + 150 * (b + 1)))
            write_compiles += counters["compiles"] - c
            mut.delete(np.arange(10 * b, 10 * b + 10))
            c = counters["compiles"]
            outs = eng.search(reqs)
            assert counters["compiles"] == c, (b, dict(counters))
            assert all(isinstance(o, tuple) for o in outs)
        rewarms = mutable.mutable_counters["rewarms"] - r0
        assert rewarms >= 1 and write_compiles >= 1
        if kind == "ivf_pq":
            return
        c = counters["compiles"]
        mut.compact(engine=eng)
        assert counters["compiles"] > c          # the new core's warm runs
        c = counters["compiles"]
        outs = eng.search(reqs)
        assert counters["compiles"] == c
        for q, (d, i) in zip(reqs, outs):
            d0, i0 = mutable.search(mut, q, K, params=fam.SearchParams(
                n_probes=4))
            np.testing.assert_array_equal(i, i0.numpy())
            np.testing.assert_array_equal(d, d0.numpy())
    finally:
        eng.close()


def test_delta_grows_on_the_ladder(x, flat):
    """The delta's block rows and chunk-table width are powers of two, so
    its shapes change O(log n) times under churn."""
    mut = mutable.MutableIndex(flat, x, build_params=FLAT_PARAMS)
    shapes = set()
    for b in range(12):
        mut.upsert(_data(70 + b, 100), np.arange(N + 100 * b,
                                                 N + 100 * (b + 1)))
        d = mut._mut_core.delta
        rows, width = d.list_data.shape[0], d.chunk_table.shape[1]
        assert rows & (rows - 1) == 0 and width & (width - 1) == 0
        shapes.add((rows, width))
    assert len(shapes) <= 6, shapes


# ---------------------------------------------------------------------------
# tiering


def test_zero_compile_warmed_tiered_engine(x, pq):
    """``test_tiering.py::TestServing::test_zero_compile_warmed_engine``:
    the hot phase, every cold tile's scan, the merges and the refine are
    warm after ``warmup()``; results equal the solo tiered search."""
    t = tiering.tier(pq, hot_fraction=0.5, tile_phys=17, dataset=x)
    sp = ivf_pq.SearchParams(n_probes=8, refine_ratio=4)
    eng = ServeEngine(t, K, sp, max_batch=32, device="cpu")
    try:
        eng.warmup()
        # warming counts no probes: it runs on a scratch counter
        assert int(eng._backend.searcher.hotness().sum()) == 0
        reqs = [x[:20], x[7:19], x[:40]]
        eng.search(reqs)
        c0 = counters["compiles"]
        outs = eng.search(reqs)
        assert counters["compiles"] == c0, dict(counters)
        for (d, i), req in zip(outs, reqs):
            _, i_solo = tiering.search(t, req, K, params=sp)
            np.testing.assert_array_equal(i, i_solo.numpy())
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the autotuner, the scheduler, faults, telemetry


def test_explore_and_promote_are_zero_compile(x):
    eng = _flat_engine(x)
    try:
        eng.search(_reqs(3))
        tuner = AutoTuner(eng, TunerConfig(seed=0, pairs=1,
                                           shadow_requests=8))
        c0 = counters["compiles"]
        tuner.warm_candidates()
        tuner.explore()
        tuner.promote(Candidate("cap16", max_batch=16))
        reqs = _reqs(4)
        outs = eng.search(reqs)
        assert counters["compiles"] == c0, dict(counters)
        assert eng.max_batch == 16
        for q, (d, i) in zip(reqs, outs):
            np.testing.assert_array_equal(i, _knn_ids(x, q))
    finally:
        eng.close()


def test_params_promotion_via_refresh_zero_compile(flat):
    sp0 = ivf_flat.SearchParams(n_probes=2)
    sp1 = ivf_flat.SearchParams(n_probes=6)
    eng = ServeEngine(flat, K, sp0, max_batch=16, device="cpu")
    eng.warmup()
    try:
        eng.search(_reqs(5))
        tuner = AutoTuner(eng, TunerConfig(seed=0, pairs=1,
                                           shadow_requests=6),
                          param_variants=[sp1])
        assert tuner.warm_candidates() > 0
        c0 = counters["compiles"]
        score = tuner._measure_real(Candidate("params0", params=sp1),
                                    _reqs(6))
        assert score.qps > 0 and 0.0 <= score.recall <= 1.0
        tuner.promote(Candidate("params0", params=sp1))
        reqs = _reqs(7)
        outs = eng.search(reqs)
        assert counters["compiles"] == c0, dict(counters)
        for q, (d, i) in zip(reqs, outs):
            _, i1 = ivf_flat.search(sp1, flat, q, K)
            np.testing.assert_array_equal(i, i1.numpy())
    finally:
        eng.close()


def test_scheduler_on_off_bit_identical_zero_compile(x):
    reqs = _reqs(8, (3, 9, 1, 14, 6, 2))
    on, off = _flat_engine(x), _flat_engine(x, scheduler=False)
    try:
        for e in (on, off):
            e.search(reqs[:1])
        c0 = counters["compiles"]
        outs_on, outs_off = on.search(reqs), off.search(reqs)
        assert counters["compiles"] == c0
        for q, (d1, i1), (d2, i2) in zip(reqs, outs_on, outs_off):
            np.testing.assert_array_equal(i1, _knn_ids(x, q))
            np.testing.assert_array_equal(i2, i1)
            np.testing.assert_array_equal(d1, d2)
    finally:
        on.close()
        off.close()


def test_chooser_uses_only_warmed_buckets_after_observations(x):
    eng = ServeEngine(torch.as_tensor(x), K, max_batch=64, device="cpu")
    try:
        eng.warmup()
        eng._cost.observe("float32", 8, 0.0001)
        eng._cost.observe("float32", 64, 1.0)
        reqs = _reqs(9, (30, 5, 3, 20, 8))
        eng.search(reqs[:1])
        c0 = counters["compiles"]
        outs = eng.search(reqs)
        assert counters["compiles"] == c0
        for q, (d, i) in zip(reqs, outs):
            np.testing.assert_array_equal(i, _knn_ids(x, q))
        assert eng.stats["super_batches"] >= 3
    finally:
        eng.close()


def test_submit_streaming_coalesces_and_matches(x):
    eng = ServeEngine(torch.as_tensor(x), K, max_batch=32, device="cpu",
                      scheduler=SchedulerConfig(quantum_s=0.02))
    try:
        eng.warmup()
        eng.search([_data(9, 2)])
        reqs = _reqs(10, (2, 3, 4, 1, 5))
        sb0 = eng.stats["super_batches"]
        c0 = counters["compiles"]
        outs = [f.result(timeout=30) for f in [eng.submit(q)
                                               for q in reqs]]
        assert counters["compiles"] == c0
        for q, (d, i) in zip(reqs, outs):
            np.testing.assert_array_equal(i, _knn_ids(x, q))
        assert eng.stats["super_batches"] - sb0 < len(reqs)
        assert eng.stats["sched_dispatches"] >= 1
    finally:
        eng.close()


def test_transient_fault_retry_bit_identical_zero_compile(x):
    eng = _flat_engine(x, scheduler=False)
    try:
        reqs = [x[:3], x[10:17], x[40:41]]
        c0 = counters["compiles"]
        with faults.plan("dispatch:n=1:raise"):
            outs = eng.search(reqs)
        assert counters["compiles"] == c0
        assert eng.stats["retries"] >= 1
        for q, (d, i) in zip(reqs, outs):
            d0, i0 = brute_force.knn(torch.as_tensor(x), torch.as_tensor(q),
                                     K, device="cpu")
            np.testing.assert_array_equal(i, i0.numpy())
            np.testing.assert_array_equal(d, d0.numpy())
    finally:
        eng.close()


def test_nonretryable_fails_fast_and_isolates(x):
    eng = _flat_engine(x, scheduler=False)
    try:
        r0 = eng.stats["retries"]
        reqs = [x[:3], x[10:17]]
        c0 = counters["compiles"]
        with faults.plan("dispatch:n=1:raise=logic"):
            outs = eng.search(reqs)
        assert counters["compiles"] == c0
        assert eng.stats["retries"] == r0
        assert eng.stats["isolation_splits"] == 1
        for q, (d, i) in zip(reqs, outs):
            np.testing.assert_array_equal(i, _knn_ids(x, q))
    finally:
        eng.close()


def test_disabled_mode_keeps_contract_counters_live():
    prev = telemetry.set_enabled(False)
    try:
        c0 = counters["compiles"]
        f = aot.aot(lambda v: v + 1)
        f(torch.zeros(4))
        assert counters["compiles"] == c0 + 1
        h = telemetry.histogram("t_torch_disabled_hist", "h")
        h.observe(1.0)
        assert h.count() == 0
    finally:
        telemetry.set_enabled(prev)


def test_warmed_engine_hammered_from_threads(x):
    eng = _flat_engine(x)
    try:
        reqs = [x[:3], x[3:8]]
        eng.search(reqs)
        base = dict(eng.stats)
        c0 = counters["compiles"]
        errs = []

        def worker():
            try:
                for _ in range(8):
                    assert len(eng.search(reqs)) == 2
            except Exception as e:   # noqa: BLE001 — checked below
                errs.append(e)

        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        assert eng.stats["requests"] - base["requests"] == 2 * 48
        assert eng.stats["queries"] - base["queries"] == 8 * 48
        assert counters["compiles"] == c0
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# builds and the eager IVF-Flat search


def test_second_tiled_build_compiles_nothing(x):
    ivf_pq.build(PQ_PARAMS, x, device="cpu")
    c0 = counters["compiles"]
    slots0 = _build._list_slots_aot.cache_size
    ivf_pq.build(PQ_PARAMS, x, device="cpu")
    assert counters["compiles"] == c0, dict(counters)
    assert slots0 >= 1 and _build._scatter_new_aot.cache_size >= 1
    assert ivf_pq._encode_tile_aot.cache_size >= 1


def test_second_extend_compiles_nothing(pq):
    x2 = _data(9, 64)
    ivf_pq.extend(pq, x2)
    c0 = counters["compiles"]
    ivf_pq.extend(pq, x2)
    assert counters["compiles"] == c0
    assert _build._scatter_append_aot.cache_size >= 1


def test_serve_engine_refresh_zero_compile(flat):
    sp = ivf_flat.SearchParams(n_probes=4)
    eng = ServeEngine(flat, K, sp, max_batch=64, device="cpu")
    try:
        eng.warmup()
        reqs = [_data(11, 3), _data(12, 9)]
        eng.search(reqs)
        idx2 = ivf_flat.extend(flat, _data(13, 200))
        eng.refresh(idx2)
        c0 = counters["compiles"]
        outs = eng.search(reqs)
        assert counters["compiles"] == c0
        assert eng.stats["refreshes"] == 1
        for q, (d, i) in zip(reqs, outs):
            d_ref, i_ref = ivf_flat.search(sp, idx2, q, K)
            np.testing.assert_array_equal(i, i_ref.numpy())
            np.testing.assert_array_equal(d, d_ref.numpy())
    finally:
        eng.close()


def test_ivf_flat_search_no_retrace_across_ragged_query_counts(flat):
    q = _data(14, 64)
    sp = ivf_flat.SearchParams(n_probes=4)
    for nq in (8, 16, 32, 64):
        ivf_flat.search(sp, flat, q[:nq], K)
    c0 = counters["compiles"]
    for nq in (3, 5, 7, 9, 13, 17, 25, 31, 33, 47, 63):
        d, _ = ivf_flat.search(sp, flat, q[:nq], K)
        assert d.shape == (nq, K)
    assert counters["compiles"] == c0
    ivf_flat.search(sp, flat, np.concatenate([q, q])[:65], K)
    assert counters["compiles"] > c0


# ---------------------------------------------------------------------------
# every newly keyed program equals the function it wraps, bit for bit


def _keyed_cases(x, flat, pq):
    from raft_tpu_torch.neighbors import _common

    sk = importlib.import_module("raft_tpu_torch.matrix.select_k")

    g = torch.Generator().manual_seed(0)
    v = torch.randn((32, 100), generator=g)
    ids = torch.randint(0, 10**6, (32, 100), generator=g, dtype=torch.int32)
    a_d, a_i = sk.select_k(v, 8)
    b_d, b_i = sk.select_k(v * 0.5, 8)
    q = torch.as_tensor(x[:32])
    probes = ivf_pq.coarse_probes(q, pq, 4, "torch")
    fprobes = sk.select_k(ivf_flat._coarse_distances(q, flat.centers,
                                                      flat.metric), 4)[1]
    mut = mutable.MutableIndex(flat, x, build_params=FLAT_PARAMS)
    mut.upsert(_data(21, 50), np.arange(N, N + 50))
    mut.delete(np.arange(0, 40))
    core, delta, tm, td = mut._snapshot()
    t = tiering.tier(pq, hot_fraction=0.5, tile_phys=17, dataset=x)
    ts = t.searcher(K, ivf_pq.SearchParams(n_probes=4))
    hot_args = (q, torch.zeros(16, dtype=torch.int32), ts._hot, ts.kind,
                ts.metric, ts.search_k, ts.n_probes, t.probe_extra_hot,
                ts.lut_dtype, ts.engines, ts.int_dtype, ts.hoisted)
    lt = torch.randint(0, 16, (300,), generator=g).to(torch.int32)
    counts = torch.bincount(lt.long(), minlength=16).numpy()
    lay = _common.chunk_layout(counts)
    table = torch.as_tensor(lay.chunk_table)
    flat_slots = _build.list_slots(lt, torch.zeros(16, dtype=torch.int32),
                                   table, lay.cap, 16)
    payload = (torch.randn((300, DIM), generator=g),)
    pid = torch.arange(300, dtype=torch.int32)
    blocks, bidx = _build.scatter_new(payload, pid, flat_slots,
                                      lay.n_phys + 1, lay.cap)
    codes = torch.randint(0, 1 << pq.pq_bits, (300, pq.pq_dim), generator=g,
                          dtype=torch.int32)
    local = flat
    pd = torch.stack([a_d, b_d])
    pi = torch.stack([a_i, b_i])
    return {
        "select_k_payload": (sk._select_k_payload_aot, sk._select_k_payload_impl,
                             (v, ids, 7, True, "torch")),
        "merge_sorted_runs": (sk._merge_aot, sk._merge_sorted_runs_impl,
                              (a_d, a_i, b_d, b_i, 8, True)),
        "mutable_merged": (mutable._merged_aot, mutable._merged_search_impl,
                           (q, core.main, delta, tm, td, K, 4, "float32",
                            ("torch", "torch"), {})),
        "mutable_fold": (mutable._fold_aot, mutable._fold_delta,
                         (q, a_d[:, :K], a_i[:, :K], flat.metric, delta, td,
                          K, 4, "float32", ("torch", "torch"), {})),
        "tiering_hot_phase": (tiering._hot_phase_aot,
                              tiering._hot_phase_impl, hot_args),
        "tiering_refine": (tiering._refine_aot, tiering._refine_impl,
                           (q, torch.randn((32, 20, DIM), generator=g),
                            torch.arange(640, dtype=torch.int32).reshape(
                                32, 20), ts.metric, K, "torch")),
        "ivf_pq_search_batch": (ivf_pq._search_batch_aot,
                                ivf_pq._search_batch_impl,
                                (q, probes, pq, K, "float32",
                                 ("torch", "torch"))),
        "ivf_pq_search_batch_legacy": (
            ivf_pq._search_batch_aot, ivf_pq._search_batch_impl,
            (q, probes, pq, K, "float32", ("torch", "torch")),
            {"hoisted": False}),
        "ivf_flat_probe_search": (ivf_flat._probe_search_aot,
                                  ivf_flat._probe_search_impl,
                                  (q, fprobes, flat, K, False, "torch")),
        "ivf_pq_encode_tile": (ivf_pq._encode_tile_aot, ivf_pq._encode_tile,
                               (pq, q, lt[:32])),
        "ivf_pq_csum_tile": (ivf_pq._csum_tile_aot, ivf_pq._csum_for_codes,
                             (codes, lt, pq.rot_centers, pq.codebooks,
                              False)),
        "build_list_slots": (_build._list_slots_aot, _build.list_slots,
                             (lt, torch.zeros(16, dtype=torch.int32), table,
                              lay.cap, 16)),
        "build_scatter_new": (_build._scatter_new_aot, _build.scatter_new,
                              (payload, pid, flat_slots, lay.n_phys + 1,
                               lay.cap)),
        "build_scatter_append": (_build._scatter_append_aot,
                                 _build.scatter_append,
                                 (blocks, bidx, payload, pid, flat_slots,
                                  False)),
        "sharded_ivf_flat_scan": (ann_mnmg._ivf_flat_scan_aot,
                                  ann_mnmg._ivf_flat_scan,
                                  (local, q, K, 4, "torch", 0)),
        "sharded_ivf_pq_scan": (ann_mnmg._ivf_pq_scan_aot,
                                ann_mnmg._ivf_pq_scan,
                                (pq, q, K, 4, "float32", "float32", True,
                                 ("torch", "torch"), 0)),
        "sharded_brute_force_scan": (
            ann_mnmg._brute_force_scan_aot, ann_mnmg._brute_force_scan,
            (torch.as_tensor(x), q, K, flat.metric, 2.0, 512, True, "torch",
             7)),
        "sharded_fold": (ann_mnmg._fold_parts_aot, ann_mnmg._fold_parts,
                         (pd, pi, 8, True, "clamp")),
    }


KEYED = ("select_k_payload", "merge_sorted_runs", "mutable_merged",
         "mutable_fold", "tiering_hot_phase", "tiering_refine",
         "ivf_pq_search_batch", "ivf_pq_search_batch_legacy",
         "ivf_flat_probe_search", "ivf_pq_encode_tile", "ivf_pq_csum_tile",
         "build_list_slots", "build_scatter_new", "build_scatter_append",
         "sharded_ivf_flat_scan", "sharded_ivf_pq_scan",
         "sharded_brute_force_scan", "sharded_fold")


@pytest.fixture(scope="module")
def keyed_cases(x, flat, pq):
    return _keyed_cases(x, flat, pq)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)]


@pytest.mark.parametrize("name", KEYED)
def test_keyed_program_equals_its_function(keyed_cases, name):
    keyed, fn, args, *kw = keyed_cases[name]
    kw = kw[0] if kw else {}
    assert isinstance(keyed, aot.AotFunction)

    def fresh(a):
        # a fresh copy for a function that writes into an argument
        if isinstance(a, torch.Tensor):
            return a.clone()
        if isinstance(a, tuple):
            return tuple(fresh(e) for e in a)
        return a

    got = _leaves(keyed(*fresh(args), **kw))
    want = _leaves(fn(*fresh(args), **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) or torch.equal(torch.isnan(g),
                                                torch.isnan(w)) and \
            torch.equal(g[~torch.isnan(g)], w[~torch.isnan(w)])
    c0 = counters["compiles"]
    keyed(*fresh(args), **kw)
    assert counters["compiles"] == c0


# ---------------------------------------------------------------------------
# the sharded and replica engines (one gloo world of two processes)


SH_SIZES = (3, 17, 1, 9, 30)


def _world_battery(comms, payload):
    """Rank 0 leads; every rank reports its own compile counter diffs."""
    from raft_tpu_torch.neighbors import ann_mnmg, ivf_flat
    from raft_tpu_torch.serve import ServeEngine
    from raft_tpu_torch.testing import faults

    c = importlib.import_module("raft_tpu_torch.core.aot"
                                ).aot_compile_counters
    x = _data(0, 800)
    reqs = _reqs(30, SH_SIZES)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=8), x, device="cpu")
    sp = ivf_flat.SearchParams(n_probes=3)
    out = {}
    # a warmed searcher: ann_mnmg.search at the warmed bucket
    sh = idx.shard(comms)
    s = sh.searcher(K, sp)
    s.warm(8)
    c0 = c["compiles"]
    d, _ = ann_mnmg.search(sh, reqs[3][:6], K, sp)
    out["searcher_compiles"] = c["compiles"] - c0
    out["searcher_shape"] = tuple(d.shape)
    refs = [tuple(t.numpy() for t in ann_mnmg.search(sh, q, K, sp))
            for q in reqs]
    # the sharded engine
    eng = ServeEngine(sh, K, sp, max_batch=32)
    if eng.is_leader:
        eng.warmup()
        eng.search(reqs[:1])
        c0 = c["compiles"]
        outs = eng.search(reqs)
        out["sharded_compiles"] = c["compiles"] - c0
        out["sharded_bits"] = all(
            np.array_equal(o[0], r[0]) and np.array_equal(o[1], r[1])
            for o, r in zip(outs, refs))
        eng.close()
    else:
        c0 = c["compiles"]
        eng.follow()
        out["follower_compiles_after_warm"] = c0
    # the replica set: two groups of one rank each
    rep = ann_mnmg.replicate(idx, comms, 2)
    s_own = rep.local.searcher(K, sp)
    s_own.warm(8)
    c0 = c["compiles"]
    s_own.warm(8)
    out["group_rewarm_compiles"] = c["compiles"] - c0
    rrefs = [ivf_flat.search(sp, idx, q, K) for q in reqs]
    eng = ServeEngine(rep, K, sp, max_batch=32)
    if not eng.is_leader:
        eng.follow()
        return out
    eng.warmup()
    eng.search(reqs[:1])
    c0 = c["compiles"]
    outs = eng.search(reqs)
    out["replica_compiles"] = c["compiles"] - c0
    out["replica_bits"] = all(
        np.array_equal(o[1], r[1].numpy()) and np.array_equal(
            o[0], r[0].numpy()) for o, r in zip(outs, rrefs))
    out["replica_lanes"] = sorted(
        lane for (eid, lane), n in eng._router._dispatches.items()
        if eid == eng._engine_id and n)
    c0 = c["compiles"]
    with faults.plan("comms:op=replica_dispatch:rank=0:raise"):
        outs = eng.search(reqs)
    out["reroute_compiles"] = c["compiles"] - c0
    out["reroute_failed"] = sum(not isinstance(o, tuple) for o in outs)
    out["reroute_stats"] = {k: eng.stats[k] for k in
                            ("replica_faults", "replica_reroutes")}
    out["degraded"] = eng._health()["replicas"]["degraded"]
    eng.close()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from raft_tpu_torch.testing.world import run_world

    here = [str(pathlib.Path(__file__).parent)]
    return run_world("test_torch_zero_compile:_world_battery", 2,
                     workdir=tmp_path_factory.mktemp("zero_compile"),
                     timeout=240, sys_path=here)


def test_warmed_searcher_zero_compiles(world):
    for r in world:
        assert r["searcher_compiles"] == 0
        assert r["searcher_shape"] == (6, K)


def test_serve_engine_sharded_coalescing(world):
    assert world[0]["sharded_compiles"] == 0
    assert world[0]["sharded_bits"]


def test_routed_identical_zero_compile_per_group_allgather(world):
    assert world[0]["replica_compiles"] == 0
    assert world[0]["replica_bits"]
    assert world[0]["replica_lanes"] == ["0", "1"]


def test_degrade_reroutes_zero_failures_healthz(world):
    r = world[0]
    assert r["reroute_compiles"] == 0 and r["reroute_failed"] == 0
    assert r["reroute_stats"]["replica_faults"] >= 1
    assert r["reroute_stats"]["replica_reroutes"] >= 1
    assert r["degraded"] == [0]


def test_no_cache_aliasing_across_groups(world):
    """Each rank keys its own group's programs (one process per rank): a
    second warm of a group's searcher is warm on its own rank, and no
    rank's warm satisfies another's (the counters are per process)."""
    assert [r["group_rewarm_compiles"] for r in world] == [0, 0]


# ---------------------------------------------------------------------------
# one seeded churn through both packages


def test_churn_against_jax_zero_compile_reads():
    import jax.numpy as jnp

    from raft_tpu.core.aot import aot_compile_counters as jcounters
    from raft_tpu.neighbors import ivf_flat as jivf
    from raft_tpu.neighbors import mutable as jmut

    n, lists = 1536, 8
    xs = np.random.default_rng(0).random((n, DIM)).astype(np.float32)
    jbp = jivf.IndexParams(n_lists=lists, kmeans_n_iters=4, seed=1)
    jmain = jivf.build(jbp, jnp.asarray(xs))
    arrays = {f: np.asarray(getattr(jmain, f)) for f in ivf_flat.ARRAY_FIELDS}
    tmain = ivf_flat.index_from_arrays(arrays, int(jmain.metric),
                                       device="cpu")
    jm = jmut.MutableIndex(jmain, jnp.asarray(xs), build_params=jbp)
    tm = mutable.MutableIndex(tmain, xs, build_params=ivf_flat.IndexParams(
        n_lists=lists, kmeans_n_iters=4, seed=1))
    full_t = ivf_flat.SearchParams(n_probes=lists)
    full_j = jivf.SearchParams(n_probes=lists)
    js = jm.searcher(K, full_j)
    ts = tm.searcher(K, full_t)
    js.warm(16, jnp.float32)
    ts.warm(16)
    q = np.random.default_rng(9).random((16, DIM)).astype(np.float32)
    rng = np.random.default_rng(1)
    port_write_compiles = 0

    def both(op, *args):
        nonlocal port_write_compiles
        c = counters["compiles"]
        getattr(tm, op)(*args)
        port_write_compiles += counters["compiles"] - c
        getattr(jm, op)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                          and a.dtype == np.float32 else a for a in args))

    def read():
        c, jc = counters["compiles"], jcounters["compiles"]
        got = ts.dispatch(torch.as_tensor(q))
        ref = js.dispatch(jnp.asarray(q))
        assert counters["compiles"] == c, "a port read compiled"
        assert jcounters["compiles"] == jc, "a JAX read compiled"
        gd, gi = (t.numpy() for t in got)
        rd, ri = (np.asarray(a) for a in ref)
        np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
        tied = np.zeros_like(rd, dtype=bool)
        close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
        tied[:, 1:] |= close
        tied[:, :-1] |= close
        np.testing.assert_array_equal(gi[~tied], ri[~tied])
        return gi

    r0 = mutable.mutable_counters["rewarms"]
    both("upsert", rng.random((64, DIM)).astype(np.float32),
         np.arange(0, 64, dtype=np.int64))
    read()
    both("delete", np.arange(100, 140, dtype=np.int64))
    read()
    # a shape-changing upsert: many new ids, past the bitmap's bucket
    both("upsert", rng.random((400, DIM)).astype(np.float32),
         np.arange(4 * n, 4 * n + 400, dtype=np.int64))
    assert mutable.mutable_counters["rewarms"] > r0
    assert port_write_compiles >= 1
    ids = read()
    assert not (set(ids.ravel().tolist()) & set(range(100, 140)))
    tm.compact()
    jm.compact()
    assert tm.size == jm.size
    read()
