"""The port's MutableIndex: the single-device cases of tests/test_mutable.py
against a rebuild oracle, and against raft_tpu's MutableIndex.

Every case runs the reference's churn script (replace, delete, insert,
duplicate re-upsert, delete delta rows) and is judged against a rebuild
of exactly the live rows: for IVF-Flat at full probe coverage the merged
main ∪ delta distances equal the rebuild's bit for bit with the same id
set per row (tie order is the one documented difference); for IVF-PQ
(the oracle retrains its codebooks) no deleted id ever comes back, every
returned id is live, and upserted rows find themselves.  The same script
on ``raft_tpu``'s MutableIndex over the same (carried) main gives the
same live set and, for IVF-Flat, the same results (distances rtol 1e-5,
ids equal wherever not tied).  The Compactor's tick is deterministic and
contains a faulted refresh; the bitmap grows only in power-of-two word
buckets, as ``raft_tpu``'s; the (main, delta, tombstones) triple saves
and loads, also across the packages; ``ServeEngine`` serves while writes
and a faulted refresh run, with zero failed requests.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors import mutable as jax_mut
from raft_tpu.neighbors import serialize as jax_ser
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, mutable, serialize
from raft_tpu_torch.testing import faults

_N, _DIM, _K, _LISTS = 1536, 24, 8, 8


def _params(kind):
    if kind == "ivf_flat":
        return ivf_flat.IndexParams(n_lists=_LISTS, kmeans_n_iters=4, seed=1)
    return ivf_pq.IndexParams(n_lists=_LISTS, pq_dim=8, pq_bits=8,
                              kmeans_n_iters=4, seed=1)


def _family(kind):
    return ivf_flat if kind == "ivf_flat" else ivf_pq


def _data(seed=0, n=_N):
    return np.random.default_rng(seed).random((n, _DIM)).astype(np.float32)


def _build_mut(kind, seed=0):
    bp = _params(kind)
    x = _data(seed)
    main = _family(kind).build(bp, x, device="cpu")
    mut = mutable.MutableIndex(main, x, build_params=bp)
    return mut, {j: x[j] for j in range(_N)}


def _churn(mut, live, seed=1):
    """The reference's churn script; mirrors every op into *live*, the
    test's own oracle books.  Returns the ops for replaying elsewhere."""
    rng = np.random.default_rng(seed)
    ops = []

    def up(ids):
        v = rng.random((ids.size, _DIM)).astype(np.float32)
        mut.upsert(v, ids)
        ops.append(("upsert", v, ids))
        for r, j in enumerate(ids):
            live[int(j)] = v[r]

    def rm(ids):
        assert mut.delete(ids) == ids.size
        ops.append(("delete", ids))
        for j in ids:
            live.pop(int(j))

    up(np.arange(0, 192))                 # replace main rows
    rm(np.arange(200, 264))               # delete main rows
    up(np.arange(5000, 5064))             # insert new ids
    up(np.arange(0, 32))                  # re-upsert ids packed in the delta
    rm(np.arange(5000, 5008))             # delete delta rows
    return ops


def _oracle(kind, live):
    ids = np.array(sorted(live), np.int64)
    x = np.stack([live[int(j)] for j in ids])
    return _family(kind).build(_params(kind), x,
                               ids=torch.as_tensor(ids, dtype=torch.int32),
                               device="cpu")


def _full(kind):
    return _family(kind).SearchParams(n_probes=_LISTS)


def _assert_vs_oracle(kind, mut, live, seed=9):
    q = _data(seed, 16)
    d_m, i_m = mutable.search(mut, q, _K, params=_full(kind))
    d_m, i_m = d_m.numpy(), i_m.numpy()
    assert set(i_m.ravel().tolist()) <= set(live)
    if kind == "ivf_flat":
        d_o, i_o = ivf_flat.search(_full(kind), _oracle(kind, live), q, _K)
        np.testing.assert_array_equal(d_m, d_o.numpy())
        for row_m, row_o in zip(i_m, i_o.numpy()):
            assert set(row_m.tolist()) == set(row_o.tolist())
    else:
        up = [j for j in list(range(32)) + list(range(5008, 5064))
              if j in live][:16]
        _, i_self = mutable.search(mut, np.stack([live[j] for j in up]), _K,
                                   params=_full(kind))
        hits = sum(j in row.tolist() for j, row in zip(up, i_self.numpy()))
        assert hits >= int(0.8 * len(up)), hits


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_churn_then_compact_matches_oracle(kind):
    mut, live = _build_mut(kind)
    _churn(mut, live)
    assert mut.size == len(live)
    assert mut.delta_rows > 0 and mut.tombstone_count > 0
    _assert_vs_oracle(kind, mut, live)
    x, ids = mut.live_rows()
    assert sorted(ids.tolist()) == sorted(live)
    for j, row in zip(ids.tolist(), x.numpy()):
        np.testing.assert_array_equal(row, live[j])
    mut.compact()
    assert mut.delta_rows == 0 and mut.tombstone_count == 0
    assert mut.size == len(live)
    _assert_vs_oracle(kind, mut, live)


def _jax_pair(kind):
    """raft_tpu's MutableIndex and the port's over one JAX-built main."""
    x = _data(0)
    if kind == "ivf_flat":
        jbp = jax_ivf.IndexParams(n_lists=_LISTS, kmeans_n_iters=4, seed=1)
        jmain = jax_ivf.build(jbp, jnp.asarray(x))
        arrays = {n: np.asarray(getattr(jmain, n))
                  for n in ivf_flat.ARRAY_FIELDS}
        tmain = ivf_flat.index_from_arrays(arrays, int(jmain.metric),
                                           device="cpu")
    else:
        jbp = jax_pq.IndexParams(n_lists=_LISTS, pq_dim=8, kmeans_n_iters=4,
                                 seed=1)
        jmain = jax_pq.build(jbp, jnp.asarray(x))
        arrays = {n: np.asarray(getattr(jmain, n))
                  for n in ivf_pq.ARRAY_FIELDS}
        tmain = ivf_pq.index_from_arrays(arrays, int(jmain.metric), 0, 8,
                                         device="cpu")
    jm = jax_mut.MutableIndex(jmain, jnp.asarray(x), build_params=jbp)
    tm = mutable.MutableIndex(tmain, x, build_params=_params(kind))
    return jm, tm


def _assert_parity(got, ref):
    gd, gi = (t.numpy() for t in got)
    rd, ri = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
    tied = np.zeros_like(rd, dtype=bool)
    close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(gi[~tied], ri[~tied])


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_same_churn_as_raft_tpu(kind):
    jm, tm = _jax_pair(kind)
    live = {j: None for j in range(_N)}
    for op in _churn(tm, dict(live)):
        if op[0] == "upsert":
            jm.upsert(jnp.asarray(op[1]), op[2])
        else:
            assert jm.delete(op[1]) == op[1].size
    assert (tm.size, tm.delta_rows, tm.tombstone_count) == (
        jm.size, jm.delta_rows, jm.tombstone_count)
    jx, jids = jm.live_rows()
    tx, tids = tm.live_rows()
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    q = _data(9, 24)
    for n_probes in (3, _LISTS):
        sp_t = _family(kind).SearchParams(n_probes=n_probes)
        sp_j = (jax_ivf if kind == "ivf_flat" else jax_pq).SearchParams(
            n_probes=n_probes)
        got = mutable.search(tm, q, _K, params=sp_t)
        ref = jax_mut.search(jm, jnp.asarray(q), _K, params=sp_j)
        if kind == "ivf_flat":
            _assert_parity(got, ref)
        else:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                       rtol=1e-5, atol=1e-5)
        dead = set(range(200, 264)) | set(range(5000, 5008))
        assert not (set(got[1].numpy().ravel().tolist()) & dead)


def test_compactor_tick_deterministic_and_contained():
    from raft_tpu_torch.serve import ServeEngine

    mut, live = _build_mut("ivf_flat")
    _churn(mut, live)
    comp = mutable.Compactor(mut, delta_fraction=0.05, tomb_fraction=0.05,
                             seed=3)
    assert comp.due()
    assert comp.tick() is True
    assert comp.compactions == 1 and comp.errors == 0
    assert mut.delta_rows == 0 and mut.tombstone_count == 0
    assert comp.tick() is False and comp.compactions == 1
    eng = ServeEngine(mut, _K, params=ivf_flat.SearchParams(n_probes=4),
                      max_batch=8, device="cpu")
    eng.warmup()
    mut.upsert(np.zeros((160, _DIM), np.float32), np.arange(6000, 6160))
    comp2 = mutable.Compactor(mut, eng, delta_fraction=0.05,
                              tomb_fraction=0.05, seed=3)
    errors0 = mutable.mutable_counters["compaction_errors"]
    with faults.plan("refresh:stage=pre_swap:raise"):
        assert comp2.tick() is False
    assert comp2.errors == 1
    assert mutable.mutable_counters["compaction_errors"] == errors0 + 1
    # the core swap came before the faulted promote: compacted, serving
    assert mut.delta_rows == 0
    (r,) = eng.search([np.zeros((3, _DIM), np.float32)])
    assert r[1].shape == (3, _K)
    mut.upsert(np.ones((160, _DIM), np.float32), np.arange(6000, 6160))
    assert comp2.tick() is True
    assert comp2.errors == 1 and comp2.compactions == 1
    assert eng.stats["refreshes"] == 1


def test_bitmap_grows_in_power_of_two_buckets():
    mut, _ = _build_mut("ivf_flat")
    widths = [mut._mut_core.n_words]
    for top in (1600, 4000, 70_000, 70_001, 1 << 20, 3_000_000):
        mut.upsert(np.zeros((1, _DIM), np.float32), np.array([top]))
        widths.append(mut._mut_core.n_words)
        assert widths[-1] == jax_mut._tomb_words(max(top, _N - 1))
        assert mut._mut_core.tomb_main_bits.shape == (widths[-1],)
        assert mut._mut_core.tomb_delta_bits.shape == (widths[-1],)
    assert all(w & (w - 1) == 0 for w in widths)
    assert widths == sorted(widths) and len(set(widths)) == 5
    for m in (0, 31, 32, 1000, 65_535, 10**6):
        assert mutable._tomb_words(m) == jax_mut._tomb_words(m)
    # a delete past the last upserted id's bucket is a no-op, not a grow
    assert mut.delete(np.array([9_000_000])) == 0


def test_upsert_duplicate_ids_in_batch_rejected():
    mut, _ = _build_mut("ivf_flat")
    with pytest.raises(LogicError):
        mut.upsert(np.zeros((2, _DIM), np.float32), np.array([7, 7]))


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_save_load_triple_preserves_results(kind, tmp_path):
    mut, live = _build_mut(kind)
    _churn(mut, live)
    q = _data(21, 9)
    sp = _full(kind)
    d0, i0 = mutable.search(mut, q, _K, params=sp)
    serialize.save_mutable(tmp_path / "m", mut)
    loaded = serialize.load_mutable(tmp_path / "m", device="cpu")
    assert loaded.size == mut.size and loaded.delta_rows == mut.delta_rows
    assert loaded.tombstone_count <= mut.tombstone_count
    d1, i1 = mutable.search(loaded, q, _K, params=sp)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    loaded.compact()
    assert loaded.size == len(live)


def test_mutable_archives_move_both_ways(tmp_path):
    """raft_tpu's save_mutable is read by the port and the reverse: the
    same live rows and the same results as the writer's."""
    jm, tm = _jax_pair("ivf_flat")
    for op in _churn(tm, {j: None for j in range(_N)}):
        if op[0] == "upsert":
            jm.upsert(jnp.asarray(op[1]), op[2])
        else:
            jm.delete(op[1])
    q = _data(22, 12)
    sp_t = ivf_flat.SearchParams(n_probes=_LISTS)
    sp_j = jax_ivf.SearchParams(n_probes=_LISTS)
    jax_ser.save_mutable(tmp_path / "j", jm)
    from_jax = serialize.load_mutable(tmp_path / "j", device="cpu")
    serialize.save_mutable(tmp_path / "t", tm)
    from_port = jax_ser.load_mutable(tmp_path / "t")
    assert from_jax.size == jm.size and from_port.size == tm.size
    np.testing.assert_array_equal(from_jax.live_rows()[1],
                                  np.asarray(jm.live_rows()[1]))
    np.testing.assert_array_equal(np.asarray(from_port.live_rows()[1]),
                                  tm.live_rows()[1])
    _assert_parity(mutable.search(from_jax, q, _K, params=sp_t),
                   jax_mut.search(jm, jnp.asarray(q), _K, params=sp_j))
    _assert_parity(mutable.search(tm, q, _K, params=sp_t),
                   jax_mut.search(from_port, jnp.asarray(q), _K,
                                  params=sp_j))


def test_serve_concurrent_churn_with_faulted_refresh():
    """Reads race writes, a compaction promotes mid-stream after an
    injected pre-swap refresh fault, an id a read just returned is
    deleted under it: zero failed requests, and the dead id stays dead."""
    from raft_tpu_torch.serve import ServeEngine

    mut, live = _build_mut("ivf_flat")
    sp = ivf_flat.SearchParams(n_probes=4)
    eng = ServeEngine(mut, _K, params=sp, max_batch=8, device="cpu")
    eng.warmup()
    rng = np.random.default_rng(11)
    stop = threading.Event()
    errors, seen = [], []

    def reader():
        r = np.random.default_rng(12)
        while not stop.is_set():
            q = r.random((5, _DIM)).astype(np.float32)
            try:
                (res,) = eng.search([q])
                if isinstance(res, BaseException):
                    raise res
                if res[1].shape != (5, _K):
                    errors.append(f"bad shape {res[1].shape}")
                seen.append(res[1].copy())
            except Exception as exc:  # noqa: BLE001 — the gate
                errors.append(repr(exc))

    t = threading.Thread(target=reader)
    t.start()
    try:
        mut.upsert(rng.random((96, _DIM)).astype(np.float32),
                   np.arange(7000, 7096))
        for _ in range(200):
            if seen:
                break
            stop.wait(0.05)
        assert seen, "reader made no progress"
        victim = int(seen[-1].ravel()[0])
        mut.delete(np.array([victim]))
        with faults.plan("refresh:stage=pre_swap:raise"):
            with pytest.raises(faults.InjectedFault):
                mut.compact(engine=eng)
        mut.upsert(rng.random((32, _DIM)).astype(np.float32),
                   np.arange(7000, 7032))
        mut.compact(engine=eng)
    finally:
        stop.set()
        t.join(30)
    assert not errors, errors[:5]
    assert eng.stats["refreshes"] >= 1 and eng.stats["dispatch_errors"] == 0
    if victim in live:
        _, i = mutable.search(mut, live[victim][None, :], _K,
                              params=_full("ivf_flat"))
        assert victim not in i.numpy().ravel().tolist()
