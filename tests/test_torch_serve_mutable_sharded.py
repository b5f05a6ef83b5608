"""A ``ServeEngine`` over a ``MutableIndex`` whose main is sharded, at
W = 2 (a gloo world of two processes, rank 0 leading, rank 1 in
``follow()``), for IVF-Flat and IVF-PQ:

* the leader's ``upsert`` / ``delete`` reach the follower (WRITE, counted
  in ``raft_tpu_serve_wire_calls``): equal books on both ranks;
* coalesced results are bit for bit each request's solo search through
  the same engine;
* a writer thread and live traffic at once: no result holds an id whose
  delete returned before its call began;
* a ``Compactor`` under live traffic fails no request, and its compacted
  shard is on each rank bit for bit a fresh ``build_sharded`` of the rows
  it compacted;
* a second engine over the same index: a compaction with writes landing
  while it builds (replayed from each rank's journal) leaves both ranks
  with the same books, the same answers and the live ids the leader's
  own bookkeeping expects;
* ``close()`` releases the follower and detaches the index, and every
  wait is bounded (the session's process-group timeout, which the control
  and compaction groups take, and ``run_world(timeout=)``)."""

import pathlib
import threading

import numpy as np
import pytest

N, D, K, LISTS = 1024, 16, 8, 8
SIZES = (5, 15, 17, 3, 9, 40, 0, 22, 11)       # 40 > max_batch: solo
MAX_BATCH = 32
KINDS = ("ivf_flat", "ivf_pq")


def _data():
    rng = np.random.default_rng(3)
    x = rng.random((N, D)).astype(np.float32)
    reqs = [rng.random((n, D)).astype(np.float32) for n in SIZES]
    return x, reqs


def _family(kind):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    if kind == "ivf_flat":
        return (ivf_flat, ivf_flat.IndexParams(n_lists=LISTS,
                                               kmeans_n_iters=4, seed=1),
                ivf_flat.SearchParams(n_probes=3))
    return (ivf_pq, ivf_pq.IndexParams(n_lists=LISTS, pq_dim=8,
                                       kmeans_n_iters=4, seed=1),
            ivf_pq.SearchParams(n_probes=3))


def _books(mut):
    return (mut.size, mut.delta_rows, mut.tombstone_count)


class _Writes:
    """The leader's writes, mirrored into its own live-id set."""

    def __init__(self, mut, seed):
        self.mut = mut
        self.rng = np.random.default_rng(seed)
        self.live = set(range(N))

    def upsert(self, ids):
        self.mut.upsert(self.rng.random((ids.size, D)).astype(np.float32),
                        ids)
        self.live.update(ids.tolist())

    def delete(self, ids):
        n = self.mut.delete(ids)
        self.live.difference_update(ids.tolist())
        return n


def _serve_phase(mut, eng, reqs, w, out):
    """Engine 1 on the leader: writes, coalesced == solo, a writer under
    traffic, a compaction under traffic; returns the rows it compacted."""
    import torch

    from raft_tpu_torch.neighbors import mutable

    eng.warmup()
    w.upsert(np.arange(0, 96))
    out["deleted"] = w.delete(np.arange(100, 164))
    w.upsert(np.arange(2000, 2032))
    w.upsert(np.arange(0, 16))
    out["books_after_writes"] = _books(mut)
    outs = eng.search(reqs)
    out["outs"] = [o if isinstance(o, Exception) else (o[0], o[1])
                   for o in outs]
    out["solo"] = [tuple(t.numpy() for t in eng._backend.solo(q))
                   if len(q) else None for q in reqs]
    # a writer and live traffic at once
    dead = torch.zeros(4096, dtype=torch.bool)
    lock = threading.Lock()
    errors, bad = [], []

    def writer():
        try:
            for b in range(6):
                w.upsert(np.arange(3000 + 16 * b, 3016 + 16 * b))
                gone = np.arange(200 + 16 * b, 216 + 16 * b)
                w.delete(gone)
                with lock:
                    dead[torch.as_tensor(gone)] = True
        except Exception as e:   # noqa: BLE001 — checked by the test
            errors.append(repr(e))

    wt = threading.Thread(target=writer)
    wt.start()
    while True:
        running = wt.is_alive()
        with lock:
            gone = dead.clone()
        for o in eng.search(reqs):
            if isinstance(o, Exception):
                errors.append(repr(o))
            elif gone[torch.as_tensor(o[1]).long().clamp_min(0)].any():
                bad.append(o[1])
        if not running:
            break
    wt.join(60)
    out["writer_errors"], out["dead_returned"] = errors, len(bad)
    # a Compactor under live traffic
    rows = mut.live_rows()
    failed = _under_traffic(eng, reqs, lambda: mutable.Compactor(
        mut, eng, delta_fraction=1e-4, tomb_fraction=1e-4).tick(), out)
    out["failed"] = failed
    return rows


def _under_traffic(eng, reqs, fn, out):
    """Run *fn* while a reader thread searches; returns the failures."""
    stop = threading.Event()
    failed = []

    def reader():
        while not stop.is_set():
            failed.extend(repr(o) for o in eng.search(reqs[:4])
                          if isinstance(o, Exception))

    rt = threading.Thread(target=reader)
    rt.start()
    try:
        out.setdefault("promoted", []).append(fn())
    finally:
        stop.set()
        rt.join(60)
    out["reader_alive"] = rt.is_alive()
    return failed


def _compact_with_writes(mut, eng, reqs, w, out):
    """Engine 2 on the leader: a compaction under traffic while a writer
    thread writes."""
    from raft_tpu_torch.neighbors import mutable

    eng.warmup()

    def compact():
        w.upsert(np.arange(3490, 3498))        # the compaction is due
        wt = threading.Thread(target=lambda: [
            (w.upsert(np.arange(3500 + 8 * b, 3508 + 8 * b)),
             w.delete(np.arange(400 + 8 * b, 408 + 8 * b)))
            for b in range(4)])
        wt.start()
        comp = mutable.Compactor(mut, eng, delta_fraction=1e-4,
                                 tomb_fraction=1e-4)
        done = comp.tick()
        wt.join(60)
        out["writer_alive"] = wt.is_alive()
        out["compactor_errors"] = comp.errors
        return done

    out["failed_2"] = _under_traffic(eng, reqs, compact, out)
    out["stats"] = dict(eng.stats)


def _battery(comms, payload):
    import torch
    import torch.distributed as dist

    from raft_tpu_torch.neighbors import mutable
    from raft_tpu_torch.serve import ServeEngine

    x, reqs = _data()
    out = {}
    for kind in KINDS:
        fam, bp, sp = _family(kind)
        sh = fam.build_sharded(bp, x, comms, device="cpu")
        mut = mutable.MutableIndex(sh, x, build_params=bp)
        res = {}
        w = _Writes(mut, 11)
        eng = ServeEngine(mut, K, sp, max_batch=MAX_BATCH)
        res["backend"] = eng.backend
        rows = [None]
        if eng.is_leader:
            rows = [_serve_phase(mut, eng, reqs, w, res)]
            eng.close()
        else:
            res["follow"] = eng.follow()
        res["wire"] = dict(eng._wire.calls)
        res["books_1"] = _books(mut)
        # the first compaction's shard against a fresh build of its rows
        # (the leader's, sent over the world)
        dist.broadcast_object_list(rows, src=0)
        ref = fam.build_sharded(bp, rows[0][0], comms,
                                ids=torch.as_tensor(rows[0][1]),
                                device="cpu")
        res["compacted_equals_build"] = all(
            torch.equal(a, b) for a, b in zip(mut._mut_core.main.stacked,
                                              ref.stacked))
        # a second engine: a compaction with writes landing during it
        eng = ServeEngine(mut, K, sp, max_batch=MAX_BATCH)
        if eng.is_leader:
            _compact_with_writes(mut, eng, reqs, w, res)
            eng.close()
            res["expected_live"] = sorted(w.live)
        else:
            res["follow_2"] = eng.follow()
        res["attached_after_close"] = mut._wire is not None
        res["books_2"] = _books(mut)
        d, i = mutable.search(mut, np.concatenate(reqs), K,
                              type(sp)(n_probes=LISTS))
        res["final"] = (d.numpy(), i.numpy())
        res["live_ids"] = sorted(mut.live_rows()[1].tolist())
        out[kind] = res
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from raft_tpu_torch.testing.world import run_world

    root = tmp_path_factory.mktemp("serve_mutable_sharded")
    return run_world("test_torch_serve_mutable_sharded:_battery", 2,
                     workdir=root, timeout=240,
                     sys_path=[str(pathlib.Path(__file__).parent)])


@pytest.mark.parametrize("kind", KINDS)
def test_writes_through_the_leader_reach_the_follower(world, kind):
    lead, follower = world[0][kind], world[1][kind]
    assert lead["backend"] == f"sharded_mutable_{kind}"
    assert lead["deleted"] == 64
    assert lead["books_1"] == follower["books_1"]
    assert lead["books_2"] == follower["books_2"]
    # every write went over the wire, staged through the host, and the
    # follower took what the leader sent
    for key in ("write", "write_bytes", "compact"):
        assert follower["wire"][key] == lead["wire"][key] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_coalesced_equals_solo(world, kind):
    lead = world[0][kind]
    assert all(isinstance(o, tuple) for o in lead["outs"])
    for (d, i), solo in zip(lead["outs"], lead["solo"]):
        if solo is None:                # the empty request
            assert d.shape == i.shape == (0, K)
            continue
        np.testing.assert_array_equal(d, solo[0])
        np.testing.assert_array_equal(i, solo[1])


@pytest.mark.parametrize("kind", KINDS)
def test_no_deleted_id_under_concurrent_writes(world, kind):
    lead = world[0][kind]
    assert lead["writer_errors"] == []
    assert lead["dead_returned"] == 0


@pytest.mark.parametrize("kind", KINDS)
def test_compactor_under_traffic_fails_no_request(world, kind):
    lead = world[0][kind]
    assert lead["promoted"] == [True, True]
    assert lead["failed"] == [] and lead["failed_2"] == []
    assert lead["compactor_errors"] == 0
    assert not lead["reader_alive"] and not lead["writer_alive"]
    assert lead["stats"]["dispatch_errors"] == 0
    assert lead["stats"]["refreshes"] >= 1


@pytest.mark.parametrize("kind", KINDS)
def test_compacted_shard_is_build_sharded_of_its_rows(world, kind):
    assert all(rank[kind]["compacted_equals_build"] for rank in world)


@pytest.mark.parametrize("kind", KINDS)
def test_journal_replay_lands_the_same_state_on_both_ranks(world, kind):
    lead, follower = world[0][kind], world[1][kind]
    np.testing.assert_array_equal(lead["final"][0], follower["final"][0])
    np.testing.assert_array_equal(lead["final"][1], follower["final"][1])
    assert lead["live_ids"] == follower["live_ids"] == lead["expected_live"]
    assert set(lead["final"][1].ravel().tolist()) <= set(lead["live_ids"])


@pytest.mark.parametrize("kind", KINDS)
def test_close_releases_the_follower(world, kind):
    lead, follower = world[0][kind], world[1][kind]
    assert follower["follow"] == follower["follow_2"] == "close"
    assert not lead["attached_after_close"]
