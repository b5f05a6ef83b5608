"""The port's resource model (``raft_tpu_torch.core.handle``) against the
JAX package's, on the CPU.

Every scenario of ``tests/test_handle_threading.py`` has a counterpart
here, held against the JAX package on the same numpy inputs: a supplied
handle records the call's outputs (and inputs) on its main stream and
``query()`` is True after ``sync()``; a call without a handle waits for
its own work and makes no default handle; ``kmeans``,
``fused_l2_nn_argmin``, ``knn`` and ``ivf_flat.build`` / ``search`` take a
``Handle(n_streams=2)``; the MNMG k-means accepts a handle (a gloo world
of 1 and of 2) and raises without comms; four threads on four handles,
and one handle's pool shared by four threads.  Host work is done when it
returns, so the lanes that hold work here are stub lanes whose marks the
test completes (:class:`StubStream`), as the JAX test's stub work does.
Then the stream bookkeeping, a cancelled wait on a lane that never
finishes, the comms ``group_start`` / ``group_end`` and
``get_group_size`` at world 1 and 2, and the rest of the JAX package's
public surface this slice ports (``tile_rows=``, ``Index.pq_len``, the
``{fn,sig}`` device sample, ``serve(varz=)``, ``Registry.reset``,
``Counter.remove``, ``FlightRecorder.entries``,
``AdmissionController.reject_closed``, ``TieredIndex.probe_extra_cold``).

Tolerances: distances rtol 1e-5; ids equal (but at distance ties, as the
family tests allow); the port with a handle and without it bit for bit.
"""

import json
import pathlib
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans as jkm
from raft_tpu.cluster import kmeans_mnmg as jkm_mnmg
from raft_tpu.cluster.kmeans_types import InitMethod as JInit
from raft_tpu.cluster.kmeans_types import KMeansParams as JParams
from raft_tpu.comms import build_comms as jbuild_comms
from raft_tpu.core import Handle as JHandle
from raft_tpu.distance import fused_l2_nn_argmin as j_argmin
from raft_tpu.distance import pairwise_distance as j_pairwise
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import knn as jknn
from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.cluster import kmeans_mnmg as tkm_mnmg
from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.core import handle as th
from raft_tpu_torch.core import interruptible as tint
from raft_tpu_torch.core.error import InterruptedError_, LogicError
from raft_tpu_torch.core.handle import Handle, Stream
from raft_tpu_torch.distance import fused_l2_nn_argmin, pairwise_distance
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_extend import (_assert_search_parity,  # noqa: E402
                               _assert_tables, _carry)

RTOL = 1e-5
#: a bound on every wait of these tests, in seconds
WAIT_S = 10.0


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(0).random((96, 12), dtype=np.float32)


class FakeEvent:
    """A mark the test completes (``done``)."""

    def __init__(self, done=False):
        self.done = done

    def query(self):
        return self.done


class StubStream(Stream):
    """A lane whose marks are :class:`FakeEvent` s: work "on the card"
    stays in flight until :meth:`finish` completes it."""

    def __init__(self, name="stub"):
        super().__init__(torch.device("cpu"), name)
        self.marks = []
        self._finished = False

    def _mark(self, timing=False):
        ev = FakeEvent(self._finished)
        self.marks.append(ev)
        return ev

    def finish(self):
        self._finished = True
        for ev in self.marks:
            ev.done = True


def stub_handle(n_streams=0):
    h = Handle(device="cpu", n_streams=n_streams)
    h._stream = StubStream("main")
    h._pool = [StubStream(f"pool{i}") for i in range(n_streams)]
    return h


def _held(stream):
    return [t for _, held in stream._inflight for t in held]


# -- the JAX package's scenarios ---------------------------------------------

def test_supplied_handle_records_outputs(data):
    h = stub_handle()
    x = torch.from_numpy(data)
    d = pairwise_distance(x, x, "euclidean", handle=h)
    s = h.get_stream()
    # the output and the input are held on the handle's stream until the
    # work is observed done
    assert len(s._inflight) == 1
    assert any(t is d for t in _held(s)) and any(t is x for t in _held(s))
    assert not s.query()
    s.finish()
    h.sync()
    assert s.query() and s._inflight == []
    ref = np.asarray(j_pairwise(data, data, "euclidean", handle=JHandle()))
    np.testing.assert_allclose(d.numpy(), ref, rtol=RTOL, atol=1e-5)
    assert torch.equal(d, pairwise_distance(x, x, "euclidean", device="cpu"))


def test_default_handle_waits(data, monkeypatch):
    monkeypatch.setattr(th, "_default_handle", None)
    waited = []
    monkeypatch.setattr(th, "_wait_for_current",
                        lambda out: waited.append(out))
    d = pairwise_distance(data, data, "cityblock", device="cpu")
    assert len(waited) == 1 and waited[0] is d   # the call waited, once
    assert th._default_handle is None            # and made no handle
    np.testing.assert_allclose(np.diag(d.numpy()), 0.0, atol=1e-5)
    ref = np.asarray(j_pairwise(data, data, "cityblock"))
    np.testing.assert_allclose(d.numpy(), ref, rtol=RTOL, atol=1e-5)


def test_nested_calls_leave_the_wait_to_the_outermost(data, monkeypatch):
    waited = []
    monkeypatch.setattr(th, "_wait_for_current",
                        lambda out: waited.append(out))
    p = KMeansParams(n_clusters=4, init=InitMethod.Array, max_iter=4)
    out = tkm.fit_predict(p, torch.from_numpy(data), centroids=data[:4])
    assert len(waited) == 1 and waited[0] is out


def test_handle_through_cluster_and_neighbors(data):
    h, jh = Handle(device="cpu", n_streams=2), JHandle(n_streams=2)
    x = torch.from_numpy(data)
    p = KMeansParams(n_clusters=4, init=InitMethod.Array, max_iter=4)
    jp = JParams(n_clusters=4, init=JInit.Array, max_iter=4)
    out = tkm.fit(p, x, centroids=data[:4], handle=h)
    h.sync()
    jout = jkm.fit(jp, data, centroids=data[:4], handle=jh)
    jh.sync()
    assert out.centroids.shape == (4, 12)
    np.testing.assert_allclose(out.centroids.numpy(),
                               np.asarray(jout.centroids), rtol=RTOL,
                               atol=1e-6)
    plain = tkm.fit(p, x, centroids=data[:4])
    assert torch.equal(out.centroids, plain.centroids)

    labels, inertia = tkm.predict(p, x, out.centroids, handle=h)
    h.sync()
    jl, ji = jkm.predict(jp, data, jout.centroids, handle=jh)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(inertia), float(ji), rtol=RTOL)

    ids = fused_l2_nn_argmin(x, out.centroids, handle=h)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(j_argmin(data, jout.centroids, handle=jh)))
    assert torch.equal(ids, fused_l2_nn_argmin(x, out.centroids))

    # queries off the rows: a self-distance's expanded-L2 rounding under
    # the root is not a distance the tolerance is for
    q = 0.5 * data[:8] + 0.25
    dist, idx = brute_force.knn(x, q, 3, handle=h)
    h.sync()
    jd, ji = jknn(data, q, 3, handle=jh)
    assert idx.shape == (8, 3)
    _assert_search_parity((dist, idx), (jd, ji))
    pd, pi = brute_force.knn(x, q, 3, device="cpu")
    assert torch.equal(dist, pd) and torch.equal(idx, pi)

    index = tivf.build(tivf.IndexParams(n_lists=4, seed=0), data, handle=h)
    plain_index = tivf.build(tivf.IndexParams(n_lists=4, seed=0), data,
                             device="cpu")
    assert index.device.type == "cpu"
    assert torch.equal(index.centers, plain_index.centers)
    dd, ii = tivf.search(tivf.SearchParams(n_probes=2), index, data[:5], 2,
                         handle=h)
    h.sync()
    assert ii.shape == (5, 2)
    pd, pi = tivf.search(tivf.SearchParams(n_probes=2), plain_index,
                         data[:5], 2)
    assert torch.equal(dd, pd) and torch.equal(ii, pi)
    # the JAX package's search of its own index, carried into the port
    jidx = jivf.build(jivf.IndexParams(n_lists=4, seed=0), data, handle=jh)
    jd, ji = jivf.search(jivf.SearchParams(n_probes=2), jidx, data[:5], 2,
                         handle=jh)
    jh.sync()
    got = tivf.search(tivf.SearchParams(n_probes=2), _carry(tivf, jidx),
                      data[:5], 2, handle=h)
    h.sync()
    _assert_search_parity(got, (jd, ji))


def test_mnmg_handle_without_comms_raises(data):
    p = KMeansParams(n_clusters=2, init=InitMethod.Array, max_iter=2)
    with pytest.raises(LogicError, match="Communicator was not initialized"):
        tkm_mnmg.fit(p, Handle(device="cpu"), data[:16], centroids=data[:2])


def test_concurrent_threads_distinct_handles(data):
    results, errors = {}, []

    def worker(tid):
        try:
            h = stub_handle()
            d = pairwise_distance(data, data[: 8 * (tid + 1)], "euclidean",
                                  handle=h)
            h.get_stream().finish()
            h.sync()
            results[tid] = d.numpy()
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append((tid, repr(e)))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(results) == [0, 1, 2, 3]
    for tid, got in results.items():
        ref = j_pairwise(data, data[: 8 * (tid + 1)], "euclidean")
        np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL,
                                   atol=1e-5)


def test_concurrent_threads_shared_handle_stream_pool(data):
    h = stub_handle(n_streams=4)
    outs = [None] * 4

    def worker(tid):
        s = h.get_stream_from_stream_pool(tid)
        d = pairwise_distance(data[: 16 * (tid + 1)], data, "cityblock",
                              device="cpu")
        s.record(d)                     # this lane owns the work
        outs[tid] = d

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    for tid in range(4):
        s = h.get_stream_from_stream_pool(tid)
        assert not s.query() and _held(s) == [outs[tid]]
        s.finish()
    h.sync_stream_pool()
    assert all(h.get_stream_from_stream_pool(b).query() for b in range(4))
    for tid, d in enumerate(outs):
        ref = j_pairwise(data[: 16 * (tid + 1)], data, "cityblock")
        np.testing.assert_allclose(d.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=1e-5)


def test_interruptible_registry_is_per_thread():
    tokens = {}
    gate = threading.Barrier(2, timeout=WAIT_S)

    def worker(tid):
        gate.wait()
        tokens[tid] = tint.get_token()
        gate.wait()

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert tokens[0] is not tokens[1]
    assert tint.get_token() not in (tokens[0], tokens[1])


# -- streams ------------------------------------------------------------------

def test_stream_semantics_with_stub_work():
    """The JAX test's stub-work contract: strong references held while in
    flight, dropped once complete (on record and on query), released by
    synchronize."""
    s = StubStream("t")
    a, b, c = (torch.zeros(1) for _ in range(3))
    s.record(a)
    s.record(b)
    assert not s.query() and len(s._inflight) == 2
    s.marks[0].done = True
    assert not s.query()            # b still pending...
    assert _held(s) == [b]          # ...but a was released
    s.marks[1].done = True
    s.record(c)                     # record prunes completed marks too
    assert _held(s) == [c]
    s.marks[2].done = True
    assert s.query() and s._inflight == []
    s.record(a)
    s.finish()
    s.synchronize()
    assert s._inflight == []


def test_stream_record_keeps_every_update_under_contention():
    """Eight threads record onto one lane with a short switch interval:
    no mark may be lost (record is a locked read-modify-write)."""
    s = StubStream("shared")
    n_threads, n_records = 8, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(n_records):
                s.record(torch.zeros(1))

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(s._inflight) == n_threads * n_records


def test_cancelled_wait_keeps_its_work():
    """A cancel from another thread ends ``synchronize`` on a lane that
    never finishes with ``InterruptedError_``; the work stays owned, and
    once it completes a second sync returns."""
    s = StubStream("never")
    s.record(torch.zeros(4))
    box, started = {}, threading.Event()

    def waiter():
        box["tid"] = threading.get_ident()
        started.set()
        try:
            s.synchronize()
            box["raised"] = False
        except InterruptedError_:
            box["raised"] = True

    t = threading.Thread(target=waiter)
    t.start()
    assert started.wait(WAIT_S)
    tint.cancel(box["tid"])
    t.join(timeout=WAIT_S)
    assert not t.is_alive() and box["raised"] is True
    assert not s.query() and len(_held(s)) == 1
    s.finish()
    s.synchronize()
    assert s.query()


def test_handle_api_matches_jax():
    h, jh = Handle(device="cpu", n_streams=3), JHandle(n_streams=3)
    assert h.get_device() == h.device
    assert h.get_next_usable_stream() is h.get_stream_from_stream_pool(0)
    assert h.get_stream() not in h._pool
    assert h.stream_pool_size == jh.stream_pool_size == 3
    assert h.is_stream_pool_initialized() == jh.is_stream_pool_initialized()
    for i in range(7):
        assert (h.get_stream_from_stream_pool(i).name
                == jh.get_stream_from_stream_pool(i).name)
        assert (h.get_next_usable_stream(i).name
                == jh.get_next_usable_stream(i).name)
    assert (h.get_stream_from_stream_pool().name
            == jh.get_stream_from_stream_pool().name)
    bare, jbare = Handle(device="cpu"), JHandle()
    assert not bare.is_stream_pool_initialized()
    assert bare.get_next_usable_stream(5) is bare.get_stream()
    with pytest.raises(LogicError, match="stream pool does not exist"):
        bare.get_stream_from_stream_pool(0)
    assert (bare.get_next_usable_stream(5).name
            == jbare.get_next_usable_stream(5).name)
    made = []
    r = h.get_resource("blas", lambda: made.append(1) or "res")
    assert r == h.get_resource("blas", lambda: "other") == "res"
    assert made == [1] == [1 if jh.get_resource("blas", lambda: 1) else 0]
    # every wait of a handle is on its own lanes
    for call in (h.sync, h.sync_stream, h.sync_stream_pool,
                 h.wait_stream_pool_on_stream):
        call()
    assert all(s.query() for s in [h.get_stream()] + h._pool)


def test_stage_copies_on_the_lane():
    s = Stream(torch.device("cpu"), "staging")
    tree = (torch.arange(6.0), [torch.ones(2, 2)], {"k": np.arange(3)})
    staged = s.stage(tree)
    assert torch.equal(staged[0], tree[0])
    assert torch.equal(staged[1][0], tree[1][0])
    assert torch.equal(staged[2]["k"], torch.arange(3))
    assert s.query()


# -- ivf_pq with a pool ---------------------------------------------------------

@pytest.fixture(scope="module")
def pq_pair():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2000, 16)).astype(np.float32)
    jidx = jpq.build(jpq.IndexParams(n_lists=16, pq_dim=8, pq_bits=8,
                                     kmeans_n_iters=4, seed=1),
                     jnp.asarray(x))
    return x, jidx, _carry(tpq, jidx)


def test_ivf_pq_search_over_a_pool(pq_pair):
    x, jidx, idx = pq_pair
    q = x[:300] + 0.01
    sp = tpq.SearchParams(n_probes=4)
    plain = tpq.search(sp, idx, q, 5, batch_size_query=64)
    h = stub_handle(n_streams=4)
    got = tpq.search(sp, idx, q, 5, batch_size_query=64, handle=h)
    # five batches over four lanes: each lane holds its batches' outputs
    held = [len(s._inflight) for s in h._pool]
    assert held == [2, 1, 1, 1]
    assert not h.get_stream().query()
    for s in [h.get_stream()] + h._pool:
        s.finish()
    h.sync()
    assert all(s.query() for s in [h.get_stream()] + h._pool)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    jh = JHandle(n_streams=4)
    ref = jpq.search(jpq.SearchParams(n_probes=4), jidx, q, 5,
                     batch_size_query=64, handle=jh)
    jh.sync()
    _assert_search_parity(got, ref)


def test_ann_entry_points_take_a_handle(data):
    from raft_tpu.neighbors import ann as jann
    from raft_tpu_torch.neighbors import ann as tann

    h, jh = stub_handle(), JHandle()
    params = tann.IVFFlatParam(nlist=4, nprobe=2)
    idx = tann.approx_knn_build_index(params, data, handle=h)
    got = tann.approx_knn_search(idx, data[:6], 3, h)
    h.get_stream().finish()
    h.sync()
    plain = tann.approx_knn_search(
        tann.approx_knn_build_index(params, data, device="cpu"), data[:6],
        3)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    jidx = jann.approx_knn_build_index(
        jann.IVFFlatParam(nlist=4, nprobe=2), data, handle=jh)
    ref = jann.approx_knn_search(jidx, data[:6], 3, jh)
    assert got[1].shape == tuple(np.asarray(ref[1]).shape) == (6, 3)


def test_sparse_pairwise_distance_takes_a_handle():
    import raft_tpu.sparse as jsp
    from raft_tpu.sparse import distance as jsd
    from raft_tpu_torch import sparse as tsp
    from raft_tpu_torch.sparse import distance as tsd

    rng = np.random.default_rng(5)
    r, c = np.nonzero(rng.random((20, 30)) < 0.2)
    v = rng.uniform(0.05, 1.0, len(r)).astype(np.float32)
    xt = tsp.from_triplets(r, c, v, (20, 30), device="cpu")
    h = stub_handle()
    got = tsd.pairwise_distance(xt, xt, handle=h)
    assert any(t is got for t in _held(h.get_stream()))
    h.get_stream().finish()
    h.sync()
    assert torch.equal(got, tsd.pairwise_distance(xt, xt))
    xj = jsp.from_triplets(r, c, v, (20, 30))
    ref = np.asarray(jsd.pairwise_distance(xj, xj, handle=JHandle()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-5)


# -- the comms world: group_start / group_end, sizes, MNMG with a handle -------

#: the rows the MNMG scenario fits (the JAX test's comms.get_size() * 8 at
#: the conftest's mesh of 8)
MNMG_ROWS = 64


def _group_battery(comms, payload):
    """One rank: the grouped p2p pair against the ungrouped one, the
    sizes, a multicast refused inside a group, the MNMG fit and predict
    through a handle, and ``build_sharded(tile_rows=)``."""
    from raft_tpu_torch.cluster import kmeans_mnmg
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.core.handle import Handle
    from raft_tpu_torch.neighbors import ivf_pq

    w, r = comms.get_size(), comms.get_rank()
    x = torch.full((3,), float(r + 1))
    ring = [(s, (s + 1) % w) for s in range(w)]
    back = [(s, (s - 1) % w) for s in range(w)]
    out = {"size": comms.get_size(), "group_size": comms.get_group_size(),
           "multiprocess": comms.is_multiprocess()}
    plain = (comms.device_sendrecv(x, ring),
             comms.device_sendrecv(2 * x, back))
    comms.group_start()
    a = comms.device_sendrecv(x, ring)
    b = comms.device_sendrecv(2 * x, back)
    out["deferred"] = bool((a == 0).all()) if w > 1 else None
    comms.group_end()
    with comms.group_start():
        with comms.group_start():        # groups nest
            c = comms.device_sendrecv(x, ring)
        out["nested_deferred"] = bool((c == 0).all()) if w > 1 else None
    out["grouped_equal"] = (torch.equal(a, plain[0])
                            and torch.equal(b, plain[1])
                            and torch.equal(c, plain[0]))
    out["received"] = (a.tolist(), b.tolist())
    comms.group_start()
    try:
        comms.device_multicast_sendrecv(x, [0], [0])
        out["multicast_in_group"] = "ran"
    except LogicError:
        out["multicast_in_group"] = "refused"
    comms.group_end()

    data = torch.from_numpy(payload["data"])
    h = Handle(device="cpu")
    h.set_comms(comms)
    p = KMeansParams(n_clusters=2, init=InitMethod.Array, max_iter=3)
    fit = kmeans_mnmg.fit(p, h, data, centroids=data[:2])
    labels, _ = kmeans_mnmg.predict(p, h, data, fit.centroids)
    out["centroids"] = fit.centroids.numpy()
    out["labels"] = labels.numpy()

    pp = ivf_pq.IndexParams(n_lists=8, pq_dim=4, pq_bits=8,
                            kmeans_n_iters=2, seed=1)
    pq = torch.from_numpy(payload["pq"])
    tiled = ivf_pq.build_sharded(pp, pq, comms, tile_rows=37, device="cpu")
    whole = ivf_pq.build(pp, pq, device="cpu").shard(comms)
    out["sharded_equal"] = all(
        torch.equal(u, v) for u, v in zip(tiled.stacked, whole.stacked))
    return out


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory, data):
    from raft_tpu_torch.testing.world import run_world

    pq = np.random.default_rng(9).normal(0, 1, (500, 16)).astype(np.float32)
    payload = {"data": data[:MNMG_ROWS], "pq": pq}
    tests = str(pathlib.Path(__file__).parent)
    dirs = {w: tmp_path_factory.mktemp(f"hw{w}") for w in (1, 2)}
    # both worlds at once: each is waiting on its processes' start-up
    with ThreadPoolExecutor(2) as pool:
        runs = {w: pool.submit(run_world, "test_torch_handle:_group_battery",
                               w, payload, workdir=dirs[w],
                               sys_path=[tests], timeout=120)
                for w in dirs}
        return {w: f.result() for w, f in runs.items()}


@pytest.mark.parametrize("world", [1, 2])
def test_comms_group_and_sizes(world_runs, world):
    for r, out in enumerate(world_runs[world]):
        assert out["size"] == out["group_size"] == world
        assert out["multiprocess"] == (world > 1)
        assert out["grouped_equal"]
        if world > 1:
            assert out["deferred"] and out["nested_deferred"]
        # the ring: rank r receives (r - 1)'s value, the reverse ring
        # (r + 1)'s doubled
        src, dst = (r - 1) % world, (r + 1) % world
        assert out["received"] == ([float(src + 1)] * 3,
                                   [2.0 * (dst + 1)] * 3)
        assert out["multicast_in_group"] == "refused"
        assert out["sharded_equal"]


@pytest.mark.parametrize("world", [1, 2])
def test_mnmg_accepts_handle(world_runs, world, data):
    comms = jbuild_comms()
    jh = JHandle(mesh=comms.mesh)
    jh.set_comms(comms)
    jp = JParams(n_clusters=2, init=JInit.Array, max_iter=3)
    x = data[:MNMG_ROWS]
    jout = jkm_mnmg.fit(jp, jh, x, centroids=x[:2])
    jl, _ = jkm_mnmg.predict(jp, jh, x, jout.centroids)
    for out in world_runs[world]:
        assert out["centroids"].shape == (2, 12)
        np.testing.assert_allclose(out["centroids"],
                                   np.asarray(jout.centroids), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_array_equal(out["labels"], np.asarray(jl))


# -- the rest of the public surface -------------------------------------------

def test_ivf_pq_tile_rows(pq_pair):
    x, jidx, idx = pq_pair
    p = tpq.IndexParams(n_lists=16, pq_dim=8, pq_bits=8, kmeans_n_iters=2,
                        seed=1)
    whole = tpq.build(p, x[:400], device="cpu")
    tiled = tpq.build(p, x[:400], tile_rows=100, device="cpu")
    for name in tpq.ARRAY_FIELDS:
        assert torch.equal(getattr(whole, name), getattr(tiled, name)), name
    # extend a carried index in tiles in both packages
    empty = jpq.build(jpq.IndexParams(n_lists=16, pq_dim=8, pq_bits=8,
                                      kmeans_n_iters=4, seed=1,
                                      add_data_on_build=False),
                      jnp.asarray(x))
    new = x[:600]
    ref = jpq.extend(empty, jnp.asarray(new), tile_rows=128)
    got = tpq.extend(_carry(tpq, empty), new, tile_rows=128)
    moved = _assert_tables(got, ref, new, np.asarray(empty.centers))
    if moved == 0:
        np.testing.assert_array_equal(got.list_codes.numpy(),
                                      np.asarray(ref.list_codes))
    assert torch.equal(
        got.list_codes,
        tpq.extend(_carry(tpq, empty), new, tile_rows=50).list_codes)


def test_ivf_pq_pq_len(pq_pair):
    _, jidx, idx = pq_pair
    assert idx.pq_len == jidx.pq_len == idx.rot_dim // idx.pq_dim


def test_device_sample_by_signature():
    from raft_tpu import telemetry as jtel
    from raft_tpu_torch import telemetry as ttel

    for tel in (ttel, jtel):
        tel.record_device_sample("t_handle_fn", "float32[64,16]", 0.003)
        hist = tel.REGISTRY.get("raft_tpu_device_seconds")
        assert hist.quantile(0.5, ("t_handle_fn",)) == pytest.approx(0.003)
    by_sig = ttel.REGISTRY.get("raft_tpu_device_signature_seconds")
    assert by_sig.quantile(0.5, ("t_handle_fn", "float32[64,16]")) == \
        pytest.approx(0.003)
    ttel.device.record_sample("t_handle_fn", "float32[64,16]", 0.001)
    assert by_sig.count(("t_handle_fn", "float32[64,16]")) == 2


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as r:
        return json.loads(r.read())


def test_http_serve_varz():
    from raft_tpu.telemetry import http as jhttp
    from raft_tpu_torch.telemetry import http as thttp

    body = {"engine": "handle-test", "lanes": 2}
    bodies = []
    for mod in (thttp, jhttp):
        srv = mod.serve(0, varz=lambda: body)
        try:
            bodies.append(_get(srv.url + "/varz"))
        finally:
            srv.close()
    assert bodies[0] == bodies[1] == body


def test_registry_reset_and_counter_remove():
    from raft_tpu.telemetry import registry as jreg
    from raft_tpu_torch.telemetry import registry as treg

    seen = []
    for reg in (treg, jreg):
        r = reg.Registry()
        c = r.counter("t_handle_total", "x", labelnames=("k",))
        c.inc(2, ("a",))
        c.inc(1, ("b",))
        c.remove(("a",))
        c.remove(("missing",))
        items = sorted(c.items())
        r.reset()
        seen.append((items, r.metrics(), r.get("t_handle_total")))
    assert seen[0] == seen[1] == ([(("b",), 1)], [], None)


def test_flight_recorder_entries():
    from raft_tpu.telemetry import http as jhttp
    from raft_tpu_torch.telemetry import http as thttp

    got = []
    for mod in (thttp, jhttp):
        rec = mod.FlightRecorder(threshold_s=0.0, cap=2)
        for n in range(3):
            rec.record([], request=n)
        got.append([(e["request"], e["seq"]) for e in rec.entries()])
        assert rec.entries() == rec.view()["entries"]
    assert got[0] == got[1] == [(1, 2), (2, 3)]


def test_admission_reject_closed():
    from raft_tpu.serve import admission as jadm
    from raft_tpu_torch.serve import admission as tadm

    errs = [mod.AdmissionController().reject_closed()
            for mod in (tadm, jadm)]
    assert [e.reason for e in errs] == ["closed", "closed"]
    assert str(errs[0]) == str(errs[1])


def test_tiered_probe_extra_cold():
    from raft_tpu.neighbors import tiering as jtier
    from raft_tpu_torch.neighbors import tiering as ttier

    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (1500, 16)).astype(np.float32)
    jidx = jivf.build(jivf.IndexParams(n_lists=16, kmeans_n_iters=4,
                                       seed=1), jnp.asarray(x))
    for tile in (17, 64):
        jt = jtier.tier(jidx, hot_fraction=0.25, tile_phys=tile)
        tt = ttier.tier(_carry(tivf, jidx), hot_fraction=0.25,
                        tile_phys=tile)
        assert tt.probe_extra_cold == jt.probe_extra_cold == tile
        assert all(e <= tt.probe_extra_cold
                   for e in tt.searcher(5)._cold_extra)
