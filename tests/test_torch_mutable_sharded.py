"""The mutable index over a sharded main at W = 2 (a gloo world of two
processes), the direct API — every rank calls each write, search and
compaction with the same arguments:

* the masked ``ShardedSearcher`` against the JAX package's masked program
  over a mesh of 2 CPU devices, on JAX-built indexes carried in through
  ``index_from_arrays`` (the port hands back squared L2Sqrt distances,
  rooted here before the comparison): distances to rtol 1e-5, ids equal
  except at near ties;
* the reference's churn script (``tests/test_mutable.py:82-121``) run
  through both packages' ``MutableIndex`` over the same carried shards
  (IVF-Flat under L2SqrtExpanded, the root order; IVF-PQ under
  L2Expanded), at full and partial probe coverage: distances to rtol
  1e-5, ids equal except at near ties, no dead id;
* world 1 (each rank in a group of one) bit for bit the port's
  single-device ``MutableIndex`` after the same churn, for both families
  and both L2 metrics;
* after ``compact()``, bit for bit the port's own ``build_sharded`` of
  the live rows at full probe coverage, the books equal on both ranks;
* mutable archives of sharded mains both ways between the packages
  (float32, int8 and uint8 IVF-Flat, float32 IVF-PQ), and the routing of
  ``save_sharded`` / ``load_sharded`` to them."""

import pathlib

import numpy as np
import pytest

W = 2
N, D, K, LISTS = 1024, 16, 8, 8
NQ = 32                                   # one bucket
PROBES = (3, LISTS)                       # partial and full coverage
CHURN = ("flat_l2sqrt", "pq_l2")
ARCHIVES = ("flat_l2sqrt", "flat_i8", "flat_u8", "pq_l2")


def _data():
    rng = np.random.default_rng(0)
    x = rng.random((N, D)).astype(np.float32)
    q = rng.random((NQ, D)).astype(np.float32)
    return x, q


def _typed(x, tag):
    if tag.endswith("i8"):
        return np.clip(np.round((x - 0.5) * 200), -127, 127).astype(np.int8)
    if tag.endswith("u8"):
        return np.clip(np.round(x * 255), 0, 255).astype(np.uint8)
    return x


def _churn_ops(tag, seed=1):
    """The reference's churn script as a list of ops, rows drawn here so
    both packages apply the same ones: replace 192 rows, delete 64 main
    rows, insert 64 new ids, re-upsert 32 ids still in the delta (a delta
    rebuild), delete 8 delta rows."""
    rng = np.random.default_rng(seed)

    def rows(n):
        return _typed(rng.random((n, D)).astype(np.float32), tag)

    return [("upsert", rows(192), np.arange(0, 192)),
            ("delete", np.arange(200, 264)),
            ("upsert", rows(64), np.arange(5000, 5064)),
            ("upsert", rows(32), np.arange(0, 32)),
            ("delete", np.arange(5000, 5008))]


def _apply(mut, ops):
    """Apply *ops*; returns the rows each delete tombstoned."""
    n = []
    for op in ops:
        if op[0] == "upsert":
            mut.upsert(op[1], np.asarray(op[2], np.int64))
        else:
            n.append(int(mut.delete(np.asarray(op[1], np.int64))))
    return n


def _live(tag, ops):
    x, _ = _data()
    live = {j: r for j, r in enumerate(_typed(x, tag))}
    for op in ops:
        if op[0] == "upsert":
            live.update(zip(op[2].tolist(), op[1]))
        else:
            for j in op[1].tolist():
                live.pop(j)
    return live


def _metric(tag):
    from raft_tpu_torch.distance import DistanceType

    return (DistanceType.L2SqrtExpanded if tag.startswith("flat")
            else DistanceType.L2Expanded)


def _build_params(tag):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    if tag.startswith("flat"):
        return ivf_flat.IndexParams(n_lists=LISTS, metric=_metric(tag),
                                    kmeans_n_iters=4, seed=1)
    return ivf_pq.IndexParams(n_lists=LISTS, pq_dim=8, pq_bits=8,
                              metric=_metric(tag), kmeans_n_iters=4, seed=1)


def _search_params(tag, n_probes):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    fam = ivf_flat if tag.startswith("flat") else ivf_pq
    return fam.SearchParams(n_probes=n_probes)


def _carry(arrays, meta):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    if meta["kind"] == "ivf_flat":
        return ivf_flat.index_from_arrays(arrays, meta["metric"],
                                          device="cpu")
    return ivf_pq.index_from_arrays(arrays, meta["metric"],
                                    meta["codebook_kind"], meta["pq_bits"],
                                    meta["dataset_dtype"], device="cpu")


def _np(t):
    return t.numpy().copy()


def _dead_words(seed=5):
    rng = np.random.default_rng(seed)
    words = np.zeros(64, np.uint32)
    for j in rng.choice(N, 300, replace=False):
        words[j >> 5] |= np.uint32(1 << (int(j) & 31))
    return words


def _battery(comms, payload):
    import torch

    from raft_tpu_torch.neighbors import (ann_mnmg, ivf_flat, ivf_pq,
                                          mutable, serialize)

    x, q = _data()
    root = pathlib.Path(payload["dir"])
    rank = comms.get_rank()
    out = {}
    words = torch.from_numpy(_dead_words().view(np.int32).copy())
    one = comms.replica_split(W).groups[rank]     # each rank alone
    for tag in CHURN:
        arrays, meta = payload["indexes"][tag]
        idx = _carry(arrays, meta)
        sh = idx.shard(comms)
        bp = _build_params(tag)
        # the masked sharded program alone
        s = ann_mnmg.ShardedSearcher(sh, K, _search_params(tag, 3),
                                     masked=True)
        d, i = s.dispatch(torch.from_numpy(q), words)
        out[("masked", tag)] = (_np(d), _np(i))
        # the churn over the sharded main
        ops = _churn_ops(tag)
        mut = mutable.MutableIndex(sh, x, build_params=bp)
        out[("deletes", tag)] = _apply(mut, ops)
        out[("books", tag)] = (mut.size, mut.delta_rows,
                               mut.tombstone_count)
        for p in PROBES:
            d, i = mutable.search(mut, q, K, _search_params(tag, p))
            out[("churn", tag, p)] = (_np(d), _np(i))
        # compaction, against build_sharded of the live rows
        live_x, live_ids = mut.live_rows()
        calls = mut._compact_comms.collective_calls
        before = calls["bcast"]
        mut.compact()
        out[("compact_bcasts", tag)] = calls["bcast"] - before
        out[("compacted_books", tag)] = (mut.size, mut.delta_rows,
                                         mut.tombstone_count)
        fam = ivf_flat if tag.startswith("flat") else ivf_pq
        ref = fam.build_sharded(bp, live_x, comms,
                                ids=torch.as_tensor(live_ids), device="cpu")
        full = _search_params(tag, LISTS)
        d0, i0 = mutable.search(mut, q, K, full)
        d1, i1 = ann_mnmg.search(ref, q, K, full)
        main = mut._mut_core.main
        # served over the index's communicator, built over its own
        out[("compacted", tag)] = (
            main.comms is comms and mut._compact_comms is not comms
            and torch.equal(d0, d1) and torch.equal(i0, i1)
            and all(torch.equal(a, b) for a, b in zip(main.stacked,
                                                      ref.stacked)))
        # world 1: each rank alone, against the single-device index
        for metric in ("l2", "l2sqrt"):
            from raft_tpu_torch.distance import DistanceType

            m = (DistanceType.L2Expanded if metric == "l2"
                 else DistanceType.L2SqrtExpanded)
            carried = _carry(arrays, dict(meta, metric=int(m)))
            m1 = mutable.MutableIndex(carried.shard(one), x, build_params=bp)
            m0 = mutable.MutableIndex(carried, x, build_params=bp)
            _apply(m1, ops)
            _apply(m0, ops)
            same = True
            for p in PROBES:
                a = mutable.search(m1, q, K, _search_params(tag, p))
                b = mutable.search(m0, q, K, _search_params(tag, p))
                same = same and all(torch.equal(u, v) for u, v in zip(a, b))
            out[("world1", tag, metric)] = same
    # archives: the JAX package's into the port, the port's out
    for tag in ARCHIVES:
        sp = _search_params(tag, 3)
        got = serialize.load_sharded(root / f"jax_{tag}", comms,
                                     device="cpu")
        again = serialize.load_mutable(root / f"jax_{tag}", device="cpu",
                                       comms=comms)
        d, i = mutable.search(got, _typed(q, tag), K, sp)
        d2, i2 = mutable.search(again, _typed(q, tag), K, sp)
        out[("jax_archive", tag)] = (
            _np(d), _np(i), isinstance(got, mutable.MutableIndex)
            and got.sharded and torch.equal(d, d2) and torch.equal(i, i2),
            (got.size, got.delta_rows, got.tombstone_count))
        serialize.save_sharded(root / f"port_{tag}", got)
        back = serialize.load_sharded(root / f"port_{tag}", comms,
                                      device="cpu")
        d3, i3 = mutable.search(back, _typed(q, tag), K, sp)
        out[("round_trip", tag)] = torch.equal(d, d3) and torch.equal(i, i3)
    return out


@pytest.fixture(scope="module")
def jax_comms():
    import jax
    from jax.sharding import Mesh

    from raft_tpu.comms import build_comms

    return build_comms(Mesh(np.array(jax.devices()[:W]), ("world",)))


def _jax_params(tag):
    from raft_tpu.distance import DistanceType as JD
    from raft_tpu.neighbors import ivf_flat as jflat
    from raft_tpu.neighbors import ivf_pq as jpq

    if tag.startswith("flat"):
        return jflat, jflat.IndexParams(
            n_lists=LISTS, metric=JD.L2SqrtExpanded, kmeans_n_iters=4,
            seed=1)
    return jpq, jpq.IndexParams(n_lists=LISTS, pq_dim=8, pq_bits=8,
                                metric=JD.L2Expanded, kmeans_n_iters=4,
                                seed=1)


@pytest.fixture(scope="module")
def jax_side(jax_comms, tmp_path_factory):
    """The JAX indexes (carried to the port as arrays), the JAX package's
    masked program and sharded ``MutableIndex`` after the churn, and the
    mutable archives it writes."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from raft_tpu.neighbors import ann_mnmg as jann
    from raft_tpu.neighbors import mutable as jmut
    from raft_tpu.neighbors import serialize as jser
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    root = tmp_path_factory.mktemp("mutable_sharded")
    x, q = _data()
    indexes, results, muts = {}, {}, {}
    words = jax_comms.globalize(jnp.asarray(_dead_words()), P())
    for tag in ARCHIVES:
        fam, bp = _jax_params(tag)
        xx = _typed(x, tag)
        idx = fam.build(bp, jnp.asarray(xx))
        if tag.startswith("flat"):
            fields = ivf_flat.ARRAY_FIELDS
            meta = {"kind": "ivf_flat", "metric": int(idx.metric)}
            sh = jann.shard_ivf_flat(idx, jax_comms)
        else:
            fields = ivf_pq.ARRAY_FIELDS
            meta = {"kind": "ivf_pq", "metric": int(idx.metric),
                    "codebook_kind": int(idx.codebook_kind),
                    "pq_bits": int(idx.pq_bits),
                    "dataset_dtype": idx.dataset_dtype}
            sh = jann.shard_ivf_pq(idx, jax_comms)
        indexes[tag] = ({n: np.asarray(getattr(idx, n)) for n in fields},
                        meta)
        if tag in CHURN:
            s = jann.ShardedSearcher(sh, K, fam.SearchParams(n_probes=3),
                                     masked=True)
            results[("masked", tag)] = tuple(
                np.asarray(a) for a in s.dispatch(jnp.asarray(q), words))
        mut = jmut.MutableIndex(sh, xx, np.arange(N), build_params=bp,
                                comms=jax_comms)
        ops = _churn_ops(tag)
        results[("deletes", tag)] = _apply(mut, ops)
        for p in PROBES:
            results[("churn", tag, p)] = tuple(np.asarray(a) for a in (
                jmut.search(mut, _typed(q, tag), K,
                            params=fam.SearchParams(n_probes=p))))
        results[("books", tag)] = (mut.size, mut.delta_rows,
                                   mut.tombstone_count)
        jser.save_sharded(str(root / f"jax_{tag}"), mut)
        muts[tag] = mut
    return dict(root=root, indexes=indexes, results=results, muts=muts)


@pytest.fixture(scope="module")
def port(jax_side):
    from raft_tpu_torch.testing.world import run_world

    return run_world("test_torch_mutable_sharded:_battery", W,
                     dict(dir=str(jax_side["root"]),
                          indexes=jax_side["indexes"]),
                     workdir=jax_side["root"] / "world", timeout=240,
                     sys_path=[str(pathlib.Path(__file__).parent)])


def _near_ties(d):
    gap = np.abs(d[:, 1:] - d[:, :-1]) <= 1e-5 * np.abs(d[:, 1:]) + 1e-6
    tied = np.zeros(d.shape, bool)
    tied[:, :-1] |= gap
    tied[:, 1:] |= gap
    return tied


def _assert_matches(d, i, want_d, want_i):
    want_d = np.asarray(want_d, np.float32)
    want_i = np.asarray(want_i)
    np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-5)
    assert not ((i != want_i) & ~_near_ties(want_d)).any()


@pytest.mark.parametrize("tag", CHURN)
def test_masked_searcher_matches_jax(port, jax_side, tag):
    want_d, want_i = jax_side["results"][("masked", tag)]
    dead = _dead_words()
    for out in port:
        d, i = out[("masked", tag)]
        if tag.startswith("flat"):     # squared: the mutable fold roots
            d = np.sqrt(np.maximum(d, 0))
        _assert_matches(d, i, want_d, want_i)
        hit = (dead[i >> 5] >> (i & 31).astype(np.uint32)) & 1
        assert not hit.any()


@pytest.mark.parametrize("n_probes", PROBES)
@pytest.mark.parametrize("tag", CHURN)
def test_churn_matches_jax_at_world_two(port, jax_side, tag, n_probes):
    res = jax_side["results"]
    live = _live(tag, _churn_ops(tag))
    want_d, want_i = res[("churn", tag, n_probes)]
    for out in port:
        assert out[("deletes", tag)] == res[("deletes", tag)] == [64, 8]
        assert out[("books", tag)] == res[("books", tag)]
        d, i = out[("churn", tag, n_probes)]
        _assert_matches(d, i, want_d, want_i)
        assert set(i.ravel().tolist()) <= set(live)
    # both ranks answer with the same bits
    a, b = (o[("churn", tag, n_probes)] for o in port)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("metric", ["l2", "l2sqrt"])
@pytest.mark.parametrize("tag", CHURN)
def test_world_one_is_single_device_bits(port, tag, metric):
    assert all(out[("world1", tag, metric)] for out in port)


@pytest.mark.parametrize("tag", CHURN)
def test_compact_is_build_sharded_of_live_rows(port, tag):
    live = _live(tag, _churn_ops(tag))
    for out in port:
        assert out[("compacted", tag)]
        assert out[("compacted_books", tag)] == (len(live), 0, 0)
        # the build's broadcasts ran on the compaction communicator
        assert out[("compact_bcasts", tag)] > 0


@pytest.mark.parametrize("tag", ARCHIVES)
def test_jax_archive_loads_into_the_port(port, jax_side, tag):
    from raft_tpu.neighbors import mutable as jmut

    _, q = _data()
    fam, _ = _jax_params(tag)
    mut = jax_side["muts"][tag]
    want_d, want_i = (np.asarray(a) for a in jmut.search(
        mut, _typed(q, tag), K, params=fam.SearchParams(n_probes=3)))
    for out in port:
        d, i, routed, books = out[("jax_archive", tag)]
        assert routed
        assert books[:2] == (mut.size, mut.delta_rows)
        _assert_matches(d, i, want_d, want_i)
        assert out[("round_trip", tag)]


@pytest.mark.parametrize("tag", ARCHIVES)
def test_port_archive_loads_into_jax(port, jax_side, jax_comms, tag):
    from raft_tpu.neighbors import mutable as jmut
    from raft_tpu.neighbors import serialize as jser

    _, q = _data()
    fam, _ = _jax_params(tag)
    got = jser.load_sharded(str(jax_side["root"] / f"port_{tag}"),
                            jax_comms)
    assert isinstance(got, jmut.MutableIndex)
    want = jax_side["muts"][tag]
    assert (got.size, got.delta_rows) == (want.size, want.delta_rows)
    sp = fam.SearchParams(n_probes=3)
    d, i = (np.asarray(a) for a in jmut.search(got, _typed(q, tag), K,
                                               params=sp))
    want_d, want_i = (np.asarray(a) for a in jmut.search(
        want, _typed(q, tag), K, params=sp))
    _assert_matches(d, i, want_d, want_i)
    for a, b in zip(tuple(got._mut_core.main.replicated)
                    + tuple(got._mut_core.main.stacked),
                    tuple(want._mut_core.main.replicated)
                    + tuple(want._mut_core.main.stacked)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
