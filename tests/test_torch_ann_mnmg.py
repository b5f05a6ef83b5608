"""The sharded ANN layer at W = 4 (a gloo world of 4 processes): the JAX
index carried in and sharded by the port, against the JAX package's
``ann_mnmg.search`` over a mesh of 4 CPU devices (distances to rtol
1e-5, ids equal except at near ties); sharded brute force against the JAX
single-device ``knn`` and bit for bit the port's own ``knn`` (the JAX
package's sharded brute force is no reference: its tests fail on this
tree); ``_partition`` equal to the JAX function; world-1 bits equal to
the single-device search; ``build_sharded`` bit for bit
``build().shard()``; one allgather of bucket·2k·4 bytes per batch; and
sharded archives both ways between the packages for float32, int8 and
uint8."""

import pathlib

import numpy as np
import pytest

W = 4
N, NQ, D, K = 400, 37, 16, 7
BUCKET = 64   # 37 queries pad to one batch of 64
ARCHIVES = ("flat_f32", "flat_i8", "flat_u8", "pq_f32")


def _data():
    rng = np.random.default_rng(7)
    w = rng.dirichlet(np.full(10, 0.4))           # unequal cluster sizes
    c = rng.uniform(-3, 3, (10, D))
    x = (c[rng.choice(10, N, p=w)] + rng.standard_normal((N, D))
         ).astype(np.float32)
    q = (c[rng.integers(0, 10, NQ)] + rng.standard_normal((NQ, D))
         ).astype(np.float32)
    return x, q


def _typed(x, tag):
    if tag.endswith("i8"):
        return np.clip(np.round(x * 20), -127, 127).astype(np.int8)
    if tag.endswith("u8"):
        return np.clip(np.round(x * 20 + 128), 0, 255).astype(np.uint8)
    return x


def _metric(name):
    from raft_tpu_torch.distance import DistanceType

    return {"l1": DistanceType.L1, "l2sqrt": DistanceType.L2SqrtExpanded,
            "inner_product": DistanceType.InnerProduct}[name]


def _carry(arrays, meta):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    if meta["kind"] == "ivf_flat":
        return ivf_flat.index_from_arrays(arrays, meta["metric"],
                                          device="cpu")
    return ivf_pq.index_from_arrays(arrays, meta["metric"],
                                    meta["codebook_kind"], meta["pq_bits"],
                                    meta["dataset_dtype"], device="cpu")


def _battery(comms, payload):
    import torch

    from raft_tpu_torch.neighbors import (ann_mnmg, brute_force, ivf_flat,
                                          ivf_pq, serialize)

    fams = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}
    x, q = _data()
    calls = comms.collective_calls
    out = {}
    root = pathlib.Path(payload["dir"])
    for tag, (arrays, meta) in payload["indexes"].items():
        idx = _carry(arrays, meta)
        fam = fams[meta["kind"]]
        sh = idx.shard(comms)
        qq = _typed(q, tag)
        before = (calls["allgather"], calls["allgather_bytes"])
        d, i = ann_mnmg.search(sh, qq, K, fam.SearchParams(n_probes=3))
        out[("search", tag)] = (d.numpy(), i.numpy(),
                                (calls["allgather"] - before[0],
                                 calls["allgather_bytes"] - before[1]))
        out[("aux", tag)] = dict(sh.aux)
        # archives: the JAX package's into the port, the port's out
        got = serialize.load_sharded(root / f"jax_{tag}", comms,
                                     device="cpu")
        out[("jax_archive", tag)] = (
            got.kind == sh.kind and got.aux == sh.aux
            and all(torch.equal(a, b) for a, b in
                    zip(got.stacked + got.replicated,
                        sh.stacked + sh.replicated)))
        serialize.save_sharded(root / f"port_{tag}", sh)
        again = serialize.load_sharded(root / f"port_{tag}", comms,
                                       device="cpu")
        out[("round_trip", tag)] = all(
            torch.equal(a, b) for a, b in zip(again.stacked, sh.stacked))
    for m in ("l1", "l2sqrt", "inner_product"):
        sb = ann_mnmg.shard_brute_force(x, comms, _metric(m), device="cpu")
        d, i = ann_mnmg.search(sb, q, K)
        out[("bf", m)] = (d.numpy(), i.numpy())
    # a ragged row count: sentinel rows under L2, refused under L1
    d, i = ann_mnmg.search(ann_mnmg.shard_brute_force(
        x[:N - 3], comms, _metric("l2sqrt"), device="cpu"), q, K)
    out["bf_ragged"] = (d.numpy(), i.numpy())
    try:
        ann_mnmg.shard_brute_force(x[:N - 3], comms, _metric("l1"),
                                   device="cpu")
        out["ragged_l1"] = "ran"
    except Exception as e:
        out["ragged_l1"] = str(e)
    # build_sharded against build().shard(), the port's own builds
    for kind, params in (("ivf_flat", ivf_flat.IndexParams(n_lists=8)),
                         ("ivf_pq", ivf_pq.IndexParams(n_lists=8,
                                                       pq_dim=8))):
        fam = fams[kind]
        a = fam.build(params, x, device="cpu").shard(comms)
        b = fam.build_sharded(params, x, comms, device="cpu")
        out[("build_sharded", kind)] = (
            a.aux == b.aux
            and all(torch.equal(u, v) for u, v in zip(a.stacked, b.stacked))
            and all(torch.equal(u, v)
                    for u, v in zip(a.replicated, b.replicated)))
    # world 1: each rank alone, as a replica group of one
    layout = comms.replica_split(W)
    one = layout.groups[comms.get_rank()]
    for tag in ("flat_f32", "pq_f32"):
        arrays, meta = payload["indexes"][tag]
        idx = _carry(arrays, meta)
        fam = fams[meta["kind"]]
        p = fam.SearchParams(n_probes=3)
        d1, i1 = ann_mnmg.search(idx.shard(one), q, K, p)
        d0, i0 = fam.search(p, idx, q, K)
        out[("world1", tag)] = torch.equal(d1, d0) and torch.equal(i1, i0)
    d1, i1 = ann_mnmg.search(ann_mnmg.shard_brute_force(
        x, one, _metric("l2sqrt"), device="cpu"), q, K)
    d0, i0 = brute_force.knn(x, q, K, _metric("l2sqrt"), device="cpu")
    out[("world1", "bf")] = torch.equal(d1, d0) and torch.equal(i1, i0)
    return out


@pytest.fixture(scope="module")
def jax_comms():
    import jax
    from jax.sharding import Mesh

    from raft_tpu.comms import build_comms

    return build_comms(Mesh(np.array(jax.devices()[:W]), ("world",)))


@pytest.fixture(scope="module")
def jax_side(jax_comms, tmp_path_factory):
    """The JAX indexes (carried to the port as arrays), their JAX shards
    and the archives the JAX package writes of them."""
    import jax.numpy as jnp

    from raft_tpu.neighbors import ann_mnmg as jann
    from raft_tpu.neighbors import ivf_flat as jflat
    from raft_tpu.neighbors import ivf_pq as jpq
    from raft_tpu.neighbors import serialize as jser
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    root = tmp_path_factory.mktemp("ann_mnmg")
    x, _ = _data()
    indexes, shards = {}, {}
    for tag in ARCHIVES:
        xx = jnp.asarray(_typed(x, tag))
        if tag.startswith("flat"):
            idx = jflat.build(jflat.IndexParams(n_lists=8), xx)
            fields = ivf_flat.ARRAY_FIELDS
            meta = {"kind": "ivf_flat", "metric": int(idx.metric)}
        else:
            idx = jpq.build(jpq.IndexParams(n_lists=8, pq_dim=8), xx)
            fields = ivf_pq.ARRAY_FIELDS
            meta = {"kind": "ivf_pq", "metric": int(idx.metric),
                    "codebook_kind": int(idx.codebook_kind),
                    "pq_bits": int(idx.pq_bits),
                    "dataset_dtype": idx.dataset_dtype}
        indexes[tag] = ({n: np.asarray(getattr(idx, n)) for n in fields},
                        meta)
        shards[tag] = jann.shard_ivf_flat(idx, jax_comms) \
            if tag.startswith("flat") else jann.shard_ivf_pq(idx, jax_comms)
        jser.save_sharded(str(root / f"jax_{tag}"), shards[tag])
    return dict(root=root, indexes=indexes, shards=shards)


@pytest.fixture(scope="module")
def port(jax_side):
    from raft_tpu_torch.testing.world import run_world

    return run_world("test_torch_ann_mnmg:_battery", W,
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


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_partition_equals_jax(world):
    from raft_tpu.neighbors import ann_mnmg as jann
    from raft_tpu_torch.neighbors import ann_mnmg
    from raft_tpu_torch.neighbors._common import chunk_layout

    counts = np.array([5, 80, 3, 40, 0, 17, 120, 9, 33, 61, 2, 250])
    lay = chunk_layout(counts)
    got = ann_mnmg._partition(lay.chunk_table, lay.n_phys + 1, world)
    want = jann._partition(lay.chunk_table, lay.n_phys + 1, world)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[2:] == want[2:]
    assert world == 1 or got[2] > 0   # continuation chunks per shard


@pytest.mark.parametrize("tag", ARCHIVES)
def test_sharded_search_matches_jax(port, jax_side, jax_comms, tag):
    from raft_tpu.neighbors import ann_mnmg as jann
    from raft_tpu.neighbors import ivf_flat as jflat
    from raft_tpu.neighbors import ivf_pq as jpq

    _, q = _data()
    fam = jflat if tag.startswith("flat") else jpq
    want_d, want_i = jann.search(jax_side["shards"][tag], _typed(q, tag), K,
                                 fam.SearchParams(n_probes=3))
    for out in port:
        d, i, _ = out[("search", tag)]
        assert d.shape == (NQ, K) and i.dtype == np.int32
        _assert_matches(d, i, want_d, want_i)
        assert out[("aux", tag)] == dict(jax_side["shards"][tag].aux)


@pytest.mark.parametrize("tag", ARCHIVES)
def test_one_allgather_per_batch(port, tag):
    for out in port:
        assert out[("search", tag)][2] == (1, BUCKET * 2 * K * 4)


@pytest.mark.parametrize("metric", ["l1", "l2sqrt", "inner_product"])
def test_sharded_brute_force_matches_single_device(port, metric):
    from raft_tpu.distance import DistanceType as JD
    from raft_tpu.neighbors import brute_force as jbf
    from raft_tpu_torch.neighbors import brute_force

    x, q = _data()
    jm = {"l1": JD.L1, "l2sqrt": JD.L2SqrtExpanded,
          "inner_product": JD.InnerProduct}[metric]
    want_d, want_i = jbf.knn(x, q, K, jm)
    own_d, own_i = brute_force.knn(x, q, K, _metric(metric), device="cpu")
    for out in port:
        d, i = out[("bf", metric)]
        _assert_matches(d, i, want_d, want_i)
        if metric == "l1":   # B5 sums every pair in one order
            np.testing.assert_array_equal(d, own_d.numpy())
            np.testing.assert_array_equal(i, own_i.numpy())


def test_ragged_brute_force_sentinels_and_l1_refusal(port):
    from raft_tpu_torch.neighbors import brute_force

    x, q = _data()
    want_d, want_i = brute_force.knn(x[:N - 3], q, K, _metric("l2sqrt"),
                                     device="cpu")
    for out in port:
        d, i = out["bf_ragged"]
        _assert_matches(d, i, want_d.numpy(), want_i.numpy())
        assert (i < N - 3).all()
        assert "not divisible by world" in out["ragged_l1"]


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_build_sharded_is_build_then_shard(port, kind):
    assert all(out[("build_sharded", kind)] for out in port)


@pytest.mark.parametrize("tag", ["flat_f32", "pq_f32", "bf"])
def test_world_one_is_single_device_bits(port, tag):
    assert all(out[("world1", tag)] for out in port)


@pytest.mark.parametrize("tag", ARCHIVES)
def test_jax_archive_loads_into_the_port(port, tag):
    assert all(out[("jax_archive", tag)] for out in port)
    assert all(out[("round_trip", tag)] for out in port)


@pytest.mark.parametrize("tag", ARCHIVES)
def test_port_archive_loads_into_jax(port, jax_side, jax_comms, tag):
    from raft_tpu.neighbors import serialize as jser

    got = jser.load_sharded(str(jax_side["root"] / f"port_{tag}"),
                            jax_comms)
    want = jax_side["shards"][tag]
    assert got.kind == want.kind and got.aux == dict(want.aux)
    for a, b in zip(tuple(got.replicated) + tuple(got.stacked),
                    tuple(want.replicated) + tuple(want.stacked)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
