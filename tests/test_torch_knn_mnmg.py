"""Distributed brute-force kNN: the port at W = 4 (a gloo world of 4
processes) under L2Sqrt, inner product and L1 for every partition, against
the JAX package's ``knn_mnmg`` on a mesh of 4 CPU devices (ids equal
except at near ties, distances to rtol 1e-5) and against the port's own
single-device ``knn`` (bit for bit on the CPU's torch engine); the one
allgather of nq·2k·4 bytes, and ``k > rows_per`` refused."""

import pathlib

import numpy as np
import pytest
import torch

W = 4
N, NQ, D, K = 400, 37, 16, 7
METRICS = ("l2sqrt", "inner_product", "l1")
PARTITIONS = ("index", "queries", "auto")


def _data():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    return x, q


def _metric(name):
    from raft_tpu_torch.distance import DistanceType

    return {"l2sqrt": DistanceType.L2SqrtExpanded,
            "inner_product": DistanceType.InnerProduct,
            "l1": DistanceType.L1}[name]


def _battery(comms, payload):
    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.neighbors.knn_mnmg import knn_mnmg

    x, q = _data()
    calls = comms.collective_calls
    out = {}
    for m in METRICS:
        for part in PARTITIONS:
            before = (calls["allgather"], calls["allgather_bytes"])
            # the query-count ≥ rows case: auto picks "queries"
            qq = np.concatenate([q] * 11) if part == "auto" else q
            d, i = knn_mnmg(comms, x, qq, K, _metric(m), partition=part,
                            device="cpu")
            out[(m, part)] = (d.numpy(), i.numpy(),
                              (calls["allgather"] - before[0],
                               calls["allgather_bytes"] - before[1]))
    try:
        knn_mnmg(comms, x, q, N // W + 1, device="cpu")
        out["k_refused"] = "ran"
    except LogicError:
        out["k_refused"] = True
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from raft_tpu_torch.testing.world import run_world

    return run_world("test_torch_knn_mnmg:_battery", W,
                     workdir=tmp_path_factory.mktemp("knn_mnmg"),
                     timeout=180,
                     sys_path=[str(pathlib.Path(__file__).parent)])


@pytest.fixture(scope="module")
def jax_comms():
    import jax
    from jax.sharding import Mesh

    from raft_tpu.comms import build_comms

    return build_comms(Mesh(np.array(jax.devices()[:W]), ("world",)))


def _queries(part):
    _, q = _data()
    return np.concatenate([q] * 11) if part == "auto" else q


def _near_ties(d, k):
    """(nq, k) mask of positions whose distance lies within 1e-5 relative
    of a neighbour's in the row's best k + 1."""
    gap = np.abs(d[:, 1:] - d[:, :-1]) <= 1e-5 * np.abs(d[:, 1:]) + 1e-6
    tied = np.zeros((d.shape[0], k), bool)
    tied |= gap[:, :k]
    tied[:, 1:] |= gap[:, :k - 1]
    return tied


@pytest.mark.parametrize("part", PARTITIONS)
@pytest.mark.parametrize("metric", METRICS)
def test_matches_jax(port, jax_comms, metric, part):
    from raft_tpu.neighbors import brute_force as jbf
    from raft_tpu.neighbors.knn_mnmg import knn_mnmg as jknn

    x, _ = _data()
    q = _queries(part)
    want_d, want_i = jknn(jax_comms, x, q, K, _jax_metric(metric),
                          partition=part)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    # near ties from the exact k + 1 best of the JAX single-device scan
    tie_d, _ = jbf.knn(x, q, K + 1, _jax_metric(metric))
    tie_d = np.asarray(tie_d)
    if metric == "inner_product":
        tie_d = -tie_d
    tied = _near_ties(tie_d, K)
    for out in port:
        d, i, _ = out[(metric, part)]
        assert d.shape == (q.shape[0], K) and i.dtype == np.int32
        np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-5)
        assert not ((i != want_i) & ~tied).any()


def _jax_metric(name):
    from raft_tpu.distance import DistanceType

    return {"l2sqrt": DistanceType.L2SqrtExpanded,
            "inner_product": DistanceType.InnerProduct,
            "l1": DistanceType.L1}[name]


@pytest.mark.parametrize("part", PARTITIONS)
@pytest.mark.parametrize("metric", METRICS)
def test_matches_single_device_knn_bit_for_bit(port, metric, part):
    from raft_tpu_torch.neighbors import brute_force

    x, _ = _data()
    q = _queries(part)
    want_d, want_i = brute_force.knn(x, q, K, _metric(metric), device="cpu")
    for out in port:
        d, i, _ = out[(metric, part)]
        np.testing.assert_array_equal(d, want_d.numpy())
        np.testing.assert_array_equal(i, want_i.numpy())


@pytest.mark.parametrize("metric", METRICS)
def test_one_allgather_of_the_packed_results(port, metric):
    """Index partition: one allgather of nq·2k·4 bytes.  Query partition:
    one allgather of each rank's bucketed slice, per·2k·4 bytes."""
    per = 16   # bucket_dim(ceil(37 / 4)): the power-of-two ladder
    per_auto = 128  # bucket_dim(ceil(407 / 4))
    for out in port:
        assert out[(metric, "index")][2] == (1, NQ * 2 * K * 4)
        assert out[(metric, "queries")][2] == (1, per * 2 * K * 4)
        assert out[(metric, "auto")][2] == (1, per_auto * 2 * K * 4)


def test_k_above_rows_per_rank_refused(port):
    assert all(out["k_refused"] is True for out in port)
