"""The port's sparse neighbours (``raft_tpu_torch.sparse.neighbors``)
against the JAX package's on the same seeded inputs: the sparse
``brute_force_knn`` (distances at rtol 1e-5, ids equal except at near
ties) over several query and index tiles, ``build_k``, ``knn_graph``,
``connect_components`` and ``mst_from_knn_graph`` (MST weight at rtol
1e-5, the same components, n − 1 edges)."""

import numpy as np
import pytest
import torch

import raft_tpu.sparse as js
from raft_tpu.distance import DistanceType as JDT
from raft_tpu.sparse import neighbors as jn
from raft_tpu_torch import sparse as ts
from raft_tpu_torch.distance import DistanceType
from raft_tpu_torch.sparse import neighbors as tn

CPU = "cpu"


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_knn_equal(td, ti, jd, ji, rtol=1e-5):
    td, ti, jd, ji = _np(td), _np(ti), np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(td, jd, rtol=rtol, atol=rtol)
    # ids must agree where a row's values are not within rtol of another
    scale = np.maximum(np.abs(jd), 1.0)
    gap = np.full(jd.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], np.abs(np.diff(jd, axis=1)))
    gap[:, :-1] = np.minimum(gap[:, :-1], np.abs(np.diff(jd, axis=1)))
    clear = gap > 10 * rtol * scale
    np.testing.assert_array_equal(ti[clear], ji[clear])


def random_csr(seed, m, dim, density):
    rng = np.random.default_rng(seed)
    mask = rng.random((m, dim)) < density
    r, c = np.nonzero(mask)
    v = rng.uniform(0.05, 1.0, len(r)).astype(np.float32)
    return (ts.from_triplets(r, c, v, (m, dim), device=CPU),
            js.from_triplets(r, c, v, (m, dim)))


@pytest.mark.parametrize("metric", ["L2Expanded", "CosineExpanded", "L1",
                                    "InnerProduct"])
def test_sparse_brute_force_knn(metric):
    ti, ji = random_csr(0, 230, 30, 0.2)
    tq, jq = random_csr(1, 25, 30, 0.2)
    td, tidx = tn.brute_force_knn(ti, tq, 7, DistanceType[metric],
                                  batch_size_index=64, batch_size_query=10)
    jd, jidx = jn.brute_force_knn(ji, jq, 7, JDT[metric],
                                  batch_size_index=64, batch_size_query=10)
    assert tuple(td.shape) == (25, 7)
    assert_knn_equal(td, tidx, jd, jidx)


def test_build_k():
    for n, c in ((1, 15), (2, 15), (100, 15), (100_000, 15), (10, 0)):
        assert tn.build_k(n, c) == jn.build_k(n, c)


def blobs(seed, n=240, dim=8, centers=6, spread=4.0, std=0.3):
    """Separated blobs near the origin.  The expanded L2 form rounds by
    about ε·‖x‖² a pair, and both packages sum it in their own order: an
    edge's weight agrees to rtol 1e-4 (norms ~40× the squared distances
    inside a blob), the MST's total to 1e-5."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (centers, dim))
    lab = rng.integers(0, centers, n)
    return (c[lab] + std * rng.standard_normal((n, dim))).astype(
        np.float32), lab


@pytest.mark.parametrize("metric", ["L2SqrtExpanded", "L2Expanded"])
def test_knn_graph(metric):
    x, _ = blobs(2)
    t = tn.knn_graph(torch.from_numpy(x), DistanceType[metric], c=3,
                     batch_size=64)
    j = jn.knn_graph(x, JDT[metric], c=3, batch_size=64)
    assert t.shape == j.shape and t.capacity == j.capacity
    n, k = x.shape[0], tn.build_k(x.shape[0], 3)
    np.testing.assert_array_equal(_np(t.rows), np.asarray(j.rows))
    assert_knn_equal(t.vals.reshape(n, k), t.cols.reshape(n, k),
                     np.asarray(j.vals).reshape(n, k),
                     np.asarray(j.cols).reshape(n, k), rtol=1e-4)
    assert not (_np(t.rows) == _np(t.cols)).any()   # no self-edges
    g = tn.knn_graph(x, c=3, device=CPU)           # an array on the device
    assert g.device.type == "cpu"


def test_connect_components():
    x, lab = blobs(3)
    colors = lab.astype(np.int32) * 2     # a labelling, ids not compact
    t = tn.connect_components(torch.from_numpy(x), torch.from_numpy(colors),
                              batch_size=50)
    j = jn.connect_components(x, colors, batch_size=50)
    assert int(t.nnz) == int(j.nnz)
    np.testing.assert_array_equal(_np(t.rows), np.asarray(j.rows))
    np.testing.assert_array_equal(_np(t.cols), np.asarray(j.cols))
    np.testing.assert_allclose(_np(t.vals), np.asarray(j.vals), rtol=1e-5)


@pytest.mark.parametrize("seed", [4, 5])
def test_mst_from_knn_graph(seed):
    """Well-separated blobs: the kNN graph is disconnected, so the
    connect-components fix-up runs."""
    x, _ = blobs(seed)
    ts_, td, tw = tn.mst_from_knn_graph(torch.from_numpy(x), c=2)
    js_, jd, jw = jn.mst_from_knn_graph(x, c=2)
    n = x.shape[0]
    assert ts_.shape[0] == n - 1
    np.testing.assert_allclose(float(tw.double().sum()),
                               float(np.asarray(jw, np.float64).sum()),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=1e-4)
    assert (np.diff(_np(tw)) >= 0).all()
    # one component: a union-find over the edges joins every vertex
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in zip(_np(ts_), _np(td)):
        ra, rb = find(a), find(b)
        assert ra != rb
        parent[ra] = rb
    # the same tree as the JAX package's where weights are tie-free
    t_edges = {tuple(sorted(e)) for e in zip(_np(ts_), _np(td))}
    j_edges = {tuple(sorted(e)) for e in zip(np.asarray(js_),
                                             np.asarray(jd))}
    assert len(t_edges ^ j_edges) <= 2
