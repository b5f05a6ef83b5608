"""The port's spectral layer (``raft_tpu_torch.spectral``) and
``sparse.fit_embedding`` against the JAX package's on the same seeded
graphs: the implicit Laplacian and modularity matvecs at rtol 1e-6,
``analyze_partition`` / ``analyze_modularity`` of the same labels at rtol
1e-6, ``partition`` and ``modularity_maximization`` on planted
communities (the same communities as JAX's, ARI >= 0.99, edge cut within
1%), and ``fit_embedding`` by subspace (its start vector and the k-means
init cannot match)."""

import numpy as np
import pytest
import torch

import raft_tpu.sparse as js
import raft_tpu.spectral as jspec
from raft_tpu_torch import sparse as ts
from raft_tpu_torch import spectral as tspec
from raft_tpu_torch.stats import adjusted_rand_index

CPU = "cpu"


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def planted(sizes, p_in=0.5, p_out=0.02, seed=0, weighted=False):
    """A symmetric planted-community graph (a path inside each block and
    one bridge between consecutive blocks keep it connected) and its
    labels."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    labels = np.repeat(np.arange(len(sizes)), sizes)
    prob = np.where(labels[:, None] == labels[None, :], p_in, p_out)
    a = (rng.random((n, n)) < prob).astype(np.float32)
    if weighted:
        a *= rng.uniform(0.5, 1.5, (n, n)).astype(np.float32)
    a = np.triu(a, 1)
    start = 0
    for s in sizes:
        a[np.arange(start, start + s - 1), np.arange(start + 1, start + s)] = 1
        start += s
    start = 0
    for s in sizes[:-1]:
        a[start + s - 1, start + s] = 1
        start += s
    a = a + a.T
    r, c = np.nonzero(a)
    return (r.astype(np.int32), c.astype(np.int32), a[r, c], (n, n)), labels


@pytest.fixture(scope="module")
def graph():
    trip, labels = planted((40, 50, 45), seed=1, weighted=True)
    return (ts.from_triplets(*trip, device=CPU), js.from_triplets(*trip),
            labels)


def test_matvecs(graph):
    t, j, _ = graph
    n = t.shape[0]
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    xt = torch.from_numpy(x)
    tmv, tdeg = tspec.laplacian_matvec(t)
    jmv, jdeg = jspec.laplacian_matvec(j)
    np.testing.assert_allclose(_np(tdeg), np.asarray(jdeg), rtol=1e-6)
    np.testing.assert_allclose(_np(tmv(xt)), np.asarray(jmv(x)), rtol=1e-6,
                               atol=1e-5)
    tmv, tdeg, tsum = tspec.modularity_matvec(t)
    jmv, jdeg, jsum = jspec.modularity_matvec(j)
    np.testing.assert_allclose(float(tsum), float(jsum), rtol=1e-6)
    np.testing.assert_allclose(_np(tmv(xt)), np.asarray(jmv(x)), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(_np(tspec.degrees(t)),
                               np.asarray(jspec.degrees(j)), rtol=1e-6)


def test_analyze_same_labels(graph):
    t, j, labels = graph
    rng = np.random.default_rng(3)
    for lab, k in ((labels, 3), (rng.integers(0, 4, len(labels)), 4),
                   (np.zeros(len(labels), np.int64), 2)):  # an empty cluster
        tc, tcost = tspec.analyze_partition(t, k, lab)
        jc, jcost = jspec.analyze_partition(j, k, lab)
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)
        np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-6)
        np.testing.assert_allclose(
            float(tspec.analyze_modularity(t, k, lab)),
            float(jspec.analyze_modularity(j, k, lab)), rtol=1e-6, atol=1e-7)


def _solvers(pkg, k):
    return (pkg.LanczosEigenSolver(pkg.EigenSolverConfig(n_eigVecs=k,
                                                         tol=1e-7)),
            pkg.KMeansClusterSolver(pkg.ClusterSolverConfig(n_clusters=k)))


def _run(pipeline, seed):
    """Four communities of 150 (expected degree 30 inside, ~1.4 across)
    through both packages' *pipeline*."""
    trip, truth = planted((150,) * 4, p_in=0.2, p_out=0.003, seed=seed)
    t, j = ts.from_triplets(*trip, device=CPU), js.from_triplets(*trip)
    tl, tvals, tvecs, _ = getattr(tspec, pipeline)(t, *_solvers(tspec, 4))
    jl, jvals, jvecs, _ = getattr(jspec, pipeline)(j, *_solvers(jspec, 4))
    assert tl.device.type == "cpu" and tuple(tvecs.shape) == (600, 4)
    # the deterministic part: eigenvalues and the eigenvector subspace
    np.testing.assert_allclose(_np(tvals), np.asarray(jvals), rtol=1e-4,
                               atol=1e-4)
    s = np.linalg.svd(_orth(_np(tvecs)).T @ _orth(jvecs), compute_uv=False)
    np.testing.assert_allclose(s, 1.0, atol=1e-3)
    truth = torch.from_numpy(truth)
    assert float(adjusted_rand_index(truth, tl)) >= 0.99
    return t, j, tl, torch.from_numpy(np.array(jl)), truth


@pytest.mark.parametrize("seed", [1, 2, 4])
@pytest.mark.parametrize("pipeline", ["partition", "modularity_maximization"])
def test_pipelines_match_jax(pipeline, seed):
    """The same communities as the JAX package's (ARI >= 0.99) and the
    same edge cut within 1%."""
    t, j, tl, jl, _ = _run(pipeline, seed)
    assert float(adjusted_rand_index(jl, tl)) >= 0.99
    tcut, _ = tspec.analyze_partition(t, 4, tl)
    jcut, _ = jspec.analyze_partition(j, 4, jl.numpy())
    np.testing.assert_allclose(float(tcut), float(jcut), rtol=1e-2)


@pytest.mark.parametrize("seed", [0, 3])
def test_partition_recovers_plants_where_jax_kmeans_does_not(seed):
    """The whitened Laplacian embedding keeps the constant eigenvector's
    rounding noise as a unit-norm column (the reference's
    ``transform_eigen_matrix``).  On these graphs the JAX package's
    k-means++ (one draw a step) then stops in a local minimum (ARI about
    0.63 against the plants, with 64-bit types on as in this suite); the
    port's k-means‖ (RAFT's greedy finish, ROADMAP §C) finds the plants.
    Both solve the same eigenproblem, and the port's labels reach ARI
    >= 0.99 against the plants (both checked in :func:`_run`)."""
    _run("partition", seed)


def _orth(a):
    return np.linalg.qr(np.asarray(a, np.float64))[0]


def test_fit_embedding_subspace():
    trip, _ = planted((30, 30, 30, 30), p_in=0.5, p_out=0.01, seed=6)
    t, j = ts.from_triplets(*trip, device=CPU), js.from_triplets(*trip)
    te = ts.fit_embedding(t, 3, seed=0)
    je = js.fit_embedding(j, 3, seed=0)
    assert tuple(te.shape) == (120, 3)
    np.testing.assert_allclose(_np(te).std(axis=0), 1.0, rtol=1e-3)
    s = np.linalg.svd(_orth(_np(te)).T @ _orth(je), compute_uv=False)
    np.testing.assert_allclose(s, 1.0, atol=1e-3)
