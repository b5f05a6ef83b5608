"""The port's single-linkage HAC (``raft_tpu_torch.cluster.single_linkage``)
against the JAX package's on the same seeded inputs: ``build_sorted_mst``
on one distance matrix bit for bit (Prim's edges, ties included, and the
stable weight sort); the dendrogram and its cut — the native runtime,
its numpy twin and the JAX package's — equal; ``single_linkage`` under
PAIRWISE and KNN_GRAPH on separated blobs: the same partition as the JAX
package's up to a relabelling."""

import importlib

import numpy as np
import pytest
import torch

from raft_tpu.distance import DistanceType as JDT
from raft_tpu_torch import native
from raft_tpu_torch.distance import DistanceType

# the modules (each package's ``cluster.single_linkage`` is the function)
jsl = importlib.import_module("raft_tpu.cluster.single_linkage")
tsl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")

CPU = "cpu"


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def blobs(seed, n=150, dim=5, centers=5):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (centers, dim))
    lab = rng.integers(0, centers, n)
    return (c[lab] + 0.2 * rng.standard_normal((n, dim))).astype(
        np.float32), lab


@pytest.mark.parametrize("ties", [False, True])
def test_build_sorted_mst_bit_for_bit(ties):
    rng = np.random.default_rng(1)
    n = 90
    if ties:   # few distinct weights: argmin's first index decides
        d = rng.integers(1, 4, (n, n)).astype(np.float32)
    else:
        d = rng.random((n, n)).astype(np.float32)
    d = np.triu(d, 1)
    d = d + d.T
    t = tsl.build_sorted_mst(dist=torch.from_numpy(d))
    j = jsl.build_sorted_mst(dist=d)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # from points: the same matrix on both sides gives the same tree
    x, _ = blobs(2)
    dx = np.asarray(jsl.pairwise_distance(x, x, JDT.L2SqrtExpanded))
    for a, b in zip(tsl.build_sorted_mst(dist=dx, device=CPU),
                    jsl.build_sorted_mst(dist=dx)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 3])
def test_dendrogram_and_cut_native_numpy_jax(seed):
    x, _ = blobs(seed)
    src, dst, w = (np.asarray(a) for a in jsl.build_sorted_mst(x))
    n = x.shape[0]
    nat = tsl.build_dendrogram_host(src, dst, w)
    twin = tsl.build_dendrogram_numpy(src, dst, w)
    jax_ = jsl.build_dendrogram_host(src, dst, w)
    for a, b, c in zip(nat, twin, jax_):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for k in (1, 2, 5, 17, n):
        lab = tsl.extract_flattened_clusters(nat[0], k, n)
        np.testing.assert_array_equal(
            lab, tsl.extract_flattened_clusters_numpy(nat[0], k, n))
        np.testing.assert_array_equal(
            lab, jsl.extract_flattened_clusters(nat[0], k, n))
        assert lab.dtype == np.int32 and len(np.unique(lab)) == k


def _same_partition(a, b):
    a, b = _np(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("linkage", ["PAIRWISE", "KNN_GRAPH"])
def test_single_linkage_matches_jax(linkage):
    x, truth = blobs(4, n=160)
    t = tsl.single_linkage(torch.from_numpy(x), DistanceType.L2SqrtExpanded,
                           tsl.LinkageDistance[linkage], n_clusters=5, c=3)
    j = jsl.single_linkage(x, JDT.L2SqrtExpanded,
                           jsl.LinkageDistance[linkage], n_clusters=5, c=3)
    assert t.labels.device.type == "cpu" and t.children.shape == (159, 2)
    assert _same_partition(t.labels, j.labels)
    assert _same_partition(t.labels, truth)
    # the merge heights are the expanded L2 form's, which each package
    # rounds in its own order (about ε·‖x‖² a pair; ‖x‖² ~ 2,500× the
    # smallest squared heights here)
    np.testing.assert_allclose(t.deltas, np.asarray(j.deltas), rtol=1e-3)
    np.testing.assert_array_equal(t.sizes[-4:], np.asarray(j.sizes)[-4:])


def test_single_linkage_arrays_and_checks():
    x, _ = blobs(5, n=40)
    out = tsl.single_linkage(x, n_clusters=3, device=CPU)
    assert len(np.unique(_np(out.labels))) == 3
    with pytest.raises(Exception, match="n_clusters"):
        tsl.single_linkage(x, n_clusters=1, device=CPU)
    with pytest.raises(ValueError, match="forest"):
        native.build_dendrogram(np.array([0, 1]), np.array([1, 0]),
                                np.zeros(2, np.float32))
