"""Single-linkage hierarchical agglomerative clustering (port of
``raft_tpu/cluster/single_linkage.py``; reference
raft/cluster/single_linkage.cuh:53 and the pipeline of
cluster/detail/single_linkage.cuh:52-117):

  connectivity graph → sorted MST → host dendrogram (union-find,
  detail/agglomerative.cuh:103 ``build_dendrogram_host``) →
  ``extract_flattened_clusters`` (:239).

PAIRWISE connectivity runs Prim's algorithm on the dense distance matrix:
n − 1 eager steps on the card (an n-wide masked argmin and an update a
step, no host read).  KNN_GRAPH builds the kNN graph and runs Borůvka with
the connect-components fix-up (:mod:`raft_tpu_torch.sparse.neighbors`).
The dendrogram and its cut run in the native runtime
(:mod:`raft_tpu_torch.native`) and raise when it cannot be built; the
numpy versions stay as plain twins (:func:`build_dendrogram_numpy`,
:func:`extract_flattened_clusters_numpy`).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import traced
from raft_tpu_torch.distance import DistanceType
from raft_tpu_torch.distance.pairwise import as_input, distance


class LinkageDistance(enum.Enum):
    """reference cluster/single_linkage_types.hpp:26."""

    PAIRWISE = "pairwise"
    KNN_GRAPH = "knn_graph"


class SingleLinkageOutput(NamedTuple):
    """reference ``linkage_output`` (single_linkage_types.hpp)."""

    labels: torch.Tensor   # (n,)
    children: np.ndarray   # (n-1, 2) scipy-style merge tree
    deltas: np.ndarray     # (n-1,) merge distances
    sizes: np.ndarray      # (n-1,) merged cluster sizes


def _prim_mst(d: torch.Tensor):
    """Dense-graph Prim: (src, dst, weight) of the n − 1 MST edges in
    insertion order; *d* holds +inf on its diagonal.  Ties go to the
    least index (``argmin``'s first), as ``jnp.argmin``."""
    n = d.shape[0]
    dev = d.device
    in_tree = torch.zeros(n, dtype=torch.bool, device=dev)
    in_tree[0] = True
    best_d = d[0].clone()
    best_src = torch.zeros(n, dtype=torch.int32, device=dev)
    src = torch.zeros(n - 1, dtype=torch.int32, device=dev)
    dst = torch.zeros(n - 1, dtype=torch.int32, device=dev)
    w = torch.zeros(n - 1, dtype=d.dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=dev)
    for i in range(n - 1):
        # the nearest vertex outside the tree
        cand = torch.where(in_tree, inf, best_d)
        u = torch.argmin(cand).view(1)
        src[i:i + 1] = best_src.index_select(0, u)
        dst[i:i + 1] = u
        w[i:i + 1] = cand.index_select(0, u)
        in_tree.index_fill_(0, u, True)
        du = d.index_select(0, u)[0]
        better = du < best_d
        best_d = torch.where(better, du, best_d)
        best_src = torch.where(better, u.to(torch.int32), best_src)
    return src, dst, w


def build_sorted_mst(x=None, metric: DistanceType = DistanceType.L2SqrtExpanded,
                     dist=None, device=None):
    """MST edges by ascending weight (reference cluster/detail/mst.cuh
    ``build_sorted_mst``) of the points *x* under *metric*, or of a given
    distance matrix *dist*.  Inputs: a tensor stays where it is, an array
    goes to *device* (``None``: the card)."""
    if dist is None:
        x = as_input(x, device)
        dist = distance(x, x, metric)
    else:
        dist = as_input(dist, device)
    n = dist.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    src, dst, w = _prim_mst(torch.where(eye, float("inf"), dist))
    order = torch.sort(w, stable=True).indices
    return src[order], dst[order], w[order]


def build_dendrogram_numpy(src, dst, weights
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The numpy twin of :func:`build_dendrogram_host` (the JAX package's
    fallback, ``raft_tpu/cluster/single_linkage.py`` :114-137)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    weights = np.asarray(weights)
    n = len(src) + 1
    parent = np.arange(2 * n - 1)
    size = np.ones(2 * n - 1, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:  # path compression
            parent[a], a = root, parent[a]
        return root

    children = np.zeros((n - 1, 2), dtype=np.int64)
    sizes = np.zeros(n - 1, dtype=np.int64)
    for i in range(n - 1):
        ra, rb = find(src[i]), find(dst[i])
        new = n + i
        children[i] = (min(ra, rb), max(ra, rb))
        size[new] = size[ra] + size[rb]
        sizes[i] = size[new]
        parent[ra] = parent[rb] = new
    return children, weights.copy(), sizes


def build_dendrogram_host(src, dst, weights
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Union-find agglomerative labelling on the host (reference
    detail/agglomerative.cuh:103): scipy-linkage-style (children, deltas,
    sizes), in the native runtime."""
    return native.build_dendrogram(_host(src), _host(dst), _host(weights))


def extract_flattened_clusters_numpy(children: np.ndarray, n_clusters: int,
                                     n: int) -> np.ndarray:
    """The numpy twin of :func:`extract_flattened_clusters` (the JAX
    package's fallback, ``raft_tpu/cluster/single_linkage.py``
    :148-163)."""
    parent = np.arange(2 * n - 1)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(n - n_clusters):
        a, b = children[i]
        new = n + i
        parent[find(a)] = new
        parent[find(b)] = new
    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


def extract_flattened_clusters(children: np.ndarray, n_clusters: int,
                               n: int) -> np.ndarray:
    """Cut the dendrogram at *n_clusters* (reference
    detail/agglomerative.cuh:239): the first n − n_clusters merges, the
    forest labelled 0..n_clusters−1; in the native runtime."""
    return native.extract_flattened_clusters(children, n_clusters, n)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@traced("raft_tpu.cluster.single_linkage")
def single_linkage(x, metric: DistanceType = DistanceType.L2SqrtExpanded,
                   linkage: LinkageDistance = LinkageDistance.PAIRWISE,
                   n_clusters: int = 2, c: int = 15,
                   device=None) -> SingleLinkageOutput:
    """Single-linkage HAC (reference cluster/single_linkage.cuh:53); *c*
    sets the kNN graph's density under KNN_GRAPH.  *x*: a tensor stays
    where it is, an array goes to *device* (``None``: the card).  The
    labels come back on that device."""
    x = as_input(x, device)
    n = x.shape[0]
    expects(2 <= n_clusters <= n, "n_clusters must be in [2, n]")
    if linkage == LinkageDistance.KNN_GRAPH:
        from raft_tpu_torch.sparse.neighbors import mst_from_knn_graph

        src, dst, w = mst_from_knn_graph(x, metric, c)
    else:
        src, dst, w = build_sorted_mst(x, metric)
    children, deltas, sizes = build_dendrogram_host(src, dst, w)
    labels = extract_flattened_clusters(children, n_clusters, n)
    return SingleLinkageOutput(torch.from_numpy(labels).to(x.device),
                               children, deltas, sizes)
