"""Spectral partition and modularity maximisation (port of
``raft_tpu/spectral/partition.py``; reference
``spectral/detail/partition.hpp:65-107`` ``partition`` +
``analyzePartition`` and ``spectral/detail/modularity_maximization.hpp``
``modularity_maximization`` + ``analyzeModularity``).

The operators stay implicit (closures over the ELL SpMV), the eigenvector
whitening is two reductions, and ``analyze_*`` score every cluster at
once with an (n, k) indicator matrix: one SpMM instead of k SpMVs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import traced
from raft_tpu_torch.sparse.linalg import spmm
from raft_tpu_torch.sparse.types import CSR
from raft_tpu_torch.spectral.matrix import (degrees, laplacian_matvec,
                                            modularity_matvec)
from raft_tpu_torch.spectral.solvers import (KMeansClusterSolver,
                                             LanczosEigenSolver)


def _transform_eigen_matrix(vecs: torch.Tensor) -> torch.Tensor:
    """Mean-centre each eigenvector and scale it to unit norm (reference
    ``transform_eigen_matrix``, spectral/detail/spectral_util.cuh)."""
    v = vecs - torch.mean(vecs, dim=0, keepdim=True)
    nrm = torch.clamp_min(torch.linalg.vector_norm(v, dim=0, keepdim=True),
                          1e-30)
    return v / nrm


@traced("raft_tpu.spectral.partition")
def partition(adj: CSR, eigen_solver: LanczosEigenSolver,
              cluster_solver: KMeansClusterSolver
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Spectral min-balanced-cut partition: the Laplacian's smallest
    eigenvectors, whitened, clustered by k-means (reference
    ``spectral/detail/partition.hpp:65``), on the adjacency's device.
    Returns (clusters (n,), eig_vals (k,), eig_vecs (n, k), inertia)."""
    expects(adj.shape[0] == adj.shape[1],
            "partition: adjacency must be square")
    mv, _ = laplacian_matvec(adj)
    eig_vals, eig_vecs = eigen_solver.solve_smallest_eigenvectors(
        mv, n=adj.shape[0], dtype=adj.data.dtype, device=adj.device)
    labels, inertia = cluster_solver.solve(_transform_eigen_matrix(eig_vecs))
    return labels, eig_vals, eig_vecs, inertia


@traced("raft_tpu.spectral.modularity_maximization")
def modularity_maximization(adj: CSR, eigen_solver: LanczosEigenSolver,
                            cluster_solver: KMeansClusterSolver
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """Community detection: the modularity matrix's largest eigenvectors,
    whitened, each row scaled to unit norm, clustered by k-means
    (reference ``spectral/detail/modularity_maximization.hpp``).  Returns
    (clusters (n,), eig_vals (k,), eig_vecs (n, k), inertia)."""
    expects(adj.shape[0] == adj.shape[1],
            "modularity_maximization: adjacency must be square")
    mv, _, _ = modularity_matvec(adj)
    eig_vals, eig_vecs = eigen_solver.solve_largest_eigenvectors(
        mv, n=adj.shape[0], dtype=adj.data.dtype, device=adj.device)
    emb = _transform_eigen_matrix(eig_vecs)
    # scale_obs: each observation to unit norm before k-means
    emb = emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=1,
                                                         keepdim=True), 1e-30)
    labels, inertia = cluster_solver.solve(emb)
    return labels, eig_vals, eig_vecs, inertia


def _one_hot(labels: torch.Tensor, k: int, dtype) -> torch.Tensor:
    return (labels[:, None] == torch.arange(k, dtype=labels.dtype,
                                            device=labels.device)).to(dtype)


def _labels(labels, adj: CSR) -> torch.Tensor:
    labels = torch.as_tensor(labels, device=adj.device)
    expects(labels.shape[0] == adj.shape[0],
            "labels must have one entry per vertex")
    return labels


def analyze_partition(adj: CSR, n_clusters: int, labels
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge cut and balanced-cut cost of a partition (reference
    ``analyzePartition``): ``cut(i) = u_iᵀ L u_i`` for cluster i's
    indicator, ``cost = Σ cut(i)/|V_i|``, ``edge_cut = Σ cut(i)/2``;
    empty clusters add nothing.  Returns (edge_cut, cost)."""
    labels = _labels(labels, adj)
    deg = degrees(adj)
    U = _one_hot(labels, n_clusters, adj.data.dtype)      # (n, k)
    LU = deg[:, None] * U - spmm(adj, U)                  # one SpMM
    cut = torch.sum(U * LU, dim=0)                        # (k,) uᵀLu
    size = torch.sum(U, dim=0)
    nonempty = size > 0
    cost = torch.sum(torch.where(nonempty,
                                 cut / torch.clamp_min(size, 1), 0.0))
    edge_cut = torch.sum(torch.where(nonempty, cut, 0.0)) / 2
    return edge_cut, cost


def analyze_modularity(adj: CSR, n_clusters: int, labels) -> torch.Tensor:
    """Modularity Q = (1/2m) Σ_i u_iᵀ B u_i of a clustering (reference
    ``analyzeModularity``)."""
    labels = _labels(labels, adj)
    deg = degrees(adj)
    edge_sum = torch.sum(deg)
    U = _one_hot(labels, n_clusters, adj.data.dtype)
    BU = spmm(adj, U) - deg[:, None] * (deg @ U)[None, :] / torch.clamp_min(
        edge_sum, 1e-30)
    return torch.sum(U * BU) / torch.clamp_min(edge_sum, 1e-30)
