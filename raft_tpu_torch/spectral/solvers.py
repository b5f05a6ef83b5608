"""Pluggable eigen and cluster solvers of the spectral pipelines (port of
``raft_tpu/spectral/solvers.py``; reference
``spectral/eigen_solvers.cuh:45`` ``lanczos_solver_t`` and
``spectral/cluster_solvers.cuh:43`` ``kmeans_solver_t``).  The configs
keep the reference's field names."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster import InitMethod, KMeansParams, fit_predict


@dataclasses.dataclass
class EigenSolverConfig:
    """Reference ``eigen_solver_config_t`` (spectral/eigen_solvers.cuh:28)."""

    n_eigVecs: int
    maxIter: int = 15          # restart rounds (reference maxIter_lanczos)
    restartIter: int = 0       # Krylov size m (0: the solver's own sizing)
    tol: float = 1e-6
    reorthogonalize: bool = True  # always on (full reorthogonalisation)
    seed: int = 1234567


class LanczosEigenSolver:
    """Reference ``lanczos_solver_t``: the solves take a
    :class:`~raft_tpu_torch.sparse.types.CSR` or a ``matvec`` callable
    (the implicit Laplacian and modularity operators) with *n* and the
    *device* it runs on."""

    def __init__(self, config: EigenSolverConfig):
        self.config = config

    def _kwargs(self):
        c = self.config
        return dict(ncv=(c.restartIter or None), max_restarts=c.maxIter,
                    tol=c.tol, seed=c.seed)

    def solve_smallest_eigenvectors(self, a, n: Optional[int] = None,
                                    dtype=torch.float32, device=None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        from raft_tpu_torch.sparse.solver import lanczos_smallest

        return lanczos_smallest(a, self.config.n_eigVecs, n=n, dtype=dtype,
                                device=device, **self._kwargs())

    def solve_largest_eigenvectors(self, a, n: Optional[int] = None,
                                   dtype=torch.float32, device=None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        from raft_tpu_torch.sparse.solver import lanczos_largest

        return lanczos_largest(a, self.config.n_eigVecs, n=n, dtype=dtype,
                               device=device, **self._kwargs())


@dataclasses.dataclass
class ClusterSolverConfig:
    """Reference ``cluster_solver_config_t`` (spectral/cluster_solvers.cuh:30)."""

    n_clusters: int
    maxIter: int = 100
    tol: float = 1e-4
    seed: int = 123456


class KMeansClusterSolver:
    """Reference ``kmeans_solver_t``: k-means (k-means++ init, the port's
    k-means‖) on the (n, n_eigVecs) spectral embedding, through
    :func:`raft_tpu_torch.cluster.fit_predict` (kernels B1 and B3 on the
    card)."""

    def __init__(self, config: ClusterSolverConfig):
        self.config = config

    def solve(self, embedding: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(labels (n,), inertia)."""
        c = self.config
        params = KMeansParams(n_clusters=c.n_clusters, max_iter=c.maxIter,
                              tol=c.tol, seed=c.seed,
                              init=InitMethod.KMeansPlusPlus)
        out = fit_predict(params, embedding)
        return out.labels, out.inertia
