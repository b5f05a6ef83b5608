"""Spectral graph partitioning and modularity clustering (port of
``raft_tpu/spectral``; reference ``raft/spectral/``): the pluggable
eigen and cluster solvers (``spectral/eigen_solvers.cuh:45``,
``cluster_solvers.cuh:43``), ``partition()``
(``spectral/detail/partition.hpp:65-107``), ``modularity_maximization()``
and the quality metrics ``analyze_partition`` / ``analyze_modularity``.
"""

from raft_tpu_torch.spectral.matrix import (degrees, laplacian_matvec,
                                            modularity_matvec)
from raft_tpu_torch.spectral.partition import (analyze_modularity,
                                               analyze_partition,
                                               modularity_maximization,
                                               partition)
from raft_tpu_torch.spectral.solvers import (ClusterSolverConfig,
                                             EigenSolverConfig,
                                             KMeansClusterSolver,
                                             LanczosEigenSolver)

__all__ = ["degrees", "laplacian_matvec", "modularity_matvec",
           "EigenSolverConfig", "LanczosEigenSolver", "ClusterSolverConfig",
           "KMeansClusterSolver", "partition", "modularity_maximization",
           "analyze_partition", "analyze_modularity"]
