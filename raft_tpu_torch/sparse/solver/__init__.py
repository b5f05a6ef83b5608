"""Sparse solvers: the restarted Lanczos eigensolver and Borůvka's MST
(port of ``raft_tpu/sparse/solver``; reference raft/sparse/solver/)."""

from raft_tpu_torch.sparse.solver.lanczos import (lanczos_largest,
                                                  lanczos_smallest)
from raft_tpu_torch.sparse.solver.mst import MSTResult, boruvka_mst

__all__ = ["MSTResult", "boruvka_mst", "lanczos_largest", "lanczos_smallest"]
