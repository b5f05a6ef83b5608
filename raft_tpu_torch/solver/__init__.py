"""Combinatorial solvers (port of ``raft_tpu/solver``; reference
raft/solver/): the batched linear assignment problem."""

from raft_tpu_torch.solver.linear_assignment import (LAPResult,
                                                     LinearAssignmentProblem,
                                                     solve_lap)

__all__ = ["LAPResult", "LinearAssignmentProblem", "solve_lap"]
