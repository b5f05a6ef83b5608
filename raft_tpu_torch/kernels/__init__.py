"""Hand-written CUDA kernels for Hopper and their wrappers.

The sources live in ``csrc/``; :mod:`raft_tpu_torch.kernels.native` builds
them at first use.  Importing this package builds nothing."""

from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.kernels.native import LAUNCHES, reset_launches

__all__ = ["resolve_engine", "LAUNCHES", "reset_launches"]
