"""Epsilon neighbourhood: boolean adjacency within a radius (port of
``raft_tpu/neighbors/epsilon_neighborhood.py``; reference
neighbors/epsilon_neighborhood.cuh ``epsUnexpL2SqNeighborhood``): for each
(x_i, y_j) pair, adjacency ``‖x_i − y_j‖² ≤ eps`` plus per-row vertex
degrees — the DBSCAN building block.

The rows of *x* go in batches of ``batch_size`` through the port's
``pairwise.distance(…, L2Expanded)``, whose products run in fixed
1,024-row blocks, so a row's adjacency is the same in any batch.  *eps*
is rounded to the inputs' type first, as the JAX package does, so
bfloat16 inputs compare against a bfloat16 ε (their distances are
float32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import as_float_tensor, distance


def eps_neighbors_l2sq(x, y, eps: float, *, batch_size: int = 8192,
                       device=None, engine: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adjacency of squared-L2 balls: ``adj[i, j] = ‖x_i − y_j‖² ≤ eps``.
    Returns (adj (m, n) bool, vd (m,) int32 row degrees) on the inputs'
    device (a tensor stays where it is; an array goes to *device*,
    default the card).  *eps* is the squared radius, as in the
    reference."""
    x = (x if isinstance(x, torch.Tensor)
         else as_float_tensor(x, resolve_device(device)))
    y = as_float_tensor(y, x.device)
    expects(x.ndim == 2 and y.ndim == 2, "inputs must be 2-d")
    expects(x.shape[1] == y.shape[1], "feature dim mismatch")
    eps = float(torch.tensor(eps, dtype=x.dtype))
    adj, vd = [], []
    for i0 in range(0, x.shape[0], batch_size):
        a = distance(x[i0:i0 + batch_size], y, DistanceType.L2Expanded,
                     2.0, engine) <= eps
        adj.append(a)
        vd.append(torch.sum(a, dim=1, dtype=torch.int32))
    if len(adj) == 1:
        return adj[0], vd[0]
    if not adj:
        return (torch.zeros((0, y.shape[0]), dtype=torch.bool,
                            device=x.device),
                torch.zeros(0, dtype=torch.int32, device=x.device))
    return torch.cat(adj), torch.cat(vd)


def eps_neighbors(x, y, eps: float, **kw) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Radius (not squared) convenience wrapper."""
    return eps_neighbors_l2sq(x, y, float(eps) ** 2, **kw)
