"""Implicit spectral operators over a CSR adjacency matrix (port of
``raft_tpu/spectral/matrix.py``; reference
``spectral/matrix_wrappers.hpp:41-45`` — ``sparse_matrix_t`` /
``laplacian_matrix_t`` / ``modularity_matrix_t``, which override ``mv``
so the Lanczos solver sees ``L·x`` or ``B·x`` without L or B being
formed).  Each operator is a plain closure over the ELL operand
(:func:`raft_tpu_torch.sparse.linalg.matvec_operand`); the JAX package
uses a ``jax.tree_util.Partial`` so that its jit cache is shared, which
PyTorch has no use for.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.sparse.linalg import apply_matvec, matvec_operand
from raft_tpu_torch.sparse.op import segment_reduce
from raft_tpu_torch.sparse.types import CSR


def degrees(adj: CSR) -> torch.Tensor:
    """The weighted degrees d_i = Σ_j a_ij."""
    return segment_reduce(adj.data, adj.row_ids(), adj.shape[0])


def laplacian_matvec(adj: CSR) -> Tuple[Callable, torch.Tensor]:
    """The implicit Laplacian ``L·x = D·x − A·x`` (reference
    ``laplacian_matrix_t::mv``): (matvec, degrees)."""
    expects(adj.shape[0] == adj.shape[1], "laplacian: matrix must be square")
    deg = degrees(adj)
    op = matvec_operand(adj)

    def matvec(x):
        return deg * x - apply_matvec(op, x)

    return matvec, deg


def modularity_matvec(adj: CSR
                      ) -> Tuple[Callable, torch.Tensor, torch.Tensor]:
    """The implicit modularity operator ``B·x = A·x − d (dᵀx) / (2m)``
    (reference ``modularity_matrix_t::mv``): (matvec, degrees, edge_sum),
    ``edge_sum = Σ_ij a_ij = 2m``."""
    expects(adj.shape[0] == adj.shape[1], "modularity: matrix must be square")
    deg = degrees(adj)
    edge_sum = torch.sum(deg)  # 2m for an undirected (symmetric) graph
    op = matvec_operand(adj)

    def matvec(x):
        scale = torch.dot(deg, x) / torch.clamp_min(edge_sum, 1e-30)
        return apply_matvec(op, x) - deg * scale

    return matvec, deg, edge_sum
