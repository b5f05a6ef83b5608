"""Broadcast a vector operation across matrix rows or columns (port of
``raft_tpu/linalg/matrix_vector.py``; reference
raft/linalg/matrix_vector_op.cuh and matrix_vector.cuh).

``bcast_along_rows=True`` means the vector has one entry per column (it is
broadcast along the rows, length n_cols); False means one entry per row.
"""

from __future__ import annotations

from typing import Callable

import torch


def _shape_vec(vec, bcast_along_rows: bool):
    return vec[None, :] if bcast_along_rows else vec[:, None]


def matrix_vector_op(mat, vec, op: Callable, bcast_along_rows: bool = True):
    """``out[i, j] = op(mat[i, j], vec[j or i])``."""
    return op(mat, _shape_vec(vec, bcast_along_rows))


def matrix_vector_op2(mat, vec1, vec2, op: Callable,
                      bcast_along_rows: bool = True):
    """The two-vector form (reference matrix_vector_op.cuh overload)."""
    return op(mat, _shape_vec(vec1, bcast_along_rows),
              _shape_vec(vec2, bcast_along_rows))


def binary_mult(mat, vec, bcast_along_rows: bool = True):
    return mat * _shape_vec(vec, bcast_along_rows)


def binary_div(mat, vec, bcast_along_rows: bool = True):
    return mat / _shape_vec(vec, bcast_along_rows)


def binary_div_skip_zero(mat, vec, bcast_along_rows: bool = True,
                         return_zero: bool = False):
    """Divide, leaving each entry whose divisor is exactly 0 as it was (or
    0 with *return_zero*) — the zero rule of the reference's
    ``binary_div_skip_zero`` as the JAX package states it."""
    v = _shape_vec(vec, bcast_along_rows)
    nz = v != 0
    out = mat / torch.where(nz, v, torch.ones_like(v))
    if return_zero:
        return torch.where(nz, out, torch.zeros_like(out))
    return torch.where(nz, out, mat)


def binary_add(mat, vec, bcast_along_rows: bool = True):
    return mat + _shape_vec(vec, bcast_along_rows)


def binary_sub(mat, vec, bcast_along_rows: bool = True):
    return mat - _shape_vec(vec, bcast_along_rows)
