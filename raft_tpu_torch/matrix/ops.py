"""Matrix manipulation primitives (port of ``raft_tpu/matrix/ops.py``;
reference raft/matrix/{argmax,argmin,col_wise_sort,copy,diagonal,gather,
init,linewise_op,math,norm,print,reciprocal,reverse,slice,sqrt,threshold,
triangular}.cuh).  Each is one or a few PyTorch operations.  Tensors stay
where they are; the initialisers (:func:`eye`, :func:`fill`) make theirs
on *device* (``None``: the card).  Functions that set entries return a
new tensor and leave their input as it was, as the JAX package's do."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device


def argmax(mat, axis: int = 1):
    """Per-row argmax (reference matrix/argmax.cuh); the first of tied
    maxima."""
    return torch.argmax(mat, dim=axis)


def argmin(mat, axis: int = 1):
    """Per-row argmin (reference matrix/argmin.cuh); the first of tied
    minima."""
    return torch.argmin(mat, dim=axis)


def col_wise_sort(mat, return_indices: bool = False):
    """Sort each column, ties in row order (reference
    matrix/col_wise_sort.cuh)."""
    vals, idx = torch.sort(mat, dim=0, stable=True)
    return (vals, idx) if return_indices else vals


def copy(mat):
    """Reference matrix/copy.cuh."""
    return mat.clone()


def truncate_rows(mat, n_rows: int):
    """The first *n_rows* rows (reference ``trunc_zero_origin``)."""
    return mat[:n_rows]


def diagonal(mat):
    """The main diagonal (reference matrix/diagonal.cuh ``get_diagonal``)."""
    return torch.diagonal(mat).clone()


def set_diagonal(mat, vec):
    """A copy of *mat* with *vec* on its main diagonal (reference
    ``set_diagonal``)."""
    out = mat.clone()
    n = min(out.shape)
    vec = torch.as_tensor(vec, dtype=out.dtype, device=out.device)
    torch.diagonal(out)[:] = vec[:n]
    return out


def matrix_diagonal_inverse(mat):
    """A copy of *mat* with its diagonal entries inverted (reference
    ``invert_diagonal``)."""
    out = mat.clone()
    d = torch.diagonal(out)
    d[:] = 1.0 / d
    return out


def eye(n_rows: int, n_cols: Optional[int] = None,
        dtype: torch.dtype = torch.float32, *, device=None):
    """Identity (reference matrix/init.cuh)."""
    return torch.eye(n_rows, n_rows if n_cols is None else n_cols,
                     dtype=dtype, device=resolve_device(device))


def fill(shape, value, dtype: torch.dtype = torch.float32, *, device=None):
    """A constant matrix (reference matrix/init.cuh ``fill``)."""
    return torch.full(tuple(shape) if not isinstance(shape, int)
                      else (shape,), value, dtype=dtype,
                      device=resolve_device(device))


def gather(mat, row_indices):
    """``out[i, :] = mat[map[i], :]`` (reference matrix/gather.cuh)."""
    return torch.index_select(mat, 0, row_indices.long())


def gather_if(mat, row_indices, stencil, pred: Callable, fallback=0.0):
    """Conditional row gather (reference ``gather_if``): rows whose stencil
    fails *pred* are filled with *fallback*."""
    out = gather(mat, row_indices)
    keep = pred(stencil)
    return torch.where(keep[:, None], out,
                       torch.as_tensor(fallback, dtype=out.dtype,
                                       device=out.device))


def linewise_op(mat, vecs, op: Callable, along_lines: bool = True):
    """``op(mat_element, vec_element, ...)`` broadcast along rows or columns
    (reference matrix/linewise_op.cuh:60); ``along_lines=True`` matches
    ``vec[j]`` to the columns (length n_cols)."""
    if not isinstance(vecs, (tuple, list)):
        vecs = (vecs,)
    shaped = [v[None, :] if along_lines else v[:, None] for v in vecs]
    return op(mat, *shaped)


def power(mat, scalar=None):
    """Element-wise square, times *scalar* when given (reference
    matrix/math.cuh ``power``)."""
    out = mat * mat
    return out if scalar is None else out * scalar


def seq_root(mat, scalar=None, set_neg_zero: bool = False):
    """Element-wise square root of *mat* (times *scalar*), negatives first
    set to 0 with *set_neg_zero* (reference matrix/math.cuh ``seqRoot``)."""
    x = mat if scalar is None else mat * scalar
    if set_neg_zero:
        x = torch.clamp_min(x, 0)
    return torch.sqrt(x)


sqrt = seq_root


def ratio(mat):
    """Divide by the sum of all entries (reference matrix/math.cuh
    ``ratio``)."""
    return mat / torch.sum(mat)


def weighted_ratio(mat, weights):
    return mat / torch.sum(mat * weights)


def reciprocal(mat, scalar=1.0, set_zero: bool = True, thres: float = 1e-15):
    """Element-wise scalar / x; with *set_zero*, entries of magnitude at
    most *thres* give 0 (reference matrix/reciprocal.cuh)."""
    if set_zero:
        big = torch.abs(mat) > thres
        safe = torch.where(big, mat, torch.ones_like(mat))
        return torch.where(big, scalar / safe, torch.zeros_like(safe))
    return scalar / mat


def reverse(mat, axis: int = 0):
    """Reverse the rows or the columns (reference matrix/reverse.cuh)."""
    return torch.flip(mat, (axis,))


def sign_flip(mat):
    """Flip each column's sign so that its entry of largest magnitude (the
    first of ties) is positive — a deterministic orientation of
    eigenvectors (reference matrix/math.cuh ``signFlip``)."""
    idx = torch.argmax(torch.abs(mat), dim=0)
    signs = torch.sign(mat[idx, torch.arange(mat.shape[1],
                                             device=mat.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return mat * signs[None, :]


def slice_matrix(mat, x1: int, y1: int, x2: int, y2: int):
    """The submatrix [x1:x2, y1:y2] (reference matrix/slice.cuh)."""
    expects(0 <= x1 < x2 <= mat.shape[0] and 0 <= y1 < y2 <= mat.shape[1],
            "slice bounds out of range")
    return mat[x1:x2, y1:y2]


def sq_norm(mat):
    """Sum of squares, the squared Frobenius norm (reference
    matrix/norm.cuh ``l2_norm``, which returns the sum of squares)."""
    return torch.sum(mat * mat)


def threshold(mat, value: float):
    """Set entries of magnitude under *value* to 0 (reference
    matrix/threshold.cuh ``zero_small_values``)."""
    return torch.where(torch.abs(mat) < value, torch.zeros_like(mat), mat)


zero_small_values = threshold


def upper_triangular(mat):
    """The upper triangle (reference matrix/triangular.cuh)."""
    return torch.triu(mat)


def print_matrix(mat, name: str = "", h_separator: str = " ",
                 v_separator: str = "\n") -> str:
    """Print *mat* (reference matrix/print.cuh) and return the text."""
    arr = (mat.detach().cpu().numpy() if isinstance(mat, torch.Tensor)
           else np.asarray(mat))
    body = v_separator.join(h_separator.join(f"{v:g}" for v in row)
                            for row in np.atleast_2d(arr))
    text = f"{name}\n{body}" if name else body
    print(text)
    return text
