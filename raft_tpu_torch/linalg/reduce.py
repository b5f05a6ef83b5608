"""Reductions: the general reduce, norms, map-reduce and the keyed sums
(port of ``raft_tpu/linalg/reduce.py``; reference raft/linalg/{reduce,
coalesced_reduction,strided_reduction,map_then_reduce,map_reduce,
mean_squared_error,norm,normalize,reduce_rows_by_key,
reduce_cols_by_key}.cuh).  As in the JAX package, the coalesced and the
strided reduction are one implementation under two names.  Tensors stay
where they are."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.linalg.types import Apply, NormType

#: above this key count a dense one-hot is the bandwidth problem
ONE_HOT_MAX_KEYS = 4096


def _identity(x):
    return x


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """float32 sums for half inputs (the JAX package's ``_acc_dtype``)."""
    return torch.float32 if dt in (torch.bfloat16, torch.float16) else dt


def use_one_hot_engine(n_keys: int, device) -> bool:
    """The JAX package's rule for a keyed sum: a one-hot product on an
    accelerator up to ``ONE_HOT_MAX_KEYS`` keys, a scatter on the CPU.
    The port's keyed sums choose for themselves and do not read it:
    :func:`reduce_cols_by_key` is a one-hot product at any key count (one
    fixed sum order on the card), :func:`reduce_rows_by_key` an
    ``index_add_``."""
    return torch.device(device).type != "cpu" and n_keys <= ONE_HOT_MAX_KEYS


def one_hot_by_key(keys: torch.Tensor, n_keys: int, dtype: torch.dtype,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense (..., n_keys) one-hot of *keys*; key ``n_keys`` yields an
    all-zero row (the discard slot for padding rows).  *weights* scales
    each row."""
    ar = torch.arange(n_keys, device=keys.device, dtype=keys.dtype)
    oh = (keys[..., None] == ar).to(dtype)
    if weights is not None:
        oh = oh * weights[..., None].to(dtype)
    return oh


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{i: ids[i]==s} data[i]``.  Ids outside
    ``[0, num_segments)`` go to a discard slot past the end and are
    dropped (the JAX scatter semantics), with no read back to the host.
    On the CPU the sum runs in row order."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def reduce_rows_by_key(data: torch.Tensor, keys: torch.Tensor,
                       n_unique_keys: int,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[k, :] = Σ_{i: keys[i]==k} w_i · data[i, :]``."""
    vals = data if weights is None else data * weights[:, None]
    return segment_sum(vals, keys, n_unique_keys)


def reduce_cols_by_key(data: torch.Tensor, keys: torch.Tensor,
                       n_unique_keys: int) -> torch.Tensor:
    """``out[i, k] = Σ_{j: keys[j]==k} data[i, j]`` (reference
    linalg/reduce_cols_by_key.cuh), as ``data @ one_hot(keys)``: a product
    adds each output in a fixed order on the card, where an indexed add
    would take its atomics' order.  Half inputs sum in float32 and come
    back in their own type."""
    acc = _acc_dtype(data.dtype)
    oh = one_hot_by_key(keys, n_unique_keys, acc)
    return (data.to(acc) @ oh).to(data.dtype)


def _fold(x: torch.Tensor, op: Callable) -> torch.Tensor:
    """Fold *op* over axis 0 as a balanced tree: log2(n) launches where a
    loop over the rows would take n.  *op* must be associative, as the
    JAX package's ``associative_scan`` fold requires too."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        top = op(x[:h], x[h:2 * h])
        x = torch.cat([top, x[2 * h:]]) if x.shape[0] % 2 else top
    return x[0]


def reduce(data: torch.Tensor, apply: Apply = Apply.ALONG_COLUMNS,
           init=None, main_op: Callable = _identity,
           reduce_op: Callable = torch.add, final_op: Callable = _identity,
           inplace_add=None) -> torch.Tensor:
    """General row or column reduction (reference linalg/reduce.cuh:50):
    ``out = final_op(fold(reduce_op, main_op(x)) ⊕ init)``, plus
    *inplace_add* when given.  ALONG_COLUMNS gives one value per row,
    ALONG_ROWS one per column.  ``torch.add`` / ``torch.minimum`` /
    ``torch.maximum`` reduce in one call; any other associative *op*
    folds as a tree.  *init* is folded in only when given (an additive
    default would clamp a min or max).  Sums of half inputs run in float32
    and come back in the input type."""
    axis = 1 if apply == Apply.ALONG_COLUMNS else 0
    mapped = main_op(data)
    if reduce_op is torch.add:
        acc = torch.sum(mapped, dim=axis,
                        dtype=_acc_dtype(mapped.dtype)).to(mapped.dtype)
    elif reduce_op is torch.minimum:
        acc = torch.amin(mapped, dim=axis)
    elif reduce_op is torch.maximum:
        acc = torch.amax(mapped, dim=axis)
    else:
        acc = _fold(torch.movedim(mapped, axis, 0), reduce_op)
    if init is not None:
        acc = reduce_op(acc, torch.as_tensor(init, dtype=acc.dtype,
                                             device=acc.device))
    out = final_op(acc)
    if inplace_add is not None:
        out = out + inplace_add
    return out


def coalesced_reduction(data, init=None, main_op=_identity,
                        reduce_op=torch.add, final_op=_identity):
    """Reduce along the contiguous (last) dimension (reference
    linalg/coalesced_reduction.cuh)."""
    return reduce(data, Apply.ALONG_COLUMNS, init, main_op, reduce_op,
                  final_op)


def strided_reduction(data, init=None, main_op=_identity,
                      reduce_op=torch.add, final_op=_identity):
    """Reduce along the strided (first) dimension (reference
    linalg/strided_reduction.cuh)."""
    return reduce(data, Apply.ALONG_ROWS, init, main_op, reduce_op,
                  final_op)


def map_then_reduce(op: Callable, *arrays, neutral=0.0,
                    reduce_op: Callable = torch.add) -> torch.Tensor:
    """Map, then reduce everything to a scalar (reference
    linalg/map_then_reduce.cuh ``mapThenReduce`` / ``mapThenSumReduce``).
    *neutral* is accepted for the reference's signature; the fold needs
    none."""
    mapped = op(*arrays)
    if reduce_op is torch.add:
        return torch.sum(mapped)
    return _fold(mapped.reshape(-1), reduce_op)


def map_reduce(op: Callable, reduce_op: Callable, *arrays, neutral=0.0):
    """Reference linalg/map_reduce.cuh."""
    return map_then_reduce(op, *arrays, neutral=neutral, reduce_op=reduce_op)


def mean_squared_error(a, b, weight=1.0) -> torch.Tensor:
    """Weighted mean of (a − b)² (reference
    linalg/mean_squared_error.cuh)."""
    d = a - b
    return torch.mean(d * d) * weight


def _norm(data, norm_type: NormType, axis: int, keepdim: bool = False):
    if norm_type == NormType.L1Norm:
        return torch.sum(torch.abs(data), dim=axis, keepdim=keepdim)
    if norm_type == NormType.L2Norm:
        return torch.sum(data * data, dim=axis, keepdim=keepdim)
    return torch.amax(torch.abs(data), dim=axis, keepdim=keepdim)


def norm(data, norm_type: NormType = NormType.L2Norm,
         apply: Apply = Apply.ALONG_COLUMNS, final_op=_identity):
    """Row or column norms (reference linalg/norm.cuh ``rowNorm`` /
    ``colNorm``).  RAFT's L2 "norm" is the sum of squares unless a square
    root is passed as *final_op*."""
    return final_op(_norm(data, norm_type,
                          1 if apply == Apply.ALONG_COLUMNS else 0))


def row_norm(data, norm_type: NormType = NormType.L2Norm, final_op=_identity):
    return norm(data, norm_type, Apply.ALONG_COLUMNS, final_op)


def col_norm(data, norm_type: NormType = NormType.L2Norm, final_op=_identity):
    return norm(data, norm_type, Apply.ALONG_ROWS, final_op)


def normalize(data, norm_type: NormType = NormType.L2Norm, eps: float = 1e-8,
              apply: Apply = Apply.ALONG_COLUMNS):
    """Scale each row (each column with ALONG_ROWS) to unit norm, the L2
    norm being the root of the sum of squares here; a row whose norm is
    at most *eps* is left as it is (reference linalg/normalize.cuh
    ``row_normalize``)."""
    n = _norm(data, norm_type, 1 if apply == Apply.ALONG_COLUMNS else 0,
              keepdim=True)
    if norm_type == NormType.L2Norm:
        n = torch.sqrt(n)
    return torch.where(n > eps, data / torch.clamp_min(n, eps), data)
