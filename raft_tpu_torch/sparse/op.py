"""Structural sparse ops: sort, filter, dedupe, slice, row op (port of
``raft_tpu/sparse/op.py``; reference ``sparse/op/`` — ``sort.h``,
``filter.hpp``, ``reduce.cuh``, ``slice.hpp``, ``row_op.cuh``).

Filters compact within the fixed capacity and update ``nnz`` instead of
shrinking buffers, so nothing here reads a count on the host.  Sorts are
stable (``torch.sort(stable=True)``): the same keys give the JAX
package's permutation exactly.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.types import COO, CSR


def _identity(dtype: torch.dtype, reduce: str):
    if dtype.is_floating_point:
        return float("inf") if reduce == "amin" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reduce == "amin" else info.min


def segment_reduce(data: torch.Tensor, ids: torch.Tensor, n: int,
                   reduce: str = "sum") -> torch.Tensor:
    """``out[s] = reduce_{i: ids[i] == s} data[i]`` over the first axis
    for ``reduce`` in ``sum`` / ``amax`` / ``amin``; ids outside [0, n)
    are dropped (the JAX segment ops' semantics the padding relies on)
    without a host read; an empty segment holds 0 (sum) or the reduction's
    identity (±inf, the integer limits), as ``jax.ops.segment_*``."""
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    shape = (n + 1,) + tuple(data.shape[1:])
    if reduce == "sum":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device)
        # exempt(raw-segment-sum): the sparse segment op's own sum
        return out.index_add_(0, ids, data)[:n]
    out = torch.full(shape, _identity(data.dtype, reduce), dtype=data.dtype,
                     device=data.device)
    if data.ndim > 1:
        ids = ids.view((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return out.scatter_reduce_(0, ids, data, reduce, include_self=False)[:n]


def stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _compact(coo: COO, keep) -> COO:
    """Stable-compact the entries where *keep* holds; repad the tail."""
    keep = keep & coo.mask()
    nnz = keep.sum(dtype=torch.int32)
    order = stable_argsort((~keep).to(torch.uint8))
    live = torch.arange(coo.capacity, device=coo.device) < nnz
    zero = torch.zeros((), dtype=coo.vals.dtype, device=coo.device)
    return COO(torch.where(live, coo.rows[order], coo.shape[0]),
               torch.where(live, coo.cols[order], 0),
               torch.where(live, coo.vals[order], zero), coo.shape, nnz=nnz)


def coo_sort(coo: COO) -> COO:
    """Sort entries by (row, col) (reference sparse/op/sort.h
    ``coo_sort``); padding (row == n_rows) sorts to the tail.  Two stable
    passes, cols then rows, as the JAX package."""
    order = stable_argsort(coo.cols)
    order = order[stable_argsort(coo.rows[order])]
    return COO(coo.rows[order], coo.cols[order], coo.vals[order], coo.shape,
               nnz=coo.nnz)


def coo_remove_scalar(coo: COO, scalar) -> COO:
    """Drop entries equal to *scalar* (reference sparse/op/filter.hpp
    ``coo_remove_scalar``)."""
    return _compact(coo, coo.vals != scalar)


def coo_remove_zeros(coo: COO) -> COO:
    """Drop explicit zeros (reference ``coo_remove_zeros``)."""
    return coo_remove_scalar(coo, 0)


def coo_sum_duplicates(coo: COO) -> COO:
    """Sum duplicate (row, col) entries; the output is sorted by (row,
    col)."""
    return _coo_combine_duplicates(coo, "sum")


def coo_max_duplicates(coo: COO) -> COO:
    """Keep the max over duplicate coordinates (reference
    sparse/op/reduce.cuh ``max_duplicates``)."""
    return _coo_combine_duplicates(coo, "max")


def _coo_combine_duplicates(coo: COO, combine: str) -> COO:
    s = coo_sort(coo)
    live = s.mask()
    cap = s.capacity
    dev = s.device
    first = torch.ones((1,), dtype=torch.bool, device=dev)
    is_new = torch.cat([first, (s.rows[1:] != s.rows[:-1])
                        | (s.cols[1:] != s.cols[:-1])]) & live
    group = torch.cumsum(is_new, 0) - 1  # padding → dropped below
    group = torch.where(live, group, cap)
    n_groups = is_new.sum(dtype=torch.int32)
    reduce = {"sum": "sum", "max": "amax", "min": "amin"}[combine]
    vals = segment_reduce(s.vals, group, cap, reduce)
    # first-occurrence coordinates per group (all duplicates share them)
    rows = segment_reduce(s.rows, group, cap, "amin")
    cols = segment_reduce(s.cols, group, cap, "amin")
    out_live = torch.arange(cap, device=dev) < n_groups
    zero = torch.zeros((), dtype=s.vals.dtype, device=dev)
    return COO(torch.where(out_live, rows, s.shape[0]),
               torch.where(out_live, cols, 0),
               torch.where(out_live, vals, zero), s.shape, nnz=n_groups)


def csr_row_slice(csr: CSR, start: int, stop: int) -> CSR:
    """Rows [start, stop) as a new CSR (reference sparse/op/slice.hpp
    ``csr_row_slice_indptr`` / ``_populate``); the capacity is kept and
    the entries shifted to the front."""
    start, stop = int(start), int(stop)
    lo, hi = csr.indptr[start], csr.indptr[stop]
    nnz = hi - lo
    idx = torch.arange(csr.capacity, device=csr.device)
    src = torch.clamp(idx + lo, 0, csr.capacity - 1)
    live = idx < nnz
    indptr = torch.minimum(torch.clamp_min(csr.indptr[start:stop + 1] - lo,
                                           0), nnz)
    zero = torch.zeros((), dtype=csr.data.dtype, device=csr.device)
    return CSR(indptr, torch.where(live, csr.indices[src], 0),
               torch.where(live, csr.data[src], zero),
               (stop - start, csr.shape[1]))


def csr_row_op(csr: CSR, fn) -> CSR:
    """Apply ``fn(row_id, values) -> values`` with each entry's row id at
    hand (reference sparse/op/row_op.cuh ``csr_row_op``)."""
    new = fn(csr.row_ids(), csr.data)
    new = torch.where(csr.mask(), new,
                      torch.zeros((), dtype=new.dtype, device=new.device))
    return CSR(csr.indptr, csr.indices, new, csr.shape)
