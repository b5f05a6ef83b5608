"""Format conversions: coo ↔ csr ↔ dense, adjacency → csr (port of
``raft_tpu/sparse/convert.py``; reference ``sparse/convert/`` —
``coo.cuh``, ``csr.cuh``, ``dense.cuh``, ``detail/adj_to_csr.cuh``).

Capacities are static; the dense → sparse direction takes an explicit
``capacity``.  :func:`from_triplets` canonicalises on the host in the
native runtime (``rt_coo_canonicalize``) and raises when the runtime
cannot be built: there is no quiet numpy fallback.
:func:`canonicalize_numpy` is the plain twin the tests hold it against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.sparse.op import segment_reduce, stable_argsort
from raft_tpu_torch.sparse.types import COO, CSR


def canonicalize_numpy(rows, cols, vals, shape
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The numpy twin of ``native.coo_canonicalize``: sort by (row, col),
    sum duplicates, drop explicit zeros (the JAX package's fallback,
    ``raft_tpu/sparse/convert.py`` :46-55)."""
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    order = np.lexsort((cols, rows))
    r, c, v0 = rows[order], cols[order], vals[order]
    key = r.astype(np.int64) * shape[1] + c
    uniq, inv = np.unique(key, return_inverse=True)
    v = np.zeros(len(uniq), vals.dtype)
    np.add.at(v, inv, v0)
    r = (uniq // shape[1]).astype(np.int32)
    c = (uniq % shape[1]).astype(np.int32)
    keep = v != 0
    return r[keep], c[keep], v[keep]


def from_triplets(rows, cols, vals, shape, device=None) -> CSR:
    """A CSR from raw host (row, col, value) triplets: sorted by (row,
    col), duplicates summed, explicit zeros dropped — in the native
    runtime (``rt_coo_canonicalize``, sums in float64) — then moved to
    *device* (``None``: the card).  Floating values keep their type;
    integer values become float32."""
    dev = resolve_device(device)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    expects(rows.shape == cols.shape == vals.shape,
            "from_triplets: rows/cols/vals must be the same length")
    r, c, v = native.coo_canonicalize(rows, cols, vals)
    v = v.astype(vals.dtype if np.issubdtype(vals.dtype, np.floating)
                 else np.float32)
    return coo_to_csr(COO(torch.from_numpy(r), torch.from_numpy(c),
                          torch.from_numpy(v), tuple(shape), device=dev))


def coo_to_csr(coo: COO) -> CSR:
    """Row-sorted COO → CSR (reference sparse/convert/csr.cuh
    ``sorted_coo_to_csr``; sort with :func:`~.op.coo_sort` first)."""
    n_rows = coo.shape[0]
    live = coo.mask()
    ones = torch.ones(coo.capacity, dtype=torch.int32, device=coo.device)
    counts = segment_reduce(ones, torch.where(live, coo.rows, n_rows),
                            n_rows)
    indptr = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                    device=coo.device),
                        torch.cumsum(counts, 0).to(torch.int32)])
    zero = torch.zeros((), dtype=coo.vals.dtype, device=coo.device)
    return CSR(indptr, torch.where(live, coo.cols, 0),
               torch.where(live, coo.vals, zero), coo.shape)


def csr_to_coo(csr: CSR) -> COO:
    """CSR → COO (reference sparse/convert/coo.cuh ``csr_to_coo``)."""
    live = csr.mask()
    zero = torch.zeros((), dtype=csr.data.dtype, device=csr.device)
    return COO(torch.where(live, csr.row_ids(), csr.shape[0]),
               torch.where(live, csr.indices, 0),
               torch.where(live, csr.data, zero), csr.shape, nnz=csr.nnz)


def coo_to_dense(coo: COO) -> torch.Tensor:
    """COO → dense; padding (row == n_rows) falls into a dropped row."""
    m, n = coo.shape
    out = torch.zeros((m + 1) * n, dtype=coo.vals.dtype, device=coo.device)
    rows = torch.clamp(coo.rows.long(), 0, m)
    # exempt(raw-segment-sum): densify: COO values scattered into a dense matrix
    out.index_add_(0, rows * n + coo.cols.long(), coo.vals)
    return out.view(m + 1, n)[:m]


def csr_to_dense(csr: CSR) -> torch.Tensor:
    """CSR → dense (reference sparse/convert/dense.cuh ``csr_to_dense``)."""
    return coo_to_dense(csr_to_coo(csr))


def dense_to_coo(x, capacity: Optional[int] = None, device=None) -> COO:
    """Dense → COO in row-major order with zeros compacted out.
    ``capacity`` defaults to m·n; entries past it are truncated (the
    reference's preallocated-output contract) and ``nnz`` reports what
    survived."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=resolve_device(device))
    m, n = x.shape
    cap = min(int(capacity), m * n) if capacity is not None else m * n
    flat = x.reshape(-1)
    nonzero = flat != 0
    nnz = torch.clamp_max(nonzero.sum(dtype=torch.int32), cap)
    order = stable_argsort((~nonzero).to(torch.uint8))[:cap]
    live = torch.arange(cap, device=x.device) < nnz
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return COO(torch.where(live, order // n, m),
               torch.where(live, order % n, 0),
               torch.where(live, flat[order], zero), (m, n), nnz=nnz)


def dense_to_csr(x, capacity: Optional[int] = None, device=None) -> CSR:
    """Dense → CSR (reference sparse/convert/csr.cuh ``dense_to_csr``)."""
    return coo_to_csr(dense_to_coo(x, capacity, device))


def adj_to_csr(adj, capacity: Optional[int] = None, device=None) -> CSR:
    """Boolean (or integer) adjacency matrix → CSR with unit weights
    (reference sparse/convert/detail/adj_to_csr.cuh)."""
    adj = adj if isinstance(adj, torch.Tensor) else torch.as_tensor(
        adj, device=resolve_device(device))
    expects(adj.dtype == torch.bool or not adj.dtype.is_floating_point,
            "adj_to_csr expects a boolean/integer adjacency matrix")
    return dense_to_csr(adj.float(), capacity)
