"""Sparse linear algebra: SpMV/SpMM, add, transpose, symmetrize, norms,
Laplacian, weak components (port of ``raft_tpu/sparse/linalg.py``;
reference ``sparse/linalg/`` — ``add.cuh``, ``degree.cuh``, ``norm.cuh``,
``symmetrize.cuh``, ``transpose.cuh``).

The products are a gather at the column indices, a multiply and a segment
sum by row.  Iterative solvers apply one matrix many times: they convert
it once on the host to the ELL hybrid (:func:`csr_to_ell`, the native
runtime's ``rt_csr_to_ell``) and run :func:`ell_spmv` — a gather and a
row sum over the padded block, an indexed add only over the overflow
tail.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.sparse.convert import coo_to_csr, csr_to_coo
from raft_tpu_torch.sparse.op import (_coo_combine_duplicates, coo_sort,
                                      coo_sum_duplicates, segment_reduce)
from raft_tpu_torch.sparse.types import COO, CSR


def spmv(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for CSR A and dense x (n_cols,)."""
    expects(x.shape[0] == csr.shape[1], "spmv: dimension mismatch")
    prod = csr.data * x[csr.indices]
    return segment_reduce(prod, csr.row_ids(), csr.shape[0])


class EllHybrid:
    """Row-padded (ELL) layout plus a COO overflow: ``cols`` / ``vals``
    (n_rows, r) with r about the rows' 95th nnz percentile; the entries of
    a longer row past r sit in ``ov_rows`` / ``ov_cols`` / ``ov_vals``
    (the HYB format cuSPARSE used)."""

    def __init__(self, cols, vals, ov_rows, ov_cols, ov_vals, shape):
        self.cols = cols
        self.vals = vals
        self.ov_rows = ov_rows
        self.ov_cols = ov_cols
        self.ov_vals = ov_vals
        self.shape = tuple(shape)

    @property
    def device(self) -> torch.device:
        return self.cols.device


def ell_width(nnz_row: np.ndarray, quantile: float) -> int:
    """The ELL block's width: the rows' nnz at *quantile*, rounded up to a
    multiple of 8 (at least 8)."""
    r = int(np.percentile(nnz_row, quantile * 100)) if len(nnz_row) else 0
    return max(1, -(-max(r, 1) // 8) * 8)


def csr_to_ell_numpy(indptr, indices, data, r: int):
    """The numpy twin of ``native.csr_to_ell`` (the JAX package's
    fallback, ``raft_tpu/sparse/linalg.py`` :97-107)."""
    indptr = np.asarray(indptr)
    n_rows = indptr.shape[0] - 1
    nnz_row = np.diff(indptr)
    offs = np.arange(r)
    starts = indptr[:-1].astype(np.int64)
    valid = offs[None, :] < nnz_row[:, None]
    take = np.where(valid, starts[:, None] + offs[None, :], 0)
    cols = np.where(valid, indices[take], 0).astype(np.int32)
    vals = np.where(valid, data[take], 0).astype(data.dtype)
    pos = np.arange(len(indices)) - np.repeat(starts, nnz_row)
    ovm = pos >= r
    ov_rows = np.repeat(np.arange(n_rows, dtype=np.int32), nnz_row)[ovm]
    return cols, vals, ov_rows, indices[ovm].astype(np.int32), data[ovm]


def csr_to_ell(csr: CSR, quantile: float = 0.95) -> EllHybrid:
    """CSR → :class:`EllHybrid`, converted on the host by the native
    runtime (a one-time cost; do it outside the solver loop).  Reads the
    CSR on the host and puts the result on its device."""
    dev = csr.device
    indptr = csr.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    n_rows = csr.shape[0]
    if nnz == 0:  # empty matrix: one all-zero column, no overflow
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return EllHybrid(torch.zeros((n_rows, 1), dtype=torch.int32,
                                     device=dev),
                         torch.zeros((n_rows, 1), dtype=csr.dtype,
                                     device=dev),
                         empty, empty,
                         torch.zeros(0, dtype=csr.dtype, device=dev),
                         csr.shape)
    # the static capacity pads indices/data past indptr[-1]: drop it
    indices = csr.indices[:nnz].cpu().numpy()
    data = csr.data[:nnz].cpu().numpy()
    r = ell_width(np.diff(indptr), quantile)
    parts = native.csr_to_ell(indptr, indices, data, r)
    return EllHybrid(*(torch.from_numpy(p).to(dev) for p in parts),
                     csr.shape)


def ell_spmv(ell: EllHybrid, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over :class:`EllHybrid`."""
    y = torch.sum(ell.vals * x[ell.cols], dim=1)
    if ell.ov_rows.shape[0]:
        y = y + segment_reduce(ell.ov_vals * x[ell.ov_cols], ell.ov_rows,
                               ell.shape[0])
    return y


def matvec_operand(csr: CSR) -> EllHybrid:
    """The SpMV operand for :func:`apply_matvec`: the ELL hybrid, always
    (the JAX package keeps the CSR for a traced input, which has no
    counterpart here)."""
    return csr_to_ell(csr)


def apply_matvec(op, v: torch.Tensor) -> torch.Tensor:
    """``A @ v`` for an :class:`EllHybrid` (or a CSR)."""
    if isinstance(op, CSR):
        return spmv(op, v)
    return ell_spmv(op, v)


def best_matvec(csr: CSR):
    """``A @ ·`` as a closure over :func:`matvec_operand`."""
    op = matvec_operand(csr)
    return lambda v: apply_matvec(op, v)


def spmm(csr: CSR, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B for CSR A (m×k) and dense B (k×n)."""
    expects(b.shape[0] == csr.shape[1], "spmm: dimension mismatch")
    prod = csr.data[:, None] * b[csr.indices, :]
    return segment_reduce(prod, csr.row_ids(), csr.shape[0])


def csr_degree(csr: CSR) -> torch.Tensor:
    """Live entries per row (reference sparse/linalg/degree.cuh)."""
    return torch.diff(csr.indptr)


def coo_degree(coo: COO) -> torch.Tensor:
    ones = torch.ones(coo.capacity, dtype=torch.int32, device=coo.device)
    return segment_reduce(ones, torch.where(coo.mask(), coo.rows,
                                            coo.shape[0]), coo.shape[0])


def row_normalize(csr: CSR, norm: str = "l1") -> CSR:
    """Each row divided by its L1 norm or its max (reference
    sparse/linalg/norm.cuh ``csr_row_normalize_l1`` / ``_max``)."""
    rows = csr.row_ids()
    n = csr.shape[0]
    if norm == "l1":
        denom = segment_reduce(torch.abs(csr.data), rows, n)
    elif norm == "max":
        denom = segment_reduce(csr.data, rows, n, "amax")
    else:
        raise ValueError(f"unknown norm {norm!r}")
    denom = torch.where(denom != 0, denom, 1)
    data = csr.data / denom[torch.clamp(rows, 0, n - 1)]
    data = torch.where(csr.mask(), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))
    return CSR(csr.indptr, csr.indices, data, csr.shape)


def csr_transpose(csr: CSR) -> CSR:
    """Aᵀ (reference sparse/linalg/transpose.h, cuSPARSE csr2csc)."""
    coo = csr_to_coo(csr)
    live = coo.mask()
    t = COO(torch.where(live, coo.cols, csr.shape[1]),
            torch.where(live, coo.rows, 0), coo.vals,
            (csr.shape[1], csr.shape[0]), nnz=coo.nnz)
    return coo_to_csr(coo_sort(t))


def csr_add(a: CSR, b: CSR) -> CSR:
    """A + B with duplicates coalesced (reference sparse/linalg/add.cuh);
    the output's capacity is ``a.capacity + b.capacity``."""
    expects(a.shape == b.shape, "csr_add: shape mismatch")
    ca, cb = csr_to_coo(a), csr_to_coo(b)
    merged = COO(torch.cat([ca.rows, cb.rows]), torch.cat([ca.cols, cb.cols]),
                 torch.cat([ca.vals, cb.vals.to(ca.vals.dtype)]), a.shape,
                 nnz=ca.nnz + cb.nnz)
    return coo_to_csr(coo_sum_duplicates(merged))


def symmetrize(coo_or_csr, combine: str = "sum"):
    """A ← A + Aᵀ with duplicates combined by *combine* (``sum``, ``max``
    or ``min``; reference sparse/linalg/symmetrize.cuh ``coo_symmetrize``).
    Returns the same container kind."""
    is_csr = isinstance(coo_or_csr, CSR)
    coo = csr_to_coo(coo_or_csr) if is_csr else coo_or_csr
    expects(coo.shape[0] == coo.shape[1], "symmetrize: matrix must be square")
    live = coo.mask()
    n = coo.shape[0]
    zero = torch.zeros((), dtype=coo.vals.dtype, device=coo.device)
    both = COO(torch.cat([coo.rows, torch.where(live, coo.cols, n)]),
               torch.cat([coo.cols, torch.where(live, coo.rows, 0)]),
               torch.cat([coo.vals, torch.where(live, coo.vals, zero)]),
               coo.shape, nnz=2 * coo.nnz)
    out = _coo_combine_duplicates(both, combine)
    return coo_to_csr(out) if is_csr else out


def weak_cc(g: CSR) -> torch.Tensor:
    """Weakly-connected component labels by min-label propagation with a
    pointer jump a pass (reference ``sparse/csr.hpp`` ``weak_cc``): each
    vertex's label is the least vertex id it reaches.  One host read a
    pass, for the loop's condition."""
    n = g.shape[0]
    expects(g.shape[0] == g.shape[1], "weak_cc: graph must be square")
    rows = g.row_ids()
    live = g.mask()
    rows_safe = torch.clamp(rows, 0, n - 1).long()
    cols_safe = torch.clamp(g.indices, 0, n - 1).long()
    cols_seg = torch.where(live, g.indices, n)
    color = torch.arange(n, dtype=torch.int32, device=g.device)
    while True:
        # weak connectivity ignores direction: pull and push the least
        # label along every edge, then jump through the labels
        pulled = segment_reduce(torch.where(live, color[cols_safe], n), rows,
                                n, "amin")
        pushed = segment_reduce(torch.where(live, color[rows_safe], n),
                                cols_seg, n, "amin")
        new = torch.minimum(color, torch.minimum(pulled, pushed))
        new = new[torch.clamp(new, 0, n - 1).long()]
        changed = bool(torch.any(new != color))
        color = new
        if not changed:
            return color


def fit_embedding(adj: CSR, n_components: int, *, seed: int = 0,
                  tol: float = 1e-6) -> torch.Tensor:
    """Spectral embedding: the smallest non-trivial Laplacian
    eigenvectors, each scaled to unit (population) std (reference
    sparse/linalg/detail/spectral.cuh:34-80 ``fit_embedding``).  Returns
    (n, n_components)."""
    from raft_tpu_torch.sparse.solver import lanczos_smallest

    lap = laplacian(adj)
    _, vecs = lanczos_smallest(lap, n_components + 1, seed=seed, tol=tol)
    emb = vecs[:, 1:]
    std = torch.clamp_min(torch.std(emb, dim=0, correction=0), 1e-12)
    return emb / std


def laplacian(adj: CSR, normalized: bool = False) -> CSR:
    """The graph Laplacian L = D − A (or I − D^-1/2 A D^-1/2),
    materialised with capacity nnz + n for the diagonal (the reference's
    ``laplacian_matrix_t`` keeps it implicit, as
    :func:`raft_tpu_torch.spectral.laplacian_matvec` does)."""
    n = adj.shape[0]
    expects(adj.shape[0] == adj.shape[1], "laplacian: matrix must be square")
    deg = segment_reduce(adj.data, adj.row_ids(), n)
    ca = csr_to_coo(adj)
    live = ca.mask()
    zero = torch.zeros((), dtype=ca.vals.dtype, device=ca.device)
    if normalized:
        inv_sqrt = torch.where(deg > 0, 1.0 / torch.sqrt(
            torch.clamp_min(deg, 1e-30)), 0.0)
        safe_r = torch.clamp(ca.rows, 0, n - 1).long()
        safe_c = torch.clamp(ca.cols, 0, n - 1).long()
        off = torch.where(live, -ca.vals * inv_sqrt[safe_r] * inv_sqrt[safe_c],
                          zero)
        diag = torch.where(deg > 0, 1.0, 0.0).to(ca.vals.dtype)
    else:
        off = torch.where(live, -ca.vals, zero)
        diag = deg.to(ca.vals.dtype)
    iota = torch.arange(n, dtype=torch.int32, device=ca.device)
    merged = COO(torch.cat([torch.where(live, ca.rows, n), iota]),
                 torch.cat([torch.where(live, ca.cols, 0), iota]),
                 torch.cat([off, diag]), adj.shape, nnz=ca.nnz + n)
    return coo_to_csr(coo_sum_duplicates(merged))
