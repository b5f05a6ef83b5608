"""Pairwise distances between the rows of two CSR matrices (port of
``raft_tpu/sparse/distance.py``; reference
``sparse/distance/distance.cuh:37-68``, its 18 metrics and its engines —
the COO-SpMV strategies of ``detail/coo_spmv.cuh``, L2 and cosine from
inner products, the generic LP loop and the binary metrics).

Two engines, as in the JAX package:

* **densify** (moderate dim): row blocks of x and y are scattered into
  dense (block × dim) tiles and handed to the dense
  :func:`raft_tpu_torch.distance.distance` — kernel B5 takes L1, Linf,
  Canberra, Lp, Hamming and the unexpanded L2 on the card, the product
  epilogues take the expanded metrics.
* **feature-compressed** (high dim, the role of the reference's
  hash-table SpMV strategies): each x-block is densified onto its own
  sorted feature set ``u`` (at most the block's nnz columns, whatever
  ``dim``), y entries are matched into that axis by binary search
  (``torch.searchsorted``), and the pair work runs on the compressed axis
  (a product for the inner-product family, tiled elementwise for the LP
  family).  Features a y row holds outside ``u`` meet only zeros of x:
  their part is a per-row sum (max for Linf) straight from the y entries.
  Memory is O(block · block_nnz), never O(block · dim).

The output is one dense (m, n) tensor on the inputs' device; the
compressed engine's tiles are written into it there (the JAX package
gathers them in a host array).  Only the row pointers are read on the
host, to size the blocks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import auto_sync_handle
from raft_tpu_torch.distance import DistanceType
from raft_tpu_torch.distance import pairwise as _dense
from raft_tpu_torch.sparse.convert import csr_to_dense
from raft_tpu_torch.sparse.op import csr_row_slice, segment_reduce
from raft_tpu_torch.sparse.types import CSR

# reference sparse/distance/distance.cuh:37-56
SUPPORTED_SPARSE_DISTANCES = (
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.CosineExpanded,
    DistanceType.InnerProduct,
    DistanceType.L1,
    DistanceType.Canberra,
    DistanceType.Linf,
    DistanceType.LpUnexpanded,
    DistanceType.JaccardExpanded,
    DistanceType.HellingerExpanded,
    DistanceType.DiceExpanded,
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.CorrelationExpanded,
    DistanceType.RusselRaoExpanded,
    DistanceType.HammingUnexpanded,
    DistanceType.JensenShannon,
    DistanceType.KLDivergence,
)

#: metrics the densify engine cannot express through the dense dispatch
#: (the reference computes them only sparsely, bin_distance.cuh)
_COMPRESSED_ONLY = (DistanceType.JaccardExpanded, DistanceType.DiceExpanded)

#: dim above which "auto" takes the feature-compressed engine
HIGHDIM_THRESHOLD = 4096


@auto_sync_handle
def pairwise_distance(x: CSR, y: CSR,
                      metric: DistanceType = DistanceType.L2Expanded,
                      p: float = 2.0, batch_size_x: int = 4096,
                      batch_size_y: Optional[int] = None,
                      engine: str = "auto", handle=None) -> torch.Tensor:
    """All-pairs distances between the rows of two CSR matrices on one
    device (reference ``sparse::distance::pairwiseDistance``,
    sparse/distance/distance.cuh:68): a dense (m, n) tensor.

    engine: ``"auto"`` (feature-compressed when dim > HIGHDIM_THRESHOLD or
    the metric is sparse-only), ``"densify"`` or ``"compressed"``.
    handle: its main stream takes the work (``auto_sync_handle``); the
    matrices stay on their device."""
    metric = DistanceType(metric)
    expects(metric in SUPPORTED_SPARSE_DISTANCES,
            f"metric {metric} not supported for sparse inputs")
    expects(x.shape[1] == y.shape[1], "pairwise_distance: dim mismatch")
    expects(x.device == y.device, "pairwise_distance: x and y lie on "
            f"different devices ({x.device}, {y.device})")
    expects(engine in ("auto", "densify", "compressed"),
            f"unknown engine {engine!r}")
    expects(not (engine == "densify" and metric in _COMPRESSED_ONLY),
            f"{metric.name} has no densify path (sparse-only in the "
            "reference, bin_distance.cuh) — use engine='compressed' or 'auto'")
    if engine == "auto":
        engine = ("compressed" if x.shape[1] > HIGHDIM_THRESHOLD
                  or metric in _COMPRESSED_ONLY else "densify")
    if engine == "compressed":
        return _pairwise_compressed(x, y, metric, p, batch_size_x,
                                    batch_size_y)
    m, n = x.shape[0], y.shape[0]
    bx = min(batch_size_x, m)
    by = min(batch_size_y or max(batch_size_x, 4096), n)
    rows = []
    for i0 in range(0, m, bx):
        xd = csr_to_dense(csr_row_slice(x, i0, min(i0 + bx, m)))
        # one (bx, dim) and one (by, dim) dense tile live at a time: the
        # batch knobs bound the densified footprint
        rows.append(torch.cat([
            _dense.distance(xd, csr_to_dense(csr_row_slice(
                y, j0, min(j0 + by, n))), metric, p)
            for j0 in range(0, n, by)], dim=1))
    return torch.cat(rows, dim=0)


# ---------------------------------------------------------------------------
# feature-compressed engine
# ---------------------------------------------------------------------------

def _row_stats(rows, vals, nrows):
    """Per-row (Σv, Σv², nnz) of padded COO entries (padding rows carry
    v = 0 and fall outside the segments)."""
    s = segment_reduce(vals, rows, nrows)
    sq = segment_reduce(vals * vals, rows, nrows)
    nnz = segment_reduce((vals != 0).to(vals.dtype), rows, nrows)
    return s, sq, nnz


def _log2(v):
    return torch.where(v > 0, v, 0.0) * math.log(2.0)


# additive metrics: (pair_fn(x, y), zero_fn(y)) with Σ_f pair_fn over u
# and Σ zero_fn over the y features outside u; pair_fn(0, 0) == 0 and
# pair_fn(0, y) == zero_fn(y).  The final transforms follow the correction.
_ADDITIVE = {
    DistanceType.L1: (lambda x, y: torch.abs(x - y), torch.abs),
    DistanceType.L2Unexpanded: (lambda x, y: (x - y) ** 2, lambda v: v * v),
    DistanceType.L2SqrtUnexpanded: (lambda x, y: (x - y) ** 2,
                                    lambda v: v * v),
    DistanceType.Canberra: (_dense.canberra_terms,
                            lambda v: (v != 0).to(v.dtype)),
    DistanceType.HammingUnexpanded: (lambda x, y: (x != y).to(x.dtype),
                                     lambda v: (v != 0).to(v.dtype)),
    DistanceType.JensenShannon: (_dense.jensen_shannon_terms, _log2),
}


def _additive_tile(fn):
    def tile(xi, yj):
        return torch.sum(fn(xi, yj), dim=-1)

    return tile


def _unique_padded(c: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The sorted distinct values of *c*, padded to *size* with *fill*
    (``jnp.unique(c, size=size, fill_value=fill)``), with no host read."""
    s = torch.sort(c).values
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=c.device),
                       s[1:] != s[:-1]])
    pos = torch.cumsum(first, 0) - 1
    pos = torch.where(first & (pos < size), pos, size)
    u = torch.full((size + 1,), fill, dtype=c.dtype, device=c.device)
    return u.scatter_(0, pos, s)[:size]


def _densify(rows, pos, vals, n_rows: int, width: int) -> torch.Tensor:
    """``zeros((n_rows, width)).at[rows, pos].add(vals, mode="drop")``
    for rows in [0, n_rows] and pos in [0, width] (the last of each
    dropped)."""
    out = torch.zeros((n_rows + 1) * (width + 1), dtype=vals.dtype,
                      device=vals.device)
    # exempt(raw-segment-sum): densify: a row block scattered into its tile
    out.index_add_(0, rows.long() * (width + 1) + pos.long(), vals)
    return out.view(n_rows + 1, width + 1)[:n_rows, :width]


def _compressed_tile(xr, xc, xv, yr, yc, yv, metric: DistanceType, p: float,
                     bx: int, by: int, ucap: int, dim: int) -> torch.Tensor:
    """One (bx × by) output tile from the padded COO entries of an x-block
    and a y-block, through the x-block's compressed feature axis ``u``.
    x pads hold (row bx, col dim, val 0), y pads (row by, col dim, val
    0)."""
    u = _unique_padded(xc, ucap, dim)  # sorted; the fill sorts last
    xpos = torch.searchsorted(u, xc)
    xd = _densify(xr, xpos, xv, bx, ucap)
    ypos = torch.searchsorted(u, yc)
    member = u[torch.clamp(ypos, 0, ucap - 1)] == yc
    ycol = torch.where(member, ypos, ucap)
    yd = _densify(yr, ycol, yv, by, ucap)
    y_out = (yr < by) & ~member  # real y entries outside u

    def outside_sum(g0v):
        return segment_reduce(torch.where(y_out, g0v, 0.0), yr, by)

    def mm(a, b):
        return a @ b.T

    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        _, xsq, _ = _row_stats(xr, xv, bx)
        _, ysq, _ = _row_stats(yr, yv, by)
        d = torch.clamp_min(xsq[:, None] + ysq[None, :] - 2.0 * mm(xd, yd),
                            0.0)
        return torch.sqrt(d) if metric == DistanceType.L2SqrtExpanded else d
    if metric == DistanceType.InnerProduct:
        return mm(xd, yd)
    if metric == DistanceType.CosineExpanded:
        _, xsq, _ = _row_stats(xr, xv, bx)
        _, ysq, _ = _row_stats(yr, yv, by)
        denom = torch.clamp_min(torch.sqrt(xsq)[:, None]
                                * torch.sqrt(ysq)[None, :], 1e-30)
        return 1.0 - mm(xd, yd) / denom
    if metric == DistanceType.CorrelationExpanded:
        xs, xsq, _ = _row_stats(xr, xv, bx)
        ys, ysq, _ = _row_stats(yr, yv, by)
        numer = dim * mm(xd, yd) - xs[:, None] * ys[None, :]
        q = dim * xsq - xs * xs
        r = dim * ysq - ys * ys
        denom = torch.sqrt(torch.clamp_min(q[:, None] * r[None, :], 1e-30))
        return 1.0 - numer / denom
    if metric == DistanceType.HellingerExpanded:
        # the inner product of square roots
        xs_ = _densify(xr, xpos, torch.sqrt(torch.abs(xv)), bx, ucap)
        ys_ = _densify(yr, ycol, torch.sqrt(torch.abs(yv)), by, ucap)
        return torch.sqrt(torch.clamp_min(1.0 - mm(xs_, ys_), 0.0))
    if metric == DistanceType.RusselRaoExpanded:
        # the raw-value inner product, as the dense engine
        return (dim - mm(xd, yd)) * (1.0 / dim)
    if metric == DistanceType.KLDivergence:
        # 0.5·(Σ x log x − Σ x log y): both terms live on u (log y := 0
        # where y == 0, kl_divergence.cuh:27)
        xlx = segment_reduce(torch.where(xv > 0, xv * torch.log(
            torch.where(xv > 0, xv, 1.0)), 0.0), xr, bx)
        ylog = torch.where(yd > 0, torch.log(torch.where(yd > 0, yd, 1.0)),
                           0.0)
        return 0.5 * (xlx[:, None] - mm(xd, ylog))
    if metric in (DistanceType.JaccardExpanded, DistanceType.DiceExpanded):
        # reference bin_distance.cuh:114-157 / :168-213 on row sums + dot
        xs, _, _ = _row_stats(xr, xv, bx)
        ys, _, _ = _row_stats(yr, yv, by)
        dot = mm(xd, yd)
        union = xs[:, None] + ys[None, :]
        if metric == DistanceType.JaccardExpanded:
            denom = union - dot
            sim = torch.where(denom != 0, dot / torch.where(denom != 0, denom,
                                                            1.0), 0.0)
        else:
            sim = torch.where(union != 0, 2.0 * dot / torch.where(
                union != 0, union, 1.0), 0.0)
        return torch.where(union == 0, 0.0, 1.0 - sim)
    if metric == DistanceType.Linf:
        base = _dense._blocked_reduce(xd, yd, _dense._tile_linf)
        corr = segment_reduce(torch.where(y_out, torch.abs(yv), 0.0), yr, by,
                              "amax")
        return torch.maximum(base, corr[None, :])
    if metric == DistanceType.LpUnexpanded:
        base = _dense._blocked_reduce(xd, yd, _additive_tile(
            lambda a, b: torch.pow(torch.abs(a - b), p)))
        corr = outside_sum(torch.pow(torch.abs(yv), p))
        return torch.pow(base + corr[None, :], 1.0 / p)
    pair, zero = _ADDITIVE[metric]
    acc = (_dense._blocked_reduce(xd, yd, _additive_tile(pair))
           + outside_sum(zero(yv))[None, :])
    if metric == DistanceType.L2SqrtUnexpanded:
        return torch.sqrt(torch.clamp_min(acc, 0.0))
    if metric == DistanceType.HammingUnexpanded:
        return acc * (1.0 / dim)
    if metric == DistanceType.JensenShannon:
        return torch.sqrt(torch.clamp_min(0.5 * acc, 0.0))
    return acc


class _Blocks:
    """Padded COO entries of a CSR's row blocks, gathered on its device
    (row pointers read once on the host)."""

    def __init__(self, csr: CSR, bsz: int):
        n, dim = csr.shape
        self.bsz = bsz
        self.n = n
        self.indptr = csr.indptr.cpu().tolist()
        # one padding entry past the buffers: every gather stays in bounds
        dev = csr.device
        self.rows = torch.cat([csr.row_ids(), torch.full(
            (1,), n, dtype=torch.int32, device=dev)])
        self.cols = torch.cat([csr.indices, torch.full(
            (1,), dim, dtype=torch.int32, device=dev)])
        self.vals = torch.cat([csr.data, csr.data.new_zeros(1)])
        self.starts = range(0, n, bsz)
        self.cap = _roundup(max((self.indptr[min(i0 + bsz, n)]
                                 - self.indptr[i0] for i0 in self.starts),
                                default=0))

    def entries(self, i0: int):
        i1 = min(i0 + self.bsz, self.n)
        s, e = self.indptr[i0], self.indptr[i1]
        idx = s + torch.arange(self.cap, device=self.rows.device)
        idx = torch.where(idx < e, idx, self.rows.shape[0] - 1)
        rows = self.rows[idx] - i0
        return (torch.where(idx < e, rows, self.bsz), self.cols[idx],
                self.vals[idx]), i1


def _roundup(v: int, q: int = 256) -> int:
    return max(q, -(-v // q) * q)


def _pairwise_compressed(x: CSR, y: CSR, metric: DistanceType, p: float,
                         batch_size_x: int, batch_size_y: Optional[int]):
    m, dim = x.shape
    n = y.shape[0]
    xb = _Blocks(x, min(batch_size_x, m, 512))  # narrower x-blocks
    yb = _Blocks(y, min(batch_size_y or 2048, n))
    # ucap covers every distinct column of a padded x-block: at most
    # min(its entries, dim features + the pad value dim)
    ucap = min(xb.cap, _roundup(dim + 1, 128))
    out = torch.empty((m, n), dtype=x.data.dtype, device=x.device)
    for i0 in xb.starts:
        (xr, xc, xv), i1 = xb.entries(i0)
        for j0 in yb.starts:
            (yr, yc, yv), j1 = yb.entries(j0)
            tile = _compressed_tile(xr, xc, xv, yr, yc, yv, metric,
                                    float(p), xb.bsz, yb.bsz, ucap, dim)
            out[i0:i1, j0:j1] = tile[:i1 - i0, :j1 - j0]
    return out
