"""Minimum spanning tree/forest by parallel Borůvka (port of
``raft_tpu/sparse/solver/mst.py``; reference
``sparse/solver/mst_solver.cuh:40`` ``MST_solver``, kernels
``solver/detail/mst_kernels.cuh``).

Whole-array rounds: each colour's lightest outgoing edge from chained
stable sorts, the 2-cycles (mutual minima) removed, pointer jumping to the
roots, the winners appended.  Ties break by the strict total order
(colour, weight, min(u, v), max(u, v)) built from stable sorts, so the
port picks the same tree as the JAX package on the same edges, ties
included.  Each round reads one flag on the host (did any colour have a
cross edge); the pointer jumping runs ⌈log₂ n⌉ + 1 passes with no read
(a pass at a fixed point changes nothing).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.sparse.convert import csr_to_coo
from raft_tpu_torch.sparse.op import stable_argsort
from raft_tpu_torch.sparse.types import COO, CSR


class MSTResult(NamedTuple):
    """Spanning-forest edges (capacity n−1, live entries first) and the
    component label of each vertex."""

    src: torch.Tensor      # (n-1,) int32; padding n
    dst: torch.Tensor      # (n-1,) int32; padding n
    weight: torch.Tensor   # (n-1,); padding 0
    n_edges: torch.Tensor  # 0-d int32: live edges
    color: torch.Tensor    # (n,) int32


def _place(buf: torch.Tensor, pos: torch.Tensor, src) -> torch.Tensor:
    """``buf.at[pos].set(src, mode="drop")``: positions outside the buffer
    land in a dropped slot."""
    size = buf.shape[0]
    pos = pos.long()
    pos = torch.where((pos >= 0) & (pos < size), pos, size)
    src = torch.as_tensor(src, device=buf.device).to(buf.dtype)
    out = torch.cat([buf, buf.new_zeros(1)])
    return out.scatter_(0, pos, src.expand(pos.shape))[:size]


def boruvka_mst(g: Union[COO, CSR]) -> MSTResult:
    """MST/MSF of a symmetric weighted graph (both directed copies
    present, as mst_solver.cuh:40 requires)."""
    coo = csr_to_coo(g) if isinstance(g, CSR) else g
    expects(coo.shape[0] == coo.shape[1], "boruvka_mst: graph must be square")
    n = coo.shape[0]
    e = coo.capacity
    dev = coo.device
    u, v, w = coo.rows, coo.cols, coo.vals
    # an entry is live iff its endpoints are in range (padding carries the
    # row == n sentinel), so merged edge lists need no compaction
    live = (u >= 0) & (u < n) & (v >= 0) & (v < n)
    u_safe = torch.clamp(u, 0, n - 1).long()
    v_safe = torch.clamp(v, 0, n - 1).long()
    # the least-significant keys sort first, once: (min(u,v), max(u,v))
    by_id = stable_argsort(torch.maximum(u, v))
    by_id = by_id[stable_argsort(torch.minimum(u, v)[by_id])]
    inf = torch.tensor(float("inf"), dtype=w.dtype, device=dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    jumps = max(1, math.ceil(math.log2(max(n, 2)))) + 1

    color = iota.clone()
    msrc = torch.full((n - 1,), n, dtype=torch.int32, device=dev)
    mdst = msrc.clone()
    mw = torch.zeros((n - 1,), dtype=w.dtype, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    while True:
        cu = color[u_safe]
        cv = color[v_safe]
        cross = live & (cu != cv)
        # edges by (colour; weight; canonical id), each pass stable
        wk = torch.where(cross, w, inf)
        order = by_id[stable_argsort(wk[by_id])]
        ck = torch.where(cross, cu, n)
        order = order[stable_argsort(ck[order])]
        ck_s = ck[order]
        first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                           ck_s[1:] != ck_s[:-1]]) & (ck_s < n)
        # each colour's winning edge (its original index); colours with no
        # cross edge keep the sentinel e
        sel = _place(torch.full((n,), e, dtype=torch.int32, device=dev),
                     torch.where(first, ck_s, n), order)
        has = sel < e
        sel_safe = torch.clamp(sel, 0, e - 1).long()
        # parent[c]: the colour at the other end of c's winning edge; a
        # mutual pair (2-cycle) keeps the smaller colour as its root
        parent = torch.where(has, cv[sel_safe], iota)
        gp = parent[torch.clamp(parent, 0, n - 1).long()]
        is_cycle = (gp == iota) & (iota < parent)
        parent = torch.where(is_cycle, iota, parent)
        roots = parent
        for _ in range(jumps):
            roots = roots[torch.clamp(roots, 0, n - 1).long()]
        # the distinct winners: a mutual pair picks one undirected edge
        # through its two copies, so dropping the root side's mark adds it
        # once
        mark = has & ~is_cycle
        chosen = _place(torch.zeros(e, dtype=torch.bool, device=dev),
                        torch.where(mark, sel, e), True) & live
        pos = count + torch.cumsum(chosen, 0) - 1
        pos = torch.where(chosen, pos, n)
        msrc = _place(msrc, pos, u)
        mdst = _place(mdst, pos, v)
        mw = _place(mw, pos, w)
        count = count + chosen.sum(dtype=torch.int32)
        color = roots[color.long()]
        if not bool(torch.any(has)):  # the round's one host read
            return MSTResult(msrc, mdst, mw, count, color)


def sorted_mst_edges(result: MSTResult):
    """The MST edges by ascending weight (reference cluster/detail/mst.cuh
    ``build_sorted_mst`` sorts before the dendrogram stage); padding is
    pushed to the tail."""
    live = (torch.arange(result.src.shape[0], device=result.src.device)
            < result.n_edges)
    wk = torch.where(live, result.weight, float("inf"))
    order = stable_argsort(wk)
    return result.src[order], result.dst[order], result.weight[order]
