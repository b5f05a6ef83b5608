"""The least work of an IVF-PQ search call (squared L2, PER_SUBSPACE
codebooks), counted from shapes and from which lists the call's queries
probe.

The probed lists come from the benchmark's own coarse step (plain float32
products over the index's centres, ``n_probes`` nearest), so the count is
the same whichever kernel runs the search.  Bytes: every input byte read
once a call — queries, centres, rotation, codebooks, and the codes and
ids of every list some query of the call probes — and every output byte
(a float32 distance and an int32 id a neighbour) written once.
Operations: the coarse product, the rotation of the queries and the
query-codebook products of the lookup table, two a multiply-add.
"""

from __future__ import annotations

from typing import Dict

import torch

from perf_bench.counts import peaks


def probed_lists(q: torch.Tensor, centers: torch.Tensor,
                 n_probes: int) -> torch.Tensor:
    """The union of the lists the queries *q* probe (bool, (n_lists,))."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qf, cf = q.float(), centers.float()
        d = ((qf * qf).sum(1)[:, None] + (cf * cf).sum(1)[None]
             - 2.0 * qf @ cf.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    hit = torch.zeros(centers.shape[0], dtype=torch.bool, device=q.device)
    hit[d.topk(n_probes, 1, largest=False).indices.reshape(-1)] = True
    return hit


def work(q: torch.Tensor, centers: torch.Tensor, list_sizes: torch.Tensor,
         rot_dim: int, pq_dim: int, pq_bits: int, n_probes: int,
         k: int) -> Dict[str, float]:
    """{"flop", "bytes", "least_s", "bound"} of one call over *q*."""
    nq, dim = q.shape
    n_lists = centers.shape[0]
    kcb = 1 << pq_bits
    code_bytes = -(-pq_dim * pq_bits // 8)
    hit = probed_lists(q, centers, n_probes)
    rows = float(list_sizes[hit].sum())
    nbytes = (4.0 * nq * dim + 4.0 * n_lists * dim + 4.0 * dim * rot_dim
              + 4.0 * kcb * rot_dim + rows * (code_bytes + 4)
              + 8.0 * nq * k)
    flop = (2.0 * nq * n_lists * dim + 2.0 * nq * dim * rot_dim
            + 2.0 * nq * rot_dim * kcb)
    t_ops = flop / peaks.F32_ACCURATE_FLOP_PER_S
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    return {"flop": flop, "bytes": nbytes, "least_s": max(t_ops, t_bytes),
            "bound": "operations" if t_ops >= t_bytes else "bytes"}
