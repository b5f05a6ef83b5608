"""Fused L2 nearest neighbour — the plain PyTorch versions of kernels B1
and B3 (``raft_tpu/kernels/fused_l2nn.py``).

These are the contract the CUDA kernels in ``kernels/csrc/fused_l2nn.cu``
are held to, and what the kernel wrappers run for tensors on the CPU:

* :func:`fused_l2_nn_plain` — per row of x, the squared L2 distance
  ``max(||x||² + ||y||² − 2 x·y, 0)`` to its nearest row of y and that
  row's index; the lowest index wins exact ties (``torch.argmin`` returns
  the first minimum, as ``jnp.argmin`` does).
* :func:`fused_l2_nn_partials_plain` — the same E-step plus the M-step
  partials: (k, d) Σ w·x per cluster, (k,) Σ w, and the inertia Σ w·val.
* :func:`fused_l2_nn_partials_batched_plain` — that for S independent
  problems (the PER_SUBSPACE codebooks), one at a time, so it never holds
  an (S, n, k) distance tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.distance.pairwise import _row_norms
from raft_tpu_torch.linalg.reduce import segment_sum

#: rows per distance block: bounds the (rows, k) transient of the plain
#: version (256 MB at k = 1024)
_BLOCK_ROWS = 1 << 16


def fused_l2_nn_plain(x: torch.Tensor, y: torch.Tensor,
                      bf16_dot: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(val (m,) f32, idx (m,) int32) of the nearest row of *y*.

    ``bf16_dot`` rounds both operands of the dot product to bfloat16 (the
    products are then exact in float32 and summed in float32) while the
    norms stay float32 — the ``precision="default"`` opt-in of the TPU
    kernel."""
    x = x.float()
    y = y.float()
    xn = _row_norms(x)
    yn = _row_norms(y)
    xd, yd = ((x.bfloat16().float(), y.bfloat16().float()) if bf16_dot
              else (x, y))
    m = x.shape[0]
    val = torch.empty(m, dtype=torch.float32, device=x.device)
    idx = torch.empty(m, dtype=torch.int32, device=x.device)
    for r0 in range(0, m, _BLOCK_ROWS):
        r1 = min(m, r0 + _BLOCK_ROWS)
        d = torch.clamp_min(xn[r0:r1, None] + yn[None, :]
                            - 2.0 * (xd[r0:r1] @ yd.T), 0.0)
        i = torch.argmin(d, dim=1)
        val[r0:r1] = torch.gather(d, 1, i[:, None])[:, 0]
        idx[r0:r1] = i.to(torch.int32)
    return val, idx


def cluster_partials_plain(x: torch.Tensor, labels: torch.Tensor, k: int,
                           weights: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The M-step partials from given labels: ((k, d) Σ w·x, (k,) Σ w)."""
    x = x.float()
    if weights is None:
        w = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
        sums = segment_sum(x, labels, k)
    else:
        w = weights.float()
        sums = segment_sum(x * w[:, None], labels, k)
    return sums, segment_sum(w, labels, k)


def fused_l2_nn_partials_plain(x: torch.Tensor, y: torch.Tensor,
                               weights: Optional[torch.Tensor] = None,
                               bf16_dot: bool = False):
    """(val, idx, sums (k, d), wsum (k,), inertia ()) — see module doc."""
    val, idx = fused_l2_nn_plain(x, y, bf16_dot)
    sums, wsum = cluster_partials_plain(x, idx, y.shape[0], weights)
    w = None if weights is None else weights.float()
    inertia = torch.sum(val) if w is None else torch.sum(val * w)
    return val, idx, sums, wsum, inertia


def fused_l2_nn_partials_batched_plain(x: torch.Tensor, y: torch.Tensor,
                                       weights: Optional[torch.Tensor] = None):
    """x (S, n, d), y (S, k, d), weights (n,) or (S, n) → (val (S, n),
    idx (S, n), sums (S, k, d), wsum (S, k), inertia (S,))."""
    outs = [fused_l2_nn_partials_plain(
        x[i], y[i], None if weights is None
        else (weights if weights.ndim == 1 else weights[i]))
        for i in range(x.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))
