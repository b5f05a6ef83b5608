"""Wrappers of kernels B1 (fused L2 nearest neighbour) and B3 (the fused
E-step plus M-step partials) — ``csrc/fused_l2nn.cu``.

Replace ``raft_tpu/kernels/fused_l2nn.py`` ``fused_l2_nn_pallas`` and
``fused_l2_nn_partials``.  A tensor on the CPU runs the plain PyTorch
version (``raft_tpu_torch.distance.fused_l2_nn``); a CUDA tensor launches
the kernel or raises — there is no quiet fallback.

B3's M-step partials come from the E-step's labels through a stable
ordering of the rows by label (``torch.argsort(stable=True)`` plus a
bincount and cumsum — index bookkeeping) and the hand-written
``segment_sums_kernel``, which adds each cluster's members in row order:
the sums repeat bit for bit from run to run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance import fused_l2_nn as plain
from raft_tpu_torch.distance.pairwise import _row_norms
from raft_tpu_torch.kernels import native

#: feature widths the TPU kernel accepts (``_MAX_D``); kept as the same
#: support predicate here
MAX_D = 2048


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "fused_l2_nn: x (m, d) and y (k, d) must share d")
    expects(x.shape[1] <= MAX_D, f"fused_l2_nn: d={x.shape[1]} > {MAX_D}")
    expects(x.device == y.device, "fused_l2_nn: x and y on one device")
    expects(y.shape[0] >= 1, "fused_l2_nn: y needs at least one row")


def _launch_nn(x: torch.Tensor, y: torch.Tensor, bf16_dot: bool):
    lib = native.library("fused_l2nn")
    m, d = x.shape
    k = y.shape[0]
    xn = _row_norms(x)
    yn = _row_norms(y)
    val = torch.empty(m, dtype=torch.float32, device=x.device)
    idx = torch.empty(m, dtype=torch.int32, device=x.device)
    err = lib.raft_fused_l2nn(x.data_ptr(), xn.data_ptr(), y.data_ptr(),
                              yn.data_ptr(), val.data_ptr(), idx.data_ptr(),
                              m, k, d, int(bool(bf16_dot)),
                              native.stream_handle(x.device))
    native.check(lib, err, "fused_l2nn_kernel")
    return val, idx


def fused_l2_nn(x: torch.Tensor, y: torch.Tensor, bf16_dot: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of x: (squared L2 distance to the nearest row of y, its
    index) as (val (m,) f32, idx (m,) int32); lowest index wins ties."""
    _check(x, y)
    if x.device.type == "cpu":
        return plain.fused_l2_nn_plain(x, y, bf16_dot)
    expects(x.device.type == "cuda", f"fused_l2_nn: device {x.device}")
    x = x.float().contiguous()
    y = y.float().contiguous()
    out = _launch_nn(x, y, bf16_dot)
    native.LAUNCHES["fused_l2_nn"] += 1
    return out


def fused_l2_nn_partials(x: torch.Tensor, y: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         bf16_dot: bool = False):
    """E-step plus M-step partials: ``(val (m,), idx (m,) int32,
    sums (k, d), wsum (k,), inertia ())`` with Σ over each cluster's
    members of w·x and w (``weights`` default to ones) and inertia
    Σ w·val."""
    _check(x, y)
    if x.device.type == "cpu":
        return plain.fused_l2_nn_partials_plain(x, y, weights, bf16_dot)
    expects(x.device.type == "cuda",
            f"fused_l2_nn_partials: device {x.device}")
    m, d = x.shape
    k = y.shape[0]
    x = x.float().contiguous()
    y = y.float().contiguous()
    w = None if weights is None else weights.float().contiguous()
    expects(w is None or (w.shape == (m,) and w.device == x.device),
            "weights must be (m,) on x's device")
    val, idx = _launch_nn(x, y, bf16_dot)
    order = torch.argsort(idx, stable=True).to(torch.int32)
    offsets = torch.zeros(k + 1, dtype=torch.int32, device=x.device)
    offsets[1:] = torch.cumsum(torch.bincount(idx, minlength=k), 0)
    sums = torch.empty((k, d), dtype=torch.float32, device=x.device)
    wsum = torch.empty(k, dtype=torch.float32, device=x.device)
    lib = native.library("fused_l2nn")
    err = lib.raft_segment_sums(x.data_ptr(),
                                0 if w is None else w.data_ptr(),
                                order.data_ptr(), offsets.data_ptr(),
                                sums.data_ptr(), wsum.data_ptr(), k, d,
                                native.stream_handle(x.device))
    native.check(lib, err, "segment_sums_kernel")
    native.LAUNCHES["fused_l2_nn_partials"] += 1
    inertia = torch.sum(val) if w is None else torch.sum(val * w)
    return val, idx, sums, wsum, inertia
