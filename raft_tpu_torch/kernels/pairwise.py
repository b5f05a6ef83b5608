"""Wrapper of kernel B5, the pairwise accumulation — ``csrc/pairwise.cu``.

Replaces ``raft_tpu/kernels/pairwise.py`` ``_pairwise_pallas`` (public
entry ``pairwise_accumulate``): over all pairs of rows,

    out[i, j] = Σ_k elem(x[i, k], y[j, k])   (max_k for linf),

float32, with the op table of the TPU kernel (:data:`OPS`).  Only the raw
accumulation: the caller finalises (sqrt for L2SqrtUnexpanded, ^(1/p) for
Lp, /k for Hamming), the reference's CoreLambda / EpilogueLambda split.

Inputs are float32, bfloat16 or float16 (x and y of one type); the sum is
taken in float32 (``accum_dtype``).  A tensor on the CPU runs the plain
version :func:`pairwise_accumulate_plain`; a CUDA tensor launches the
kernel or raises.  Both sum each output's terms in k order, so a row's
result does not depend on the other rows of its batch.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.pairwise import canberra_terms
from raft_tpu_torch.kernels import native

#: op → (elementwise term of (x_ik, y_jk, p), merge over k, C code)
OPS = {
    "l1": (lambda a, b, p: torch.abs(a - b), "add", 0),
    "l2": (lambda a, b, p: (a - b) * (a - b), "add", 1),
    "linf": (lambda a, b, p: torch.abs(a - b), "max", 2),
    "lp": (lambda a, b, p: torch.pow(torch.abs(a - b), p), "add", 3),
    "hamming": (lambda a, b, p: (a != b).float(), "add", 4),
    "canberra": (lambda a, b, p: canberra_terms(a, b), "add", 5),
}
#: the input types the kernel is instantiated for, by their C code
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def pairwise_accumulate_plain(x: torch.Tensor, y: torch.Tensor, op: str,
                              p: float = 2.0) -> torch.Tensor:
    """The plain version: (m, n) float32, the terms folded in k order
    (``torch.maximum`` propagates NaN, as ``jnp.maximum`` does)."""
    elem, merge, _ = OPS[op]
    xf, yf = x.float(), y.float()
    acc = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float32,
                      device=x.device)
    for kk in range(x.shape[1]):
        part = elem(xf[:, kk, None], yf[None, :, kk], float(p))
        acc = acc + part if merge == "add" else torch.maximum(acc, part)
    return acc


def pairwise_accumulate(x: torch.Tensor, y: torch.Tensor, op: str,
                        p: float = 2.0) -> torch.Tensor:
    """Raw accumulated values (m, n) float32 of *op* over all row pairs."""
    expects(op in OPS, f"pairwise_accumulate: unknown op {op!r}")
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "pairwise_accumulate: x (m, k) and y (n, k)")
    expects(x.dtype == y.dtype and x.dtype in DTYPES,
            f"pairwise_accumulate: types {x.dtype}, {y.dtype}")
    expects(x.device == y.device, "pairwise_accumulate: x and y on one "
            "device")
    if x.device.type == "cpu":
        return pairwise_accumulate_plain(x, y, op, p)
    expects(x.device.type == "cuda",
            f"pairwise_accumulate: device {x.device}")
    m, k = x.shape
    n = y.shape[0]
    x = x.contiguous()
    y = y.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        lib = native.library("pairwise")
        err = lib.raft_pairwise_accumulate(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, OPS[op][2],
            float(p), DTYPES[x.dtype], native.stream_handle(x.device))
        native.check(lib, err, "pairwise_kernel")
        native.LAUNCHES["pairwise_accumulate"] += 1
    return out
