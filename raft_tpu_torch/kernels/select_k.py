"""Wrapper of kernel B2, the filtered warp select-k — ``csrc/select_k.cu``.

Replaces ``raft_tpu/kernels/select_k.py`` ``select_k_blockwise``: per row,
the positions of the k best values best-first, ties at the lowest
position, NaN ranked as the worst value, half types compared in float32
(the kernel reads float16 and bfloat16 rows in their own type and widens
them exactly, so order and ties are unchanged); the kernel reads the
values back from the raw input by position.  Bit-identical to the plain
version in ``raft_tpu_torch.matrix.select_k``.

A tensor on the CPU runs the plain version; a CUDA tensor launches the
kernel or raises.  :func:`supports` is the JAX package's own support
predicate (floating rows, ``k <= MAX_K <= n``) narrowed to the types that
widen exactly to float32; callers keep other shapes on the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.kernels import native

#: largest k the kernel accepts (four 32-lane register runs)
MAX_K = 128
#: the kernel compares in float32; these widen to it exactly (float64
#: would not, and stays on the plain version); value: the kernel's code
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def supports(k: int, n: int, dtype: torch.dtype) -> bool:
    return int(k) <= MAX_K and int(k) <= int(n) and dtype in _DTYPES


def select_k_blockwise(values: torch.Tensor, k: int, select_min: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (..., k), positions (..., k) int32) of the k best per row."""
    k = int(k)
    expects(values.ndim >= 1, "select_k: values must have a last axis")
    n = values.shape[-1]
    expects(supports(k, n, values.dtype),
            f"select_k kernel: unsupported k={k}, n={n}, {values.dtype}")
    if values.device.type == "cpu":
        from raft_tpu_torch.matrix.select_k import select_k_plain

        return select_k_plain(values, k, select_min)
    expects(values.device.type == "cuda", f"select_k: device {values.device}")
    lead = values.shape[:-1]
    x = values.reshape(-1, n).contiguous()
    rows = x.shape[0]
    vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    pos = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows:
        lib = native.library("select_k")
        err = lib.raft_select_k(x.data_ptr(), rows, n, k,
                                int(bool(select_min)), _DTYPES[x.dtype],
                                vals.data_ptr(), pos.data_ptr(),
                                native.stream_handle(x.device))
        native.check(lib, err, "select_k_kernel")
        native.LAUNCHES["select_k"] += 1
    return vals.reshape(lead + (k,)), pos.reshape(lead + (k,))
