"""Row statistics of the expanded-L2 form (subset port of
``raft_tpu/distance/pairwise.py`` ``_row_norms``).

Float32 products run in full float32 across the port: it never enables
TF32 (``torch.backends.cuda.matmul.allow_tf32`` stays False), matching the
JAX package's "highest" precision contract.
"""

from __future__ import annotations

import torch

_HALF_DTYPES = (torch.bfloat16, torch.float16)


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    """Per-row squared L2 norms; half inputs accumulate in float32."""
    if x.dtype in _HALF_DTYPES:
        x = x.float()
    return torch.sum(x * x, dim=1)
