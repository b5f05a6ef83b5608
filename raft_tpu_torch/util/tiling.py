"""Tile-padding helpers (port of ``raft_tpu/util/tiling.py``).

``LANE`` (128) and ``SUBLANE`` (8) are the TPU's lane and sublane widths,
and :func:`min_tile` its smallest (sublane, lane) tile by item size.  The
port keeps the names and pads by the same multiples only so that a padded
shape is the JAX package's: the H100 needs none of them (its kernels mask
their ragged edges themselves and pad nothing in memory)."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.util.math import round_up_safe

LANE = 128  # the TPU's last-dim tile width, all types
SUBLANE = 8  # the TPU's second-to-last tile width for 4-byte types

_SUBLANES = {4: 8, 2: 16, 1: 32}


def min_tile(dtype) -> Tuple[int, int]:
    """The TPU's minimum (sublane, lane) tile for *dtype* (a torch type)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (_SUBLANES.get(itemsize, 8), LANE)


def pad_dim(n: int, multiple: int) -> int:
    return round_up_safe(max(n, 1), multiple)


def pad_to_tile(x: torch.Tensor, row_mult: int = SUBLANE,
                col_mult: int = LANE, fill=0):
    """Pad the trailing two dims of *x* up to multiples of (row_mult,
    col_mult) with *fill* (a 1-d *x*: its one dim to col_mult); returns
    (padded, original shape)."""
    shape = tuple(x.shape)
    if x.ndim == 1:
        n = pad_dim(shape[0], col_mult)
        if n != shape[0]:
            x = torch.nn.functional.pad(x, (0, n - shape[0]), value=fill)
        return x, shape
    r, c = shape[-2], shape[-1]
    rp, cp = pad_dim(r, row_mult), pad_dim(c, col_mult)
    if (rp, cp) != (r, c):
        x = torch.nn.functional.pad(x, (0, cp - c, 0, rp - r), value=fill)
    return x, shape


def unpad(x, orig_shape):
    """Slice a padded tensor back to *orig_shape*."""
    return x[tuple(slice(0, s) for s in orig_shape)]
