"""Keyed reductions (subset port of ``raft_tpu/linalg/reduce.py``:
``one_hot_by_key``, ``segment_sum``) — the k-means M-step's building
blocks."""

from __future__ import annotations

from typing import Optional

import torch


def one_hot_by_key(keys: torch.Tensor, n_keys: int, dtype: torch.dtype,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense (..., n_keys) one-hot of *keys*; key ``n_keys`` yields an
    all-zero row (the discard slot for padding rows).  *weights* scales
    each row."""
    ar = torch.arange(n_keys, device=keys.device, dtype=keys.dtype)
    oh = (keys[..., None] == ar).to(dtype)
    if weights is not None:
        oh = oh * weights[..., None].to(dtype)
    return oh


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{i: ids[i]==s} data[i]``.  Ids outside
    ``[0, num_segments)`` are dropped (the JAX scatter semantics the
    discard slot relies on).  On the CPU the sum runs in row order."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    if not bool(keep.all()):
        data, ids = data[keep], ids[keep]
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)


def reduce_rows_by_key(data: torch.Tensor, keys: torch.Tensor,
                       n_unique_keys: int,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[k, :] = Σ_{i: keys[i]==k} w_i · data[i, :]``."""
    vals = data if weights is None else data * weights[:, None]
    return segment_sum(vals, keys, n_unique_keys)
