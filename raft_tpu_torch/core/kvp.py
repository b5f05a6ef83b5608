"""Key-value pair of the fused argmin reductions (port of
``raft_tpu/core/kvp.py``; reference ``raft::KeyValuePair``,
core/kvp.hpp:62), produced by the fused L2 nearest neighbour and consumed
by k-means."""

from __future__ import annotations

from typing import NamedTuple

import torch


class KeyValuePair(NamedTuple):
    """Per-sample nearest centre: ``key`` (m,) int32, ``value`` (m,)."""

    key: torch.Tensor
    value: torch.Tensor


def kvp_min(a: KeyValuePair, b: KeyValuePair) -> KeyValuePair:
    """Elementwise min by value, ties to the smaller key (reference
    distance/detail/fused_l2_nn.cuh ``MinAndDistanceReduceOp``)."""
    take_b = (b.value < a.value) | ((b.value == a.value) & (b.key < a.key))
    return KeyValuePair(key=torch.where(take_b, b.key, a.key),
                        value=torch.where(take_b, b.value, a.value))
