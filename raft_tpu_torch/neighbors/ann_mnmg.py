"""The cross-rank merge of the sharded ANN layer (port of part of
``raft_tpu/neighbors/ann_mnmg.py``): per-rank (nq, k) top-k runs pack into
ONE payload — distances beside int32 ids bit-cast into the float32 lane —
so the whole exchange is a single ``comms.allgather``, and the (world, nq,
k) parts fold with ``merge_sorted_parts``, earlier ranks winning ties
(the reference's ``neighbors/brute_force.cuh:76`` part merge).

The sharded IVF indexes, ``save_sharded`` / ``load_sharded`` and the
replica layer of the JAX module come with a later slice (ROADMAP).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.matrix.select_k import merge_sorted_parts


def _allgather_packed(comms: Comms, d: torch.Tensor, i: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (rows, k) distances and ids as (world, rows, k) parts,
    moved by ONE allgather of the (rows, 2k) packed payload (float64
    distances carry the ids widened exactly)."""
    i = i.to(torch.int32)
    if d.dtype == torch.float64:
        parts = comms.allgather(torch.cat([d, i.to(torch.float64)], dim=1))
        return parts[..., :k], parts[..., k:].to(torch.int32)
    parts = comms.allgather(torch.cat([d.to(torch.float32),
                                       i.view(torch.float32)], dim=1))
    return parts[..., :k], parts[..., k:].contiguous().view(torch.int32)


def _merge_one_allgather(comms: Comms, d: torch.Tensor, i: torch.Tensor,
                         k: int, select_min: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-rank (nq, k) top-k runs with EXACTLY ONE collective.
    ``Comms.collective_calls`` records the allgather and its nq·2k·4
    bytes."""
    pd, pi = _allgather_packed(comms, d, i, k)
    return merge_sorted_parts(pd, pi, k=k, select_min=select_min)
