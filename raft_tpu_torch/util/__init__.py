"""Utility layer: integer and tile math and host helpers (port of
``raft_tpu/util``; reference ``raft/util/``): ``ceildiv`` and ``Pow2``
(util/integer_utils.hpp, util/pow2_utils.cuh), the tile-padding helpers,
``product_of`` for parameter grids and a prime sieve."""

from raft_tpu_torch.util.itertools import product_of
from raft_tpu_torch.util.math import (Pow2, alignDown, alignTo, ceildiv,
                                      is_pow2, next_pow2, round_up_safe)
from raft_tpu_torch.util.seive import Seive
from raft_tpu_torch.util.tiling import (LANE, SUBLANE, min_tile, pad_dim,
                                        pad_to_tile, unpad)

__all__ = ["LANE", "SUBLANE", "Pow2", "Seive", "alignDown", "alignTo",
           "ceildiv", "is_pow2", "min_tile", "next_pow2", "pad_dim",
           "pad_to_tile", "product_of", "round_up_safe", "unpad"]
