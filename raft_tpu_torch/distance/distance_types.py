"""Distance metric types (port of ``raft_tpu/distance/distance_types.py``;
values match the reference enum, distance_types.hpp:23-68)."""

from __future__ import annotations

import enum


class DistanceType(enum.IntEnum):
    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    Precomputed = 100


#: the metrics the fused L2 nearest-neighbour kernels serve
L2_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
              DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded)
