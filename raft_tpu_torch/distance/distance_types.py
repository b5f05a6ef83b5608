"""Distance metric types (port of ``raft_tpu/distance/distance_types.py``;
values match the reference enum, distance_types.hpp:23-68, and the metric
names are pylibraft's, pairwise_distance.pyx:65-91)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


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


#: pylibraft's metric-name table (pairwise_distance.pyx:65-91)
DISTANCE_TYPES = {
    "l2": DistanceType.L2SqrtUnexpanded,
    "sqeuclidean": DistanceType.L2Unexpanded,
    "euclidean": DistanceType.L2SqrtUnexpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "chebyshev": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "cosine": DistanceType.CosineExpanded,
    "lp": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "minkowski": DistanceType.LpUnexpanded,
    "russellrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
    "haversine": DistanceType.Haversine,
}

#: the names pylibraft's dense path supports (pairwise_distance.pyx:88-91)
SUPPORTED_DISTANCES = [
    "euclidean", "l1", "cityblock", "l2", "inner_product", "chebyshev",
    "minkowski", "canberra", "kl_divergence", "correlation", "russellrao",
    "hellinger", "lp", "hamming", "jensenshannon", "cosine", "sqeuclidean",
]


class KernelType(enum.Enum):
    """The gram kernels (reference distance_types.hpp:70
    ``kernels::KernelType``)."""

    LINEAR = "linear"
    POLYNOMIAL = "polynomial"
    RBF = "rbf"
    TANH = "tanh"


@dataclass
class KernelParams:
    """Reference distance_types.hpp:72-86 ``kernels::KernelParams``."""

    kernel: KernelType = KernelType.LINEAR
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0
