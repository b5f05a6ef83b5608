"""K-means parameter types (port of ``raft_tpu/cluster/kmeans_types.py``;
reference raft/cluster/kmeans_types.hpp:26-75)."""

from __future__ import annotations

import enum
from dataclasses import dataclass

from raft_tpu_torch.distance.distance_types import DistanceType


class InitMethod(enum.Enum):
    KMeansPlusPlus = "kmeans++"
    Random = "random"
    Array = "array"


@dataclass
class KMeansParams:
    n_clusters: int = 8
    init: InitMethod = InitMethod.KMeansPlusPlus
    max_iter: int = 300
    tol: float = 1e-4
    verbosity: int = 4
    seed: int = 0
    metric: DistanceType = DistanceType.L2Expanded
    n_init: int = 1
    oversampling_factor: float = 2.0
    batch_samples: int = 2048
    batch_centroids: int = 0
    inertia_check: bool = False
