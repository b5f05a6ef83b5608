"""Haversine (great-circle) k-nearest neighbours (port of
``raft_tpu/neighbors/haversine.py``; reference
spatial/knn/detail/haversine_distance.cuh ``haversine_knn``)."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors.brute_force import knn


def haversine_knn(index, queries, k: int, **kw
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN in great-circle distance over (lat, lon) rows in radians:
    (distances (nq, k), ids (nq, k)); keywords as :func:`knn`."""
    expects(index.shape[1] == 2 and queries.shape[1] == 2,
            "haversine inputs must be (n, 2) lat/lon radians")
    return knn(index, queries, k, DistanceType.Haversine, **kw)
