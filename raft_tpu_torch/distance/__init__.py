from raft_tpu_torch.distance.distance_types import (DISTANCE_TYPES,
                                                    L2_METRICS,
                                                    SUPPORTED_DISTANCES,
                                                    DistanceType)
from raft_tpu_torch.distance.pairwise import (ACCUMULATE_METRICS, distance,
                                              distance_with_stats,
                                              metric_stats, pairwise_distance)

__all__ = ["ACCUMULATE_METRICS", "DISTANCE_TYPES", "L2_METRICS",
           "SUPPORTED_DISTANCES", "DistanceType", "distance",
           "distance_with_stats", "metric_stats", "pairwise_distance"]
