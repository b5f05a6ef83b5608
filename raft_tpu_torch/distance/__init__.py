from raft_tpu_torch.distance.distance_types import DistanceType, L2_METRICS

__all__ = ["DistanceType", "L2_METRICS"]
