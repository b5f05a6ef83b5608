from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors.brute_force import (brute_force_knn,
                                                  fused_l2_knn, knn,
                                                  knn_merge_parts)
from raft_tpu_torch.neighbors.haversine import haversine_knn

__all__ = ["brute_force", "ivf_flat", "ivf_pq", "brute_force_knn",
           "fused_l2_knn", "knn", "knn_merge_parts", "haversine_knn"]
