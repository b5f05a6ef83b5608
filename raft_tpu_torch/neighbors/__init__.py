from raft_tpu_torch.neighbors import (ann_mnmg, ball_cover, brute_force,
                                      epsilon_neighborhood, ivf_flat, ivf_pq,
                                      knn_mnmg)
from raft_tpu_torch.neighbors.brute_force import (brute_force_knn,
                                                  fused_l2_knn, knn,
                                                  knn_merge_parts)
from raft_tpu_torch.neighbors.epsilon_neighborhood import (eps_neighbors,
                                                           eps_neighbors_l2sq)
from raft_tpu_torch.neighbors.haversine import haversine_knn

__all__ = ["ann_mnmg", "ball_cover", "brute_force", "epsilon_neighborhood",
           "ivf_flat", "ivf_pq", "knn_mnmg", "brute_force_knn",
           "fused_l2_knn", "knn", "knn_merge_parts", "eps_neighbors",
           "eps_neighbors_l2sq", "haversine_knn"]
