from raft_tpu_torch.cluster.kmeans import (EMPartials, KeyValuePair,
                                          centroids_from_sums, fused_em_step,
                                          min_cluster_and_distance,
                                          update_centroids)
from raft_tpu_torch.cluster.kmeans_balanced import build_hierarchical

__all__ = ["EMPartials", "KeyValuePair", "build_hierarchical",
           "centroids_from_sums", "fused_em_step", "min_cluster_and_distance",
           "update_centroids"]
