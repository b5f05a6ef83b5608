"""Clustering: k-means, balanced k-means and multi-GPU k-means
(:mod:`.kmeans_mnmg`) (port of ``raft_tpu/cluster``; reference
raft/cluster/) and single-linkage HAC (:mod:`.single_linkage`)."""

from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.cluster.kmeans import (EMPartials, KMeans, KMeansOutput,
                                           KeyValuePair, centroids_from_sums,
                                           cluster_cost, fit, fit_predict,
                                           fused_em_enabled, fused_em_step,
                                           init_plus_plus, init_random,
                                           kmeans_plus_plus,
                                           min_cluster_and_distance,
                                           pack_em_partials, predict,
                                           sample_centroids,
                                           shuffle_and_gather, transform,
                                           unpack_em_partials,
                                           update_centroids)
from raft_tpu_torch.cluster import kmeans_mnmg  # noqa: F401
from raft_tpu_torch.cluster.kmeans_balanced import (adjust_centers,
                                                    build_clusters,
                                                    build_hierarchical)
from raft_tpu_torch.cluster.single_linkage import (LinkageDistance,
                                                   SingleLinkageOutput,
                                                   build_sorted_mst,
                                                   single_linkage)

__all__ = ["EMPartials", "InitMethod", "KMeans", "KMeansOutput",
           "KMeansParams", "KeyValuePair", "LinkageDistance",
           "SingleLinkageOutput", "build_sorted_mst", "single_linkage", "adjust_centers",
           "build_clusters", "build_hierarchical", "centroids_from_sums",
           "cluster_cost", "fit", "fit_predict", "fused_em_enabled",
           "fused_em_step", "init_plus_plus", "init_random",
           "kmeans_plus_plus", "min_cluster_and_distance",
           "pack_em_partials", "predict", "sample_centroids",
           "shuffle_and_gather", "transform", "unpack_em_partials",
           "update_centroids"]
