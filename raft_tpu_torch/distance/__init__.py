from raft_tpu_torch.distance.distance_types import (DISTANCE_TYPES,
                                                    L2_METRICS,
                                                    SUPPORTED_DISTANCES,
                                                    DistanceType,
                                                    KernelParams,
                                                    KernelType)
from raft_tpu_torch.distance.fused_l2_nn import (fused_l2_nn,
                                                 fused_l2_nn_argmin,
                                                 fused_l2_nn_min_reduce)
from raft_tpu_torch.distance.kernels import (GramMatrixBase, LinearKernel,
                                             PolynomialKernel, RBFKernel,
                                             TanhKernel, gram_matrix,
                                             kernel_factory)
from raft_tpu_torch.distance.pairwise import (ACCUMULATE_METRICS, distance,
                                              distance_with_stats,
                                              metric_stats, pairwise_distance)

__all__ = ["ACCUMULATE_METRICS", "DISTANCE_TYPES", "L2_METRICS",
           "SUPPORTED_DISTANCES", "DistanceType", "GramMatrixBase",
           "KernelParams", "KernelType", "LinearKernel", "PolynomialKernel",
           "RBFKernel", "TanhKernel", "distance", "distance_with_stats",
           "fused_l2_nn", "fused_l2_nn_argmin", "fused_l2_nn_min_reduce",
           "gram_matrix", "kernel_factory", "metric_stats",
           "pairwise_distance"]
