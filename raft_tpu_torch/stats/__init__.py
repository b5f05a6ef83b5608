"""Statistics and metrics (port of ``raft_tpu/stats``; reference
raft/stats/)."""

from raft_tpu_torch.stats.metrics import (IC_Type, accuracy,
                                          adjusted_rand_index,
                                          completeness_score,
                                          contingency_matrix, dispersion,
                                          entropy, homogeneity_score,
                                          information_criterion_batched,
                                          kl_divergence, mutual_info_score,
                                          r2_score, rand_index,
                                          regression_metrics,
                                          silhouette_score,
                                          silhouette_score_batched,
                                          trustworthiness_score, v_measure)
from raft_tpu_torch.stats.summary import (col_weighted_mean, cov, histogram,
                                          mean, mean_add, mean_center,
                                          meanvar, minmax, row_weighted_mean,
                                          stddev, sum_, vars_, weighted_mean)

__all__ = ["IC_Type", "accuracy", "adjusted_rand_index", "col_weighted_mean",
           "completeness_score", "contingency_matrix", "cov", "dispersion",
           "entropy", "histogram", "homogeneity_score",
           "information_criterion_batched", "kl_divergence", "mean",
           "mean_add", "mean_center", "meanvar", "minmax",
           "mutual_info_score", "r2_score", "rand_index",
           "regression_metrics", "row_weighted_mean", "silhouette_score",
           "silhouette_score_batched", "stddev", "sum_",
           "trustworthiness_score", "v_measure", "vars_", "weighted_mean"]
