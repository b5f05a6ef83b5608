from raft_tpu_torch.matrix.select_k import (merge_sorted_parts,
                                            merge_sorted_runs, select_k,
                                            select_max_k, select_min_k)

__all__ = ["merge_sorted_parts", "merge_sorted_runs", "select_k",
           "select_max_k", "select_min_k"]
