from raft_tpu_torch.matrix.select_k import merge_sorted_runs, select_k

__all__ = ["merge_sorted_runs", "select_k"]
