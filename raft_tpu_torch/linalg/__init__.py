from raft_tpu_torch.linalg.reduce import (one_hot_by_key, reduce_cols_by_key,
                                         reduce_rows_by_key, segment_sum)

__all__ = ["one_hot_by_key", "reduce_cols_by_key", "reduce_rows_by_key",
           "segment_sum"]
