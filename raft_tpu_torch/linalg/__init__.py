from raft_tpu_torch.linalg.reduce import (one_hot_by_key, reduce_cols_by_key,
                                         reduce_rows_by_key, segment_sum)

__all__ = ["one_hot_by_key", "reduce_cols_by_key", "reduce_rows_by_key",
           "segment_sum"]


def __getattr__(name):
    # legacy alias: the reference forwards raft/linalg/lanczos.hpp to the
    # sparse solver (raft_tpu/linalg/__init__.py:76-83); lazy, so dense-only
    # users do not import the sparse package
    if name in ("lanczos_smallest", "lanczos_largest"):
        from raft_tpu_torch.sparse import solver

        return getattr(solver, name)
    raise AttributeError(
        f"module 'raft_tpu_torch.linalg' has no attribute {name!r}")
