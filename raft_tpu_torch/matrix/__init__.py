"""Matrix manipulation primitives (port of ``raft_tpu/matrix``; reference
raft/matrix/)."""

from raft_tpu_torch.matrix.ops import (
    argmax, argmin, col_wise_sort, copy, diagonal, eye, fill, gather,
    gather_if, linewise_op, matrix_diagonal_inverse, power, print_matrix,
    ratio, reciprocal, reverse, seq_root, set_diagonal, sign_flip,
    slice_matrix, sq_norm, sqrt, threshold, truncate_rows, upper_triangular,
    weighted_ratio, zero_small_values)
from raft_tpu_torch.matrix.select_k import (merge_sorted_parts,
                                            merge_sorted_runs, select_k,
                                            select_max_k, select_min_k)

__all__ = [
    "argmax", "argmin", "col_wise_sort", "copy", "diagonal", "eye", "fill",
    "gather", "gather_if", "linewise_op", "matrix_diagonal_inverse",
    "merge_sorted_parts", "merge_sorted_runs", "power", "print_matrix",
    "ratio", "reciprocal", "reverse", "select_k", "select_max_k",
    "select_min_k", "seq_root", "set_diagonal", "sign_flip", "slice_matrix",
    "sq_norm", "sqrt", "threshold", "truncate_rows", "upper_triangular",
    "weighted_ratio", "zero_small_values"]
