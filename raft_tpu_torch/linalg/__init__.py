"""Dense linear algebra (port of ``raft_tpu/linalg``; reference
raft/linalg/): elementwise operations, reductions, BLAS, matrix-vector
broadcasts and factorizations, in plain PyTorch (cuBLAS and cuSOLVER on
the card), as the JAX package leaves them to XLA."""

from raft_tpu_torch.linalg.blas import axpy, dot, gemm, gemv, transpose
from raft_tpu_torch.linalg.decompositions import (
    cholesky_r1_update, eig_dc, eig_jacobi, eig_sel_dc,
    evaluate_svd_by_reconstruction, lstsq_eig, lstsq_qr, lstsq_svd_jacobi,
    lstsq_svd_qr, qr_get_q, qr_get_qr, rsvd_fixed_rank, rsvd_perc, svd_eig,
    svd_jacobi, svd_qr, svd_reconstruction)
from raft_tpu_torch.linalg.elementwise import (
    add, add_scalar, binary_op, divide, divide_scalar, map_, map_offset,
    multiply, multiply_scalar, power, power_scalar, sqrt, subtract,
    subtract_scalar, ternary_op, unary_op)
from raft_tpu_torch.linalg.matrix_vector import (
    binary_add, binary_div, binary_div_skip_zero, binary_mult, binary_sub,
    matrix_vector_op, matrix_vector_op2)
from raft_tpu_torch.linalg.reduce import (
    coalesced_reduction, col_norm, map_reduce, map_then_reduce,
    mean_squared_error, norm, normalize, one_hot_by_key, reduce,
    reduce_cols_by_key, reduce_rows_by_key, row_norm, segment_sum,
    strided_reduction, use_one_hot_engine)
from raft_tpu_torch.linalg.types import Apply, NormType, axis_for

__all__ = [
    "Apply", "NormType", "add", "add_scalar", "axis_for", "axpy",
    "binary_add", "binary_div", "binary_div_skip_zero", "binary_mult",
    "binary_op", "binary_sub", "cholesky_r1_update", "coalesced_reduction",
    "col_norm", "divide", "divide_scalar", "dot", "eig_dc", "eig_jacobi",
    "eig_sel_dc", "evaluate_svd_by_reconstruction", "gemm", "gemv",
    "lstsq_eig", "lstsq_qr", "lstsq_svd_jacobi", "lstsq_svd_qr", "map_",
    "map_offset", "map_reduce", "map_then_reduce", "matrix_vector_op",
    "matrix_vector_op2", "mean_squared_error", "multiply",
    "multiply_scalar", "norm", "normalize", "one_hot_by_key", "power",
    "power_scalar", "qr_get_q", "qr_get_qr", "reduce", "reduce_cols_by_key",
    "reduce_rows_by_key", "row_norm", "rsvd_fixed_rank", "rsvd_perc",
    "segment_sum", "sqrt", "strided_reduction", "subtract",
    "subtract_scalar", "svd_eig", "svd_jacobi", "svd_qr",
    "svd_reconstruction", "ternary_op", "transpose", "unary_op",
    "use_one_hot_engine"]


def __getattr__(name):
    # legacy alias: the reference forwards raft/linalg/lanczos.hpp to the
    # sparse solver (raft_tpu/linalg/__init__.py:76-83); lazy, so dense-only
    # users do not import the sparse package
    if name in ("lanczos_smallest", "lanczos_largest"):
        from raft_tpu_torch.sparse import solver

        return getattr(solver, name)
    raise AttributeError(
        f"module 'raft_tpu_torch.linalg' has no attribute {name!r}")
