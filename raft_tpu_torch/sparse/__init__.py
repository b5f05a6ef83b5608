"""Sparse primitives (port of ``raft_tpu/sparse``; reference raft/sparse/):
fixed-capacity COO/CSR containers, conversions, structural ops, sparse
linear algebra, sparse pairwise distances, sparse neighbours, and the MST
and Lanczos solvers.

Every container is a fixed-capacity buffer with the JAX package's padding
convention: padded COO entries carry ``row == n_rows, col == 0, val ==
0``, so segment reductions over n_rows segments drop them, gathers stay
in bounds and sums are unaffected; a CSR keeps ``indptr[-1] == nnz`` with
tail padding past nnz.
"""

from raft_tpu_torch.sparse.types import COO, CSR
from raft_tpu_torch.sparse import convert, linalg, op  # noqa: F401
from raft_tpu_torch.sparse import distance, neighbors  # noqa: F401
from raft_tpu_torch.sparse.convert import (adj_to_csr, coo_to_csr,
                                           coo_to_dense, csr_to_coo,
                                           csr_to_dense, dense_to_coo,
                                           dense_to_csr, from_triplets)
from raft_tpu_torch.sparse.op import (coo_max_duplicates, coo_remove_scalar,
                                      coo_remove_zeros, coo_sort,
                                      coo_sum_duplicates, csr_row_op,
                                      csr_row_slice)
from raft_tpu_torch.sparse.linalg import (EllHybrid, coo_degree, csr_add,
                                          csr_degree, csr_to_ell,
                                          csr_transpose, ell_spmv,
                                          fit_embedding, laplacian,
                                          row_normalize, spmm, spmv,
                                          symmetrize, weak_cc)
from raft_tpu_torch.sparse.solver import (MSTResult, boruvka_mst,
                                          lanczos_largest, lanczos_smallest)

__all__ = ["COO", "CSR", "EllHybrid", "MSTResult", "adj_to_csr",
           "boruvka_mst", "coo_degree", "coo_max_duplicates",
           "coo_remove_scalar", "coo_remove_zeros", "coo_sort",
           "coo_sum_duplicates", "coo_to_csr", "coo_to_dense", "csr_add",
           "csr_degree", "csr_row_op", "csr_row_slice", "csr_to_coo",
           "csr_to_dense", "csr_to_ell", "csr_transpose", "dense_to_coo",
           "dense_to_csr", "ell_spmv", "fit_embedding", "from_triplets",
           "lanczos_largest", "lanczos_smallest", "laplacian",
           "row_normalize", "spmm", "spmv", "symmetrize", "weak_cc"]
