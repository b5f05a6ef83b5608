"""BLAS-level operations (port of ``raft_tpu/linalg/blas.py``; reference
raft/linalg/{gemm,gemv,axpy,dot,transpose}.cuh, which call cuBLAS).  The
products are ``torch.matmul`` (cuBLAS on the card), as the JAX package
leaves them to XLA's ``dot``; float32 products run in full float32 unless
the caller turns TF32 on (``torch.backends.cuda.matmul.allow_tf32``).
Tensors stay where they are."""

from __future__ import annotations

import torch


def gemm(a, b, alpha=1.0, beta=0.0, c=None, trans_a: bool = False,
         trans_b: bool = False) -> torch.Tensor:
    """C = alpha·op(A)·op(B) + beta·C (reference linalg/gemm.cuh)."""
    a = a.T if trans_a else a
    b = b.T if trans_b else b
    out = torch.matmul(a, b)
    if alpha != 1.0:
        out = out * alpha
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


def gemv(a, x, alpha=1.0, beta=0.0, y=None,
         trans_a: bool = False) -> torch.Tensor:
    """y = alpha·op(A)·x + beta·y (reference linalg/gemv.cuh)."""
    a = a.T if trans_a else a
    out = torch.matmul(a, x)
    if alpha != 1.0:
        out = out * alpha
    if y is not None and beta != 0.0:
        out = out + beta * y
    return out


def axpy(alpha, x, y) -> torch.Tensor:
    """y + alpha·x (reference linalg/axpy.cuh)."""
    return y + alpha * x


def dot(x, y) -> torch.Tensor:
    """Inner product of the flattened inputs (reference linalg/dot.cuh)."""
    return torch.dot(x.reshape(-1), y.reshape(-1))


def transpose(a) -> torch.Tensor:
    """Out-of-place transpose (reference linalg/transpose.cuh)."""
    return a.T.contiguous()
