"""Gram (kernel) matrices of SVM-style kernels (port of
``raft_tpu/distance/kernels.py``; reference raft/distance/kernels.cuh and
detail/kernels/{gram_matrix,kernel_matrices,kernel_factory}.cuh):
LINEAR, POLYNOMIAL, RBF and TANH over dense rows, each one product
``x @ y.T`` (cuBLAS on the card, in full float32) and an elementwise
epilogue; RBF through the expanded form ‖x‖² + ‖y‖² − 2x·y, clamped at
0.  Arrays go to *device* (``None``: the card); tensors stay where they
are."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import KernelParams, KernelType
from raft_tpu_torch.distance.pairwise import as_input


class GramMatrixBase:
    """Reference detail/kernels/gram_matrix.cuh ``gram_matrix_base``."""

    def __init__(self, params: KernelParams, *, device=None):
        self.params = params
        self.device = device

    def __call__(self, x, y):
        return self.evaluate(x, y)

    def _inputs(self, x, y):
        return as_input(x, self.device), as_input(y, self.device)

    def linear(self, x, y):
        x, y = self._inputs(x, y)
        return x @ y.T

    def evaluate(self, x, y):  # pragma: no cover - abstract
        raise NotImplementedError


class LinearKernel(GramMatrixBase):
    def evaluate(self, x, y):
        return self.linear(x, y)


class PolynomialKernel(GramMatrixBase):
    def evaluate(self, x, y):
        p = self.params
        return torch.pow(p.gamma * self.linear(x, y) + p.coef0, p.degree)


class TanhKernel(GramMatrixBase):
    def evaluate(self, x, y):
        p = self.params
        return torch.tanh(p.gamma * self.linear(x, y) + p.coef0)


class RBFKernel(GramMatrixBase):
    def evaluate(self, x, y):
        x, y = self._inputs(x, y)
        xn = torch.sum(x * x, dim=1)
        yn = torch.sum(y * y, dim=1)
        sq = torch.clamp_min(xn[:, None] + yn[None, :] - 2.0 * (x @ y.T),
                             0.0)
        return torch.exp(-self.params.gamma * sq)


_KERNELS = {KernelType.LINEAR: LinearKernel,
            KernelType.POLYNOMIAL: PolynomialKernel,
            KernelType.RBF: RBFKernel, KernelType.TANH: TanhKernel}


def kernel_factory(params: KernelParams, *, device=None) -> GramMatrixBase:
    """Reference detail/kernels/kernel_factory.cuh ``KernelFactory::create``."""
    cls = _KERNELS.get(params.kernel)
    if cls is None:
        raise LogicError(f"unsupported kernel {params.kernel}")
    return cls(params, device=device)


def gram_matrix(x, y, params: KernelParams, *, device=None) -> torch.Tensor:
    """The kernel matrix K(x_i, y_j), (m, n)."""
    return kernel_factory(params, device=device).evaluate(x, y)
