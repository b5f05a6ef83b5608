"""The port's gram matrices (``raft_tpu_torch.distance.kernels``) against
raft_tpu on the CPU: the four kernels over several parameter sets, the
factory, ``gram_matrix`` and the kernel types.

Tolerance: rtol 1e-5 plus 1e-5 × gamma × (‖x‖² + ‖y‖²) × K for RBF (its
expanded form rounds the squared distance to about 1e-5 of the norms in
float32) and rtol 1e-5 of the product's Σ|x·y| scale elsewhere (the
packages' products sum in other orders).
"""

import numpy as np
import pytest
import torch

import raft_tpu.distance as jd
import raft_tpu_torch.distance as td
from raft_tpu_torch.core.error import LogicError


@pytest.fixture(scope="module")
def xy():
    rng = np.random.default_rng(162)
    x = rng.standard_normal((29, 11)).astype(np.float32)
    y = rng.standard_normal((17, 11)).astype(np.float32)
    return x, y


CASES = [("LINEAR", 3, 1.0, 0.0), ("POLYNOMIAL", 3, 0.5, 1.0),
         ("POLYNOMIAL", 2, 1.5, -0.5), ("TANH", 3, 0.1, 0.2),
         ("TANH", 3, 0.5, -1.0), ("RBF", 3, 0.1, 0.0), ("RBF", 3, 2.0, 0.0)]


@pytest.mark.parametrize("kernel,degree,gamma,coef0", CASES)
def test_gram_matrix(xy, kernel, degree, gamma, coef0):
    x, y = xy
    tp = td.KernelParams(td.KernelType[kernel], degree, gamma, coef0)
    jp = jd.KernelParams(jd.KernelType[kernel], degree, gamma, coef0)
    got = td.gram_matrix(torch.from_numpy(x), torch.from_numpy(y), tp)
    want = np.asarray(jd.gram_matrix(x, y, jp))
    assert got.shape == want.shape == (29, 17)
    assert got.dtype == torch.float32
    nrm = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    if kernel == "RBF":
        atol = 1e-5 * gamma * nrm * np.abs(want)
    else:
        scale = np.abs(x) @ np.abs(y).T
        # the epilogue's derivative at the product times the product's
        # rounding: degree·(gamma·p + c)^(degree−1)·gamma for POLYNOMIAL,
        # at most gamma for TANH and 1 for LINEAR
        p = x.astype(np.float64) @ y.astype(np.float64).T
        slope = {"LINEAR": 1.0,
                 "POLYNOMIAL": np.abs(degree * (gamma * p + coef0)
                                      ** (degree - 1) * gamma),
                 "TANH": gamma}[kernel]
        atol = 1e-5 * slope * scale
    err = np.abs(got.numpy() - want)
    tol = 1e-5 * np.abs(want) + atol + 1e-7
    assert (err <= tol).all(), float((err / tol).max())


def test_factory_and_classes(xy):
    x, y = xy
    for kt, cls in ((td.KernelType.LINEAR, td.LinearKernel),
                    (td.KernelType.POLYNOMIAL, td.PolynomialKernel),
                    (td.KernelType.TANH, td.TanhKernel),
                    (td.KernelType.RBF, td.RBFKernel)):
        k = td.kernel_factory(td.KernelParams(kt), device="cpu")
        assert type(k) is cls and isinstance(k, td.GramMatrixBase)
        # a call is evaluate; arrays go to the given device
        assert torch.equal(k(x, y), k.evaluate(torch.from_numpy(x),
                                               torch.from_numpy(y)))
    with pytest.raises(LogicError, match="unsupported kernel"):
        td.kernel_factory(td.KernelParams(kernel="sigmoid"))


def test_kernel_types_match():
    assert [k.value for k in td.KernelType] == [k.value for k in
                                                jd.KernelType]
    assert td.KernelParams() .__dict__ == {
        **jd.KernelParams().__dict__,
        "kernel": td.KernelType(jd.KernelParams().kernel.value)}
