"""Kernel B5's plain version (``raft_tpu_torch.kernels.pairwise``) against
the Pallas kernel ``raft_tpu.kernels.pairwise.pairwise_accumulate`` run in
interpret mode, on shapes off the 128-blocks (k ≤ 32 keeps the unrolled
interpret-mode compiles at seconds).

Tolerance: every op's terms are non-negative, so Σ|terms| is the value
itself: the summing ops agree to rtol 1e-5 (other summation order), linf
and the hamming count exactly.
"""

import numpy as np
import pytest
import torch

from raft_tpu.kernels.pairwise import pairwise_accumulate as jax_accumulate
from raft_tpu_torch.kernels import pairwise as pk

EXACT = ("linf", "hamming")
SHAPES = [(37, 45, 13), (1, 130, 32), (129, 3, 1)]


def _inputs(m, n, k, seed, quantize):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((n, k)).astype(np.float32)
    if quantize:   # equal and zero coordinates: hamming and canberra's 0/0
        x, y = np.round(x * 2) / 2, np.round(y * 2) / 2
    return x, y


def _assert_matches(got, ref, op):
    if op in EXACT:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.all(np.abs(got - ref) <= 1e-5 * np.abs(ref) + 1e-30), (
            op, np.abs(got - ref).max())


@pytest.mark.parametrize("op", sorted(pk.OPS))
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plain_matches_pallas_interpret(op, m, n, k):
    x, y = _inputs(m, n, k, m * 1000 + n + k, op in ("hamming", "canberra"))
    ref = np.asarray(jax_accumulate(x, y, op, 3.0, interpret=True))
    got = pk.pairwise_accumulate(torch.from_numpy(x), torch.from_numpy(y),
                                 op, 3.0).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    _assert_matches(got, ref, op)


@pytest.mark.parametrize("p", [1.5, 3.0])
def test_lp_exponent_matches_pallas_interpret(p):
    x, y = _inputs(25, 30, 10, 7, False)
    ref = np.asarray(jax_accumulate(x, y, "lp", p, interpret=True))
    got = pk.pairwise_accumulate(torch.from_numpy(x), torch.from_numpy(y),
                                 "lp", p).numpy()
    _assert_matches(got, ref, "lp")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("op", sorted(pk.OPS))
def test_half_inputs_accumulate_in_float32(op, dtype):
    """Half inputs give the float32 result of their exact widening."""
    x, y = _inputs(20, 33, 17, 3, True)
    xh, yh = torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype)
    got = pk.pairwise_accumulate(xh, yh, op, 3.0)
    ref = pk.pairwise_accumulate(xh.float(), yh.float(), op, 3.0)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref)


def test_linf_propagates_nan_and_canberra_zero_convention():
    x = torch.tensor([[float("nan"), 1.0], [0.0, 0.0]])
    y = torch.tensor([[0.0, 0.0], [0.0, 3.0]])
    linf = pk.pairwise_accumulate(x, y, "linf")
    assert torch.isnan(linf[0]).all() and torch.equal(
        linf[1], torch.tensor([0.0, 3.0]))
    canb = pk.pairwise_accumulate(x, y, "canberra")
    # the NaN coordinate contributes 0 (den > 0 is false), 0/0 gives 0
    assert torch.equal(canb, torch.tensor([[1.0, 0.5], [0.0, 1.0]]))


def test_rows_do_not_depend_on_the_batch():
    x, y = _inputs(64, 50, 9, 5, False)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for op in pk.OPS:
        assert torch.equal(pk.pairwise_accumulate(xt[:7], yt, op),
                           pk.pairwise_accumulate(xt, yt, op)[:7])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    from raft_tpu_torch.core.error import LogicError

    x = torch.zeros(3, 4)
    with pytest.raises(LogicError):
        pk.pairwise_accumulate(x, x, "cosine")
    with pytest.raises(LogicError):
        pk.pairwise_accumulate(x.double(), x.double(), "l1")
    with pytest.raises(LogicError):
        pk.pairwise_accumulate(x, x.half(), "l1")
    with pytest.raises(LogicError):
        pk.pairwise_accumulate(x, torch.zeros(3, 5), "l1")
