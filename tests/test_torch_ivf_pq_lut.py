"""Parity of kernel B4's plain version with the JAX package's Pallas kernel.

``_lut_score_plain`` (what the port runs for CPU tensors, and what the
CUDA kernel is held to on the card) against
``raft_tpu.kernels.ivf_pq_lut._lut_score_pallas`` in interpret mode, on
the same seeded numpy codes and LUTs: pq_bits 4, 5 and 8, all four LUT
types, nq and cap off the TPU kernel's block multiples.  Tolerance:
1e-5 × Σ_m |lut term| per score (both sum the same float32 terms, in
another association order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.kernels.ivf_pq_lut import _lut_score_pallas
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.kernels import ivf_pq_lut
from raft_tpu_torch.neighbors import ivf_pq as tpq

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16, "float8_e4m3": jnp.float8_e4m3fn}


def _case(nq, cap, pq_dim, pq_bits, lut_dtype, seed):
    rng = np.random.default_rng(seed)
    kcb = 1 << pq_bits
    codes = rng.integers(0, kcb, (nq * cap, pq_dim))
    packed = np.array(jax_pq._pack_codes(jnp.asarray(codes), pq_bits)
                        ).reshape(nq, cap, -1)
    lut = rng.uniform(0.0, 400.0 if lut_dtype == "float8_e4m3" else 50.0,
                      (nq, pq_dim * kcb)).astype(np.float32)
    lut_j = jnp.asarray(lut).astype(_JNP[lut_dtype])
    # torch cannot read ml_dtypes arrays: cross in float32 (exact widening)
    lut_t = torch.from_numpy(np.array(lut_j.astype(jnp.float32))).to(
        tpq._LUT_DTYPES[lut_dtype])
    return packed, lut_j, lut_t, kcb


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "float16",
                                       "float8_e4m3"])
@pytest.mark.parametrize("nq,cap,pq_dim,pq_bits", [
    (5, 37, 8, 8),      # nq and cap off the (8, 128) blocks
    (9, 130, 12, 5),    # 5 bits: codes straddle bytes, 8 code bytes
    (3, 21, 10, 4),     # 4 bits, 5 code bytes
])
def test_plain_matches_pallas_interpret(nq, cap, pq_dim, pq_bits, lut_dtype):
    packed, lut_j, lut_t, kcb = _case(nq, cap, pq_dim, pq_bits, lut_dtype,
                                      nq * cap + pq_bits)
    ref = np.asarray(_lut_score_pallas(jnp.asarray(packed), lut_j,
                                       pq_dim=pq_dim, pq_bits=pq_bits,
                                       kcb=kcb, interpret=True))
    codes_t = torch.from_numpy(packed)
    got = ivf_pq_lut._lut_score_plain(codes_t, lut_t, pq_dim, pq_bits, kcb)
    mag = ivf_pq_lut._lut_score_plain(codes_t, lut_t.float().abs(), pq_dim,
                                      pq_bits, kcb).numpy()
    assert got.shape == (nq, cap) and got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - ref) <= 1e-5 * mag)


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
def test_row_form_reads_the_probed_rows(pq_bits):
    """``lut_score_rows`` on a code block plus one row per query equals
    the gathered form (already gathered codes, ``rows = arange(nq)``) —
    on the CPU both run the plain version, whose arithmetic the kernel
    repeats."""
    rng = np.random.default_rng(pq_bits)
    pq_dim, kcb = 7, 1 << pq_bits
    codes = torch.from_numpy(rng.integers(0, kcb, (6 * 19, pq_dim)))
    block = tpq._pack_codes(codes, pq_bits).reshape(6, 19, -1)
    rows = torch.tensor([5, 0, 3, 3], dtype=torch.int32)
    lut = torch.from_numpy(rng.standard_normal((4, pq_dim * kcb)
                                               ).astype(np.float32))
    got = ivf_pq_lut.lut_score_rows(block, rows, lut, pq_dim, pq_bits, kcb)
    ref = ivf_pq_lut.lut_score_rows(block[rows.long()], torch.arange(4), lut,
                                    pq_dim, pq_bits, kcb)
    assert torch.equal(got, ref)
    unpacked = ivf_pq_lut.unpack_codes(block[rows.long()], pq_dim, pq_bits)
    direct = torch.gather(lut, 1, (unpacked.long() + torch.arange(pq_dim)
                                   * kcb).reshape(4, -1))
    torch.testing.assert_close(got, direct.reshape(4, 19, pq_dim).sum(-1))
    # rows outside the block clamp into it, as the JAX gathers do
    out_of_range = torch.tensor([9, -2, 3, 3], dtype=torch.int32)
    assert torch.equal(ivf_pq_lut.lut_score_rows(block, out_of_range, lut,
                                                 pq_dim, pq_bits, kcb), got)


def test_support_predicate():
    """Every LUT type of the port has a kernel instantiation; any other
    type is refused, on the CPU as on the card."""
    assert set(ivf_pq_lut.LUT_DTYPES) == set(tpq._LUT_DTYPES.values())
    block = torch.zeros(2, 3, 8, dtype=torch.uint8)
    rows = torch.tensor([0, 1])
    ok = ivf_pq_lut.lut_score_rows(block, rows, torch.ones(2, 8 * 256),
                                   8, 8, 256)
    assert torch.equal(ok, torch.full((2, 3), 8.0))
    with pytest.raises(LogicError, match="LUT type"):
        ivf_pq_lut.lut_score_rows(block, rows, torch.ones(
            2, 8 * 256, dtype=torch.float64), 8, 8, 256)
