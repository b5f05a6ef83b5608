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


def _scan_case(nq, n_steps, cap, pq_dim, pq_bits, lut_dtype, n_luts, seed,
               csum=True, fp8_scale=False):
    """A code block of 6 rows plus the empty dummy row 6: full, partly
    filled and empty rows (ids −1 past each row's size), each query's
    steps over them (dummy steps included), per-step bases, the list-side
    sums and, for the fp8 LUT, one scale per query."""
    rng = np.random.default_rng(seed)
    kcb = 1 << pq_bits
    n_rows = 7
    codes = torch.from_numpy(rng.integers(0, kcb, (n_rows * cap, pq_dim)))
    block = tpq._pack_codes(codes, pq_bits).reshape(n_rows, cap, -1)
    sizes = torch.tensor([cap, cap // 2, 1, 0, cap - 1, 3, 0],
                         dtype=torch.int32)
    ids = torch.from_numpy(rng.permutation(10_000)[:n_rows * cap].astype(
        np.int32)).reshape(n_rows, cap)
    ids[torch.arange(cap)[None, :] >= sizes[:, None]] = -1
    phys = torch.from_numpy(rng.integers(0, n_rows, (nq, n_steps)).astype(
        np.int32))
    phys[:, -1] = n_rows - 1                       # a dummy step
    shape = (nq, pq_dim * kcb) if n_luts == 1 else (nq, n_luts, pq_dim * kcb)
    lut = torch.from_numpy(rng.uniform(0.0, 400.0, shape).astype(np.float32)
                           ).to(tpq._LUT_DTYPES[lut_dtype])
    probe_ord = (torch.from_numpy(rng.integers(0, n_luts, (nq, n_steps))
                                  .astype(np.int32)) if n_luts > 1 else None)
    base = torch.from_numpy(rng.uniform(-50, 50, (nq, n_steps)).astype(
        np.float32))
    list_csum = (torch.from_numpy(rng.uniform(-20, 20, (n_rows, cap)).astype(
        np.float32)) if csum else None)
    scale = (torch.from_numpy(rng.uniform(0.5, 3.0, nq).astype(np.float32))
             if fp8_scale else None)
    return block, sizes, ids, phys, lut, probe_ord, base, list_csum, scale


def _per_step_reference(block, sizes, ids, phys, lut, probe_ord, base,
                        list_csum, scale, pq_dim, pq_bits, k, select_min):
    """The per-step path: raw plain scores, the epilogue, the live mask,
    a per-step select_k and the running merge_sorted_runs (or, from
    k >= 24, one select over the stacked masked tiles)."""
    from raft_tpu_torch.neighbors._common import scan_probe_lists

    kcb = 1 << pq_bits

    def score_tile(rows, s):
        lut_t = ivf_pq_lut._lut_slice(lut, probe_ord, s)
        d = ivf_pq_lut._lut_score_plain(block[rows.long()], lut_t, pq_dim,
                                        pq_bits, kcb)
        if scale is not None:
            d = d / scale[:, None]
        d = d + base[:, s, None]
        return d + list_csum[rows.long()] if list_csum is not None else d

    return scan_probe_lists(phys, score_tile, ids, sizes, k,
                            select_min=select_min, dtype=torch.float32,
                            engine="torch", xs=(range(phys.shape[1]),))


@pytest.mark.parametrize("k", [1, 10, 23, 24, 50, 200])
@pytest.mark.parametrize("n_luts", [1, 3])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "float16",
                                       "float8_e4m3"])
def test_scan_twin_equals_per_step_path(lut_dtype, n_luts, k):
    """Scan mode's plain twin plus the one select over the steps' winners
    equals raw plain + epilogue + live mask + per-step select + running
    merge bit for bit — distances, ids and tie order — over dummy steps,
    empty, partly filled and full rows, k below and above 24 and past
    the candidates (k = 200 > S · cap: worst values and id −1)."""
    nq, n_steps, cap, pq_dim, pq_bits = 5, 6, 32, 8, 8
    case = _scan_case(nq, n_steps, cap, pq_dim, pq_bits, lut_dtype, n_luts,
                      seed=k * 10 + n_luts,
                      fp8_scale=lut_dtype == "float8_e4m3")
    block, sizes, ids, phys, lut, probe_ord, base, csum, scale = case
    for select_min in (True, False):
        kk = min(k, cap)
        vals, slots = ivf_pq_lut.lut_scan_topk(
            block, phys, sizes, lut, probe_ord, base, csum, scale, pq_dim,
            pq_bits, 1 << pq_bits, kk, select_min)
        assert vals.shape == (nq, n_steps, kk) and slots.dtype == torch.int32
        got = tpq._select_scanned(vals, slots, phys, ids, k, select_min,
                                  "torch")
        ref = _per_step_reference(*case, pq_dim, pq_bits, k, select_min)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("nq,pq_dim,pq_bits,csum", [
    (1, 8, 8, True),      # a solo query
    (4, 13, 4, False),    # 4 bits, 7 code bytes, no list-side term
    (3, 10, 5, True),     # 5 bits: codes straddle bytes
    (2, 9, 7, False)])
def test_scan_twin_ragged_codes(nq, pq_dim, pq_bits, csum):
    case = _scan_case(nq, 5, 19, pq_dim, pq_bits, "float32", 1,
                      seed=nq + pq_bits, csum=csum)
    block, sizes, ids, phys, lut, probe_ord, base, lcsum, scale = case
    vals, slots = ivf_pq_lut.lut_scan_topk(block, phys, sizes, lut, None,
                                           base, lcsum, None, pq_dim,
                                           pq_bits, 1 << pq_bits, 10)
    got = tpq._select_scanned(vals, slots, phys, ids, 10, True, "torch")
    ref = _per_step_reference(*case, pq_dim, pq_bits, 10, True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    # a dead slot's sentinel fills a short step, at the lowest dead slots
    empty = (phys == 6)
    assert bool(torch.isinf(vals[empty]).all())
    assert torch.equal(slots[empty][0], torch.arange(10, dtype=torch.int32))


def test_scan_refuses_bad_shapes():
    case = _scan_case(2, 3, 16, 8, 8, "float32", 3, seed=1)
    block, sizes, ids, phys, lut, probe_ord, base, csum, scale = case
    with pytest.raises(LogicError, match="probe_ord"):
        ivf_pq_lut.lut_scan_topk(block, phys, sizes, lut, None, base, csum,
                                 None, 8, 8, 256, 4)
    with pytest.raises(LogicError, match="kk"):
        ivf_pq_lut.lut_scan_topk(block, phys, sizes, lut, probe_ord, base,
                                 csum, None, 8, 8, 256, 17)


def test_scan_refuses_the_sequential_sum():
    """The sequential float16 sum is raw mode's (the legacy search scores
    step by step); scan mode takes the float32 and the rounded-once sums."""
    case = _scan_case(2, 3, 16, 8, 8, "float32", 3, seed=1)
    block, sizes, ids, phys, lut, probe_ord, base, csum, scale = case
    for acc in (ivf_pq_lut.SUM_FLOAT32, ivf_pq_lut.SUM_HALF_ONCE):
        ivf_pq_lut.lut_scan_topk(block, phys, sizes, lut, probe_ord, base,
                                 csum, None, 8, 8, 256, 4, acc=acc)
    with pytest.raises(LogicError, match="acc"):
        ivf_pq_lut.lut_scan_topk(block, phys, sizes, lut, probe_ord, base,
                                 csum, None, 8, 8, 256, 4,
                                 acc=ivf_pq_lut.SUM_HALF_SEQUENTIAL)
