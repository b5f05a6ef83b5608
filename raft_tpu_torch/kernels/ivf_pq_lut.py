"""Wrapper of kernel B4, the IVF-PQ LUT scoring — ``csrc/ivf_pq_lut.cu``.

Replaces ``raft_tpu/kernels/ivf_pq_lut.py`` ``_lut_score_pallas`` (public
entry ``lut_score``): scores (nq, cap) float32 of bit-packed PQ codes
against one flattened lookup table per query,

    out[q, c] = Σ_m lut[q, m·2^bits + code[q, c, m]],

the codes packed LSB-first at pq_bits (4–8) bits each, the LUT in float32,
bfloat16, float16 or float8 e4m3 and the sum in float32.

:func:`lut_score_rows` is the form the probe scan calls: the index's whole
(rows, cap, code_bytes) code block plus the (nq,) physical row each query
scans, read in place by the kernel (the JAX package's signature on
already gathered (nq, cap, code_bytes) codes is this with
``rows = arange(nq)``).  A tensor on the CPU runs the plain version
:func:`_lut_score_plain` (unpack, gather, sum in float32 — the JAX
package's CPU lookup); a CUDA tensor launches the kernel or raises.  The
kernel takes a LUT row of any width: a row larger than one block's shared
memory is staged in chunks of subspaces.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.kernels import native

#: the LUT types the kernel is instantiated for, by their C code
LUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.float8_e4m3fn: 3}


def unpack_codes(packed: torch.Tensor, pq_dim: int, pq_bits: int
                 ) -> torch.Tensor:
    """(…, code_bytes) uint8 → (…, pq_dim) int32 codes of the LSB-first
    bitstream: code m is bits [m·bits, (m+1)·bits), taken from the (at
    most two) bytes it lies in."""
    if pq_bits == 8:
        return packed[..., :pq_dim].to(torch.int32)
    dev = packed.device
    off = torch.arange(pq_dim, device=dev) * pq_bits
    lo = (off >> 3)
    wide = torch.cat([packed, packed.new_zeros(packed.shape[:-1] + (1,))],
                     dim=-1).to(torch.int32)
    pair = wide[..., lo] | (wide[..., lo + 1] << 8)
    return (pair >> (off & 7).to(torch.int32)) & ((1 << pq_bits) - 1)


def _lut_score_plain(codes_packed: torch.Tensor, lut: torch.Tensor,
                     pq_dim: int, pq_bits: int, kcb: int) -> torch.Tensor:
    """The plain version: (nq, cap, code_bytes) uint8 codes, (nq, pq_dim·kcb)
    LUT → (nq, cap) float32, each LUT entry widened to float32 (exact)
    before the sum."""
    nq, cap = codes_packed.shape[0], codes_packed.shape[1]
    codes = unpack_codes(codes_packed, pq_dim, pq_bits).long()
    offsets = torch.arange(pq_dim, device=codes.device) * kcb
    flat = (codes + offsets).reshape(nq, cap * pq_dim)
    got = torch.gather(lut.float(), 1, flat)
    return torch.sum(got.reshape(nq, cap, pq_dim), dim=-1)


def _check(list_codes, rows, lut, pq_dim, pq_bits, kcb):
    expects(list_codes.ndim == 3 and list_codes.dtype == torch.uint8,
            "lut_score: codes must be (rows, cap, code_bytes) uint8")
    expects(4 <= pq_bits <= 8 and kcb == 1 << pq_bits,
            f"lut_score: pq_bits={pq_bits}, kcb={kcb}")
    expects(list_codes.shape[2] * 8 >= pq_dim * pq_bits,
            "lut_score: code_bytes too small for pq_dim · pq_bits")
    expects(rows.ndim == 1 and not rows.dtype.is_floating_point,
            "lut_score: rows must be (nq,) integers")
    expects(lut.ndim == 2 and lut.shape == (rows.shape[0], pq_dim * kcb),
            "lut_score: lut must be (nq, pq_dim · kcb)")
    expects(list_codes.device == rows.device == lut.device,
            "lut_score: codes, rows and lut on one device")
    expects(lut.dtype in LUT_DTYPES, f"lut_score: LUT type {lut.dtype}")


def lut_score_rows(list_codes: torch.Tensor, rows: torch.Tensor,
                   lut: torch.Tensor, pq_dim: int, pq_bits: int, kcb: int
                   ) -> torch.Tensor:
    """Scores (nq, cap) f32 of ``list_codes[rows[q]]`` against ``lut[q]``;
    the kernel reads each query's row of the code block in place (a row
    outside the block is clamped into it)."""
    _check(list_codes, rows, lut, pq_dim, pq_bits, kcb)
    if lut.device.type == "cpu":
        rows = torch.clamp(rows.long(), 0, list_codes.shape[0] - 1)
        return _lut_score_plain(list_codes[rows], lut, pq_dim, pq_bits, kcb)
    expects(lut.device.type == "cuda", f"lut_score: device {lut.device}")
    nq, cap = rows.shape[0], list_codes.shape[1]
    codes = list_codes.contiguous()
    rows = rows.to(torch.int32).contiguous()
    lut = lut.contiguous()
    out = torch.empty((nq, cap), dtype=torch.float32, device=lut.device)
    lib = native.library("ivf_pq_lut")
    err = lib.raft_lut_score(codes.data_ptr(), rows.data_ptr(),
                             lut.data_ptr(), out.data_ptr(), nq,
                             codes.shape[0], cap, codes.shape[2],
                             int(pq_dim), int(pq_bits), LUT_DTYPES[lut.dtype],
                             lut.device.index,
                             native.stream_handle(lut.device))
    native.check(lib, err, "lut_score_kernel")
    native.LAUNCHES["lut_score"] += 1
    return out
