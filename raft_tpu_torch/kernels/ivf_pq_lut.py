"""Wrapper of kernel B4, the IVF-PQ LUT scoring — ``csrc/ivf_pq_lut.cu``.

Replaces ``raft_tpu/kernels/ivf_pq_lut.py`` ``_lut_score_pallas`` (public
entry ``lut_score``): scores (nq, cap) float32 of bit-packed PQ codes
against one flattened lookup table per query,

    out[q, c] = Σ_m lut[q, m·2^bits + code[q, c, m]],

the codes packed LSB-first at pq_bits (4–8) bits each, the LUT in float32,
bfloat16, float16 or float8 e4m3 and the sum in float32.

One kernel, two modes, one launch counter each:

* :func:`lut_score_rows` (raw mode, counter ``lut_score``): the TPU
  kernel's function on the index's whole (rows, cap, code_bytes) code
  block plus the (nq,) physical row each query scans, read in place (the
  JAX package's signature on already gathered (nq, cap, code_bytes) codes
  is this with ``rows = arange(nq)``).  Its plain version is
  :func:`_lut_score_plain` (unpack, gather, sum in float32 — the JAX
  package's CPU lookup).
* :func:`lut_scan_topk` (scan mode, counter ``lut_scan``, or
  ``lut_scan_tombstones`` with a tombstone bitmap): the whole
  probe scan of a query batch in one launch — every (query, step)'s live
  slots scored, the search's epilogue applied, and each step's best
  ``kk`` (value, slot) kept.  Its plain twin :func:`lut_scan_topk_plain`
  runs the same steps in a loop: raw plain scores, the epilogue, the
  live mask and a stable per-step select.  Given a row's ids
  (``list_indices``) and a tombstone bitmap (``tomb_words``), scan mode
  also drops every slot whose id is set: a dead slot never enters the
  step's best ``kk`` (inside the kernel, so a step with many dead
  candidates among its best loses no live one), and a step's fill
  entries get slot −1.

Both modes take ``acc``, the sum's type (the IVF-PQ search's
``internal_distance_dtype``): :data:`SUM_FLOAT32` sums the float32 terms in
float32; :data:`SUM_HALF_ONCE` rounds each term to float16, sums in
float32 and rounds the sum once to float16 (XLA's float16 reduction on
the CPU, the JAX package's hoisted search); :data:`SUM_HALF_SEQUENTIAL`,
raw mode only, rounds each term to float16 and adds them in float16 in
subspace order (the JAX package's legacy search, which scores step by
step).  The plain versions take it too.  Each sum type is an
instantiation of the kernel of its own.

A tensor on the CPU runs the plain versions; a CUDA tensor launches the
kernel or raises.  The kernel takes a LUT row of any width: a row larger
than what a block's shared memory has left is read from global memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.analysis.registry import audit_program
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.kernels import native

#: the LUT types the kernel is instantiated for, by their C code
LUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.float8_e4m3fn: 3}
#: the sum's type (module docstring), by its C code
SUM_FLOAT32, SUM_HALF_ONCE, SUM_HALF_SEQUENTIAL = 0, 1, 2


def _aligned(lut: torch.Tensor) -> torch.Tensor:
    """The LUT contiguous and 16-byte aligned (the kernel stages its rows
    with bulk copies)."""
    lut = lut.contiguous()
    return lut.clone() if lut.data_ptr() % 16 else lut


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
                     pq_dim: int, pq_bits: int, kcb: int,
                     acc: int = SUM_FLOAT32) -> torch.Tensor:
    """The plain version: (nq, cap, code_bytes) uint8 codes, (nq, pq_dim·kcb)
    LUT → (nq, cap) float32, each LUT entry widened to float32 (exact)
    before the sum, which *acc* types (module docstring)."""
    nq, cap = codes_packed.shape[0], codes_packed.shape[1]
    codes = unpack_codes(codes_packed, pq_dim, pq_bits).long()
    offsets = torch.arange(pq_dim, device=codes.device) * kcb
    flat = (codes + offsets).reshape(nq, cap * pq_dim)
    got = torch.gather(lut.float(), 1, flat).reshape(nq, cap, pq_dim)
    if acc == SUM_HALF_SEQUENTIAL:
        terms = got.half()
        out = torch.zeros((nq, cap), dtype=torch.float16, device=got.device)
        for m in range(pq_dim):
            out = out + terms[..., m]
        return out.float()
    if acc == SUM_HALF_ONCE:
        return torch.sum(got.half().float(), dim=-1).half().float()
    return torch.sum(got, dim=-1)


def _check(list_codes, rows, lut, pq_dim, pq_bits, kcb, acc):
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
    expects(acc in (SUM_FLOAT32, SUM_HALF_ONCE, SUM_HALF_SEQUENTIAL),
            f"lut_score: acc={acc}")


@audit_program(
    "kernels.ivf_pq_lut", transient_bytes=8 << 20,
    notes="B4 raw mode: 64 queries' f32 LUTs against their rows of a "
          "(64, 64, 8 B) code block, pq_dim 8 × 8 bits")
def lut_score_rows(list_codes: torch.Tensor, rows: torch.Tensor,
                   lut: torch.Tensor, pq_dim: int, pq_bits: int, kcb: int,
                   acc: int = SUM_FLOAT32) -> torch.Tensor:
    """Scores (nq, cap) f32 of ``list_codes[rows[q]]`` against ``lut[q]``,
    summed as *acc* says; the kernel reads each query's row of the code
    block in place (a row outside the block is clamped into it)."""
    _check(list_codes, rows, lut, pq_dim, pq_bits, kcb, acc)
    if lut.device.type == "cpu":
        rows = torch.clamp(rows.long(), 0, list_codes.shape[0] - 1)
        return _lut_score_plain(list_codes[rows], lut, pq_dim, pq_bits, kcb,
                                acc)
    expects(lut.device.type == "cuda", f"lut_score: device {lut.device}")
    nq, cap = rows.shape[0], list_codes.shape[1]
    codes = list_codes.contiguous()
    rows = rows.to(torch.int32).contiguous()
    lut = _aligned(lut)
    out = torch.empty((nq, cap), dtype=torch.float32, device=lut.device)
    lib = native.library("ivf_pq_lut")
    err = lib.raft_lut_score(codes.data_ptr(), rows.data_ptr(),
                             lut.data_ptr(), out.data_ptr(), nq,
                             codes.shape[0], cap, codes.shape[2],
                             int(pq_dim), int(pq_bits), LUT_DTYPES[lut.dtype],
                             int(acc), lut.device.index,
                             native.stream_handle(lut.device))
    native.check(lib, err, "lut_score_kernel")
    native.LAUNCHES["lut_score"] += 1
    return out


def _lut_slice(lut: torch.Tensor, probe_ord: Optional[torch.Tensor],
               step: int) -> torch.Tensor:
    """(nq, F) LUT of one step: the query's table, or with *probe_ord* the
    slice of its (nq, P, F) per-probe tables (gathered as raw bits, since
    index kernels need not cover float8)."""
    if probe_ord is None:
        return lut
    bits = lut.view(torch.uint8) if lut.element_size() == 1 else lut
    rq = torch.arange(lut.shape[0], device=lut.device)
    return bits[rq, probe_ord[:, step].long()].view(lut.dtype)


def _check_scan(list_codes, phys, phys_sizes, lut, probe_ord, base,
                list_csum, scale, pq_dim, pq_bits, kcb, kk, list_indices,
                tomb_words, acc):
    nq, n_steps = phys.shape
    cap = list_codes.shape[1]
    expects(list_codes.ndim == 3 and list_codes.dtype == torch.uint8,
            "lut_scan: codes must be (rows, cap, code_bytes) uint8")
    expects(4 <= pq_bits <= 8 and kcb == 1 << pq_bits,
            f"lut_scan: pq_bits={pq_bits}, kcb={kcb}")
    expects(list_codes.shape[2] * 8 >= pq_dim * pq_bits,
            "lut_scan: code_bytes too small for pq_dim · pq_bits")
    expects(phys_sizes.shape == (list_codes.shape[0],),
            "lut_scan: phys_sizes must be (rows,)")
    expects(lut.dtype in LUT_DTYPES, f"lut_scan: LUT type {lut.dtype}")
    expects(lut.shape[0] == nq and lut.shape[-1] == pq_dim * kcb
            and lut.ndim in (2, 3), "lut_scan: lut must be (nq, F) or "
            "(nq, P, F), F = pq_dim · kcb")
    expects((lut.ndim == 3 and lut.shape[1] > 1) == (probe_ord is not None),
            "lut_scan: probe_ord goes with (nq, P > 1, F) per-probe LUTs")
    expects(probe_ord is None or probe_ord.shape == (nq, n_steps),
            "lut_scan: probe_ord must be (nq, S)")
    expects(base.shape == (nq, n_steps), "lut_scan: base must be (nq, S)")
    expects(list_csum is None or list_csum.shape == list_codes.shape[:2],
            "lut_scan: list_csum must be (rows, cap)")
    expects(scale is None or scale.shape == (nq,),
            "lut_scan: scale must be (nq,)")
    expects(1 <= kk <= cap, f"lut_scan: kk={kk} outside [1, cap={cap}]")
    expects((list_indices is None) == (tomb_words is None),
            "lut_scan: list_indices and tomb_words go together")
    expects(list_indices is None
            or list_indices.shape == list_codes.shape[:2],
            "lut_scan: list_indices must be (rows, cap)")
    expects(tomb_words is None or (tomb_words.ndim == 1
                                   and tomb_words.shape[0] >= 1
                                   and tomb_words.dtype in (torch.int32,
                                                            torch.uint32)),
            "lut_scan: tomb_words must be (n_words,) int32 or uint32")
    expects(acc in (SUM_FLOAT32, SUM_HALF_ONCE),
            f"lut_scan: acc={acc} (the sequential float16 sum is raw "
            "mode's)")


def lut_scan_topk_plain(list_codes, phys, phys_sizes, lut, probe_ord, base,
                        list_csum, scale, pq_dim: int, pq_bits: int,
                        kcb: int, kk: int, select_min: bool = True,
                        list_indices: Optional[torch.Tensor] = None,
                        tomb_words: Optional[torch.Tensor] = None, *,
                        acc: int = SUM_FLOAT32
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of scan mode, step by step: (values (nq, S, kk)
    float32, slots (nq, S, kk) int32).  Under a tombstone mask a step's
    candidates are its live slots whose id is not dead, in slot order,
    ahead of the masked ones; fill entries take the sentinel and slot
    −1."""
    from raft_tpu_torch.matrix.select_k import select_k_plain
    from raft_tpu_torch.neighbors._common import tombstone_hit

    _check_scan(list_codes, phys, phys_sizes, lut, probe_ord, base,
                list_csum, scale, pq_dim, pq_bits, kcb, kk, list_indices,
                tomb_words, acc)
    nq, n_steps = phys.shape
    cap = list_codes.shape[1]
    dev = list_codes.device
    lut2 = lut if lut.ndim == 2 or probe_ord is not None else lut[:, 0]
    sentinel = float("inf") if select_min else float("-inf")
    slots = torch.arange(cap, device=dev)
    vals = torch.empty((nq, n_steps, kk), dtype=torch.float32, device=dev)
    pos = torch.empty((nq, n_steps, kk), dtype=torch.int32, device=dev)
    for s in range(n_steps):
        row = phys[:, s].long()
        d = _lut_score_plain(list_codes[row], _lut_slice(lut2, probe_ord, s),
                             pq_dim, pq_bits, kcb, acc)
        if scale is not None:
            d = d / scale[:, None]
        d = d + base[:, s, None]
        if list_csum is not None:
            d = d + list_csum[row]
        live = slots[None, :] < phys_sizes[row][:, None]
        if tomb_words is None:
            d = torch.where(live, d, torch.full_like(d, sentinel))
            vals[:, s], pos[:, s] = select_k_plain(d, kk, select_min)
            continue
        live = live & ~tombstone_hit(list_indices[row], tomb_words)
        # the candidates first, in slot order: a masked slot follows
        # every candidate, also one at the sentinel value
        order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
        d = torch.where(live, d, torch.full_like(d, sentinel))
        v, p = select_k_plain(torch.gather(d, 1, order), kk, select_min)
        cand = p.long() < live.sum(1, keepdim=True)
        vals[:, s] = v
        pos[:, s] = torch.where(cand, torch.gather(order, 1, p.long()),
                                -1).to(torch.int32)
    return vals, pos


def lut_scan_topk(list_codes: torch.Tensor, phys: torch.Tensor,
                  phys_sizes: torch.Tensor, lut: torch.Tensor,
                  probe_ord: Optional[torch.Tensor], base: torch.Tensor,
                  list_csum: Optional[torch.Tensor],
                  scale: Optional[torch.Tensor], pq_dim: int, pq_bits: int,
                  kcb: int, kk: int, select_min: bool = True,
                  list_indices: Optional[torch.Tensor] = None,
                  tomb_words: Optional[torch.Tensor] = None, *,
                  acc: int = SUM_FLOAT32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan mode: each query's S physical rows ``phys`` (nq, S) scored on
    their live slots (below ``phys_sizes[row]``) against the query's LUT
    (nq, F), or with ``probe_ord`` (nq, S) the step's slice of its
    (nq, P, F) per-probe tables; each score finished as
    ``raw / scale[q] + base[q, step] + list_csum[row, slot]`` (the terms
    given); per step the best ``kk`` (value, slot), best-first, ties at
    the lower slot, dead slots (the sentinel) filling a short step.  With
    ``list_indices`` (rows, cap) int32 and ``tomb_words`` (n_words,) a
    slot whose id has its bit set is dead too (the id clamped into the
    bitmap, as ``_common.tombstone_hit`` does), and the fill's slots are
    −1.  The raw sum is typed by *acc* (module docstring).  Returns
    (values (nq, S, kk) float32, slots (nq, S, kk) int32)."""
    if lut.device.type == "cpu":
        return lut_scan_topk_plain(list_codes, phys, phys_sizes, lut,
                                   probe_ord, base, list_csum, scale, pq_dim,
                                   pq_bits, kcb, kk, select_min,
                                   list_indices, tomb_words, acc=acc)
    _check_scan(list_codes, phys, phys_sizes, lut, probe_ord, base,
                list_csum, scale, pq_dim, pq_bits, kcb, kk, list_indices,
                tomb_words, acc)
    expects(lut.device.type == "cuda", f"lut_scan: device {lut.device}")
    tensors = [list_codes, phys, phys_sizes, base] + [
        t for t in (probe_ord, list_csum, scale, list_indices, tomb_words)
        if t is not None]
    expects(all(t.device == lut.device for t in tensors),
            "lut_scan: every tensor on the LUT's device")
    nq, n_steps = phys.shape
    codes = list_codes.contiguous()
    phys = phys.to(torch.int32).contiguous()
    sizes = phys_sizes.to(torch.int32).contiguous()
    lut = _aligned(lut)
    n_luts = 1 if lut.ndim == 2 else lut.shape[1]
    ordp = (probe_ord.to(torch.int32).contiguous() if probe_ord is not None
            else None)
    base = base.to(torch.float32).contiguous()
    csum = (list_csum.to(torch.float32).contiguous() if list_csum is not None
            else None)
    scale = scale.to(torch.float32).contiguous() if scale is not None else None
    ids = (list_indices.to(torch.int32).contiguous()
           if list_indices is not None else None)
    words = tomb_words.contiguous() if tomb_words is not None else None
    out_v = torch.empty((nq, n_steps, kk), dtype=torch.float32,
                        device=lut.device)
    out_s = torch.empty((nq, n_steps, kk), dtype=torch.int32,
                        device=lut.device)
    if nq and n_steps:
        lib = native.library("ivf_pq_lut")
        # a batch too small to fill the card splits each step over `tiles`
        # blocks, which meet through a scratch of runs and zeroed counts
        tiles = lib.raft_lut_scan_tiles(nq, n_steps, codes.shape[1],
                                        lut.device.index)
        if tiles < 0:
            native.check(lib, -tiles, "lut_scan_kernel")
        scratch = counts = None
        if tiles > 1:
            scratch = torch.empty(nq * n_steps * tiles * 128,
                                  dtype=torch.int64, device=lut.device)
            counts = torch.zeros(nq * n_steps, dtype=torch.int32,
                                 device=lut.device)
        err = lib.raft_lut_scan(
            codes.data_ptr(), phys.data_ptr(), sizes.data_ptr(),
            lut.data_ptr(), 0 if ordp is None else ordp.data_ptr(), n_luts,
            base.data_ptr(), 0 if csum is None else csum.data_ptr(),
            0 if scale is None else scale.data_ptr(), out_v.data_ptr(),
            out_s.data_ptr(), nq, n_steps, codes.shape[0], codes.shape[1],
            codes.shape[2], int(pq_dim), int(pq_bits), LUT_DTYPES[lut.dtype],
            int(kk), int(bool(select_min)), tiles,
            0 if scratch is None else scratch.data_ptr(),
            0 if counts is None else counts.data_ptr(),
            0 if ids is None else ids.data_ptr(),
            0 if words is None else words.data_ptr(),
            0 if words is None else words.shape[0], int(acc),
            lut.device.index,
            native.stream_handle(lut.device))
        native.check(lib, err, "lut_scan_kernel")
        native.LAUNCHES["lut_scan" if words is None
                        else "lut_scan_tombstones"] += 1
    return out_v, out_s
