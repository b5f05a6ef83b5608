#!/usr/bin/env python3
"""Time kernels B4 (IVF-PQ LUT scoring) and B5 (pairwise accumulation) on
one NVIDIA card, device time only, beside their yardsticks and bounds.

    python3 tools/b4_b5_probe.py                  # needs one CUDA card
    python3 tools/b4_b5_probe.py --ptxas --sass   # also registers, spills
                                                  # and B5's L1 inner loop
    python3 tools/b4_b5_probe.py --root DIR       # time the kernels of the
                                                  # checkout at DIR

``--root`` imports ``raft_tpu_torch`` from another checkout (for example an
unpacked parent commit), so one command can time parent, change, change,
parent on one card; what that checkout lacks (B4's scan mode) is skipped.
Prints one JSON line per measurement:

* ``b5``: every op at the brute-force scan step (1,024 × 16,384 × 128,
  float32; L1 also bfloat16 and float16) and L1 at the serving buckets
  8 and 64, beside the bound (the float32 instruction rate, L1 two
  instructions per element) and ``torch.cdist`` p=1.
* ``b4_step``: raw mode at one probe-scan step (1,024 queries × cap
  2,200 × 64 code bytes, float32 and bfloat16 LUT) beside the bytes bound
  and ``embedding_bag``.
* ``b4_batch``: one query batch's scan (1,024 queries × 40 steps × cap
  2,200, half of the steps dummy, rows 10–100% full): the per-step path
  (40 raw launches, epilogue, live mask, B2, running merge) and, where it
  exists, scan mode plus the one select over the steps; the bound counts
  each distinct row's live code bytes once, the LUT once per query and
  the (nq, S, kk) output.  Also scan mode and the per-step path for the
  first 1 and 8 queries of the batch (small buckets).
* ``ptxas`` (``--ptxas``): ``nvcc -Xptxas -v`` lines of the B2, B4 and B5
  sources; ``sass`` (``--sass``): the opcode histogram of B5's L1 float32
  kernel at the widest tile (``cuobjdump -sass``).

Times are means of CUDA-event-timed repetitions after a warm call,
enqueued while the card sleeps.
"""

import argparse
import collections
import pathlib
import re
import subprocess
import sys

from probe_common import (F32_INSTR_PER_S, HBM_BYTES_PER_S, elapsed_ms, emit,
                          nvidia_smi, ptxas)


def sass(native) -> None:
    """Opcode histogram of B5's L1 float32 kernel at the widest tile (the
    parent has one tile shape), and the FADDs per element of its k-loop."""
    lib = native._target("pairwise")
    cuobjdump = pathlib.Path(native._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    # the mangled name carries the op (0 = L1), float, and the tile TM = 8
    pick = [f for f in funcs if "pairwise_kernel" in f.split("\n")[0]
            and "ILi0EfLi8E" in f.split("\n")[0]]
    if not pick:
        pick = [f for f in funcs if "pairwise_kernel" in f.split("\n")[0]
                and "ILi0EfE" in f.split("\n")[0]]
    if not pick:
        emit({"probe": "sass", "error": "no L1 float32 kernel found"})
        return
    body = pick[0]
    ops = collections.Counter()
    for ln in body.splitlines():
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      ln)
        if m:
            ops[m.group(1).split(".")[0]] += 1
    emit({"probe": "sass", "kernel": body.split("\n")[0].strip()[:120],
          "instructions": sum(ops.values()),
          "opcodes": dict(ops.most_common(20))})


def b5(dev, gen) -> None:
    import torch

    from raft_tpu_torch.kernels import pairwise as pk

    x = torch.randn(1024, 128, generator=gen, device=dev)
    y = torch.randn(16384, 128, generator=gen, device=dev)
    m, k = x.shape
    n = y.shape[0]
    per = {"l1": 2, "l2": 2, "linf": 2, "lp": 5, "hamming": 2, "canberra": 5}
    for op in pk.OPS:
        bound = 1e3 * max(per[op] * m * n * k / F32_INSTR_PER_S,
                          4.0 * (m * k + n * k + m * n) / HBM_BYTES_PER_S)
        emit({"probe": "b5", "op": op, "shape": [m, n, k], "dtype": "float32",
              "ms": elapsed_ms(lambda: pk.pairwise_accumulate(x, y, op, 3.0)),
              "bound_ms": bound})
    for dt in (torch.bfloat16, torch.float16):
        xd, yd = x.to(dt), y.to(dt)
        emit({"probe": "b5", "op": "l1", "shape": [m, n, k],
              "dtype": str(dt)[6:],
              "ms": elapsed_ms(lambda: pk.pairwise_accumulate(xd, yd, "l1"))})
    for mb in (8, 64):
        emit({"probe": "b5", "op": "l1", "shape": [mb, n, k],
              "dtype": "float32",
              "ms": elapsed_ms(lambda: pk.pairwise_accumulate(x[:mb], y,
                                                              "l1")),
              "bound_ms": 1e3 * 2 * mb * n * k / F32_INSTR_PER_S})
    emit({"probe": "b5", "library": "torch.cdist p=1", "shape": [m, n, k],
          "ms": elapsed_ms(lambda: torch.cdist(x, y, p=1.0), 5)})


def pq_block(dev, gen, n_rows=1200, cap=2200, pq_dim=64):
    """A code block at the smoke index's shape (8-bit codes), rows 10–100%
    full, the last one the empty dummy row, and ids −1 past each size."""
    import torch

    codes = torch.randint(0, 256, (n_rows, cap, pq_dim), generator=gen,
                          device=dev, dtype=torch.uint8)
    sizes = (torch.rand(n_rows, generator=gen, device=dev) * 0.9 + 0.1)
    sizes = (sizes * cap).to(torch.int32)
    sizes[-1] = 0
    ids = torch.arange(n_rows * cap, device=dev, dtype=torch.int32).reshape(
        n_rows, cap)
    ids[torch.arange(cap, device=dev)[None, :] >= sizes[:, None]] = -1
    return codes, sizes, ids


def b4(dev, gen) -> None:
    import torch

    from raft_tpu_torch.kernels import ivf_pq_lut as kl
    from raft_tpu_torch.neighbors._common import scan_probe_lists

    nq, cap, pq_dim, kcb, n_steps, k = 1024, 2200, 64, 256, 40, 10
    codes, sizes, ids = pq_block(dev, gen, cap=cap, pq_dim=pq_dim)
    n_rows = codes.shape[0]
    rows = torch.randint(0, n_rows - 1, (nq,), generator=gen, device=dev,
                         dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        lut = (torch.rand(nq, pq_dim * kcb, generator=gen, device=dev)
               * 400).to(dt)
        n_bytes = (int(rows.unique().numel()) * cap * pq_dim
                   + lut.numel() * lut.element_size() + 4.0 * nq * cap)
        emit({"probe": "b4_step", "lut": str(dt)[6:],
              "shape": [nq, cap, pq_dim],
              "ms": elapsed_ms(lambda: kl.lut_score_rows(
                  codes, rows, lut, pq_dim, 8, kcb)),
              "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S})
    lut = torch.rand(nq, pq_dim * kcb, generator=gen, device=dev) * 400
    bag = (codes[rows.long()].long()
           + torch.arange(pq_dim, device=dev) * kcb
           + (torch.arange(nq, device=dev) * pq_dim * kcb)[:, None, None])
    bag = bag.reshape(nq * cap, pq_dim)
    weight = lut.reshape(-1, 1)
    emit({"probe": "b4_step", "library": "embedding_bag",
          "shape": [nq, cap, pq_dim],
          "ms": elapsed_ms(lambda: torch.nn.functional.embedding_bag(
              bag, weight, mode="sum"), 5)})
    del bag

    # one query batch: 20 probed rows and 20 dummy steps per query
    phys = torch.full((nq, n_steps), n_rows - 1, dtype=torch.int32,
                      device=dev)
    phys[:, :20] = torch.randint(0, n_rows - 1, (nq, 20), generator=gen,
                                 device=dev, dtype=torch.int32)
    base = torch.rand(nq, n_steps, generator=gen, device=dev) * 100
    csum = torch.rand(n_rows, cap, generator=gen, device=dev) * 10
    live = sizes[phys.long()].long()
    live_share = float(live.sum()) / (nq * n_steps * cap)

    def per_step():
        def score_tile(r, s):
            d = kl.lut_score_rows(codes, r, lut, pq_dim, 8, kcb)
            return d + base[:, s, None] + csum[r.long()]
        return scan_probe_lists(phys, score_tile, ids, sizes, k, True,
                                torch.float32, engine="cuda",
                                xs=(range(n_steps),))

    out = {"probe": "b4_batch", "shape": [nq, n_steps, cap, pq_dim],
           "live_share_of_scored_pairs": live_share,
           "per_step_path_ms": elapsed_ms(per_step, 5),
           "raw_launches_x40_ms": elapsed_ms(lambda: [
               kl.lut_score_rows(codes, phys[:, s], lut, pq_dim, 8, kcb)
               for s in range(n_steps)], 5)}
    if hasattr(kl, "lut_scan_topk"):
        from raft_tpu_torch.neighbors.ivf_pq import _select_scanned

        def scan():
            return kl.lut_scan_topk(codes, phys, sizes, lut, None, base,
                                    csum, None, pq_dim, 8, kcb, k)

        def fused():
            v, sl = scan()
            return _select_scanned(v, sl, phys, ids, k, True, "cuda")

        got, ref = fused(), per_step()
        out["fused_equals_per_step"] = bool(torch.equal(got[0], ref[0])
                                            and torch.equal(got[1], ref[1]))
        out["scan_ms"] = elapsed_ms(scan)
        out["fused_path_ms"] = elapsed_ms(fused)
        rows_u = phys.unique().long()
        live_codes = float(sizes[rows_u].long().sum())
        n_bytes = (live_codes * (pq_dim + 4) + lut.numel() * 4
                   + 8.0 * nq * n_steps * k + 8.0 * nq * n_steps)
        out["scan_bound_ms"] = 1e3 * n_bytes / HBM_BYTES_PER_S
        for snq in (1, 8):
            sp, sb = phys[:snq].contiguous(), base[:snq].contiguous()
            sl = lut[:snq].contiguous()

            def small_per_step():
                def score_tile(r, s):
                    d = kl.lut_score_rows(codes, r, sl, pq_dim, 8, kcb)
                    return d + sb[:, s, None] + csum[r.long()]
                return scan_probe_lists(sp, score_tile, ids, sizes, k, True,
                                        torch.float32, engine="cuda",
                                        xs=(range(n_steps),))

            out[f"scan_ms_nq{snq}"] = elapsed_ms(lambda: kl.lut_scan_topk(
                codes, sp, sizes, sl, None, sb, csum, None, pq_dim, 8, kcb,
                k))
            out[f"per_step_path_ms_nq{snq}"] = elapsed_ms(small_per_step, 5)
    emit(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from raft_tpu_torch.kernels import native

    if not torch.cuda.is_available():
        print("b4_b5_probe: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"probe": "device", "root": args.root, "nvidia_smi": nvidia_smi()})
    if args.ptxas:
        ptxas(native, ("pairwise", "ivf_pq_lut", "select_k"))
    native.load_all()
    if args.sass:
        sass(native)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b5(dev, gen)
    b4(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
