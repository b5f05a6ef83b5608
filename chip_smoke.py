#!/usr/bin/env python3
"""Drive raft_tpu_torch's IVF-Flat, IVF-PQ and brute-force serving paths on
one NVIDIA card.

    python3 chip_smoke.py            # full size; needs one CUDA card

The deployment is ann-benchmarks' sift-128-euclidean at full size, with
data of the same shape made from a seed (a clustered Gaussian mixture in
float32, since the SIFT files are not in the repository): 1,000,000 base
vectors × 128, 10,000 queries, k = 10, L2.  IVF-Flat with n_lists = 1024
(RAFT's ANN bench entry ``raft_ivf_flat.nlist1024``), n_probes = 20,
kmeans_n_iters = 20, kmeans_trainset_fraction = 0.5.  IVF-PQ with the
JAX package's defaults at n_lists = 1024: pq_dim 64, pq_bits 8,
PER_SUBSPACE codebooks, the PCA-balanced rotation, pq_trainset_cap
262,144; searched with n_probes = 20 and the float32 LUT.  Brute force:
exact kNN under L1 ("l1", cuML's ``NearestNeighbors(algorithm="brute",
metric="manhattan")``) over the same 1,000,000 × 128 dataset, which is
the index (512 MB on the card), in index tiles of 16,384 rows.

Phases, one JSON line each:

1. device — the card, its power limit (nvidia-smi), torch and CUDA; then
   the kernels are built from ``raft_tpu_torch/kernels/csrc`` (nvcc, one
   process per source, all at once).
2. kernels — B1, B2 and B3 against their plain PyTorch versions on the
   card at the main paths' shapes (B1 and B3 also at the PQ codebook
   training shape, 262,144 × 256 × 2) and at ragged edge shapes, with
   their median device times, the plain versions', one PyTorch library
   call's where one computes the same function, and the least time the
   card could take (bound).  B3 also for all 64 PQ subspaces in one
   launch (64 × 262,144 × 256 × 2) against its plain twin and, bit for
   bit, against 64 launches of one subspace, and its M-step alone at the
   balancing-EM shape; B2 also at a brute-force scan step (1,024 ×
   16,384, k = 10, ``torch.topk`` as the yardstick), all on float32,
   float16 and bfloat16 rows.
3. IVF-Flat main path — launch counts reset, then ``ivf_flat.build``,
   ``ServeEngine(...).warmup()`` and ragged coalesced ``search()`` calls
   covering all queries; the counts are read right after and B1, B2, B3
   must have launched.  Checks: coalesced results equal solo ``search``
   per request, recall@10 against exact neighbours (``torch.cdist`` +
   ``torch.topk``, the checker) of 1,000 queries, and the kernel path's
   recall within 0.002 of the plain path's.
4. IVF-PQ main path — the same with ``ivf_pq.build`` and an IVF-PQ
   ``ServeEngine``: B1, B2, B3 and B4 must have launched, and the build
   at most ``MAX_PQ_BUILD_B3`` times B3.  Checks:
   coalesced equals solo, kernel-path recall@10 within 0.002 of the plain
   path's at the float32 LUT and, for a solo search, at the fp8 LUT.
5. B4 against its plain version at the IVF-PQ main path's step shape
   (1,024 queries × the index's capacity, pq_dim 64, 8 bits) for all four
   LUT types, and at ragged shapes (nq 1 and 37, capacities off the
   256-slot block, pq_bits 4/5/7 with odd code bytes); ``embedding_bag``
   is the library yardstick.
6. brute-force main path — launch counts reset, then
   ``ServeEngine(x, 10, metric="l1", max_batch=1024).warmup()`` and the
   same ragged calls; B5 and B2 must have launched.  Checks: coalesced
   equals solo ``knn`` per request bit for bit; on 1,000 queries, ids
   equal ``torch.cdist(p=1)`` + ``torch.topk`` (the checker) except at
   near ties and distances to rtol 1e-5; on every query, the kernel path
   against the plain path (``engine="torch"``) in the same way.
7. ``pairwise_distance`` — every name of ``SUPPORTED_DISTANCES`` at
   1,024 × 16,384 × 128 against ``engine="torch"`` (rtol 1e-5, atol
   1e-5); the seven B5 metrics must launch B5 and the others must not.
8. B5 against its plain version: all six ops × float32 / bfloat16 /
   float16 at the scan step (bucket 1,024 × tile 16,384 × 128), ragged
   shapes (m 1 and 37, n 1, 129 and 16,385, k 1, 3, 127 and 960, one NaN
   in x), and the rows of a 37-row batch equal to the first 37 of the
   1,024-row one bit for bit; each op's time beside the plain version's,
   ``torch.cdist``'s (p = 1, 2 without the matrix-product form, ∞, 3 and
   0; Canberra has none) and the bound, counted from at least
   ``B5_OPS_PER_ELEMENT`` float32 instructions per element at the card's
   instruction rate against the bytes moved.
9. the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

``--profile`` adds device time by kernel over one 1,024-query super-batch
of each engine (``torch.profiler``).

Any failed check exits non-zero before the last line.  Float32 products
run in full float32 (TF32 off for matmul and cuDNN).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: the card's published peaks (H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12   # float32 outside the tensor cores
#: float32 instructions issued per second outside the tensor cores (the
#: flop rate counts a fused multiply-add as two)
F32_INSTR_PER_S = F32_FLOP_PER_S / 2

#: cycles the card sleeps before a timed call, ahead of the host's
#: enqueue (about 1 ms)
SLEEP_CYCLES = 2_000_000
#: which TPU kernel each port kernel replaces
REPLACES = {
    "fused_l2_nn": "raft_tpu/kernels/fused_l2nn.py:86",
    "fused_l2_nn_partials": "raft_tpu/kernels/fused_l2nn.py:187",
    "select_k": "raft_tpu/kernels/select_k.py:155",
    "lut_score": "raft_tpu/kernels/ivf_pq_lut.py:98",
    "pairwise_accumulate": "raft_tpu/kernels/pairwise.py:81",
}
SOURCE = {
    "fused_l2_nn": "raft_tpu_torch/kernels/csrc/fused_l2nn.cu",
    "fused_l2_nn_partials": "raft_tpu_torch/kernels/csrc/fused_l2nn.cu",
    "select_k": "raft_tpu_torch/kernels/csrc/select_k.cu",
    "lut_score": "raft_tpu_torch/kernels/csrc/ivf_pq_lut.cu",
    "pairwise_accumulate": "raft_tpu_torch/kernels/csrc/pairwise.cu",
}
#: B3 launches an IVF-PQ build may take: the coarse balancing EM (20 + 5
#: iterations) and one per codebook Lloyd iteration (20) for all subspaces
MAX_PQ_BUILD_B3 = 50
#: the kernels each main path must launch
PATH_KERNELS = {
    "ivf_flat": ("fused_l2_nn", "fused_l2_nn_partials", "select_k"),
    "ivf_pq": ("fused_l2_nn", "fused_l2_nn_partials", "select_k",
               "lut_score"),
    "brute_force": ("pairwise_accumulate", "select_k"),
}
#: B5's float32 instructions per element, at least (L1: a subtract and an
#: add with an abs modifier; l2: a subtract and a fused multiply-add; linf
#: a subtract and a NaN-propagating max; lp a subtract, log2, multiply,
#: exp2 and add; hamming a compare and an add; canberra a subtract, an add
#: of two abs, a reciprocal and multiply, and an add)
B5_OPS_PER_ELEMENT = {"l1": 2, "l2": 2, "linf": 2, "lp": 5, "hamming": 2,
                      "canberra": 5}


class CheckFailed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, device, reps: int = 5) -> float:
    """Median milliseconds of *fn* over *reps* calls after one warm call
    (CUDA events on the card: device time, unless *fn* waits on the
    host)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            # the card sleeps while the host enqueues the call, so the
            # events time the device's work, not the wrapper's launch
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(n_bytes: float, ops: float, ops_per_s: float = F32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mixture(gen, n, dim, centers, noise, device):
    import torch

    comp = torch.randint(0, centers.shape[0], (n,), generator=gen,
                         device=device)
    return centers[comp] + noise * torch.randn(n, dim, generator=gen,
                                               device=device)


def near_ties(x, y, rows: int = 1 << 15, of_norms: bool = False):
    """Per row of x: whether its two nearest rows of y (float64) lie
    within 1e-5 relative of each other — of the nearer distance, or with
    *of_norms* of ‖x‖² + ‖y‖² of the nearer row, the scale at which the
    float32 expanded form rounds (a row that is itself a centre has a
    distance of 0 and a neighbour a rounding step away)."""
    import torch

    yd = y.double()
    yn = (yd * yd).sum(1)
    out = []
    for r in range(0, x.shape[0], rows):
        xd = x[r:r + rows].double()
        xn = (xd * xd).sum(1)
        d = xn[:, None] + yn[None] - 2 * xd @ yd.T
        two = torch.topk(d, 2, dim=1, largest=False)
        scale = (xn + yn[two.indices[:, 0]] if of_norms
                 else two.values[:, 0].clamp_min(1e-30))
        out.append((two.values[:, 1] - two.values[:, 0]) <= 1e-5 * scale)
    return torch.cat(out)


def check_labels(name, idx, ref_idx, x, y, of_norms: bool = False):
    diff = idx != ref_idx
    n_diff = int(diff.sum())
    if n_diff:
        ties = near_ties(x, y, of_norms=of_norms)
        check(not bool((diff & ~ties).any()),
              f"{name}: labels differ outside near ties")
    return n_diff


def kernel_phase(device, x, queries, centers_probe, rep: int):
    """Each kernel against its plain version; returns the kernels' rows."""
    import torch

    from raft_tpu_torch.distance import fused_l2_nn as plain_nn
    from raft_tpu_torch.kernels import fused_l2nn, select_k as ksel
    from raft_tpu_torch.matrix.select_k import select_k_plain

    rows = {}
    gen = torch.Generator(device=device).manual_seed(11)

    # B1 at the list-assignment shape (n × n_lists × dim) and a ragged one
    y = centers_probe
    m, d = x.shape
    k = y.shape[0]
    val, idx = fused_l2nn.fused_l2_nn(x, y)
    pv, pi = plain_nn.fused_l2_nn_plain(x, y)
    n_diff = check_labels("fused_l2_nn", idx, pi, x, y)
    err = float((val - pv).abs().max())
    check(torch.allclose(val, pv, rtol=1e-5, atol=1e-4),
          "fused_l2_nn: values beyond rtol 1e-5, atol 1e-4")
    xr = torch.randn(1000, 100, generator=gen, device=device)
    yr = torch.randn(1000, 100, generator=gen, device=device)
    rv, ri = fused_l2nn.fused_l2_nn(xr, yr)
    prv, pri = plain_nn.fused_l2_nn_plain(xr, yr)
    n_diff_r = check_labels("fused_l2_nn ragged", ri, pri, xr, yr)
    check(torch.allclose(rv, prv, rtol=1e-5, atol=1e-4),
          "fused_l2_nn ragged: values beyond tolerance")
    ms = timed(lambda: fused_l2nn.fused_l2_nn(x, y), device, rep)
    plain_ms = timed(lambda: plain_nn.fused_l2_nn_plain(x, y), device, 3)
    b, by = bound_ms(4.0 * (m * d + k * d + 2 * m), 2.0 * m * k * d)
    rows["fused_l2_nn"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=b, bound_by=by, library_ms=None)
    emit({"phase": "kernel", "name": "fused_l2_nn", "shape": [m, k, d],
          "label_diffs_near_ties": n_diff, "ragged_shape": [1000, 1000, 100],
          "ragged_label_diffs_near_ties": n_diff_r, **rows["fused_l2_nn"]})

    # B3 at the balancing-EM shape (trainset × n_lists × dim)
    xt = x[: m // 2]
    mt = xt.shape[0]
    out = fused_l2nn.fused_l2_nn_partials(xt, y)
    ref = plain_nn.fused_l2_nn_partials_plain(xt, y)
    n_diff3 = check_labels("fused_l2_nn_partials", out[1], ref[1], xt, y)
    sums_ref, wsum_ref = plain_nn.cluster_partials_plain(xt, out[1], k)
    abs_ref, _ = plain_nn.cluster_partials_plain(xt.abs(), out[1], k)
    err3 = float((out[2] - sums_ref).abs().max())
    check(bool(((out[2] - sums_ref).abs() <= 1e-4 * abs_ref + 1e-6).all()),
          "fused_l2_nn_partials: sums beyond 1e-4 of the members' |sum|")
    check(torch.allclose(out[3], wsum_ref, rtol=1e-4),
          "fused_l2_nn_partials: weights beyond rtol 1e-4")
    again = fused_l2nn.fused_l2_nn_partials(xt, y)
    check(torch.equal(again[2], out[2]), "fused_l2_nn_partials: sums "
          "differ between two runs")
    ms = timed(lambda: fused_l2nn.fused_l2_nn_partials(xt, y), device, rep)
    plain_ms = timed(lambda: plain_nn.fused_l2_nn_partials_plain(xt, y),
                     device, 3)
    # the M-step alone (per-chunk partials from B1's labels) beside its
    # bytes bound: one read of x and the labels, the partials written
    m_ms = (timed(lambda: fused_l2nn._launch_cluster_partials(
        xt, out[1], None, k), device, rep) if device.type == "cuda" else None)
    m_bound, _ = bound_ms(4.0 * (mt * d + mt + k * d + k), 0.0)
    b, by = bound_ms(4.0 * (mt * d + 2 * k * d + 2 * mt + k),
                     2.0 * mt * k * d + mt * d)
    rows["fused_l2_nn_partials"] = dict(max_abs_err=err3, ms=ms,
                                        plain_ms=plain_ms, bound_ms=b,
                                        bound_by=by, library_ms=None,
                                        m_step_ms=m_ms,
                                        m_step_bound_ms=m_bound)
    emit({"phase": "kernel", "name": "fused_l2_nn_partials",
          "shape": [mt, k, d], "label_diffs_near_ties": n_diff3,
          "sums_bitwise_repeat": True, **rows["fused_l2_nn_partials"]})

    # B1 and B3 at the PQ codebook-training shape: one Lloyd step of one
    # subspace (pq_trainset_cap × 2^8 codewords × ds = 2)
    xc = torch.randn(262144, 2, generator=gen, device=device)
    yc = xc[torch.randperm(262144, generator=gen, device=device)[:256]]
    cv, ci = fused_l2nn.fused_l2_nn(xc, yc)
    pcv, pci = plain_nn.fused_l2_nn_plain(xc, yc)
    n_diff_c = check_labels("fused_l2_nn codebook", ci, pci, xc, yc)
    check(torch.allclose(cv, pcv, rtol=1e-5, atol=1e-5),
          "fused_l2_nn codebook: values beyond rtol 1e-5, atol 1e-5")
    outc = fused_l2nn.fused_l2_nn_partials(xc, yc)
    sums_c, wsum_c = plain_nn.cluster_partials_plain(xc, outc[1], 256)
    abs_c, _ = plain_nn.cluster_partials_plain(xc.abs(), outc[1], 256)
    check(bool(((outc[2] - sums_c).abs() <= 1e-4 * abs_c + 1e-6).all())
          and torch.allclose(outc[3], wsum_c, rtol=1e-4),
          "fused_l2_nn_partials codebook: partials beyond tolerance")
    for name, fn, plain_fn in (
            ("fused_l2_nn", fused_l2nn.fused_l2_nn,
             plain_nn.fused_l2_nn_plain),
            ("fused_l2_nn_partials", fused_l2nn.fused_l2_nn_partials,
             plain_nn.fused_l2_nn_partials_plain)):
        rows[name].update(
            codebook_shape=[262144, 256, 2],
            codebook_ms=timed(lambda: fn(xc, yc), device, rep),
            codebook_plain_ms=timed(lambda: plain_fn(xc, yc), device, rep))
    rows["fused_l2_nn"]["codebook_max_abs_err"] = float(
        (cv - pcv).abs().max())
    rows["fused_l2_nn_partials"]["codebook_max_abs_err"] = float(
        (outc[2] - sums_c).abs().max())
    emit({"phase": "kernel", "name": "fused_l2_nn+partials@codebook",
          "shape": [262144, 256, 2], "label_diffs_near_ties": n_diff_c,
          **{f"{n}_{key}": rows[n][key]
             for n in ("fused_l2_nn", "fused_l2_nn_partials")
             for key in ("codebook_ms", "codebook_plain_ms",
                         "codebook_max_abs_err")}})
    rows["fused_l2_nn_partials"].update(
        b3_batched_phase(device, gen, rep, min(262144, m)))

    # B2 at the coarse top-n_probes shape, a probe-tile shape, a
    # brute-force scan step, and a matrix of ties, NaN and ±inf; float32,
    # float16 and bfloat16 rows
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.kernels import pairwise as pk
    from raft_tpu_torch.neighbors.ivf_flat import _coarse_distances

    coarse = _coarse_distances(queries, y, DistanceType.L2Expanded)
    cases = {
        "coarse": (coarse, 20),
        "probe_tile": (torch.rand(1024, 2448, generator=gen, device=device)
                       * 100.0, 10),
        # a brute-force scan step: L1 distances of 1,024 queries to 16,384
        # rows (B5's output)
        "scan": (pk.pairwise_accumulate(queries[:1024], x[:16384], "l1"),
                 10),
    }
    ties = torch.randint(-40, 40, (1000, 1000), generator=gen,
                         device=device).float() / 4.0
    flat = ties.view(-1)
    spots = torch.randperm(flat.numel(), generator=gen, device=device)[:30000]
    flat[spots[:10000]] = float("nan")
    flat[spots[10000:20000]] = float("inf")
    flat[spots[20000:]] = float("-inf")
    cases["ties_nan_inf"] = (ties, 128)
    info = {}
    for name, (vals, kk) in cases.items():
        for dt in (torch.float32, torch.float16, torch.bfloat16):
            vd = vals.to(dt)
            for select_min in (True, False):
                kv, kp = ksel.select_k_blockwise(vd, kk, select_min)
                pv2, pp = select_k_plain(vd, kk, select_min)
                check(torch.equal(kp, pp),
                      f"select_k {name} {dt}: positions differ")
                check(torch.equal(torch.nan_to_num(kv.float(), nan=0.5),
                                  torch.nan_to_num(pv2.float(), nan=0.5)),
                      f"select_k {name} {dt}: values differ")
        info[name] = [list(vals.shape), kk]
    by_shape = {}
    for name in ("coarse", "probe_tile", "scan"):
        vals, kk = cases[name]
        nq, nl = vals.shape
        b, by = bound_ms(4.0 * nq * nl + 8.0 * nq * kk, float(nq * nl))
        by_shape[name] = dict(
            shape=[nq, nl, kk], bound_ms=b, bound_by=by,
            ms=timed(lambda: ksel.select_k_blockwise(vals, kk), device, rep),
            plain_ms=timed(lambda: select_k_plain(vals, kk), device, rep),
            library_ms=timed(lambda: torch.topk(vals, kk, dim=1,
                                                largest=False), device, rep),
            half_ms={str(dt).split(".")[1]: timed(
                lambda h=vals.to(dt): ksel.select_k_blockwise(h, kk), device,
                rep) for dt in (torch.float16, torch.bfloat16)})
    # the brute-force scan shape is where B2 spends most of its time
    scan = by_shape["scan"]
    rows["select_k"] = dict(max_abs_err=0.0, ms=scan["ms"],
                            plain_ms=scan["plain_ms"],
                            bound_ms=scan["bound_ms"],
                            bound_by=scan["bound_by"],
                            library_ms=scan["library_ms"], by_shape=by_shape)
    emit({"phase": "kernel", "name": "select_k", "shape": scan["shape"],
          "cases": info, "positions_bit_identical": True,
          "library": "torch.topk", **rows["select_k"]})
    return rows


def b3_batched_phase(device, gen, rep: int, n: int):
    """B3 at the IVF-PQ codebook step: all 64 subspaces of n (the build's
    pq_trainset_cap, 262,144) × 2 against 256 codewords in one launch,
    against its plain twin and against 64 launches of one subspace each
    (bit for bit); returns the fields for B3's row."""
    import torch

    from raft_tpu_torch.distance import fused_l2_nn as plain_nn
    from raft_tpu_torch.kernels import fused_l2nn

    s, k, ds = 64, 256, 2
    xs = torch.randn(s, n, ds, generator=gen, device=device)
    ys = torch.stack([xs[i, torch.randperm(n, generator=gen,
                                           device=device)[:k]]
                      for i in range(s)])
    out = fused_l2nn.fused_l2_nn_partials_batched(xs, ys)
    ref = plain_nn.fused_l2_nn_partials_batched_plain(xs, ys)
    n_diff, err = 0, 0.0
    for i in range(s):
        n_diff += check_labels("fused_l2_nn_partials batched", out[1][i],
                               ref[1][i], xs[i], ys[i], of_norms=True)
        sums, wsum = plain_nn.cluster_partials_plain(xs[i], out[1][i], k)
        mag, _ = plain_nn.cluster_partials_plain(xs[i].abs(), out[1][i], k)
        check(bool(((out[2][i] - sums).abs() <= 1e-5 * mag + 1e-6).all())
              and torch.equal(out[3][i], wsum),
              "fused_l2_nn_partials batched: partials beyond 1e-5 of the "
              "members' |sum|")
        err = max(err, float((out[2][i] - sums).abs().max()))
        one = fused_l2nn.fused_l2_nn_partials(xs[i], ys[i])
        check(all(torch.equal(a[i], b) for a, b in zip(out, one)),
              "fused_l2_nn_partials batched: differs from the one-subspace "
              "launch")
    again = fused_l2nn.fused_l2_nn_partials_batched(xs, ys)
    check(all(torch.equal(a, b) for a, b in zip(again, out)),
          "fused_l2_nn_partials batched: differs between two runs")
    # the least work: x and the centres read, labels, values and partials
    # written; (ds + 4) float32 instructions per (row, centre) pair (ds
    # fused multiply-adds, the expanded form, the clamp and the compare)
    b, by = bound_ms(4.0 * (s * n * ds + 2 * s * k * ds + 2 * s * n + s * k),
                     float(s) * n * k * (ds + 4), F32_INSTR_PER_S)
    row = dict(
        batched_shape=[s, n, k, ds], batched_max_abs_err=err,
        batched_label_diffs_near_ties=n_diff, batched_bound_ms=b,
        batched_bound_by=by,
        batched_ms=timed(lambda: fused_l2nn.fused_l2_nn_partials_batched(
            xs, ys), device, rep),
        batched_plain_ms=timed(
            lambda: plain_nn.fused_l2_nn_partials_batched_plain(xs, ys),
            device, 3),
        per_subspace_x64_ms=timed(lambda: [
            fused_l2nn.fused_l2_nn_partials(xs[i], ys[i]) for i in range(s)],
            device, 3))
    emit({"phase": "kernel", "name": "fused_l2_nn_partials@batched",
          "equals_per_subspace_launches": True, "sums_bitwise_repeat": True,
          **row})
    return row


def recall(ids, truth):
    hits = (ids[:, :, None] == truth[:, None, :]).any(-1).sum()
    return float(hits) / truth.numel()


def profile_serve(path, eng, q_host, device, top: int = 12):
    """Device time by kernel over one full super-batch (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = q_host[:eng.max_batch]
    eng.search([batch])   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.search([batch])   # the wall time, without the profiler
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.search([batch])
        torch.cuda.synchronize()
    # kernel rows only (the CPU-op rows repeat their kernels' time)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    emit({"phase": "profile", "path": path, "queries": len(batch),
          "wall_ms": wall_ms, "device_ms": device_ms,
          "kernel_launches": sum(e.count for e in events),
          "device_busy_share": device_ms / wall_ms if wall_ms else None,
          "top": [{"name": e.key[:80], "calls": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in events[:top]]})


def ragged_calls(q_host, n_queries: int):
    """Ragged requests covering every query, eight to a call."""
    pattern = [1, 7, 64, 300, 1500, 33, 128, 900, 2, 511]
    reqs, start, j = [], 0, 0
    while start < n_queries:
        size = min(pattern[j % len(pattern)], n_queries - start)
        reqs.append(q_host[start:start + size])
        start += size
        j += 1
    return reqs, [reqs[c:c + 8] for c in range(0, len(reqs), 8)]


def serve_path(path, device, eng, k, reqs, calls, n_queries):
    """Serve every query through *eng* after its warmup; the launch counts
    were reset before the path began and are read right after serving."""
    import torch

    from raft_tpu_torch.kernels import native

    t0 = time.perf_counter()
    n_warm = eng.warmup()
    warm_s = time.perf_counter() - t0
    call_s, results = [], []
    t_serve = time.perf_counter()
    for call in calls:
        t0 = time.perf_counter()
        results.extend(eng.search(call))
        call_s.append(time.perf_counter() - t0)
    serve_s = time.perf_counter() - t_serve
    launches = dict(native.LAUNCHES)
    emit({"phase": "serve", "path": path, "requests": len(reqs),
          "calls": len(calls), "queries": n_queries,
          "max_batch": eng.max_batch, "warmup_signatures": n_warm,
          "warmup_s": warm_s, "serve_s": serve_s,
          "qps": n_queries / serve_s,
          "call_ms_p50": float(np.percentile(call_s, 50) * 1e3),
          "call_ms_p99": float(np.percentile(call_s, 99) * 1e3),
          "stats": eng.stats, "launches": launches,
          "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                             if device.type == "cuda" else None)})
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"{path} main path never launched {name}")
    for q, (d, i) in zip(reqs, results):
        check(isinstance(d, np.ndarray), f"a request failed: {d!r}")
        check(d.shape == (q.shape[0], k) and np.isfinite(d).all(),
              "results must be finite (n, k)")
    return results, launches


def emit_build(path, index, build_s, build_info):
    emit({"phase": "build", "path": path, "seconds": build_s,
          "n_lists": index.n_lists, "capacity": index.capacity,
          "padding_fraction": index.padding_fraction, **build_info})


def check_coalesced(path, search_fn, reqs, results):
    for q, (d, i) in zip(reqs, results):
        sd, si = search_fn(q)
        check(np.array_equal(d, sd.cpu().numpy())
              and np.array_equal(i, si.cpu().numpy()),
              f"{path}: coalesced results differ from solo search")


def _reset(device):
    import torch

    from raft_tpu_torch.kernels import native

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    native.reset_launches()


def _synced_seconds(device, t0) -> float:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _first_ids(results, nr, device):
    import torch

    return torch.as_tensor(np.concatenate([r[1] for r in results])[:nr],
                           device=device).long()


def ivf_flat_path(device, x, reqs, calls, n_queries, truth, qr, n_lists,
                  n_probes, k):
    """The IVF-Flat main path and its checks; returns (engine, launches)."""
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import ServeEngine

    _reset(device)
    t0 = time.perf_counter()
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=n_lists), x,
                           device=device)
    build_s = _synced_seconds(device, t0)
    check(index.size == x.shape[0], "build: index does not hold every row")
    params = ivf_flat.SearchParams(n_probes=n_probes)
    emit_build("ivf_flat", index, build_s,
               {"physical_rows": int(index.list_data.shape[0]),
                "index_bytes": index.list_data.numel() * 4})
    eng = ServeEngine(index, k, params, max_batch=1024)
    results, launches = serve_path("ivf_flat", device, eng, k, reqs, calls,
                                   n_queries)
    check_coalesced("ivf_flat",
                    lambda q: ivf_flat.search(params, index, q, k),
                    reqs, results)
    nr = qr.shape[0]
    ids_kernel = _first_ids(results, nr, device)
    _, ids_plain = ivf_flat.search(params, index, qr, k, engine="torch")
    r_kernel = recall(ids_kernel, truth)
    r_plain = recall(ids_plain.long(), truth)
    emit({"phase": "checks", "path": "ivf_flat",
          "coalesced_equals_solo": True, "recall_at_10": r_kernel,
          "recall_at_10_plain_path": r_plain, "recall_queries": nr})
    check(abs(r_kernel - r_plain) <= 0.002,
          "ivf_flat: kernel-path recall is not within 0.002 of the plain "
          "path's")
    return eng, launches


def ivf_pq_path(device, x, reqs, calls, n_queries, truth, qr, n_lists,
                n_probes, k):
    """The IVF-PQ main path and its checks; returns (index, engine,
    launches)."""
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.serve import ServeEngine

    _reset(device)
    t0 = time.perf_counter()
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=n_lists), x,
                         device=device)
    build_s = _synced_seconds(device, t0)
    check(index.size == x.shape[0], "build: index does not hold every row")
    # the coarse trainer's balancing EM and one batched launch per
    # codebook Lloyd iteration for all pq_dim subspaces
    b3_build = native.LAUNCHES["fused_l2_nn_partials"]
    check(0 < b3_build <= MAX_PQ_BUILD_B3,
          f"ivf_pq build launched B3 {b3_build} times (at most "
          f"{MAX_PQ_BUILD_B3})")
    leaf_bytes = sum(getattr(index, f).numel()
                     * getattr(index, f).element_size()
                     for f in ivf_pq.ARRAY_FIELDS)
    params = ivf_pq.SearchParams(n_probes=n_probes)
    emit_build("ivf_pq", index, build_s,
               {"b3_launches": b3_build,
                "pq_dim": index.pq_dim, "pq_bits": index.pq_bits,
                "physical_rows": int(index.list_codes.shape[0]),
                "code_bytes_per_row": int(index.list_codes.shape[2]),
                "codes_bytes": index.list_codes.numel(),
                "index_bytes": leaf_bytes})
    eng = ServeEngine(index, k, params, max_batch=1024)
    results, launches = serve_path("ivf_pq", device, eng, k, reqs, calls,
                                   n_queries)
    check_coalesced("ivf_pq", lambda q: ivf_pq.search(params, index, q, k),
                    reqs, results)
    nr = qr.shape[0]
    ids_kernel = _first_ids(results, nr, device)
    _, ids_plain = ivf_pq.search(params, index, qr, k, engine="torch")
    r_kernel = recall(ids_kernel, truth)
    r_plain = recall(ids_plain.long(), truth)
    p8 = ivf_pq.SearchParams(n_probes=n_probes, lut_dtype="float8_e4m3")
    _, ids8 = ivf_pq.search(p8, index, qr, k)
    _, ids8_plain = ivf_pq.search(p8, index, qr, k, engine="torch")
    r8, r8_plain = recall(ids8.long(), truth), recall(ids8_plain.long(),
                                                      truth)
    emit({"phase": "checks", "path": "ivf_pq",
          "coalesced_equals_solo": True, "recall_at_10": r_kernel,
          "recall_at_10_plain_path": r_plain,
          "recall_at_10_fp8": r8, "recall_at_10_fp8_plain_path": r8_plain,
          "fp8_batch_cap": ivf_pq.hoisted_batch_cap(index, n_probes,
                                                    "float8_e4m3"),
          "recall_queries": nr})
    check(abs(r_kernel - r_plain) <= 0.002,
          "ivf_pq: kernel-path recall is not within 0.002 of the plain "
          "path's")
    check(abs(r8 - r8_plain) <= 0.002,
          "ivf_pq fp8: kernel-path recall is not within 0.002 of the plain "
          "path's")
    return index, eng, launches


def lut_phase(device, index, queries, rep: int):
    """B4 against its plain version at the IVF-PQ main path's step shape
    for all four LUT types, and at ragged shapes; returns B4's row."""
    import torch

    from raft_tpu_torch.kernels import ivf_pq_lut as kl
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.ivf_flat import _coarse_distances

    gen = torch.Generator(device=device).manual_seed(13)

    def compare(codes, rows, lut, pq_dim, bits, what):
        kcb = 1 << bits
        got = kl.lut_score_rows(codes, rows, lut, pq_dim, bits, kcb)
        gathered = codes[rows.long()]
        ref = kl._lut_score_plain(gathered, lut, pq_dim, bits, kcb)
        mag = kl._lut_score_plain(gathered, lut.float().abs(), pq_dim, bits,
                                  kcb)
        check(bool(((got - ref).abs() <= 1e-5 * mag).all()),
              f"lut_score {what}: beyond 1e-5 × Σ|lut term| of the plain "
              "version")
        return float((got - ref).abs().max())

    # the main path's step shape: each query's nearest list's first chunk
    nq = min(1024, queries.shape[0])
    pq_dim, bits = index.pq_dim, index.pq_bits
    kcb = 1 << bits
    cap, code_bytes = index.capacity, index.list_codes.shape[2]
    probe = torch.argmin(_coarse_distances(queries[:nq], index.centers,
                                           index.metric), dim=1)
    rows = index.chunk_table[probe, 0].contiguous()
    codes = index.list_codes
    # queries that share a row share its code bytes: the kernel reads rows
    # in place, so the bound counts each distinct row once
    distinct = int(rows.unique().numel())
    by_dtype, errs = {}, []
    for name, dt in ivf_pq._LUT_DTYPES.items():
        lut = (torch.rand(nq, pq_dim * kcb, generator=gen, device=device)
               * 440.0).to(dt)
        errs.append(compare(codes, rows, lut, pq_dim, bits, name))
        itemsize = lut.element_size()
        b, by = bound_ms(distinct * cap * code_bytes
                         + nq * pq_dim * kcb * itemsize
                         + 4.0 * nq * cap + 4.0 * nq, float(nq * cap * pq_dim))
        by_dtype[name] = dict(
            max_abs_err=errs[-1], bound_ms=b, bound_by=by,
            ms=timed(lambda: kl.lut_score_rows(codes, rows, lut, pq_dim,
                                               bits, kcb), device, rep),
            plain_ms=timed(lambda: kl._lut_score_plain(
                codes[rows.long()], lut, pq_dim, bits, kcb), device, 3))
    # the library yardstick, float32: one embedding_bag over the flattened
    # LUT, bag (q, c) holding the pq_dim entries q·F + m·kcb + code
    lut32 = (torch.rand(nq, pq_dim * kcb, generator=gen, device=device)
             * 440.0)
    unpacked = kl.unpack_codes(codes[rows.long()], pq_dim, bits).long()
    ids = (unpacked + (torch.arange(pq_dim, device=device) * kcb)
           + (torch.arange(nq, device=device) * pq_dim * kcb)[:, None, None])
    ids = ids.reshape(nq * cap, pq_dim)
    weight = lut32.reshape(-1, 1)
    bag = torch.nn.functional.embedding_bag(ids, weight, mode="sum")
    ref = kl.lut_score_rows(codes, rows, lut32, pq_dim, bits, kcb)
    check(torch.allclose(bag.reshape(nq, cap), ref, rtol=1e-5, atol=1e-3),
          "embedding_bag yardstick disagrees with B4")
    lib_ms = timed(lambda: torch.nn.functional.embedding_bag(
        ids, weight, mode="sum"), device, rep)
    del ids, unpacked

    # ragged shapes: nq 1 and 37, capacities off the 256-slot block,
    # pq_bits 4/5/7 with odd code bytes, and LUT rows beyond one block's
    # shared memory (staged in subspace chunks)
    ragged = []
    for rnq, rcap, rdim, rbits in ((1, 1000, 64, 8), (37, 257, 64, 8),
                                   (37, 1001, 13, 4), (5, 999, 10, 5),
                                   (37, 333, 17, 7), (3, 300, 480, 8),
                                   (4, 130, 2000, 5)):
        rk = 1 << rbits
        rcodes = torch.randint(0, rk, (7 * rcap, rdim), generator=gen,
                               device=device)
        block = ivf_pq._pack_codes(rcodes, rbits).reshape(7, rcap, -1)
        rrows = torch.randint(0, 7, (rnq,), generator=gen, device=device,
                              dtype=torch.int32)
        for name, dt in ivf_pq._LUT_DTYPES.items():
            lut = (torch.rand(rnq, rdim * rk, generator=gen, device=device)
                   * 440.0).to(dt)
            errs.append(compare(block, rrows, lut, rdim, rbits,
                                f"ragged {rnq}×{rcap}×{rdim}@{rbits} {name}"))
        ragged.append([rnq, rcap, rdim, rbits, int(block.shape[2])])
    row = dict(max_abs_err=max(errs), ms=by_dtype["float32"]["ms"],
               plain_ms=by_dtype["float32"]["plain_ms"],
               bound_ms=by_dtype["float32"]["bound_ms"],
               bound_by=by_dtype["float32"]["bound_by"], library_ms=lib_ms,
               by_lut_dtype=by_dtype)
    emit({"phase": "kernel", "name": "lut_score",
          "shape": [nq, cap, code_bytes, pq_dim, bits],
          "distinct_rows": distinct,
          "ragged_shapes_nq_cap_pqdim_bits_codebytes": ragged,
          "library": "embedding_bag", **row})
    return row


def check_knn(name, d, i, ref_d, ref_i, tie_d):
    """(nq, k) distances and ids against a reference: distances to rtol
    1e-5; ids equal except at near ties, where a position's distance in
    *tie_d* (the checker's best k + 1 per row) lies within 1e-5 relative of
    a neighbour's.  Returns the number of ids that differ at near ties."""
    import torch

    check(bool(((d - ref_d).abs() <= 1e-5 * ref_d.abs() + 1e-6).all()),
          f"{name}: distances beyond rtol 1e-5")
    kk = d.shape[1]
    gap = (tie_d[:, 1:] - tie_d[:, :-1]).abs() <= 1e-5 * tie_d[:, 1:].abs()
    tied = torch.zeros_like(d, dtype=torch.bool)
    tied |= gap[:, :kk]                 # tied with the next candidate
    tied[:, 1:] |= gap[:, :kk - 1]      # tied with the previous one
    diff = i.long() != ref_i.long()
    check(not bool((diff & ~tied).any()),
          f"{name}: ids differ outside near ties")
    return int(diff.sum())


def brute_force_path(device, x, queries, reqs, calls, n_queries, qr, k):
    """The brute-force main path (exact kNN under L1 over the whole
    dataset) and its checks; returns (engine, launches)."""
    import torch

    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.serve import ServeEngine

    _reset(device)
    eng = ServeEngine(x, k, metric="l1", max_batch=1024, device=device)
    results, launches = serve_path("brute_force", device, eng, k, reqs,
                                   calls, n_queries)
    check_coalesced("brute_force",
                    lambda q: brute_force.knn(x, q, k, "l1", device=device),
                    reqs, results)
    nr = qr.shape[0]
    got_d = torch.as_tensor(np.concatenate([r[0] for r in results]),
                            device=device)
    got_i = _first_ids(results, n_queries, device)
    # the checker: every L1 distance, then the k + 1 smallest per row
    t0 = time.perf_counter()
    ref = torch.cdist(qr, x, p=1.0)
    ref_d, ref_i = torch.topk(ref, k + 1, dim=1, largest=False)
    del ref
    checker_s = _synced_seconds(device, t0)
    ties_checker = check_knn("brute_force vs torch.cdist", got_d[:nr],
                             got_i[:nr], ref_d[:, :k], ref_i[:, :k], ref_d)
    # the plain path's k + 1 best tell its near ties at rank k
    t0 = time.perf_counter()
    plain_d, plain_i = brute_force.knn(x, queries, k + 1, "l1",
                                       device=device, engine="torch")
    plain_s = _synced_seconds(device, t0)
    ties_plain = check_knn("brute_force kernel vs plain path", got_d, got_i,
                           plain_d[:, :k], plain_i[:, :k], plain_d)
    emit({"phase": "checks", "path": "brute_force", "metric": "l1",
          "coalesced_equals_solo": True, "checker_queries": nr,
          "checker": "torch.cdist(p=1) + torch.topk",
          "checker_s": checker_s,
          "id_diffs_at_near_ties_vs_checker": ties_checker,
          "plain_path_queries": n_queries, "plain_path_s": plain_s,
          "id_diffs_at_near_ties_vs_plain_path": ties_plain,
          "index_bytes": x.numel() * x.element_size()})
    return eng, launches


def pairwise_distance_phase(device, rep: int):
    """Every name of SUPPORTED_DISTANCES at the scan step shape against
    ``engine="torch"``; the B5 metrics must launch B5, the others not."""
    import torch

    from raft_tpu_torch.distance import (ACCUMULATE_METRICS, DISTANCE_TYPES,
                                         SUPPORTED_DISTANCES,
                                         pairwise_distance)
    from raft_tpu_torch.kernels import native

    gen = torch.Generator(device=device).manual_seed(17)
    # positive rows: the domain of every metric (Hellinger, KL, JS)
    x = torch.rand(1024, 128, generator=gen, device=device) + 1e-3
    y = torch.rand(16384, 128, generator=gen, device=device) + 1e-3
    out = {}
    for name in SUPPORTED_DISTANCES:
        native.reset_launches()
        got = pairwise_distance(x, y, name, p=3.0, device=device)
        launched = native.LAUNCHES["pairwise_accumulate"]
        b5 = DISTANCE_TYPES[name] in ACCUMULATE_METRICS
        check((launched > 0) == b5,
              f"pairwise_distance {name}: B5 launches {launched}")
        t0 = time.perf_counter()
        ref = pairwise_distance(x, y, name, p=3.0, device=device,
                                engine="torch")
        plain_ms = _synced_seconds(device, t0) * 1e3
        check(got.shape == (1024, 16384) and bool(torch.isfinite(got).all()),
              f"pairwise_distance {name}: not finite (1024, 16384)")
        check(torch.allclose(got, ref, rtol=1e-5, atol=1e-5),
              f"pairwise_distance {name}: beyond rtol 1e-5, atol 1e-5 of "
              "the plain path")
        out[name] = {"b5": b5, "max_abs_err": float((got - ref).abs().max()),
                     "ms": timed(lambda: pairwise_distance(
                         x, y, name, p=3.0, device=device), device, rep),
                     "plain_ms": plain_ms}
    emit({"phase": "pairwise_distance", "shape": [1024, 16384, 128],
          "metric_arg": 3.0, "metrics": out})


def pairwise_kernel_phase(device, x, queries, rep: int):
    """B5 against its plain version: six ops × three input types at the
    brute-force scan step (bucket 1,024 × tile 16,384 × 128) and at ragged
    shapes, the batch-invariance check, and each op's time beside the
    plain version's, a ``torch.cdist`` yardstick's and the bound; returns
    B5's row (the L1 numbers)."""
    import torch

    from raft_tpu_torch.kernels import pairwise as pk

    dtypes = (torch.float32, torch.bfloat16, torch.float16)

    def compare(a, b, op, what):
        got = pk.pairwise_accumulate(a, b, op, 3.0)
        ref = pk.pairwise_accumulate_plain(a, b, op, 3.0)
        nan = torch.isnan(ref)
        check(torch.equal(torch.isnan(got), nan), f"{what}: NaN differs")
        err = (got - ref).abs()[~nan]
        if op in ("linf", "hamming"):
            check(not bool(err.any()), f"{what}: not exact")
        else:   # the terms are non-negative: Σ|terms| is the value
            check(bool((err <= 1e-5 * ref.abs()[~nan]).all()),
                  f"{what}: beyond 1e-5 × Σ|terms| of the plain version")
        return float(err.max()) if err.numel() else 0.0

    # the step shape; values in quarters, so coordinates tie and vanish
    xs = torch.round(queries[:1024] * 4) / 4
    ys = torch.round(x[:16384] * 4) / 4
    m, k = xs.shape
    n = ys.shape[0]
    library = {
        "l1": (lambda: torch.cdist(xs, ys, p=1.0), lambda a: a),
        "l2": (lambda: torch.cdist(
            xs, ys, p=2.0, compute_mode="donot_use_mm_for_euclid_dist"),
            torch.sqrt),
        "linf": (lambda: torch.cdist(xs, ys, p=float("inf")), lambda a: a),
        "lp": (lambda: torch.cdist(xs, ys, p=3.0),
               lambda a: torch.pow(a, 1.0 / 3.0)),
        "hamming": (lambda: torch.cdist(xs, ys, p=0.0), lambda a: a),
    }
    by_op = {}
    for op in pk.OPS:
        errs = {str(dt).split(".")[1]: compare(xs.to(dt), ys.to(dt), op,
                                               f"pairwise {op} {dt} step")
                for dt in dtypes}
        acc = pk.pairwise_accumulate(xs, ys, op, 3.0)
        check(torch.equal(pk.pairwise_accumulate(xs[:37], ys, op, 3.0),
                          acc[:37]),
              f"pairwise {op}: rows depend on the batch")
        lib_ms = None
        if op in library:
            fn, fin = library[op]
            check(torch.allclose(fin(acc), fn(), rtol=1e-4, atol=1e-4),
                  f"pairwise {op}: torch.cdist yardstick disagrees")
            lib_ms = timed(fn, device, rep)
        ops_per = B5_OPS_PER_ELEMENT[op]
        b, by = bound_ms(4.0 * (m * k + n * k + m * n),
                         float(ops_per) * m * n * k, F32_INSTR_PER_S)
        by_op[op] = dict(
            max_abs_err=max(errs.values()), max_abs_err_by_dtype=errs,
            ms=timed(lambda: pk.pairwise_accumulate(xs, ys, op, 3.0), device,
                     rep),
            plain_ms=timed(lambda: pk.pairwise_accumulate_plain(xs, ys, op,
                                                                3.0),
                           device, 3),
            library_ms=lib_ms, bound_ms=b, bound_by=by,
            ops_per_element=ops_per)
    half_ms = {str(dt).split(".")[1]: timed(
        lambda: pk.pairwise_accumulate(xs.to(dt), ys.to(dt), "l1"), device,
        rep) for dt in dtypes[1:]}

    # ragged shapes, one NaN in x; k = 960 is above the TPU kernel's cap
    gen = torch.Generator(device=device).manual_seed(19)
    ragged, errs = [], []
    for rm in (1, 37):
        for rn in (1, 129, 16385):
            for rk in (1, 3, 127, 960):
                a = torch.round(torch.randn(rm, rk, generator=gen,
                                            device=device) * 4) / 4
                b = torch.round(torch.randn(rn, rk, generator=gen,
                                            device=device) * 4) / 4
                a[0, rk // 2] = float("nan")
                for op in pk.OPS:
                    for dt in dtypes:
                        errs.append(compare(a.to(dt), b.to(dt), op,
                                            f"pairwise {op} {dt} "
                                            f"{rm}×{rn}×{rk}"))
                ragged.append([rm, rn, rk])
    l1 = by_op["l1"]
    row = dict(max_abs_err=max([l1["max_abs_err"]] + errs), ms=l1["ms"],
               plain_ms=l1["plain_ms"], bound_ms=l1["bound_ms"],
               bound_by=l1["bound_by"], library_ms=l1["library_ms"])
    emit({"phase": "kernel", "name": "pairwise_accumulate",
          "shape": [m, n, k], "library": "torch.cdist",
          "batch_invariant_rows": 37, "l1_ms_by_dtype": half_ms,
          "ragged_shapes_m_n_k": ragged, "by_op": by_op, **row})
    return row


def run(device, n: int, n_queries: int, dim: int, n_lists: int,
        n_probes: int, k: int, seed: int, rep: int = 5,
        profile: bool = False):
    """The phases after the device line; returns the kernels' rows."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    comps = torch.randn(4 * n_lists, dim, generator=gen, device=device)
    x = mixture(gen, n, dim, comps, 0.7, device)
    queries = mixture(gen, n_queries, dim, comps, 0.7, device)
    probe_centers = mixture(gen, n_lists, dim, comps, 0.7, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    emit({"phase": "data", "n": n, "dim": dim, "queries": n_queries,
          "seed": seed, "seconds": time.perf_counter() - t0})

    rows = kernel_phase(device, x, queries, probe_centers, rep)

    q_host = queries.cpu().numpy()
    reqs, calls = ragged_calls(q_host, n_queries)
    nr = min(1000, n_queries)
    qr = queries[:nr]
    dist = torch.cdist(qr, x, compute_mode="donot_use_mm_for_euclid_dist")
    truth = torch.topk(dist, k, dim=1, largest=False).indices
    del dist
    args = (device, x, reqs, calls, n_queries, truth, qr, n_lists, n_probes,
            k)
    eng_flat, launches_flat = ivf_flat_path(*args)
    index_pq, eng_pq, launches_pq = ivf_pq_path(*args)
    rows["lut_score"] = lut_phase(device, index_pq, queries, rep)
    eng_bf, launches_bf = brute_force_path(device, x, queries, reqs, calls,
                                           n_queries, qr, k)
    pairwise_distance_phase(device, rep)
    rows["pairwise_accumulate"] = pairwise_kernel_phase(device, x, queries,
                                                        rep)
    by_path = {"ivf_flat": launches_flat, "ivf_pq": launches_pq,
               "brute_force": launches_bf}
    for name, row in rows.items():
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    if profile:
        profile_serve("ivf_flat", eng_flat, q_host, device)
        profile_serve("ivf_pq", eng_pq, q_host, device)
        profile_serve("brute_force", eng_bf, q_host, device)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n-lists", type=int, default=1024)
    ap.add_argument("--n-probes", type=int, default=20)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one 1024-query super-batch of each "
                    "engine with torch.profiler and print device time by "
                    "kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from raft_tpu_torch.kernels import native
    except ImportError as e:
        print(f"chip_smoke: the raft_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    device = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    native.load_all()
    emit({"phase": "kernel_build", "seconds": time.perf_counter() - t0,
          "sources": [f"{s}.cu" for s in native.SOURCES]})
    try:
        rows = run(device, args.n, args.queries, args.dim, args.n_lists,
                   args.n_probes, args.k, args.seed,
                   profile=args.profile)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    kernels = [dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], **row)
               for name, row in rows.items()]
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
