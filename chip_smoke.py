#!/usr/bin/env python3
"""Drive raft_tpu_torch's IVF-Flat serving path on one NVIDIA card.

    python3 chip_smoke.py            # full size; needs one CUDA card

The deployment is ann-benchmarks' sift-128-euclidean at full size, with
data of the same shape made from a seed (a clustered Gaussian mixture in
float32, since the SIFT files are not in the repository): 1,000,000 base
vectors × 128, 10,000 queries, k = 10, L2; IVF-Flat with n_lists = 1024
(RAFT's ANN bench entry ``raft_ivf_flat.nlist1024``), n_probes = 20,
kmeans_n_iters = 20, kmeans_trainset_fraction = 0.5.

Phases, one JSON line each:

1. device — the card, its power limit (nvidia-smi), torch and CUDA; then
   the kernels are built from ``raft_tpu_torch/kernels/csrc`` (nvcc).
2. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes and at ragged edge shapes, with its median time,
   the plain version's, one PyTorch library call's where one computes the
   same function, and the least time the card could take (bound).
3. main path — launch counts reset, then ``ivf_flat.build`` on the
   kernels, ``ServeEngine(...).warmup()`` and ragged coalesced
   ``search()`` calls covering all queries; the counts are read right
   after and each kernel must have launched.  Then the checks: coalesced
   results equal solo ``search`` per request, recall@10 against exact
   neighbours (``torch.cdist`` + ``torch.topk``, the checker) of 1,000
   queries, and the kernel path's recall within 0.002 of the plain path's.
4. the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

``--profile`` adds a profile phase after the checks: device time by
kernel over one 1,024-query super-batch (``torch.profiler``).

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

#: which TPU kernel each port kernel replaces
REPLACES = {
    "fused_l2_nn": "raft_tpu/kernels/fused_l2nn.py:86",
    "fused_l2_nn_partials": "raft_tpu/kernels/fused_l2nn.py:187",
    "select_k": "raft_tpu/kernels/select_k.py:155",
}
SOURCE = {
    "fused_l2_nn": "raft_tpu_torch/kernels/csrc/fused_l2nn.cu",
    "fused_l2_nn_partials": "raft_tpu_torch/kernels/csrc/fused_l2nn.cu",
    "select_k": "raft_tpu_torch/kernels/csrc/select_k.cu",
}


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
    (CUDA events on the card)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
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


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mixture(gen, n, dim, centers, noise, device):
    import torch

    comp = torch.randint(0, centers.shape[0], (n,), generator=gen,
                         device=device)
    return centers[comp] + noise * torch.randn(n, dim, generator=gen,
                                               device=device)


def near_ties(x, y, rows: int = 1 << 15):
    """Per row of x: whether its two nearest rows of y (float64) lie
    within 1e-5 relative of each other."""
    import torch

    yd = y.double()
    yn = (yd * yd).sum(1)
    out = []
    for r in range(0, x.shape[0], rows):
        xd = x[r:r + rows].double()
        d = (xd * xd).sum(1)[:, None] + yn[None] - 2 * xd @ yd.T
        two = torch.topk(d, 2, dim=1, largest=False).values
        out.append((two[:, 1] - two[:, 0])
                   <= 1e-5 * two[:, 0].clamp_min(1e-30))
    return torch.cat(out)


def check_labels(name, idx, ref_idx, x, y):
    diff = idx != ref_idx
    n_diff = int(diff.sum())
    if n_diff:
        ties = near_ties(x, y)
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
    b, by = bound_ms(4.0 * (mt * d + 2 * k * d + 2 * mt + k),
                     2.0 * mt * k * d + mt * d)
    rows["fused_l2_nn_partials"] = dict(max_abs_err=err3, ms=ms,
                                        plain_ms=plain_ms, bound_ms=b,
                                        bound_by=by, library_ms=None)
    emit({"phase": "kernel", "name": "fused_l2_nn_partials",
          "shape": [mt, k, d], "label_diffs_near_ties": n_diff3,
          "sums_bitwise_repeat": True, **rows["fused_l2_nn_partials"]})

    # B2 at the coarse top-n_probes shape, a probe-tile shape, and a
    # matrix of ties, NaN and ±inf
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.neighbors.ivf_flat import _coarse_distances

    coarse = _coarse_distances(queries, y, DistanceType.L2Expanded)
    cases = {
        "coarse": (coarse, 20),
        "probe_tile": (torch.rand(1024, 2448, generator=gen, device=device)
                       * 100.0, 10),
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
        for select_min in (True, False):
            kv, kp = ksel.select_k_blockwise(vals, kk, select_min)
            pv2, pp = select_k_plain(vals, kk, select_min)
            check(torch.equal(kp, pp), f"select_k {name}: positions differ")
            check(torch.equal(torch.nan_to_num(kv, nan=0.5),
                              torch.nan_to_num(pv2, nan=0.5)),
                  f"select_k {name}: values differ")
        info[name] = [list(vals.shape), kk]
    nq, nl = coarse.shape
    ms = timed(lambda: ksel.select_k_blockwise(coarse, 20), device, rep)
    plain_ms = timed(lambda: select_k_plain(coarse, 20), device, rep)
    lib_ms = timed(lambda: torch.topk(coarse, 20, dim=1, largest=False),
                   device, rep)
    tile, tk = cases["probe_tile"]
    tile_ms = timed(lambda: ksel.select_k_blockwise(tile, tk), device, rep)
    b, by = bound_ms(4.0 * nq * nl + 8.0 * nq * 20, float(nq * nl))
    rows["select_k"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            bound_ms=b, bound_by=by, library_ms=lib_ms)
    emit({"phase": "kernel", "name": "select_k", "shape": [nq, nl, 20],
          "cases": info, "positions_bit_identical": True,
          "probe_tile_ms": tile_ms, **rows["select_k"]})
    return rows


def recall(ids, truth):
    hits = (ids[:, :, None] == truth[:, None, :]).any(-1).sum()
    return float(hits) / truth.numel()


def profile_serve(eng, q_host, device, top: int = 12):
    """Device time by kernel over one full super-batch (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.search([q_host[:1024]])   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.search([q_host[:1024]])   # the wall time, without the profiler
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.search([q_host[:1024]])
        torch.cuda.synchronize()
    # kernel rows only (the CPU-op rows repeat their kernels' time)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    emit({"phase": "profile", "queries": 1024, "wall_ms": wall_ms,
          "device_ms": device_ms,
          "device_busy_share": device_ms / wall_ms if wall_ms else None,
          "top": [{"name": e.key[:80], "calls": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in events[:top]]})


def run(device, n: int, n_queries: int, dim: int, n_lists: int,
        n_probes: int, k: int, seed: int, rep: int = 5,
        profile: bool = False):
    """The phases after the device line; returns the kernels' rows."""
    import torch

    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import ServeEngine

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

    # ---- main path: counts from here to the end of serving ----
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=n_lists), x,
                           device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "n_lists": index.n_lists,
          "capacity": index.capacity,
          "physical_rows": int(index.list_data.shape[0]),
          "padding_fraction": index.padding_fraction,
          "index_bytes": index.list_data.numel() * 4})
    check(index.size == n, "build: index does not hold every row")

    params = ivf_flat.SearchParams(n_probes=n_probes)
    eng = ServeEngine(index, k, params, max_batch=1024)
    t0 = time.perf_counter()
    n_warm = eng.warmup()
    warm_s = time.perf_counter() - t0
    q_host = queries.cpu().numpy()
    pattern = [1, 7, 64, 300, 1500, 33, 128, 900, 2, 511]
    reqs, start, j = [], 0, 0
    while start < n_queries:
        size = min(pattern[j % len(pattern)], n_queries - start)
        reqs.append(q_host[start:start + size])
        start += size
        j += 1
    calls = [reqs[c:c + 8] for c in range(0, len(reqs), 8)]
    call_s, results = [], []
    t_serve = time.perf_counter()
    for call in calls:
        t0 = time.perf_counter()
        results.extend(eng.search(call))
        call_s.append(time.perf_counter() - t0)
    serve_s = time.perf_counter() - t_serve
    launches = dict(native.LAUNCHES)
    emit({"phase": "serve", "requests": len(reqs), "calls": len(calls),
          "queries": n_queries, "warmup_signatures": n_warm,
          "warmup_s": warm_s, "serve_s": serve_s,
          "qps": n_queries / serve_s,
          "call_ms_p50": float(np.percentile(call_s, 50) * 1e3),
          "call_ms_p99": float(np.percentile(call_s, 99) * 1e3),
          "stats": eng.stats, "launches": launches,
          "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                             if device.type == "cuda" else None)})
    for name in REPLACES:
        check(launches[name] > 0, f"main path never launched {name}")

    # ---- checks of what came out ----
    for q, (d, i) in zip(reqs, results):
        check(isinstance(d, np.ndarray), f"a request failed: {d!r}")
        check(d.shape == (q.shape[0], k) and np.isfinite(d).all(),
              "results must be finite (n, k)")
        sd, si = ivf_flat.search(params, index, q, k)
        check(np.array_equal(d, sd.cpu().numpy())
              and np.array_equal(i, si.cpu().numpy()),
              "coalesced results differ from solo search")
    nr = min(1000, n_queries)
    qr = queries[:nr]
    dist = torch.cdist(qr, x, compute_mode="donot_use_mm_for_euclid_dist")
    truth = torch.topk(dist, k, dim=1, largest=False).indices
    ids_kernel = torch.as_tensor(np.concatenate([r[1] for r in results])[:nr],
                                 device=device).long()
    _, ids_plain = ivf_flat.search(params, index, qr, k, engine="torch")
    r_kernel = recall(ids_kernel, truth)
    r_plain = recall(ids_plain.long(), truth)
    emit({"phase": "checks", "coalesced_equals_solo": True,
          "recall_at_10": r_kernel, "recall_at_10_plain_path": r_plain,
          "recall_queries": nr})
    check(abs(r_kernel - r_plain) <= 0.002,
          "kernel-path recall is not within 0.002 of the plain path's")
    for name, row in rows.items():
        row["launches"] = launches[name]
    if profile:
        profile_serve(eng, q_host, device)
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
                    help="also trace one 1024-query super-batch with "
                    "torch.profiler and print device time by kernel")
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
