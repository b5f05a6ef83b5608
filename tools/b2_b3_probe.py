#!/usr/bin/env python3
"""Time kernels B2 (select-k) and B3 (the k-means E-step plus M-step
partials) on one NVIDIA card, stage by stage, beside their yardsticks.

    python3 tools/b2_b3_probe.py            # needs one CUDA card and nvcc
    python3 tools/b2_b3_probe.py --ptxas    # also print nvcc -Xptxas -v
    python3 tools/b2_b3_probe.py --pq-recall  # also build IVF-PQ twice

Prints one JSON line per measurement:

* ``select_k`` at the main paths' shapes (10,000 × 1,024 k = 20, the
  coarse top-n_probes; 1,024 × 2,448 k = 10, a probe tile; 1,024 × 16,384
  k = 10, a brute-force scan step, on uniform values and on real L1
  distances): B2, ``torch.topk`` and the bytes bound.
* ``b3_split`` at the PQ codebook shape (262,144 × 256 × 2) and the
  coarse balancing-EM shape (500,000 × 1,024 × 128): each stage of one
  fused EM step on its own (B1's E-step with its row norms, and the M-step
  stages the wrapper in ``raft_tpu_torch/kernels/fused_l2nn.py`` has: the
  argsort and segmented sum before the redesign, the per-chunk partials
  after it) and the whole step (at narrow rows after the redesign: the
  fused E+M kernel) with the centroid update.
* ``b3_batched`` (where the batched entry point exists): all 64 PQ
  subspaces in one call against 64 calls of one subspace each.
* ``pq_recall`` (``--pq-recall``): IVF-PQ at full size built through the
  kernels and through their plain versions, build seconds and recall@10,
  after a profiled kernel build (``pq_build_profile``: device time by
  kernel against the wall).

Every time is the mean of CUDA-event-timed repetitions after a warm call,
enqueued while the card sleeps: device time, without the host's launch
overhead (``b2_back_to_back_ms`` times B2's calls back to back instead,
which adds it where the host is the slower side).
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from raft_tpu_torch.kernels import native  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
#: cycles the card sleeps per timed call, ahead of the host's enqueue
SLEEP_CYCLES = 200_000


def elapsed_ms(fn, reps: int = 20, sleep: bool = True) -> float:
    """Milliseconds per call.  With *sleep* the card sleeps while the host
    enqueues the calls, so this is device time; without, the calls run
    back to back and the host's launch overhead counts where it is the
    slower side."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if sleep:
        torch.cuda._sleep(SLEEP_CYCLES * reps)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas() -> None:
    for name in native.SOURCES:
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run([native._nvcc(), *native.NVCC_FLAGS,
                                  "-Xptxas", "-v", "-o", f"{tmp}/{name}.so",
                                  str(native.CSRC / f"{name}.cu")],
                                 capture_output=True, text=True)
        lines = [ln for ln in (out.stdout + out.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln
                 or "Compiling entry" in ln]
        print(f"== {name}.cu rc={out.returncode}")
        print("\n".join(lines)[-6000:], flush=True)


def mixture(gen, n, dim, comps, dev):
    idx = torch.randint(0, comps.shape[0], (n,), generator=gen, device=dev)
    return comps[idx] + 0.7 * torch.randn(n, dim, generator=gen, device=dev)


def select_shapes(dev, gen):
    from raft_tpu_torch.kernels import select_k as ksel
    from raft_tpu_torch.kernels import pairwise as pk

    comps = torch.randn(4096, 128, generator=gen, device=dev)
    q = mixture(gen, 1024, 128, comps, dev)
    base = mixture(gen, 16384, 128, comps, dev)
    cases = {
        "coarse_10000x1024_k20": (torch.rand(10000, 1024, generator=gen,
                                             device=dev) * 100.0, 20),
        "probe_tile_1024x2448_k10": (torch.rand(1024, 2448, generator=gen,
                                                device=dev) * 100.0, 10),
        "scan_1024x16384_k10_uniform": (torch.rand(1024, 16384,
                                                   generator=gen,
                                                   device=dev) * 100.0, 10),
        "scan_1024x16384_k10_l1": (pk.pairwise_accumulate(q, base, "l1"),
                                   10),
    }
    for name, (v, k) in cases.items():
        rows, n = v.shape
        b_ms = 1e3 * (4.0 * rows * n + 4.0 * rows * k) / HBM_BYTES_PER_S
        out = {"probe": "select_k", "case": name, "shape": [rows, n, k],
               "bound_ms": b_ms,
               "b2_ms": elapsed_ms(lambda: ksel.select_k_blockwise(v, k)),
               "b2_back_to_back_ms": elapsed_ms(
                   lambda: ksel.select_k_blockwise(v, k), sleep=False),
               "topk_ms": elapsed_ms(lambda: torch.topk(v, k, dim=1,
                                                        largest=False))}
        for dt in (torch.float16, torch.bfloat16):
            vh = v.to(dt)
            out[f"b2_{str(dt)[6:]}_ms"] = elapsed_ms(
                lambda: ksel.select_k_blockwise(vh, k))
        emit(out)


def b3_split(dev, gen, x, y, name):
    """Each stage of one fused EM step of the per-matrix wrapper, timed on
    its own, then the whole step and the centroid update."""
    from raft_tpu_torch.cluster.kmeans import centroids_from_sums
    from raft_tpu_torch.distance.pairwise import _row_norms
    from raft_tpu_torch.kernels import fused_l2nn

    m, d = x.shape
    k = y.shape[0]
    lib = native.library("fused_l2nn")
    st = native.stream_handle(dev)
    xn, yn = _row_norms(x), _row_norms(y)
    val = torch.empty(m, dtype=torch.float32, device=dev)
    idx = torch.empty(m, dtype=torch.int32, device=dev)

    def e_step():
        lib.raft_fused_l2nn(x.data_ptr(), xn.data_ptr(), y.data_ptr(),
                            yn.data_ptr(), val.data_ptr(), idx.data_ptr(),
                            m, k, d, 0, st)

    e_step()
    stages = {"row_norms_x_and_y": lambda: (_row_norms(x), _row_norms(y)),
              "e_step_b1": e_step}
    out = {"probe": "b3_split", "shape": name, "m": m, "k": k, "d": d}
    if hasattr(lib, "raft_segment_sums"):   # the argsort M-step
        order = torch.argsort(idx, stable=True).to(torch.int32)
        offsets = torch.zeros(k + 1, dtype=torch.int32, device=dev)
        offsets[1:] = torch.cumsum(torch.bincount(idx, minlength=k), 0)
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        wsum = torch.empty(k, dtype=torch.float32, device=dev)

        def offs():
            o = torch.zeros(k + 1, dtype=torch.int32, device=dev)
            o[1:] = torch.cumsum(torch.bincount(idx, minlength=k), 0)

        stages.update({
            "argsort_stable": lambda: torch.argsort(idx, stable=True).to(
                torch.int32),
            "bincount_cumsum": offs,
            "segment_sums_kernel": lambda: lib.raft_segment_sums(
                x.data_ptr(), 0, order.data_ptr(), offsets.data_ptr(),
                sums.data_ptr(), wsum.data_ptr(), k, d, st),
        })
    if hasattr(lib, "raft_cluster_partials"):   # the per-chunk M-step
        stages["m_step_cluster_partials"] = (
            lambda: fused_l2nn._launch_cluster_partials(x, idx, None, k))
    stages["inertia_sum"] = lambda: torch.sum(val)
    for s, fn in stages.items():
        out[f"{s}_ms"] = elapsed_ms(fn)
    p = fused_l2nn.fused_l2_nn_partials(x, y)
    out["centroids_from_sums_ms"] = elapsed_ms(
        lambda: centroids_from_sums(p[2], p[3], y, torch.float32))
    out["whole_step_ms"] = elapsed_ms(
        lambda: fused_l2nn.fused_l2_nn_partials(x, y))
    # the M-step reads x and the labels once and writes the partials
    out["m_step_bytes_bound_ms"] = 1e3 * (4.0 * (m * d + m + k * d + k)
                                          / HBM_BYTES_PER_S)
    emit(out)


def b3_batched(dev, gen):
    from raft_tpu_torch.kernels import fused_l2nn

    batched = getattr(fused_l2nn, "fused_l2_nn_partials_batched", None)
    if batched is None:
        return
    s, n, k, ds = 64, 262144, 256, 2
    x = torch.randn(s, n, ds, generator=gen, device=dev)
    y = torch.stack([x[i, torch.randperm(n, generator=gen, device=dev)[:k]]
                     for i in range(s)])
    out = {"probe": "b3_batched", "shape": [s, n, k, ds],
           "batched_ms": elapsed_ms(lambda: batched(x, y), 10),
           "per_subspace_x64_ms": elapsed_ms(
               lambda: [fused_l2nn.fused_l2_nn_partials(x[i], y[i])
                        for i in range(s)], 3)}
    emit(out)


def pq_recall(dev, gen):
    """IVF-PQ at the smoke's size (1,000,000 × 128 mixture, n_lists 1024,
    the default PQ parameters) built twice, through the kernels and
    through their plain versions (``engine="torch"``), each searched
    through the kernels: build seconds and recall@10 of 1,000 queries."""
    import time

    from raft_tpu_torch.neighbors import ivf_pq

    comps = torch.randn(4096, 128, generator=gen, device=dev)
    x = mixture(gen, 1_000_000, 128, comps, dev)
    q = mixture(gen, 1000, 128, comps, dev)
    d = torch.cdist(q, x, compute_mode="donot_use_mm_for_euclid_dist")
    truth = torch.topk(d, 10, dim=1, largest=False).indices
    del d
    out = {"probe": "pq_recall", "n": 1_000_000, "queries": 1000}
    # where a kernel build's time goes: device time by kernel against the
    # wall (the first build also warms the allocator)
    from torch.profiler import ProfilerActivity, profile

    ivf_pq.build(ivf_pq.IndexParams(n_lists=1024), x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ivf_pq.build(ivf_pq.IndexParams(n_lists=1024), x)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    emit({"probe": "pq_build_profile", "wall_s_profiled": wall,
          "device_s": sum(e.self_device_time_total for e in events) / 1e6,
          "kernel_launches": sum(e.count for e in events),
          "top": [{"name": e.key[:70], "calls": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in events[:10]]})
    for name, engine in (("kernels", None), ("plain", "torch")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = ivf_pq.build(ivf_pq.IndexParams(n_lists=1024), x,
                             engine=engine)
        torch.cuda.synchronize()
        out[f"{name}_build_s"] = time.perf_counter() - t0
        _, ids = ivf_pq.search(ivf_pq.SearchParams(n_probes=20), index, q,
                               10)
        hits = (ids.long()[:, :, None] == truth[:, None, :]).any(-1).sum()
        out[f"{name}_recall_at_10"] = float(hits) / truth.numel()
    emit(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--pq-recall", action="store_true",
                    help="also build IVF-PQ at full size through the "
                    "kernels and through the plain versions and compare "
                    "recall")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b2_b3_probe: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ptxas:
        ptxas()
    native.load_all()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"probe": "device", "nvidia_smi": smi})
    gen = torch.Generator(device=dev).manual_seed(0)
    select_shapes(dev, gen)
    xc = torch.randn(262144, 2, generator=gen, device=dev)
    yc = xc[torch.randperm(262144, generator=gen, device=dev)[:256]]
    b3_split(dev, gen, xc, yc, "codebook_262144x256x2")
    comps = torch.randn(4096, 128, generator=gen, device=dev)
    xb = mixture(gen, 500000, 128, comps, dev)
    yb = mixture(gen, 1024, 128, comps, dev)
    b3_split(dev, gen, xb, yb, "coarse_500000x1024x128")
    b3_batched(dev, gen)
    if args.pq_recall:
        pq_recall(dev, torch.Generator(device=dev).manual_seed(1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
