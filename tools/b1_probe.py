#!/usr/bin/env python3
"""Time kernel B1 (fused L2 nearest neighbour) on one NVIDIA card, device
time only, beside its two bounds and the product alone.

    python3 tools/b1_probe.py               # needs one CUDA card
    python3 tools/b1_probe.py --root DIR    # B1 of the checkout at DIR
    python3 tools/b1_probe.py --widths      # also B1 by row width
    python3 tools/b1_probe.py --builds      # also the builds by kernel
    python3 tools/b1_probe.py --quality 0 1 2   # only index quality
    python3 tools/b1_probe.py --ptxas       # also registers and spills

``--root`` imports ``raft_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive`` under ``build/``), so one
command can time parent, change, change, parent on one card.  Prints one
JSON line per measurement:

* ``b1``: ``fused_l2_nn`` (row norms included) at the shapes the build
  path gives it — list assignment 1,000,000 × 1,024 × 128, B3's E-step
  500,000 × 1,024 × 128, the meso assignment 1,000,000 × 32 × 128 and
  one mesocluster's fine clustering 16,384 × 32 × 128 — on a seeded
  Gaussian mixture; beside the float32 bound outside the tensor cores
  (2·m·k·d flop at 67 TFLOP/s), the 3xTF32 bound (6·m·k·d flop at the
  tensor cores' 495 TFLOP/s), the bytes bound, and ``torch.matmul(x,
  y.T)`` in full float32 ("product only": it writes the (m, k) product
  and finds no minimum, so it is a yardstick, not the same function).
  Labels are checked against the plain version (except near ties).
* ``b1_width`` (``--widths``): ``fused_l2_nn`` as the checkout
  dispatches it at 262,144 × 256 × d for d from 1 to 256 (the PQ
  codebook shape at d = 2) and which kernel that is; run against a
  parent whose B1 is the float32 FMA kernel alone, it gives the
  crossover of the two kernels.
* ``profile_build`` (``--builds``): ``ivf_flat.build`` and
  ``ivf_pq.build`` at the smoke's deployment (1,000,000 × 128, n_lists
  1,024) by kernel, through ``chip_smoke.profile_build`` of this
  checkout run on the package under ``--root``.  For this checkout it
  prints what ``python3 chip_smoke.py --profile`` prints; it is here for
  an older checkout, whose own smoke has no build profile.
* ``quality`` (``--quality SEED ...``): per seed, the smoke's data
  (``chip_smoke.py --seed SEED``: the 1,000,000 × 128 mixture and its
  first 1,000 queries) and IVF-Flat and IVF-PQ (n_lists 1,024) built
  through the kernels and through their plain versions (``engine=
  "torch"``), each searched the way it was built (n_probes 20, k 10):
  recall@10 and the coarse centres' mean squared distance over the rows
  (the k-means objective, by the plain version).  B1 enters the builds
  only, so this is what a B1 change can move in the indexes.
* ``ptxas`` (``--ptxas``): ``nvcc -Xptxas -v`` lines of B1's source.

Kernel times are means of CUDA-event-timed
repetitions after a warm call, enqueued while the card sleeps.
"""

import argparse
import pathlib
import sys

from probe_common import (F32_FLOP_PER_S, HBM_BYTES_PER_S, TF32_FLOP_PER_S,
                          elapsed_ms, emit, mixture, nvidia_smi, ptxas)

SHAPES = {"list_assignment": (1_000_000, 1024, 128),
          "b3_e_step": (500_000, 1024, 128),
          "meso_assignment": (1_000_000, 32, 128),
          "fine_cluster": (16_384, 32, 128)}


def bounds(m, k, d):
    return {"bound_f32_ms": 2e3 * m * k * d / F32_FLOP_PER_S,
            "bound_3xtf32_ms": 6e3 * m * k * d / TF32_FLOP_PER_S,
            "bound_bytes_ms": 4e3 * (m * d + k * d + 2 * m)
            / HBM_BYTES_PER_S}


def kernel_of(fused_l2nn, d: int) -> str:
    """Which B1 kernel the checkout runs at width *d* (float32)."""
    if getattr(fused_l2nn, "tensor_cores", lambda *_: False)(d, False):
        return "tensor_cores_3xtf32"
    return "fma_f32"


def b1(dev, gen, comps, reps: int) -> None:
    import torch

    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels import fused_l2nn

    x_all = mixture(gen, 1_000_000, 128, comps, dev)
    for name, (m, k, d) in SHAPES.items():
        x = x_all[:m]
        y = mixture(gen, k, d, comps, dev)
        val, idx = fused_l2nn.fused_l2_nn(x, y)
        pv, pi = fused_l2_nn_plain(x, y)
        diff = idx != pi
        n_diff = int(diff.sum())
        if n_diff:   # near ties: the two best within 1e-5 relative
            d2 = torch.cdist(x[diff].double(), y.double()) ** 2
            two = torch.topk(d2, 2, dim=1, largest=False).values
            tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].clamp_min(
                1e-30)
            n_off = int((~tie).sum())
        else:
            n_off = 0
        scale = (x * x).sum(1) + (y * y).sum(1)[idx.long()]
        ms = elapsed_ms(lambda: fused_l2nn.fused_l2_nn(x, y), reps)
        prod_ms = elapsed_ms(lambda: torch.matmul(x, y.T), max(2, reps // 2))
        row = {"probe": "b1", "shape": name, "m": m, "k": k, "d": d,
               "ms": ms, "product_only_ms": prod_ms,
               "label_diffs": n_diff, "label_diffs_off_near_ties": n_off,
               "max_err_of_norms": float(((val - pv).abs() / scale).max()),
               "kernel": kernel_of(fused_l2nn, d), **bounds(m, k, d)}
        row["share_of_f32_bound"] = row["bound_f32_ms"] / ms
        row["share_of_3xtf32_bound"] = row["bound_3xtf32_ms"] / ms
        emit(row)
        del val, idx, pv, pi


def widths(dev, gen, reps: int) -> None:
    import torch

    from raft_tpu_torch.kernels import fused_l2nn

    m, k = 262_144, 256
    for d in (1, 2, 4, 8, 16, 24, 32, 64, 128, 256):
        x = torch.randn(m, d, generator=gen, device=dev)
        y = x[torch.randperm(m, generator=gen, device=dev)[:k]]
        emit({"probe": "b1_width", "m": m, "k": k, "d": d,
              "kernel": kernel_of(fused_l2nn, d),
              "ms": elapsed_ms(lambda: fused_l2nn.fused_l2_nn(x, y), reps),
              **bounds(m, k, d)})


def builds(dev, gen, comps) -> None:
    import importlib.util

    import torch

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_here", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x = mixture(gen, 1_000_000, 128, comps, dev)
    torch.cuda.synchronize()
    for name in ("ivf_flat", "ivf_pq"):
        smoke.profile_build(name, dev, x, 1024)


def quality(dev, seed: int, n: int = 1_000_000, n_lists: int = 1024
            ) -> None:
    import torch

    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    gen = torch.Generator(device=dev).manual_seed(seed)
    comps = torch.randn(4 * n_lists, 128, generator=gen, device=dev)
    x = mixture(gen, n, 128, comps, dev)
    q = mixture(gen, 10_000, 128, comps, dev)[:1000]
    dist = torch.cdist(q, x, compute_mode="donot_use_mm_for_euclid_dist")
    truth = torch.topk(dist, 10, dim=1, largest=False).indices
    del dist
    for name, mod in (("ivf_flat", ivf_flat), ("ivf_pq", ivf_pq)):
        for engine in (None, "torch"):
            index = mod.build(mod.IndexParams(n_lists=n_lists), x, device=dev,
                              engine=engine)
            _, ids = mod.search(mod.SearchParams(n_probes=20), index, q, 10,
                                engine=engine)
            hits = (ids.long()[:, :, None] == truth[:, None, :]).any(-1)
            val, _ = fused_l2_nn_plain(x, index.centers)
            emit({"probe": "quality", "seed": seed, "index": name,
                  "built": "plain" if engine else "kernels",
                  "recall_at_10": float(hits.sum()) / truth.numel(),
                  "mean_sq_dist_to_centre": float(val.double().mean()),
                  "capacity": int(index.capacity)})
            del index


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--widths", action="store_true")
    ap.add_argument("--builds", action="store_true")
    ap.add_argument("--quality", type=int, nargs="*", default=[])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from raft_tpu_torch.kernels import native

    if not torch.cuda.is_available():
        print("b1_probe: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"probe": "device", "root": args.root, "nvidia_smi": nvidia_smi()})
    if args.ptxas:
        ptxas(native, ("fused_l2nn",), ("wgmma", "Performance"))
    native.load_all()
    dev = torch.device("cuda")
    if args.quality:   # the witness alone
        for seed in args.quality:
            quality(dev, seed)
        return 0
    gen = torch.Generator(device=dev).manual_seed(0)
    comps = torch.randn(4096, 128, generator=gen, device=dev)
    b1(dev, gen, comps, args.reps)
    if args.widths:
        widths(dev, gen, args.reps)
    if args.builds:
        builds(dev, gen, comps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
