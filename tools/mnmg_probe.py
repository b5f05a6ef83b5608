#!/usr/bin/env python3
"""The smoke's two distributed phases alone: ``mnmg`` (a world of one over
NCCL in this process) and ``mnmg_w2`` (two gloo processes on the one
card), on the smoke's data — the k-means path's ``make_blobs`` at
BASELINE.json configs[1] with its k-means‖ init, and the 1M × 128 mixture
with its 10,000 queries, made from the same seed the same way.

    python3 tools/mnmg_probe.py [--seed 0] [--n 1000000]   # one CUDA card

Prints the card's name and power limit, then the ``mnmg`` and ``mnmg_w2``
JSON lines exactly as ``chip_smoke.py`` does (their checks hold here too,
launch counts included), then one line of launches by path.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n-lists", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mnmg_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from raft_tpu_torch import cluster
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.random import RngState, make_blobs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    native.load_all()
    cs.emit({"phase": "kernel_build", "seconds": time.perf_counter() - t0})
    # the smoke's data, in its order
    gen = torch.Generator(device=device).manual_seed(args.seed)
    comps = torch.randn(4 * args.n_lists, args.dim, generator=gen,
                        device=device)
    x = cs.mixture(gen, args.n, args.dim, comps, 0.7, device)
    queries = cs.mixture(gen, args.queries, args.dim, comps, 0.7, device)
    n, dim, k = cs.KMEANS_SHAPE
    kx, _, _ = make_blobs(RngState(args.seed), n, dim, n_clusters=k,
                          cluster_std=1.0, device=device)
    params = cluster.KMeansParams(n_clusters=k, seed=args.seed)
    c0 = cluster.init_plus_plus(RngState(args.seed), kx, k,
                                params.oversampling_factor,
                                metric=params.metric)
    # the k-means path warms every kernel of its fit before these phases
    cluster.fit_predict(params, kx)
    try:
        km, knn, world1 = cs.mnmg_phase(device, args.seed, (kx, c0), x,
                                        queries, args.k, smi)
        km2, knn2 = cs.mnmg_w2_phase(device, args.seed, (kx, c0), x,
                                     queries, args.n_lists, args.k, world1,
                                     smi)
    except cs.CheckFailed as e:
        print(f"mnmg_probe: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"launches_by_path": {
        "mnmg_km": km, "mnmg_km_w2": km2, "mnmg_knn": knn,
        "mnmg_knn_w2": knn2}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
