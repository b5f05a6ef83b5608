#!/usr/bin/env python3
"""The k-means‖ finish on the card: greedy local trials against one draw.

    python3 tools/kmeans_probe.py [--seeds 3] [--n 100000] [--dim 128]
                                  [--k 1024] [--device cpu]

On ``make_blobs`` data of the k-means path's configuration (BASELINE.json
configs[1]: 100,000 × 128, k = 1,024, cluster_std 1.0), for each seed:
``fit_predict`` with the reference defaults twice — once with the port's
greedy finish (``kmeans.local_trials(k)`` draws a step, RAFT's and
scikit-learn's rule) and once with one draw a step (the JAX package's
plain weighted k-means++, by making ``local_trials`` return 1) — printing
the init's seconds, ``n_iter``, the inertia and the ARI against
``make_blobs``' labels, beside the card's name and power limit.  With
``--device cpu`` it runs the plain versions on the host (at a smaller
shape: the ARI is the algorithm's; the seconds are no device metric).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from probe_common import emit, nvidia_smi  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from raft_tpu_torch.cluster import KMeansParams, fit_predict
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.random import RngState, make_blobs
    from raft_tpu_torch.stats import adjusted_rand_index

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("kmeans_probe: no CUDA device is available", file=sys.stderr)
        return 2
    smi = nvidia_smi() if dev.type == "cuda" else "cpu"
    greedy = kmeans.local_trials
    for seed in range(args.seeds):
        x, truth, _ = make_blobs(RngState(seed), args.n, args.dim,
                                 n_clusters=args.k, device=dev)
        params = KMeansParams(n_clusters=args.k, seed=seed)
        for name, trials in (("greedy", greedy), ("one_draw", lambda k: 1)):
            kmeans.local_trials = trials
            t0 = time.perf_counter()
            kmeans.init_plus_plus(RngState(seed), x, args.k)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            out = fit_predict(params, x)
            emit({"probe": "kmeans_finish", "seed": seed, "finish": name,
                  "trials": trials(args.k), "shape": [args.n, args.dim,
                                                      args.k],
                  "init_s": init_s, "n_iter": int(out.n_iter),
                  "inertia": float(out.inertia),
                  "ari": float(adjusted_rand_index(truth, out.labels)),
                  "card": smi})
    kmeans.local_trials = greedy
    return 0


if __name__ == "__main__":
    sys.exit(main())
