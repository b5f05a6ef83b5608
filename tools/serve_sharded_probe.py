#!/usr/bin/env python3
"""The smoke's type-ladder and distributed serving phases alone —
``serve_dtypes``, ``sharded`` (world 1 over NCCL in this process),
``sharded_w2`` and ``replica_w2`` (two gloo processes on the one card) —
on the smoke's data: the 1M × 128 mixture with its 10,000 queries, made
from the same seed the same way, the IVF-Flat and IVF-PQ indexes built
and served single-device first (the results and qps the phases compare
with).

    python3 tools/serve_sharded_probe.py [--seed 0] [--n 1000000]   # one CUDA card

Prints the card's name and power limit, one ``resident`` line per
single-device engine, then the four JSON lines exactly as
``chip_smoke.py`` does (their checks hold here too, launch counts
included), then one line of launches by path.  ``--profile`` adds a
``profile`` line (device time by kernel over one 1,024-query
super-batch) for each single-device and world-1 sharded engine.
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
    ap.add_argument("--n-probes", type=int, default=20)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one 1,024-query super-batch of each "
                    "single-device and world-1 sharded engine")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("serve_sharded_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
    from raft_tpu_torch.serve import ServeEngine

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
    q_host = queries.cpu().numpy()
    nq, k = args.queries, args.k
    reqs, calls = cs.ragged_calls(q_host, nq)
    flat_params = ivf_flat.SearchParams(n_probes=args.n_probes)
    indexes = {
        "ivf_flat": (ivf_flat.build(ivf_flat.IndexParams(
            n_lists=args.n_lists), x, device=device), flat_params, {}),
        "ivf_pq": (ivf_pq.build(ivf_pq.IndexParams(n_lists=args.n_lists),
                                x, device=device),
                   ivf_pq.SearchParams(n_probes=args.n_probes), {}),
        "brute_force": (x, None, {"metric": "l1", "device": device})}
    resident, engines = {}, {}
    try:
        for kind, (index, params, kw) in indexes.items():
            eng = ServeEngine(index, k, params, max_batch=1024, **kw)
            results, _, serve_s = cs._closed_loop(eng, calls)
            row = {"phase": "resident", "path": kind, "qps": nq / serve_s,
                   "card": smi}
            cs.emit(row)
            resident[kind] = (cs.Served(results, row, None), index)
            engines[kind] = eng
            if args.profile:
                cs.profile_serve(kind, eng, q_host, device)
        dt = cs.serve_dtypes_phase(device, {
            "brute_force": (engines["brute_force"], lambda q: brute_force.knn(
                x, q, k, "l1", device=device)),
            "ivf_flat": (engines["ivf_flat"], lambda q: ivf_flat.search(
                flat_params, indexes["ivf_flat"][0], q, k))}, q_host, nq,
            smi)
        sh, world1, qps1 = cs.sharded_phase(
            device, x, q_host, reqs, calls, nq, args.n_lists, args.n_probes,
            k, resident, smi, args.profile)
        w2 = cs.sharded_w2_phase(device, args.seed, x, queries, args.n_lists,
                                 args.n_probes, k, resident, world1, qps1,
                                 smi)
        rep = cs.replica_w2_phase(device, args.seed, x, queries,
                                  args.n_lists, args.n_probes, k, resident,
                                  smi)
    except cs.CheckFailed as e:
        print(f"serve_sharded_probe: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"launches_by_path": {
        "serve_dtypes": dt, "sharded": sh, "sharded_w2": w2,
        "replica_w2": rep}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
