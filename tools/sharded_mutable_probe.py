#!/usr/bin/env python3
"""The smoke's sharded mutable phases alone — ``sharded_mutable`` (world
1 over NCCL in this process, IVF-Flat and IVF-PQ) and
``sharded_mutable_w2`` (IVF-PQ on two gloo processes on the one card,
its coordinator a native ``MailboxServer``) — on the smoke's data: the
1M × 128 mixture with its 10,000 queries, made from the same seed the
same way, the IVF-Flat and IVF-PQ indexes built single-device first (the
mutable indexes the world-1 phase compares with).

    python3 tools/sharded_mutable_probe.py [--seed 0] [--n 1000000]   # one CUDA card

Prints the card's name and power limit, then the two JSON lines exactly
as ``chip_smoke.py`` does (their checks hold here too, launch counts
included), then one line of launches by path.
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
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sharded_mutable_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

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
    _, calls = cs.ragged_calls(queries.cpu().numpy(), args.queries)
    resident = {
        "ivf_flat": (None, ivf_flat.build(
            ivf_flat.IndexParams(n_lists=args.n_lists), x, device=device)),
        "ivf_pq": (None, ivf_pq.build(
            ivf_pq.IndexParams(n_lists=args.n_lists), x, device=device))}
    try:
        t0 = time.perf_counter()
        w1, world1, qps1 = cs.sharded_mutable_phase(
            device, args.seed, x, queries, calls, args.queries,
            args.n_lists, args.n_probes, args.k, resident, smi)
        w2 = cs.sharded_mutable_w2_phase(
            device, args.seed, x, queries, args.n_lists, args.n_probes,
            args.k, resident, world1, qps1, smi)
        phases_s = time.perf_counter() - t0
    except cs.CheckFailed as e:
        print(f"sharded_mutable_probe: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"phases_s": phases_s, "launches_by_path": {
        "sharded_mutable": w1, "sharded_mutable_w2": w2}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
