#!/usr/bin/env python3
"""The smoke's ``handle`` phase alone, at the smoke's size: the kernels
built, the smoke's seeded 1,000,000 × 128 mixture and 10,000 queries, the
IVF-PQ (n_lists 1,024, the JAX package's defaults) and IVF-Flat indexes
built through the kernels, then ``chip_smoke.handle_phase`` — the
IVF-PQ search with no handle, ``Handle()`` and a pool of 4 (seconds to
return, seconds to ``sync()``, pool streams pending at return), B1–B5
under a handle against the handle-less calls, the allocator, cancel and
foreign-stream checks.

    python3 tools/handle_probe.py [--seed 0] [--reps 3]    # one CUDA card

Prints the card's name and power limit, the ``handle`` line exactly as
``chip_smoke.py`` does, then one line of the builds' and the phase's
seconds.
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
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("handle_probe: no CUDA device is available", file=sys.stderr)
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
    cs.HANDLE_REPS = args.reps
    t0 = time.perf_counter()
    native.load_all()
    t_build = time.perf_counter() - t0
    n, n_queries, dim, n_lists, n_probes, k = (1_000_000, 10_000, 128,
                                               1024, 20, 10)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    comps = torch.randn(4 * n_lists, dim, generator=gen, device=device)
    x = cs.mixture(gen, n, dim, comps, 0.7, device)
    queries = cs.mixture(gen, n_queries, dim, comps, 0.7, device)
    t1 = time.perf_counter()
    index_pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=n_lists), x)
    index_flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=n_lists), x)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t1
    try:
        t2 = time.perf_counter()
        cs.handle_phase(device, index_pq, index_flat, x, queries, n_probes,
                        k, smi)
        t_phase = time.perf_counter() - t2
    except cs.CheckFailed as e:
        print(f"handle_probe: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernel_build_s": t_build, "index_build_s": t_index,
                      "phase_s": t_phase}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
