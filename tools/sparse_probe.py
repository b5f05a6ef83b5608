#!/usr/bin/env python3
"""The smoke's sparse graph phases alone — ``single_linkage`` (KNN_GRAPH
on the k-means path's 100,000 × 128 blobs, PAIRWISE on their first
20,000 rows against scipy's MST), ``spectral`` (BASELINE.json configs[3]
and the 1M-vertex planted-partition graph through ``partition`` and
``modularity_maximization``) and ``sparse_knn`` (TF-IDF-shaped rows,
cosine and inner product on the compressed engine, L1 on the densify
engine) — on the smoke's seeded data, in the smoke's order.

    python3 tools/sparse_probe.py [--seed 0]      # one CUDA card

Prints the card's name and power limit, then the phases' JSON lines
exactly as ``chip_smoke.py`` does (their checks hold here too, launch
counts included), then one line of launches by path and the phases'
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
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sparse_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from raft_tpu_torch.kernels import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    native.load_all()
    cs.emit({"phase": "kernel_build", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    try:
        sl, _, scipy_check = cs.single_linkage_phase(device, args.seed,
                                                     smi)
        try:
            spec, _ = cs.spectral_phase(device, args.seed, smi)
            spknn = cs.sparse_knn_phase(device, args.seed, smi)
            scipy_check.finish()
        finally:
            scipy_check.close()
    except cs.CheckFailed as e:
        print(f"sparse_probe: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"phases_s": time.perf_counter() - t0,
                      "launches_by_path": {"single_linkage": sl,
                                           "spectral": spec,
                                           "sparse_knn": spknn}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
