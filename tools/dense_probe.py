#!/usr/bin/env python3
"""The smoke's compile probe and ``dense`` phase alone: ``probe.cu`` and
``fused_l2nn.cu`` built one at a time and checked (kernels B6 and B1),
then the dense long tail — reductions, ``gemm``, ``argmin``, the four
least-squares algorithms and the SVDs on configs[1]'s blobs, the
symmetric eigenproblem, the RBF gram matrix, the label utilities and the
LAP solver against scipy — on the smoke's seeded data, with the smoke's
checks.

    python3 tools/dense_probe.py [--seed 0]      # one CUDA card

Prints the card's name and power limit, then the ``probe`` line, B6's
``kernel`` line and the ``dense`` line exactly as ``chip_smoke.py`` does,
then one line of the probe's launches and the phases' seconds.
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
        print("dense_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    try:
        _, launches = cs.probe_phase(device)
        cs.dense_phase(device, args.seed, smi)
    except cs.CheckFailed as e:
        print(f"dense_probe: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"phases_s": time.perf_counter() - t0,
                      "launches_probe": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
