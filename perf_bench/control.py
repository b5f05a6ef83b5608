"""Readings that set the limits of ``correct`` (not run by the benchmark's
own runs).

    python3 perf_bench/control.py --workload <name> --seeds 1,2,... \
        --seconds 3 [--fault <name>]

In one process, for each seed: one run of the cell as the benchmark makes
it (a short window at the cell's own load), its compared numbers, and on
the same sampled queries the control's: the reference's own search in
TF32 put in the program's place and judged as the program is.  With
``--fault`` the port's training is broken as ``faults.py`` plants it,
and the program's readings are the fault's.  One JSON line a seed, then
the largest program reading and the smallest control reading of each
number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import contextlib

    import torch

    from perf_bench import faults

    from perf_bench.harness import cell as cell_mod
    from perf_bench.harness import spec

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    prog, ctrl = {}, {}
    for s in [int(v) for v in args.seeds.split(",")]:
        c = spec.load(args.workload)
        plant = (faults.planted(args.fault, c.config) if args.fault
                 else contextlib.nullcontext())
        t = time.perf_counter()
        with plant:
            out = cell_mod.run(c, s, args.seconds, False, dev, t,
                               control=True)
        row = {"seed": s, "fault": args.fault, "correct": out["correct"],
               "program": {k: v["value"] for k, v in out["check"].items()},
               "control": out["control"], "info": out["info"],
               "metrics": out["metrics"]}
        print(json.dumps(row), flush=True)
        for k, v in row["program"].items():
            prog[k] = max(prog.get(k, v), v)
        for k, v in out["control"].items():
            ctrl[k] = min(ctrl.get(k, v), v)
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": prog, "control_min": ctrl}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
