"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perf_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the port's kernel libraries, the seeded data, the warm and the
timed build, the warm-up of every shape the traffic uses) is timed as
``setup_s``; then the window runs for ``--seconds``; then the answers are
held to the plain reference.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``; ``check`` last: each
compared number beside its limit), and the compared numbers are the last
lines of standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.

Exits 2 without a result when there is no CUDA card (or fewer than the
cell asks for), and 3 when a module of JAX or of the JAX package was
loaded.
"""

import os
import time

T_START = time.perf_counter()
# one process with few host threads: the card's host is shared, and a
# parallel host op that loses a core stalls whole (set before numpy and
# torch are imported)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "2"

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _log(msg: str) -> None:
    print(f"perf_bench: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # libraries the port may pull in must not load JAX on their own
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    from perf_bench.harness import cell as cell_mod
    from perf_bench.harness import spec

    c = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available():
        _log("no CUDA device: this benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < c.chips:
        _log(f"{c.name} needs {c.chips} cards, "
             f"{torch.cuda.device_count()} found")
        return 2
    out = cell_mod.run(c, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START, log=_log)
    bad = cell_mod.forbidden_modules()
    if bad:
        _log(f"forbidden modules loaded in this process: {bad}")
        return 3
    for name, v in out["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
