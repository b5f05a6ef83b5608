"""Find the knee of an open-loop cell: the highest offered rate the port
sustains without a growing backlog.

    python3 perf_bench/sweep.py --workload <open cell> --rates 4000,6000 \
        --seconds 10 [--seed N]

One set-up (the cell's own: data, builds, the warmed engine), then the
cell's mix at each rate in turn, rising.  A rate is sustained when the answered rows a
second reach 95% of the offered and the median latency of the last
quarter of requests is at most twice that of the first quarter (a queue
that grows through the run makes the later requests wait longer).  The
knee is the highest rate below which every rate was sustained.  One JSON
line a rate, then the knee and 0.8 times it, the rate an open cell below
capacity takes.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def sustained(row: dict) -> bool:
    return (row["served_qps"] >= 0.95 * row["offered_qps"]
            and row["last_quarter_p50_ms"] <= 2.0 * row["first_quarter_p50_ms"]
            and row["failed"] == 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from perf_bench.harness import cell, loops, spec, traffic
    from perf_bench.harness.trace import Tracer

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    c = spec.load(args.workload)
    off = Tracer(False, dev)
    su = cell.set_up(c, args.seed, args.seconds, dev, off)
    server, pool_host = su.server, su.pool.cpu().numpy()
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = dict(c.traffic, rate_qps=rate)
        tr = traffic.make(mix, args.seed, args.seconds, su.pool.shape[0],
                          su.x.shape[1])
        reqs = [pool_host[r] for r in tr.rows]
        w = loops.open_loop(server, reqs, tr.arrivals, args.seconds, off, [])
        lat = w.latencies_s
        q = max(1, len(lat) // 4)
        row = {"rate_qps": rate, "requests": w.attempted,
               "offered_qps": sum(tr.sizes) / float(tr.arrivals[-1] or 1),
               "served_qps": w.queries / w.answered_by_s,
               "p50_ms": float(np.percentile(lat, 50)) * 1e3,
               "p99_ms": float(np.percentile(lat, 99)) * 1e3,
               "first_quarter_p50_ms": float(np.median(lat[:q])) * 1e3,
               "last_quarter_p50_ms": float(np.median(lat[-q:])) * 1e3,
               "failed": w.failed + w.unanswered, "late_s": w.late_s,
               "coalesced": dict(server.engine.stats)["super_batches"]}
        row["sustained"] = sustained(row)
        rows.append(row)
        print(json.dumps(row), flush=True)
    server.close()
    knee = None
    for r in sorted(rows, key=lambda r: r["rate_qps"]):
        if not r["sustained"]:
            break
        knee = r["rate_qps"]
    print(json.dumps({"knee_qps": knee,
                      "cell_rate_qps": 0.8 * knee if knee else None,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
