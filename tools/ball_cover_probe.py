#!/usr/bin/env python3
"""Time the random ball cover on one CUDA card, pass by pass.

    python3 tools/ball_cover_probe.py [--n N] [--queries Q] [--k K]
        [--all-points M ...] [--cap-s S] [--metric l2|haversine]
        [--profile]

The data are the smoke's (``chip_smoke.py`` ``ball_cover`` phase): N
points of a Gaussian mixture in 3 dimensions (4,096 components, noise
0.7), or clustered (lat, lon) radians for Haversine.  Prints one JSON
line each: the build (seconds, landmarks, chunk capacity, physical rows,
list-size and radius quantiles), both passes of ``knn_query`` over Q
queries (landmarks a query, queries, seconds), with ``--profile`` the
first pass's kernel launches and device time (``torch.profiler``), and
``all_knn_query`` over the first M points with its passes summed.
"""

import argparse
import json
import math
import sys
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--all-points", type=int, nargs="*",
                    default=[200_000, 1_000_000],
                    help="all_knn_query over the first M points, each M in "
                    "turn while the last one's time, scaled by (M/M')², "
                    "stays under --cap-s")
    ap.add_argument("--cap-s", type=float, default=300.0)
    ap.add_argument("--metric", choices=("l2", "haversine"), default="l2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ball_cover_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(__import__("pathlib").Path(__file__)
                           .resolve().parents[1]))
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.neighbors import ball_cover as bc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)

    def mixture(n, centres, noise):
        pick = torch.randint(0, centres.shape[0], (n,), generator=gen,
                             device=dev)
        return centres[pick] + noise * torch.randn(
            n, centres.shape[1], generator=gen, device=dev)

    if args.metric == "l2":
        centres = torch.randn(4096, 3, generator=gen, device=dev)
        noise, metric = 0.7, DistanceType.L2SqrtExpanded
    else:
        centres = torch.stack([
            (torch.rand(4096, generator=gen, device=dev) * 2 - 1) * 1.4,
            (torch.rand(4096, generator=gen, device=dev) * 2 - 1)
            * math.pi], 1)
        noise, metric = 0.02, DistanceType.Haversine
    x = mixture(args.n, centres, noise)
    q = mixture(args.queries, centres, noise)
    card = torch.cuda.get_device_name(0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = bc.build_index(x, metric, seed=args.seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sizes = index.list_sizes.float()
    qs = torch.tensor([0.0, 0.5, 0.9, 0.99, 1.0], device=dev)
    emit({"probe": "build", "metric": args.metric, "n": args.n,
          "seconds": build_s, "n_landmarks": index.n_landmarks,
          "capacity": index.capacity,
          "physical_rows": int(index.list_data.shape[0]),
          "list_size_q": torch.quantile(sizes, qs).tolist(),
          "radius_q": torch.quantile(index.radii.float(), qs).tolist(),
          "card": card})

    passes = []
    scan, batch = bc._scan_landmarks, bc._query_batch
    first_of_batch = [False]

    def marked_batch(*a, **kw):
        first_of_batch[0] = True
        return batch(*a, **kw)

    def timed_scan(index, qb, probe_ids, k, engine=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = scan(index, qb, probe_ids, k, engine)
        torch.cuda.synchronize()
        passes.append({"first": first_of_batch[0],
                       "width": int(probe_ids.shape[1]),
                       "queries": int(qb.shape[0]),
                       "landmarks": int((probe_ids
                                         < index.n_landmarks).sum()),
                       "seconds": time.perf_counter() - t})
        first_of_batch[0] = False
        return out

    bc._scan_landmarks, bc._query_batch = timed_scan, marked_batch
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        p0 = min(index.n_landmarks,
                 max(4, int(math.isqrt(index.n_landmarks)) * 2))
        first = torch.topk(bc.distance(q, index.landmarks, index.metric),
                           p0, dim=1, largest=False).indices.int()
        scan(index, q, first, args.k)   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            scan(index, q, first, args.k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        dev_us = sum(e.self_device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        emit({"probe": "profile_first_pass", "probes": p0,
              "wall_s": wall, "device_s": dev_us / 1e6,
              "launches": sum(e.count for e in events),
              "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                      for e in top], "card": card})
    passes.clear()
    t0 = time.perf_counter()
    bc.knn_query(index, q, args.k)
    torch.cuda.synchronize()
    emit({"probe": "knn_query", "queries": args.queries, "k": args.k,
          "seconds": time.perf_counter() - t0, "passes": passes,
          "card": card})

    prev = None
    for m in args.all_points:
        if prev is not None and prev[1] * (m / prev[0]) ** 2 > args.cap_s:
            emit({"probe": "all_knn_query", "points": m, "skipped":
                  f"projected past {args.cap_s} s"})
            break
        sub = (index if m >= args.n else
               bc.build_index(x[:m], metric, seed=args.seed))
        passes.clear()
        t0 = time.perf_counter()
        bc.all_knn_query(sub, 8)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        second = [p for p in passes if not p["first"]]
        emit({"probe": "all_knn_query", "points": m, "k": 8,
              "seconds": secs, "passes": len(passes),
              "first_pass_s": sum(p["seconds"] for p in passes
                                  if p["first"]),
              "second_pass_s": sum(p["seconds"] for p in second),
              "second_pass_queries": sum(p["queries"] for p in second),
              "second_pass_landmarks": sum(p["landmarks"] for p in second),
              "card": card})
        prev = (m, secs)
    bc._scan_landmarks, bc._query_batch = scan, batch
    return 0


if __name__ == "__main__":
    sys.exit(main())
