#!/usr/bin/env python3
"""What the serving layer costs on the host: closed-loop ``search()``
calls over the smoke's data (1,000,000 × 128 mixture, 10,000 queries in
the smoke's ragged requests, eight to a call) through an IVF-PQ engine
(n_lists 1,024, n_probes 20, the host-bound path) and an L1 brute-force
engine, each in three configurations timed in turns:

- ``legacy``: ``scheduler=False, admission=False`` (the drain-all engine);
- ``default``: the continuous-batching chooser and admission on;
- ``default_no_telemetry``: the same with ``telemetry.set_enabled(False)``
  (no spans, histograms or device sampling; counters stay).

One measurement serves every query ``passes`` times (enough passes for a
quarter of a second); a round measures each configuration once, the
first one rotating from round to round.  Prints one JSON line per path
with each configuration's qps per round, median and quartiles, and the
per-round ratio to ``legacy``, beside the card's name and power limit.

    python3 tools/serve_probe.py [--rounds 10] [--seed 0]
"""

import argparse
import math
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its data and request pattern)
from probe_common import emit, nvidia_smi  # noqa: E402

CONFIGS = ("legacy", "default", "default_no_telemetry")
#: the smoke's deployment: sift-128-euclidean's shape, n_lists 1,024
N, DIM, QUERIES, N_LISTS = 1_000_000, 128, 10_000, 1024


def _engines(path, x, device):
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.serve import ServeEngine

    if path == "ivf_pq":
        index = ivf_pq.build(ivf_pq.IndexParams(n_lists=N_LISTS), x,
                             device=device)
        params = ivf_pq.SearchParams(n_probes=20)

        def make(**kw):
            return ServeEngine(index, 10, params, max_batch=1024, **kw)
    else:
        def make(**kw):
            return ServeEngine(x, 10, metric="l1", max_batch=1024,
                               device=device, **kw)
    engines = {"legacy": make(scheduler=False, admission=False),
               "default": make()}
    engines["default_no_telemetry"] = engines["default"]
    for eng in set(engines.values()):
        eng.warmup()
    return engines


def _serve(eng, calls, passes, telemetry_on):
    import torch

    from raft_tpu_torch import telemetry

    prev = telemetry.set_enabled(telemetry_on)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(passes):
            for call in calls:
                eng.search(call)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        telemetry.set_enabled(prev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", default="ivf_pq,brute_force")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(args.seed)
    comps = torch.randn(4 * N_LISTS, DIM, generator=gen, device=device)
    x = chip_smoke.mixture(gen, N, DIM, comps, 0.7, device)
    queries = chip_smoke.mixture(gen, QUERIES, DIM, comps, 0.7, device)
    _, calls = chip_smoke.ragged_calls(queries.cpu().numpy(), QUERIES)
    smi = nvidia_smi()
    for path in args.paths.split(","):
        engines = _engines(path, x, device)
        first = _serve(engines["legacy"], calls, 1, True)
        passes = max(1, math.ceil(0.25 / first))
        qps = {c: [] for c in CONFIGS}
        for r in range(args.rounds):
            for j in range(len(CONFIGS)):
                c = CONFIGS[(r + j) % len(CONFIGS)]
                s = _serve(engines[c], calls, passes,
                           c != "default_no_telemetry")
                qps[c].append(QUERIES * passes / s)
        row = {"path": path, "passes": passes, "rounds": args.rounds,
               "card": smi}
        for c in CONFIGS:
            q1, med, q3 = (statistics.quantiles(qps[c], n=4)
                           if len(qps[c]) > 1 else [qps[c][0]] * 3)
            row[c] = {"qps": qps[c], "median": med, "q1": q1, "q3": q3}
            if c != "legacy":
                row[c]["ratio_to_legacy"] = [
                    a / b for a, b in zip(qps[c], qps["legacy"])]
                row[c]["wins_over_legacy"] = sum(
                    a > b for a, b in zip(qps[c], qps["legacy"]))
        emit(row)
        for eng in set(engines.values()):
            eng.close()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
