#!/usr/bin/env python3
"""The smoke's ``aot`` and ``audit`` phases alone: every kernel source
built (nvcc, all at once) into the checkout's ``build/``, then
``prewarm()`` in a fresh process over that cache (nothing may build; each
signature's first and warm call; B1, B2 and B5 at prewarmed signatures
against their plain versions; BASELINE configs[0] at 5,000 × 5,000 × 50
against float64; the grid again with no compile), then the program
audit of every registered program on the card, with the smoke's checks,
then the keyed serving programs' own cost (``serve_wrapper``, see
:func:`serve_wrapper`).

    python3 tools/aot_audit_probe.py [--seed 0] [--golden-dir DIR]
                                     [--serve-only]

``--golden-dir`` writes the card's fingerprints under
``DIR/<scope>/<program>.json`` (the layout of
``raft_tpu_torch/analysis/goldens``).  Prints the card's name and power
limit, the build's seconds, the phases' lines as ``chip_smoke.py`` does,
and one line of the launches by phase.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


#: the smoke's serving set: 1M × 128 rows, 1,024 lists, 20 probes, k = 10
SERVE_N, SERVE_DIM, SERVE_LISTS, SERVE_PROBES, SERVE_K = (
    1_000_000, 128, 1024, 20, 10)
#: ragged queries a pass, the smoke's traffic
SERVE_QUERIES = 10_000


def _signature_us(keyed, args, kwargs, reps: int = 2000) -> float:
    """Host µs of one signature and its warm check: the work
    :class:`AotFunction` adds to a call."""
    t0 = time.perf_counter()
    for _ in range(reps):
        keyed._first_call(keyed._signature(args, kwargs))
    return 1e6 * (time.perf_counter() - t0) / reps


def serve_wrapper(device, smi, seed: int):
    """The cost of keying each dispatch on its signature
    (``core/aot.py``) on five serving paths over the smoke's 1M × 128 set:
    IVF-Flat, IVF-PQ, brute force under L1, the mutable index over the
    IVF-Flat main after 10,000 upserts and 10,000 deletes, and IVF-PQ
    tiered with a quarter of its lists on the card:

    - ``signature_us``: host µs of one signature and its warm check, by
      keyed program, over 2,000 calls with the arguments of one real
      dispatch (a super-batch, or one cold tile's scan and merge);
      ``key_us_per_dispatch`` is their sum over the programs one dispatch
      calls (the tiered path: the hot phase, then each cold tile's scan
      and merge, ``key_us_per_cold_tile``);
    - ``qps_on`` / ``qps_off``: closed-loop qps over the smoke's ragged
      traffic with every program of the path as the :class:`AotFunction`
      (on) and as the function it wraps (off), in the order on, off,
      off, on within one process (host-bound qps varies between passes,
      so compare within a path only).

    One line a path."""
    import importlib

    import numpy as np
    import torch

    import chip_smoke as cs
    from raft_tpu_torch.neighbors import (ivf_flat, ivf_pq, mutable,
                                          tiering)
    from raft_tpu_torch.serve import ServeEngine

    sk = importlib.import_module("raft_tpu_torch.matrix.select_k")
    gen = torch.Generator(device=device).manual_seed(seed)
    comps = torch.randn(4 * SERVE_LISTS, SERVE_DIM, generator=gen,
                        device=device)
    x = cs.mixture(gen, SERVE_N, SERVE_DIM, comps, 0.7, device)
    q = cs.mixture(gen, SERVE_QUERIES, SERVE_DIM, comps, 0.7, device)
    _, calls = cs.ragged_calls(q.cpu().numpy(), SERVE_QUERIES)
    flat_p = ivf_flat.SearchParams(n_probes=SERVE_PROBES)
    pq_p = ivf_pq.SearchParams(n_probes=SERVE_PROBES)
    flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=SERVE_LISTS), x,
                          device=device)
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=SERVE_LISTS), x,
                      device=device)

    def churned():
        mut = mutable.MutableIndex(flat, x, build_params=ivf_flat.IndexParams(
            n_lists=SERVE_LISTS))
        rng = np.random.default_rng(seed)
        for b in range(20):
            ids = np.arange(SERVE_N + 500 * b, SERVE_N + 500 * (b + 1))
            mut.upsert(cs.mixture(gen, 500, SERVE_DIM, comps, 0.7, device),
                       ids)
            mut.delete(rng.choice(SERVE_N, 500, replace=False))
        return ServeEngine(mut, SERVE_K, flat_p, max_batch=1024)

    # path → (engine maker, the (owner, attribute) of each keyed program
    # a dispatch calls; "backend" is the engine's backend)
    paths = {
        "ivf_flat": (lambda: ServeEngine(flat, SERVE_K, flat_p,
                                         max_batch=1024),
                     [("backend", "fn")]),
        "ivf_pq": (lambda: ServeEngine(pq, SERVE_K, pq_p, max_batch=1024),
                   [("backend", "fn")]),
        "brute_force": (lambda: ServeEngine(x, SERVE_K, metric="l1",
                                            max_batch=1024, device=device),
                        [("backend", "fn")]),
        "mutable_ivf_flat": (churned, [(mutable, "_merged_aot")]),
        "tiered_ivf_pq": (lambda: ServeEngine(
            tiering.tier(pq, hot_fraction=0.25), SERVE_K, pq_p,
            max_batch=1024),
            [(tiering, "_hot_phase_aot"), (ivf_pq, "_search_batch_aot"),
             (sk, "_merge_aot")]),
    }
    rows = {}
    for path, (make, programs) in paths.items():
        eng = make()
        owners = [eng._backend if o == "backend" else o
                  for o, _ in programs]
        keyed = [getattr(o, name) for o, (_, name) in zip(owners, programs)]
        seen = {}

        def recorder(name, fn):
            def record(*a, **kw):
                seen.setdefault(name, (a, kw))
                return fn(*a, **kw)
            return record

        def install(fns):
            for o, (_, name), fn in zip(owners, programs, fns):
                setattr(o, name, fn)

        install([recorder(name, k) for (_, name), k in zip(programs, keyed)])
        eng.warmup()
        install(keyed)
        sig_us = {name: _signature_us(k, *seen[name])
                  for (_, name), k in zip(programs, keyed)}
        qps = {"on": [], "off": []}
        for mode in ("on", "off", "off", "on"):
            install(keyed if mode == "on" else [k._fn for k in keyed])
            _, _, serve_s = cs._closed_loop(eng, calls, warm=False)
            qps[mode].append(SERVE_QUERIES / serve_s)
        install(keyed)
        row = {"signature_us": sig_us, "qps_on": qps["on"],
               "qps_off": qps["off"]}
        if path.startswith("tiered"):
            tiles = len(eng._backend.searcher.tiered.cold_tiles)
            per_tile = sig_us["_search_batch_aot"] + sig_us["_merge_aot"]
            row.update(cold_tiles=tiles, key_us_per_cold_tile=per_tile,
                       key_us_per_dispatch=sig_us["_hot_phase_aot"]
                       + tiles * per_tile)
        else:
            row["key_us_per_dispatch"] = sum(sig_us.values())
        eng.close()
        rows[path] = row
        print(json.dumps({"phase": "serve_wrapper", "path": path,
                          "nvidia_smi": smi, **row}), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--golden-dir", default=None)
    ap.add_argument("--serve-only", action="store_true",
                    help="only the serve_wrapper lines (no aot/audit)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("aot_audit_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from raft_tpu_torch.kernels import native

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    native.load_all()
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "kernel_build", "seconds": build_s,
                      "nvidia_smi": smi}), flush=True)
    if args.serve_only:
        serve_wrapper(device, smi, args.seed)
        return 0
    try:
        t1 = time.perf_counter()
        aot = cs.aot_phase(device, args.seed, smi)
        t2 = time.perf_counter()
        audit = cs.audit_phase(device, smi, args.golden_dir)
        t3 = time.perf_counter()
        serve_wrapper(device, smi, args.seed)
    except cs.CheckFailed as e:
        print(f"aot_audit_probe: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"aot_s": t2 - t1, "audit_s": t3 - t2,
                      "launches": {"aot": aot, "audit": audit},
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
