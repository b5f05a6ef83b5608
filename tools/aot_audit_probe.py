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


def serve_wrapper(device, smi, seed: int):
    """The cost of keying each dispatch on its signature
    (``core/aot.py``) on the three serving paths the smoke drives
    (IVF-Flat, IVF-PQ, brute force under L1, over its 1M × 128 set):

    - ``signature_us``: host µs of one signature and its warm check, the
      work :class:`AotFunction` adds to a dispatch, over 2,000 calls with
      the arguments of one real super-batch;
    - ``qps_on`` / ``qps_off``: closed-loop qps over the smoke's ragged
      traffic with the backend's program as the :class:`AotFunction`
      (on) and as the function it wraps (off), in the order on, off,
      off, on within one process (host-bound qps varies between passes,
      so compare within a path only).

    One line a path."""
    import torch

    import chip_smoke as cs
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.serve import ServeEngine

    gen = torch.Generator(device=device).manual_seed(seed)
    comps = torch.randn(4 * SERVE_LISTS, SERVE_DIM, generator=gen,
                        device=device)
    x = cs.mixture(gen, SERVE_N, SERVE_DIM, comps, 0.7, device)
    q = cs.mixture(gen, SERVE_QUERIES, SERVE_DIM, comps, 0.7, device)
    _, calls = cs.ragged_calls(q.cpu().numpy(), SERVE_QUERIES)
    makers = {
        "ivf_flat": lambda: ServeEngine(
            ivf_flat.build(ivf_flat.IndexParams(n_lists=SERVE_LISTS), x,
                           device=device), SERVE_K,
            ivf_flat.SearchParams(n_probes=SERVE_PROBES), max_batch=1024),
        "ivf_pq": lambda: ServeEngine(
            ivf_pq.build(ivf_pq.IndexParams(n_lists=SERVE_LISTS), x,
                         device=device), SERVE_K,
            ivf_pq.SearchParams(n_probes=SERVE_PROBES), max_batch=1024),
        "brute_force": lambda: ServeEngine(x, SERVE_K, metric="l1",
                                           max_batch=1024, device=device),
    }
    rows = {}
    for path, make in makers.items():
        eng = make()
        backend = eng._backend
        keyed = type(backend).fn
        seen = {}

        def record(*a, **kw):
            seen.update(args=a, kwargs=kw)
            return keyed(*a, **kw)

        backend.fn = record
        eng.warmup()
        backend.fn = keyed
        a, kw = seen["args"], seen["kwargs"]
        reps = 2000
        t0 = time.perf_counter()
        for _ in range(reps):
            keyed._first_call(keyed._signature(a, kw))
        sig_us = 1e6 * (time.perf_counter() - t0) / reps
        qps = {"on": [], "off": []}
        for mode in ("on", "off", "off", "on"):
            backend.fn = keyed if mode == "on" else keyed._fn
            _, _, serve_s = cs._closed_loop(eng, calls, warm=False)
            qps[mode].append(SERVE_QUERIES / serve_s)
        backend.fn = keyed
        eng.close()
        rows[path] = {"signature_us": sig_us, "qps_on": qps["on"],
                      "qps_off": qps["off"]}
        print(json.dumps({"phase": "serve_wrapper", "path": path,
                          "nvidia_smi": smi, **rows[path]}), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--golden-dir", default=None)
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
