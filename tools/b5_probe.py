#!/usr/bin/env python3
"""First short call for kernel B5 (``raft_tpu_torch/kernels/csrc/pairwise.cu``)
on one NVIDIA card: compile it with ``-Xptxas -v`` (registers, shared
memory and spills of every instantiation), build every kernel source,
hold B5 against its plain version for all ops and input types at a few
shapes (up to the brute-force scan step, 1,024 × 16,384 × 128), check
that a 37-row batch gives the same rows as the 1,024-row one, and time
each op at the step shape beside ``torch.cdist`` p=1.

    python3 tools/b5_probe.py        # needs one CUDA card and nvcc
"""

import pathlib
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from raft_tpu_torch.kernels import native, pairwise as pk  # noqa: E402


def elapsed_ms(fn, reps: int = 10) -> float:
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("b5_probe: no CUDA device is available", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-Xptxas",
                              "-v", "-o", f"{tmp}/pairwise.so",
                              str(native.CSRC / "pairwise.cu")],
                             capture_output=True, text=True)
    print(out.returncode, out.stdout[-3000:], out.stderr[-6000:])
    t0 = time.time()
    native.load_all()
    print("build", time.time() - t0)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for m, n, k in [(1, 1, 1), (37, 129, 3), (37, 16385, 127), (1, 129, 960),
                    (1024, 16384, 128)]:
        x = torch.round(torch.randn(m, k, generator=g, device=dev) * 4) / 4
        y = torch.round(torch.randn(n, k, generator=g, device=dev) * 4) / 4
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            for op in pk.OPS:
                got = pk.pairwise_accumulate(x.to(dt), y.to(dt), op, 3.0)
                ref = pk.pairwise_accumulate_plain(x.to(dt), y.to(dt), op,
                                                   3.0)
                err = (got - ref).abs()
                if not bool((err <= 1e-5 * ref.abs()).all()):
                    bad += 1
                    print("BAD", m, n, k, dt, op, float(err.max()))
        print("shape", m, n, k, "done", flush=True)
    x = torch.randn(1024, 128, generator=g, device=dev)
    y = torch.randn(16384, 128, generator=g, device=dev)
    for op in pk.OPS:
        a = pk.pairwise_accumulate(x, y, op, 3.0)
        b = pk.pairwise_accumulate(x[:37], y, op, 3.0)
        print("invariant", op, torch.equal(a[:37], b))
        print("ms", op, elapsed_ms(lambda: pk.pairwise_accumulate(x, y, op,
                                                                  3.0)))
    print("cdist p1 ms", elapsed_ms(lambda: torch.cdist(x, y, p=1)))
    print("BAD count", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
