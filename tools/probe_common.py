"""What the kernel probes under ``tools/`` share: the card's published
peaks, device timing with CUDA events, the data they time on, and
``nvcc -Xptxas -v`` of a kernel source.

The probes import it as a sibling module (``python3 tools/<probe>.py``
puts ``tools/`` first on the path); it imports nothing of the port, so a
probe run with ``--root`` against another checkout times that
checkout's kernels with this checkout's clock.
"""

import json
import subprocess
import tempfile

#: the card's published peaks (H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
F32_INSTR_PER_S = F32_FLOP_PER_S / 2   # an FMA counts as two flop
TF32_FLOP_PER_S = 495e12  # tensor cores, TF32 operands, float32 sums
#: cycles the card sleeps per timed call, ahead of the host's enqueue
SLEEP_CYCLES = 200_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def elapsed_ms(fn, reps: int = 20, sleep: bool = True) -> float:
    """Milliseconds per call, the mean of *reps* calls after a warm one.
    With *sleep* the card sleeps while the host enqueues the calls, so
    this is device time; without, the calls run back to back and the
    host's launch overhead counts where it is the slower side."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if sleep:
        torch.cuda._sleep(SLEEP_CYCLES * reps)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def mixture(gen, n, dim, comps, dev):
    """*n* rows of a Gaussian mixture around the rows of *comps*."""
    import torch

    pick = torch.randint(0, comps.shape[0], (n,), generator=gen, device=dev)
    return comps[pick] + 0.7 * torch.randn(n, dim, generator=gen, device=dev)


def ptxas(native, sources, words=(), keep: int = 80) -> None:
    """One ``ptxas`` line per source: its entry functions, registers,
    spills and errors (and lines holding any of *words*) from
    ``nvcc -Xptxas -v`` with the port's build flags."""
    want = ("registers", "spill", "error", "Compiling entry", *words)
    for name in sources:
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run([native._nvcc(), *native.NVCC_FLAGS,
                                  "-Xptxas", "-v", "-o", f"{tmp}/{name}.so",
                                  str(native.CSRC / f"{name}.cu")],
                                 capture_output=True, text=True)
        lines = [ln for ln in (out.stdout + out.stderr).splitlines()
                 if any(w in ln for w in want)]
        emit({"probe": "ptxas", "source": f"{name}.cu", "rc": out.returncode,
              "lines": lines[-keep:]})
