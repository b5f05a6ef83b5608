"""Run one function on every rank of a world of processes — the multi-rank
harness of the port's CPU tests and of the smoke's multi-process phase.

:func:`run_world` starts *world* Python processes (this module's
``__main__``), each of which opens a :class:`~raft_tpu_torch.comms.
CommsSession` over a ``file://`` rendezvous in *workdir*, calls
``target(comms, payload)`` and writes what it returns (pickled) back to
*workdir*.  The parent waits for all of them under one deadline: a rank
that fails or a world that hangs raises, and every process still running
is killed first.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time
from typing import Any, List, Optional, Sequence


def run_world(target: str, world: int, payload: Any = None, *,
              workdir, backend: str = "gloo", device: str = "cpu",
              timeout: float = 120.0, threads: int = 1,
              coordinator: Optional[str] = None,
              sys_path: Sequence[str] = ()) -> List[Any]:
    """``target`` ("module:function") on each of *world* ranks; returns
    their results in rank order.  *sys_path* entries go in front of each
    process's import path (the package's checkout always does); *threads*
    is each process's ``torch.set_num_threads``."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    root = str(pathlib.Path(__file__).resolve().parents[2])
    store = workdir / "store"
    if store.exists():
        store.unlink()
    procs = []
    for rank in range(world):
        spec = dict(target=target, rank=rank, world=world,
                    init_method=f"file://{store}", backend=backend,
                    device=device, payload=payload, threads=threads,
                    coordinator=coordinator, timeout_s=timeout,
                    sys_path=[root, *map(str, sys_path)],
                    out=str(workdir / f"rank{rank}.out"))
        spec_path = workdir / f"rank{rank}.spec"
        spec_path.write_bytes(pickle.dumps(spec))
        log = open(workdir / f"rank{rank}.log", "wb")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.testing.world",
             str(spec_path)], cwd=root, stdout=log,
            stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is not None or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"world of {world} running {target} did not finish in "
                    f"{timeout:.0f} s:\n" + _logs(workdir, world))
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed is not None:
        raise RuntimeError(
            f"rank {failed} of {world} running {target} failed (exit "
            f"{procs[failed][0].returncode}):\n" + _logs(workdir, world))
    return [pickle.loads((workdir / f"rank{r}.out").read_bytes())
            for r in range(world)]


def _logs(workdir: pathlib.Path, world: int) -> str:
    out = []
    for r in range(world):
        text = (workdir / f"rank{r}.log").read_text(errors="replace")
        out.append(f"--- rank {r} ---\n{text[-4000:]}")
    return "\n".join(out)


def _worker(spec_path: str) -> None:
    spec = pickle.loads(pathlib.Path(spec_path).read_bytes())
    sys.path[:0] = spec["sys_path"]
    import importlib

    import torch

    from raft_tpu_torch.comms import CommsSession

    torch.set_num_threads(spec["threads"])
    module, _, name = spec["target"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    session = CommsSession(
        multihost=dict(init_method=spec["init_method"],
                       world_size=spec["world"], rank=spec["rank"],
                       timeout_s=spec["timeout_s"]),
        session_id="world", device=spec["device"], backend=spec["backend"],
        coordinator=spec["coordinator"]).init()
    try:
        out = fn(session.comms, spec["payload"])
    finally:
        session.destroy()
    tmp = spec["out"] + ".tmp"
    pathlib.Path(tmp).write_bytes(pickle.dumps(out))
    os.replace(tmp, spec["out"])


if __name__ == "__main__":
    _worker(sys.argv[1])
