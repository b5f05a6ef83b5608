#!/usr/bin/env python3
"""Which ``torch.distributed`` operations gloo runs on CUDA tensors in this
installation of PyTorch — the question behind ``raft_tpu_torch.comms``'
``GLOO_CUDA_OPS`` (NCCL takes one rank per device, so several ranks on one
card run over gloo, and an operation gloo refuses a CUDA tensor for is
staged through the host).

    python3 tools/gloo_cuda_probe.py            # needs one CUDA card

Each operation runs in a world of its own (two processes on the card,
``raft_tpu_torch.testing.world``) on CUDA tensors, raw
``torch.distributed`` calls, and its result is checked against the value
it must have.  One JSON line per operation (``ok``, each rank's last
line of output when the world failed, or ``timeout``), then
``{"gloo_cuda_ops": [...]}``: the communicator's names of the operations
that passed.
"""

import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: probe name → the communicator operation it stands for
OPS = {"all_reduce_sum": "allreduce", "all_reduce_prod": "allreduce",
       "all_reduce_min": "allreduce", "all_reduce_max": "allreduce",
       "broadcast": "bcast", "broadcast_bool": "bcast",
       "all_gather": "allgather", "reduce_scatter_tensor": "reducescatter",
       "batch_isend_irecv": "device_sendrecv"}


def _probe(comms, op):
    """One rank of a probe world: *op* on CUDA tensors; True when the
    result is the value it must be."""
    import torch
    import torch.distributed as dist

    r, w = comms.get_rank(), comms.get_size()
    dev = comms.device
    x = torch.arange(4, dtype=torch.float32, device=dev) + r + 1
    if op.startswith("all_reduce"):
        kind = op.rsplit("_", 1)[1]
        red = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
               "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[kind]
        parts = [torch.arange(4, dtype=torch.float32, device=dev) + i + 1
                 for i in range(w)]
        want = {"sum": sum(parts), "prod": parts[0] * parts[1],
                "min": torch.minimum(*parts),
                "max": torch.maximum(*parts)}[kind]
        t = x.clone()
        dist.all_reduce(t, op=red)
        return t.device == dev and torch.equal(t, want)
    if op == "broadcast":
        t = x.clone()
        dist.broadcast(t, src=0)
        return torch.equal(t, torch.arange(4, dtype=torch.float32,
                                           device=dev) + 1)
    if op == "broadcast_bool":
        t = torch.tensor([r == 0, False], device=dev)
        dist.broadcast(t, src=0)
        return t.tolist() == [True, False]
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(parts, x)
        return all(torch.equal(p, torch.arange(4, dtype=torch.float32,
                                               device=dev) + i + 1)
                   for i, p in enumerate(parts))
    if op == "reduce_scatter_tensor":
        inp = torch.arange(2 * w, dtype=torch.float32, device=dev) * (r + 1)
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, inp)
        scale = sum(i + 1 for i in range(w))
        want = torch.arange(2 * w, dtype=torch.float32,
                            device=dev)[2 * r:2 * r + 2] * scale
        return torch.equal(out, want)
    if op == "batch_isend_irecv":
        buf = torch.zeros_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, (r + 1) % w),
            dist.P2POp(dist.irecv, buf, (r - 1) % w)])
        for q in reqs:
            q.wait()
        return torch.equal(buf, torch.arange(4, dtype=torch.float32,
                                             device=dev) + (r - 1) % w + 1)
    raise ValueError(op)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from raft_tpu_torch.testing.world import run_world

    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    passed = {}
    for op, name in OPS.items():
        with tempfile.TemporaryDirectory() as tmp:
            try:
                res = run_world("gloo_cuda_probe:_probe", 2, op, workdir=tmp,
                                backend="gloo", device="cuda", timeout=90,
                                sys_path=[str(ROOT / "tools")])
                verdict = "ok" if all(res) else "wrong result"
            except TimeoutError:
                verdict = "timeout"
            except RuntimeError as e:
                # each rank's last line (a rank that died says nothing)
                blocks = str(e).split("--- rank ")[1:]
                verdict = {b.split(" ", 1)[0]: ([ln for ln in b.splitlines()
                                                 if ln.strip()][1:] or
                                                ["(no output)"])[-1][-200:]
                           for b in blocks}
        print(json.dumps({"op": op, "comms_op": name, "verdict": verdict}),
              flush=True)
        passed.setdefault(name, True)
        passed[name] &= verdict == "ok"
    print(json.dumps({"gloo_cuda_ops": sorted(n for n, ok in passed.items()
                                              if ok)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
