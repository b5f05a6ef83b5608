"""Wrapper of kernel B6, the compile probe — ``csrc/probe.cu`` — and the
probe stage it serves.

Replaces ``bench/tpu_session.py:357`` ``add_one``, the trivial Pallas
kernel of ``pallas_probe_stage`` (:343), which learned whether the TPU
toolchain could compile and run a kernel at all before the fused L2 NN
kernel was tried.  :func:`probe` is that stage on the card: case (a)
builds ``probe.cu`` alone and runs it on a 128 × 128 zero tensor, case (b)
builds ``fused_l2nn.cu`` alone and runs kernel B1 at a small shape, each
checked against its plain version; a failure is recorded with the
compiler's or the launch's whole error text.

:func:`add_one` is the kernel and takes CUDA tensors only: it raises on a
CPU tensor (there is no plain fallback behind it).  :func:`add_one_plain`
is the plain version, for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.kernels import native

#: case (a)'s shape, the TPU probe's
ADD_ONE_SHAPE = (128, 128)
#: case (b)'s shapes, the TPU probe's: x (1,024, 128) against y (256, 128)
L2NN_SHAPES = ((1024, 128), (256, 128))


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 by kernel B6, for a contiguous float32 CUDA tensor."""
    expects(x.device.type == "cuda",
            f"add_one: kernel B6 takes a CUDA tensor, got {x.device}")
    expects(x.dtype == torch.float32, f"add_one: float32 only, got "
            f"{x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        lib = native.library("probe")
        err = lib.raft_add_one(x.data_ptr(), out.data_ptr(), x.numel(),
                               native.stream_handle(x.device))
        native.check(lib, err, "add_one_kernel")
        native.LAUNCHES["add_one"] += 1
    return out


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`add_one`."""
    return x + 1


def _built(name: str) -> float:
    """Build (or find built) and load ``csrc/<name>.cu``; its seconds."""
    t0 = time.perf_counter()
    native.library(name)
    return time.perf_counter() - t0


def _l2nn_case(device: torch.device) -> Dict:
    from raft_tpu_torch.distance.fused_l2_nn import (fused_l2_nn,
                                                     fused_l2_nn_argmin,
                                                     fused_l2_nn_plain)

    row: Dict = {"case": "fused_l2nn_small",
                 "shape": [L2NN_SHAPES[0][0], L2NN_SHAPES[1][0],
                           L2NN_SHAPES[0][1]]}
    if device.type == "cuda":
        row["build_s"] = _built("fused_l2nn")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random(L2NN_SHAPES[0], np.float32),
                        device=device)
    y = torch.as_tensor(rng.random(L2NN_SHAPES[1], np.float32),
                        device=device)
    ids = fused_l2_nn_argmin(x, y).long()
    kv = fused_l2_nn(x, y)
    pv, pi = fused_l2_nn_plain(x, y)
    # a near tie: the two best distances within 1e-5 (relative, float64)
    # exempt(dtype-drift): float64 near-tie yardstick of the probe's B1 row
    d = torch.cdist(x.double(), y.double()) ** 2
    two = torch.topk(d, 2, dim=1, largest=False).values
    tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].clamp_min(1e-30)
    bad = ((ids != pi.long()) | (kv.key.long() != pi.long())) & ~tie
    # B1's value contract: 1e-5 of the distance, or of ‖x‖² + ‖y‖² where
    # the distance is far below the norms (its 3xTF32 products)
    norms = (x * x).sum(1) + (y * y).sum(1)[pi.long()]
    err = (kv.value - pv).abs()
    over = err > 1e-5 * (pv.abs() + norms)
    row.update(mismatched_ids=int(bad.sum()), near_ties=int(tie.sum()),
               max_value_err=float(err.max()),
               ok=not bool(bad.any()) and not bool(over.any()))
    return row


def probe(device=None) -> List[Dict]:
    """Case (a), then case (b) on *device* (``None``: the card); one row
    each, with ``ok`` and, on failure, ``error``: the whole text of the
    compiler's or the launch's error.  Raises nothing of its own: the
    caller decides what a failed case means."""
    device = resolve_device(device)
    rows = []
    row: Dict = {"case": "trivial_add", "shape": list(ADD_ONE_SHAPE)}
    try:
        if device.type == "cuda":
            row["build_s"] = _built("probe")
        x = torch.zeros(ADD_ONE_SHAPE, dtype=torch.float32, device=device)
        out = add_one(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        row["ok"] = bool(torch.equal(out, add_one_plain(x)))
    except Exception as e:  # noqa: BLE001 - the row is the probe's result
        row.update(ok=False, error=f"{type(e).__name__}: {e}")
    rows.append(row)
    try:
        row = _l2nn_case(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except Exception as e:  # noqa: BLE001 - the row is the probe's result
        row = {"case": "fused_l2nn_small", "ok": False,
               "error": f"{type(e).__name__}: {e}"}
    rows.append(row)
    return rows
