"""The engine policy of the kernel layer (port of
``raft_tpu/kernels/engine.py`` ``resolve_engine``).

Each kernel kind has two engines: ``"torch"``, its plain PyTorch version,
and ``"cuda"``, the hand-written kernel.  On a CUDA device the default is
``"cuda"``, on the CPU ``"torch"``; an explicit ``"cuda"`` on the CPU
raises.  The only narrowing is the JAX package's own support predicate:
the L2 metric family for ``"l2nn"`` (an explicit ``"cuda"`` outside it
raises; the default resolves to ``"torch"``), and ``select_k``'s
``supports(k, n, dtype)``, which its callers apply per call shape.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.distance.distance_types import L2_METRICS

KINDS = ("l2nn", "select_k")
ENGINES = ("torch", "cuda")


def resolve_engine(kind: str, device, metric=None,
                   engine: Optional[str] = None) -> str:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; expected one of "
                         f"{KINDS}")
    device = torch.device(device)
    supported = not (kind == "l2nn" and metric is not None
                     and metric not in L2_METRICS)
    if engine is None:
        return "cuda" if device.type == "cuda" and supported else "torch"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if engine == "cuda":
        if device.type != "cuda":
            raise ValueError(f"engine='cuda' needs a CUDA device, got "
                             f"{device}")
        if not supported:
            raise ValueError("engine='cuda' supports only the L2 metric "
                             f"family for l2nn, got {metric}")
    return engine
