"""The engine policy of the kernel layer (port of
``raft_tpu/kernels/engine.py`` ``resolve_engine``).

Each kernel kind has two engines: ``"torch"``, its plain PyTorch version,
and ``"cuda"``, the hand-written kernel.  On a CUDA device the default is
``"cuda"``, on the CPU ``"torch"``; an explicit ``"cuda"`` on the CPU
raises.  The narrowings are the JAX package's own support predicates:
the L2 metric family for ``"l2nn"`` and the metrics of kernel B5 for
``"pairwise"`` (an explicit ``"cuda"`` outside them raises; the default
resolves to ``"torch"``), and ``select_k``'s ``supports(k, n, dtype)``,
which its callers apply per call shape.

``"pq_lut"`` (kernel B4) is not narrowed.  The TPU kernel's limit of a
4,096-wide LUT row (its one-hot block has to fit VMEM) does not apply on
Hopper: B4 builds no one-hot, gathers from the LUT row staged in shared
memory (64 KB for the default pq_dim 64 × 2^8 float32), and stages a row
larger than one block's shared memory in chunks of subspaces.

``"pairwise"`` (kernel B5) serves ``ACCUMULATE_METRICS``: L1,
L2Unexpanded, L2SqrtUnexpanded, Linf, Canberra, LpUnexpanded and
HammingUnexpanded.  The two narrowings of the TPU path are not carried
over.  Its cap of k <= 512 was the compile time of the TPU kernel's
unrolled k loop; B5 loops over k-chunks, so any k works.  Its exclusion
of half inputs was there because the TPU kernel accumulated in the input
type; B5 widens bfloat16 and float16 to float32 as it loads them and
accumulates in float32, the ``accum_dtype`` rule.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.distance.distance_types import L2_METRICS
from raft_tpu_torch.distance.pairwise import ACCUMULATE_METRICS

KINDS = ("l2nn", "select_k", "pq_lut", "pairwise")
ENGINES = ("torch", "cuda")


def resolve_engine(kind: str, device, metric=None,
                   engine: Optional[str] = None) -> str:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; expected one of "
                         f"{KINDS}")
    device = torch.device(device)
    supported = not ((kind == "l2nn" and metric is not None
                      and metric not in L2_METRICS)
                     or (kind == "pairwise"
                         and metric not in ACCUMULATE_METRICS))
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
            raise ValueError(f"engine='cuda' has no {kind} kernel for "
                             f"metric {metric}")
    return engine
