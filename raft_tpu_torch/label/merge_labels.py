"""Merge two labelings joined by a mask (port of
``raft_tpu/label/merge_labels.py``; reference raft/label/merge_labels.cuh
``merge_labels``), the step of connected-components algorithms such as
the MST fix-up: nodes that share a labels_a class are connected; a node
where *mask* holds is also connected to the nodes that share its labels_b
class.  Every node gets the least labels_a value of its merged component.

The fixed point is reached by alternating a scatter-min over the two
class partitions, as the JAX package's ``while_loop`` does; the loop reads
one flag back a round (O(diameter) rounds, at most O(log n) for usual
label graphs)."""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=resolve_device(device))


def _segment_min(vals, ids, n, big):
    out = torch.full((n,), big, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, ids, vals, reduce="amin")


def merge_labels(labels_a, labels_b, mask, *, device=None) -> torch.Tensor:
    """Labels are node ids: every labels_a value, and every labels_b value
    at a masked position, must lie in [0, n) (the reference kernel
    indexes its propagation array by label value); others raise
    :class:`LogicError`.  Returns int32 labels on the inputs' device
    (arrays: *device*, ``None`` the card)."""
    a = _tensor(labels_a, device)
    dev = a.device
    a = a.to(torch.int64)
    b = _tensor(labels_b, dev).to(dev, torch.int64)
    m = _tensor(mask, dev).to(dev, torch.bool)
    n = a.shape[0]
    if n == 0:
        return a.to(torch.int32)
    expects(bool(((a >= 0) & (a < n)).all()),
            f"merge_labels: labels_a values must be node ids in [0, {n})")
    expects(not bool((m & ((b < 0) | (b >= n))).any()),
            f"merge_labels: masked labels_b values must be node ids in "
            f"[0, {n})")
    big = n                          # above every valid label
    b_safe = torch.clamp(b, 0, n - 1)
    r = a
    while True:
        r1 = _segment_min(r, a, n, big)[a]
        contrib = torch.where(m, r1, torch.full_like(r1, big))
        mb = _segment_min(contrib, b_safe, n, big)
        r2 = torch.where(m, torch.minimum(r1, mb[b_safe]), r1)
        if not bool((r2 != r).any()):
            return r2.to(torch.int32)
        r = r2
