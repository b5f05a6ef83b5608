"""Class-label utilities (port of ``raft_tpu/label/classlabels.py``;
reference raft/label/classlabels.cuh:41-116 ``getUniquelabels``,
``getOvrlabels``, ``make_monotonic``).  Arrays go to *device* (``None``:
the card); tensors stay where they are."""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.core.handle import resolve_device


def _labels(labels, device) -> torch.Tensor:
    if isinstance(labels, torch.Tensor):
        return labels
    return torch.as_tensor(np.asarray(labels), device=resolve_device(device))


def get_unique_labels(labels, *, device=None) -> torch.Tensor:
    """The distinct labels, ascending (reference ``getUniquelabels``)."""
    return torch.unique(_labels(labels, device), sorted=True)


def get_ovr_labels(labels, target_label, true_val=1, false_val=0, *,
                   device=None) -> torch.Tensor:
    """One-vs-rest relabelling (reference ``getOvrlabels``): *true_val*
    where a label is *target_label*, *false_val* elsewhere."""
    labels = _labels(labels, device)
    return torch.where(labels == target_label,
                       torch.as_tensor(true_val, device=labels.device),
                       torch.as_tensor(false_val, device=labels.device))


def make_monotonic(labels, unique_labels=None, zero_based: bool = True, *,
                   device=None) -> torch.Tensor:
    """Map label values onto a dense range in the order of the distinct
    values: 0..n−1, or 1..n with ``zero_based=False`` (reference
    ``make_monotonic``).

    Labels on the host (an array or a CPU tensor) go through the native
    runtime's ``rt_make_monotonic`` (``raft_tpu_torch/native.py``; int32
    labels); a failed build raises, there is no fallback.  An array's
    result goes to *device* (``None``: the card), a tensor's stays where
    the tensor is.  Labels on the card, or any labels with *unique_labels*
    given, take ``torch.searchsorted`` into the sorted distinct values."""
    on_host = (not isinstance(labels, torch.Tensor)
               or labels.device.type == "cpu")
    if unique_labels is None and on_host:
        host = (labels.numpy() if isinstance(labels, torch.Tensor)
                else np.asarray(labels))
        out, _ = native.make_monotonic(host, zero_based=zero_based)
        out = torch.from_numpy(out)
        if isinstance(labels, torch.Tensor):
            return out
        return out.to(resolve_device(device))
    labels = _labels(labels, device)
    if unique_labels is None:
        unique_labels = torch.unique(labels, sorted=True)
    unique_labels = torch.as_tensor(unique_labels, device=labels.device)
    idx = torch.searchsorted(unique_labels, labels.to(unique_labels.dtype))
    return idx if zero_based else idx + 1
