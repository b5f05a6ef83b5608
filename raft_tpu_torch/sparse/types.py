"""Sparse containers: fixed-capacity COO and CSR (port of
``raft_tpu/sparse/types.py``; reference ``sparse/coo.hpp`` — ``COO`` with
preallocated device buffers and ``setSize`` — and ``sparse/csr.hpp``).

Plain classes over tensors on one device.  The JAX package's padding
convention is kept: a static capacity (the buffers' length), with the
entries at positions ``>= nnz`` holding ``row == n_rows, col == 0,
val == 0`` (COO) and zero tail padding past ``indptr[-1] == nnz`` (CSR).
Borůvka's live test and ``connect_components``' compaction rely on it.
``nnz`` is a 0-d int32 tensor on the container's device: reading it on
the host is a sync, which the port does only where the JAX package calls
``int(...)``.

Device: given arrays go to *device* (``None``: the card, raising without
one); given tensors stay on their device unless *device* is named.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device


def container_device(*parts, device=None) -> torch.device:
    """The device of a container built from *parts*: *device* if named,
    else the first tensor's, else the card (``resolve_device(None)``)."""
    if device is not None:
        return resolve_device(device)
    for p in parts:
        if isinstance(p, torch.Tensor):
            return p.device
    return resolve_device(None)


def as_index(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).to(torch.int32)


def as_values(a, device: torch.device) -> torch.Tensor:
    """Values on *device*; a float64 array (not tensor) becomes float32,
    as the JAX package's arrays do with 64-bit types off."""
    t = torch.as_tensor(a, device=device)
    # exempt(dtype-drift): the check that turns a float64 array into float32
    if not isinstance(a, torch.Tensor) and t.dtype == torch.float64:
        t = t.float()
    return t


class COO:
    """Coordinate-format sparse matrix with fixed capacity.

    Attributes: ``rows``, ``cols`` int32 (capacity,); ``vals``
    (capacity,); ``nnz`` 0-d int32 tensor (live entries, <= capacity);
    ``shape`` (n_rows, n_cols)."""

    def __init__(self, rows, cols, vals, shape: Tuple[int, int], nnz=None,
                 device=None):
        dev = container_device(rows, cols, vals, device=device)
        self.rows = as_index(rows, dev)
        self.cols = as_index(cols, dev)
        self.vals = as_values(vals, dev)
        self.shape = (int(shape[0]), int(shape[1]))
        self.nnz = torch.as_tensor(self.rows.shape[0] if nnz is None
                                   else nnz, device=dev).to(torch.int32)

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def mask(self) -> torch.Tensor:
        """Boolean (capacity,) mask of live entries."""
        return torch.arange(self.capacity, device=self.device) < self.nnz

    def to(self, device) -> "COO":
        return COO(self.rows, self.cols, self.vals, self.shape, self.nnz,
                   device=device)

    def __repr__(self):
        return (f"COO(shape={self.shape}, capacity={self.capacity}, "
                f"dtype={self.vals.dtype}, device={self.device})")


class CSR:
    """Compressed-sparse-row matrix with fixed capacity: ``indptr`` is
    (n_rows+1,) with ``indptr[-1] == nnz``; ``indices`` / ``data`` have
    length ``capacity >= nnz`` with zero tail padding."""

    def __init__(self, indptr, indices, data, shape: Tuple[int, int],
                 device=None):
        dev = container_device(indptr, indices, data, device=device)
        self.indptr = as_index(indptr, dev)
        self.indices = as_index(indices, dev)
        self.data = as_values(data, dev)
        self.shape = (int(shape[0]), int(shape[1]))
        expects(self.indptr.shape[0] == self.shape[0] + 1,
                "CSR indptr must have n_rows+1 entries")

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def nnz(self) -> torch.Tensor:
        return self.indptr[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def row_ids(self) -> torch.Tensor:
        """int32 (capacity,) row of each entry; padding maps to n_rows
        (dropped by segment ops over n_rows segments)."""
        pos = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.device)
        return torch.searchsorted(self.indptr, pos, right=True,
                                  out_int32=True) - 1

    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.nnz

    def to(self, device) -> "CSR":
        return CSR(self.indptr, self.indices, self.data, self.shape,
                   device=device)

    def __repr__(self):
        return (f"CSR(shape={self.shape}, capacity={self.capacity}, "
                f"dtype={self.data.dtype}, device={self.device})")
