"""Owning arrays and non-owning views bound to a memory type and a layout
(port of ``raft_tpu/core/mdarray.py``; reference core/mdarray.hpp:127,
device_mdarray.hpp:133-171, host_mdarray.hpp, memory_type.hpp:19).

A tensor carries its shape, type and device, so these classes are thin:
they bind a tensor to a :class:`MemoryType` and a :class:`Layout` and give
the reference's factories and views.  Device memory is the card
(``cuda``: the handle's device, or the card when no handle is given);
host memory is a CPU tensor, pinned when a card is present so that copies
to it run asynchronously.  Column-major data is kept as the row-major
buffer of its transpose plus the layout tag; :meth:`MdSpan.logical` and
``__array__`` give the logical orientation.
"""

from __future__ import annotations

import enum
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device


class MemoryType(enum.Enum):
    """Where an mdarray's memory lives (reference memory_type.hpp:19)."""

    HOST = "host"
    DEVICE = "device"
    MANAGED = "managed"
    PINNED = "pinned"


class Layout(enum.Enum):
    """layout_c_contiguous / layout_f_contiguous (reference mdspan.hpp)."""

    C = "row_major"
    F = "col_major"


row_major = Layout.C
col_major = Layout.F


class MdSpan:
    """Non-owning view: (tensor, memory type, layout)."""

    __slots__ = ("_array", "memory_type", "layout")

    def __init__(self, array: Any, memory_type: MemoryType = MemoryType.DEVICE,
                 layout: Layout = Layout.C):
        self._array = array
        self.memory_type = memory_type
        self.layout = layout

    @property
    def shape(self) -> Tuple[int, ...]:
        s = tuple(self._array.shape)
        return tuple(reversed(s)) if self.layout == Layout.F else s

    @property
    def dtype(self):
        return self._array.dtype

    @property
    def ndim(self) -> int:
        return self._array.ndim

    def extent(self, i: int) -> int:
        return self.shape[i]

    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def data(self) -> Any:
        """The backing buffer (row-major; the transpose's if layout F)."""
        return self._array

    def logical(self) -> Any:
        """The tensor in its logical orientation."""
        return self._array.T if self.layout == Layout.F else self._array

    def __array__(self, dtype=None, copy=None):
        t = self.logical()
        out = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
               else np.asarray(t))
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}(shape={self.shape}, "
                f"dtype={self.dtype}, {self.memory_type.value}, "
                f"{self.layout.value})")


class MdArray(MdSpan):
    """Owning array (reference mdarray.hpp:127); ownership is the tensor's
    reference count, so the difference from :class:`MdSpan` is one of
    API."""

    def view(self) -> MdSpan:
        return MdSpan(self._array, self.memory_type, self.layout)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype


def _device_of(handle) -> torch.device:
    return handle.device if handle is not None else resolve_device(None)


def _zeros(shape, dtype, memory_type: MemoryType, layout: Layout,
           device=None) -> torch.Tensor:
    buf = tuple(reversed(shape)) if layout == Layout.F else tuple(shape)
    if memory_type == MemoryType.DEVICE:
        return torch.zeros(buf, dtype=_torch_dtype(dtype), device=device)
    return torch.zeros(buf, dtype=_torch_dtype(dtype),
                       pin_memory=torch.cuda.is_available())


def make_device_scalar(handle, value, dtype=None) -> MdArray:
    dt = None if dtype is None else _torch_dtype(dtype)
    return MdArray(torch.as_tensor(value, dtype=dt,
                                   device=_device_of(handle)),
                   MemoryType.DEVICE, Layout.C)


def make_device_vector(handle, n: int, dtype=np.float32) -> MdArray:
    return MdArray(_zeros((n,), dtype, MemoryType.DEVICE, Layout.C,
                          _device_of(handle)), MemoryType.DEVICE, Layout.C)


def make_device_matrix(handle, n_rows: int, n_cols: int, dtype=np.float32,
                       layout: Layout = Layout.C) -> MdArray:
    return MdArray(_zeros((n_rows, n_cols), dtype, MemoryType.DEVICE, layout,
                          _device_of(handle)), MemoryType.DEVICE, layout)


def make_device_mdarray(handle, shape: Sequence[int], dtype=np.float32,
                        layout: Layout = Layout.C) -> MdArray:
    return MdArray(_zeros(tuple(shape), dtype, MemoryType.DEVICE, layout,
                          _device_of(handle)), MemoryType.DEVICE, layout)


def make_host_scalar(value, dtype=None) -> MdArray:
    t = torch.as_tensor(np.asarray(value, dtype=dtype))
    if torch.cuda.is_available():
        t = t.pin_memory()
    return MdArray(t, MemoryType.HOST, Layout.C)


def make_host_vector(n: int, dtype=np.float32) -> MdArray:
    return MdArray(_zeros((n,), dtype, MemoryType.HOST, Layout.C),
                   MemoryType.HOST, Layout.C)


def make_host_matrix(n_rows: int, n_cols: int, dtype=np.float32,
                     layout: Layout = Layout.C) -> MdArray:
    return MdArray(_zeros((n_rows, n_cols), dtype, MemoryType.HOST, layout),
                   MemoryType.HOST, layout)


def as_device_array(x: Any, dtype=None, handle=None) -> torch.Tensor:
    """*x* (a tensor, an array, anything with ``__array__`` or
    ``__dlpack__``, an :class:`MdSpan`) as a tensor in device memory —
    the handle's device, or the card — cast to *dtype* when given (the
    role of pylibraft's ``__cuda_array_interface__`` input handling)."""
    if isinstance(x, MdSpan):
        x = x.logical()
    if not isinstance(x, torch.Tensor):
        if hasattr(x, "__dlpack__") and not isinstance(x, np.ndarray):
            x = torch.from_dlpack(x)
        else:
            x = torch.as_tensor(np.asarray(x))
    return x.to(device=_device_of(handle),
                dtype=None if dtype is None else _torch_dtype(dtype))


def expect_matrix(x, name: str = "input") -> None:
    expects(getattr(x, "ndim", None) == 2, f"{name} must be a 2-d array")


def expect_same_dtype(*arrays) -> None:
    dts = {a.dtype for a in arrays}
    expects(len(dts) == 1, f"dtype mismatch: {dts}")
