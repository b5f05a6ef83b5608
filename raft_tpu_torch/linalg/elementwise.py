"""Elementwise operations (port of ``raft_tpu/linalg/elementwise.py``;
reference raft/linalg/{add,subtract,multiply,divide,power,sqrt,eltwise,
unary_op,binary_op,ternary_op,map}.cuh).  Each is one PyTorch operation
on the card or the host; tensors stay where they are."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.handle import resolve_device


def add(x, y):
    return torch.add(x, y)


def subtract(x, y):
    return torch.subtract(x, y)


def multiply(x, y):
    return torch.multiply(x, y)


def divide(x, y):
    return torch.divide(x, y)


def power(x, y):
    return torch.pow(x, y)


def sqrt(x):
    return torch.sqrt(x)


def add_scalar(x, scalar):
    return x + scalar


def subtract_scalar(x, scalar):
    return x - scalar


def multiply_scalar(x, scalar):
    return x * scalar


def divide_scalar(x, scalar):
    return x / scalar


def power_scalar(x, scalar):
    return torch.pow(x, scalar)


def unary_op(x, op):
    """``op(x_i)`` elementwise (reference linalg/unary_op.cuh)."""
    return op(x)


def binary_op(x, y, op):
    """``op(x_i, y_i)`` elementwise (reference linalg/binary_op.cuh)."""
    return op(x, y)


def ternary_op(x, y, z, op):
    """``op(x_i, y_i, z_i)`` elementwise (reference linalg/ternary_op.cuh)."""
    return op(x, y, z)


def map_(op, *arrays):
    """N-ary elementwise map (reference linalg/map.cuh ``map``)."""
    return op(*arrays)


def map_offset(shape, op, *, device=None):
    """``out[i] = op(i)`` over the row-major offsets of *shape* (reference
    linalg/map.cuh ``map_offset``), reshaped to *shape*; the offsets are
    int64 on *device* (``None``: the card)."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, device=resolve_device(device))
    return op(idx).reshape(tuple(shape))
