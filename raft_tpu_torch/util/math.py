"""Integer and power-of-two math (port of ``raft_tpu/util/math.py``;
reference util/integer_utils.hpp, util/pow2_utils.cuh)."""

from __future__ import annotations


def ceildiv(a: int, b: int) -> int:
    """Reference ``raft::ceildiv`` (util/cuda_utils.cuh)."""
    return -(-a // b)


def round_up_safe(a: int, b: int) -> int:
    """Smallest multiple of *b* >= *a* (reference util/integer_utils.hpp)."""
    return ceildiv(a, b) * b


def is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def next_pow2(v: int) -> int:
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()


def alignTo(v: int, align: int) -> int:
    return round_up_safe(v, align)


def alignDown(v: int, align: int) -> int:
    return (v // align) * align


class Pow2:
    """Power-of-two alignment helper (reference util/pow2_utils.cuh
    ``Pow2``)."""

    def __init__(self, value: int):
        if not is_pow2(value):
            raise ValueError(f"Pow2: {value} is not a power of two")
        self.value = value
        self.mask = value - 1
        self.log2 = value.bit_length() - 1

    def round_down(self, x: int) -> int:
        return x & ~self.mask

    def round_up(self, x: int) -> int:
        return (x + self.mask) & ~self.mask

    def div(self, x: int) -> int:
        return x >> self.log2

    def mod(self, x: int) -> int:
        return x & self.mask

    def is_aligned(self, x: int) -> bool:
        return (x & self.mask) == 0
