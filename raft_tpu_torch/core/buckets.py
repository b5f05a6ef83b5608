"""The power-of-two batch ladder (port of ``raft_tpu/core/aot.py``
``_bucket_dim``): every search pads its query batch up to a bucket, so
ragged request sizes map onto a handful of shapes."""

from __future__ import annotations


def bucket_dim(n: int) -> int:
    """Smallest power of two >= *n*, floored at 8."""
    if n <= 8:
        return 8
    return 1 << (int(n - 1).bit_length())
