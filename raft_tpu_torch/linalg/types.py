"""Shared linalg types (port of ``raft_tpu/linalg/types.py``; reference
raft/linalg/linalg_types.hpp and norm.cuh's ``NormType``)."""

from __future__ import annotations

import enum


class Apply(enum.Enum):
    """Which dimension a row- or column-wise operation runs along
    (reference ``Apply::ALONG_ROWS`` / ``ALONG_COLUMNS``).

    ALONG_ROWS: one result per column (reduce across rows).
    ALONG_COLUMNS: one result per row (reduce across columns).
    """

    ALONG_ROWS = "along_rows"
    ALONG_COLUMNS = "along_columns"


class NormType(enum.Enum):
    """Reference linalg/norm.cuh ``NormType`` {L1Norm, L2Norm, LinfNorm}."""

    L1Norm = "l1"
    L2Norm = "l2"
    LinfNorm = "linf"


def axis_for(apply: Apply) -> int:
    """The axis a reduction along *apply* runs over (RAFT's rowNorm gives
    one value per row, colNorm one per column)."""
    return 0 if apply == Apply.ALONG_ROWS else 1
