"""Comms types (port of ``raft_tpu/comms/comms_types.py``; reference
raft/core/comms.hpp:33-106).

``Status`` mirrors ``status_t`` {SUCCESS, ERROR, ABORT}; ``ReduceOp`` mirrors
``op_t`` {SUM, PROD, MIN, MAX}; ``Request`` plays ``request_t`` for the
host-side p2p plane.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any


class Status(enum.Enum):
    """reference core/comms.hpp:33 ``status_t``."""

    SUCCESS = "success"  # Synchronization successful
    ERROR = "error"  # An error occurred querying sync status
    ABORT = "abort"  # A failure occurred in sync, queued operations aborted


class ReduceOp(enum.Enum):
    """reference core/comms.hpp:98 ``op_t``."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"


@dataclass
class Request:
    """Host-side p2p request handle (reference ``request_t``)."""

    kind: str  # "send" | "recv"
    peer: int
    tag: int
    payload: Any = None
    done: bool = False
