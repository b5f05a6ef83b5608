"""Exception hierarchy and check helpers (port of ``raft_tpu/core/error.py``;
reference ``raft::exception`` / ``RAFT_EXPECTS`` / ``RAFT_FAIL``)."""

from __future__ import annotations


class RaftError(Exception):
    """Base exception of the port."""

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message

    def __str__(self) -> str:
        return self.message


class LogicError(RaftError):
    """Invalid API usage / failed precondition (``raft::logic_error``)."""


class CudaError(RaftError):
    """A failure the card reported (a refused or faulted kernel launch)."""


class DeviceError(CudaError):
    """The name the port raises device failures under.  Not a
    ``RuntimeError``: the serving supervisor never retries it, since a
    sticky CUDA error (an illegal address) poisons the context and a
    retry on it fails the same way."""


class InterruptedError_(RaftError):
    """Raised by :mod:`raft_tpu_torch.core.interruptible` on cancellation
    (``raft::interrupted_exception``, reference core/interruptible.hpp:41)."""


def expects(condition: bool, message: str = "precondition violated") -> None:
    """``RAFT_EXPECTS``: raise :class:`LogicError` unless *condition* holds."""
    if not condition:
        raise LogicError(message)


def fail(message: str = "") -> None:
    """``RAFT_FAIL``: unconditional :class:`LogicError`."""
    raise LogicError(message)


class CorruptionError(RaftError):
    """A stored artifact failed its integrity check (truncated or
    corrupted archive, checksum mismatch)."""
