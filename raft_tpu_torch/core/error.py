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


def expects(condition: bool, message: str = "precondition violated") -> None:
    """``RAFT_EXPECTS``: raise :class:`LogicError` unless *condition* holds."""
    if not condition:
        raise LogicError(message)


def fail(message: str = "") -> None:
    """``RAFT_FAIL``: unconditional :class:`LogicError`."""
    raise LogicError(message)
