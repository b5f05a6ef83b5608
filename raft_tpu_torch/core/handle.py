"""Device resolution and the resource handle (port of
``raft_tpu/core/handle.py`` ``Stream`` / ``Handle``; reference
``raft::handle_t``, core/handle.hpp:54,88-130).

A :class:`Handle` is a device plus a pool of streams.  On a CUDA device a
:class:`Stream` wraps a ``torch.cuda.Stream``; on the CPU it is a lane
with nothing to order (host work is synchronous), so the same serving code
runs on both.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from raft_tpu_torch.core.error import expects


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``torch.device("cuda")``.  Raises when no
    card is present and none was asked for — the port never carries on
    quietly on the CPU; pass ``device="cpu"`` for the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "raft_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the host")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("raft_tpu_torch: device='cuda' asked for, but no "
                           "CUDA device is available")
    return device


class Stream:
    """One dispatch lane.  ``context()`` makes it the current stream for
    the work issued inside; ``record()`` marks the end of that work and
    ``synchronize()`` waits for the last recorded mark."""

    def __init__(self, device: torch.device, name: str = "main"):
        self.name = name
        self.device = device
        self._stream = (torch.cuda.Stream(device=device)
                        if device.type == "cuda" else None)
        self._event: Optional[torch.cuda.Event] = None

    @contextlib.contextmanager
    def context(self):
        """Issue the enclosed work on this lane.  The lane first waits for
        the work already queued on the current stream (the index and the
        inputs were made there)."""
        if self._stream is None:
            yield self
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            yield self

    def record(self) -> Optional[torch.cuda.Event]:
        """Mark the end of the work issued so far; returns the mark (None
        on the CPU, where work is already done)."""
        if self._stream is None:
            return None
        self._event = torch.cuda.Event()
        self._event.record(self._stream)
        return self._event

    def synchronize(self) -> None:
        if self._event is not None:
            self._event.synchronize()
            self._event = None


class Handle:
    """Device plus stream pool (pylibraft ``Handle(n_streams=...)``)."""

    def __init__(self, device=None, n_streams: int = 0):
        expects(n_streams >= 0, "n_streams must be >= 0")
        self.device = resolve_device(device)
        self._stream = Stream(self.device, "main")
        self._pool: List[Stream] = [Stream(self.device, f"pool{i}")
                                    for i in range(n_streams)]

    def get_next_usable_stream(self, idx: Optional[int] = None) -> Stream:
        """Pool stream ``idx`` (mod pool size) if a pool exists, else the
        main stream (reference handle.hpp:117-130)."""
        if self._pool:
            return self._pool[(idx or 0) % len(self._pool)]
        return self._stream

    def sync(self) -> None:
        for s in [self._stream] + self._pool:
            s.synchronize()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
