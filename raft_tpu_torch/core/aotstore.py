"""The on-disk executable store (``raft_tpu/core/aotstore.py``) — not
ported: a stub that says why.

The JAX package's store has two halves.  Its cost half persists the
serving scheduler's per-signature cost rows; the port has it as
:mod:`raft_tpu_torch.core.coststore`.  Its executable half serializes
compiled XLA executables so a restarted server skips tracing, lowering
and compiling.  The port's only compiled artifacts are the ``nvcc``-built
kernel libraries and the ``g++``-built native runtime, and
:func:`raft_tpu_torch.core.aot.enable_persistent_cache` already persists
those, each named by the hash of its sources and flags under a directory
scoped by the toolchain's fingerprint.  A second store and a second knob
would keep the same files twice.
"""

from __future__ import annotations


def install(path=None):
    """Not ported (see the module doc): use
    :func:`raft_tpu_torch.core.aot.enable_persistent_cache`."""
    raise NotImplementedError(
        "raft_tpu_torch: the executable store has no counterpart — the "
        "port's compiled artifacts are the kernel libraries, which "
        "core.aot.enable_persistent_cache persists (core/aotstore.py)")
