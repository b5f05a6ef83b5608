"""Hot-path program registry for the Level-2 program audit (port of
``raft_tpu/analysis/registry.py``; ``hlo_program`` :94 is
:func:`audit_program` here).

Programs declare their budgets NEXT TO their definitions: the decorator
registers the function and returns it unchanged::

    from raft_tpu_torch.analysis.registry import audit_program

    @audit_program("ivf_flat.search_batch", host_reads=0,
                   transient_bytes=8 << 20, notes="...")
    def _search_batch_impl(queries, index, k, n_probes, sqrt, engine):
        ...

The inputs at the audit shape live in one place,
:mod:`raft_tpu_torch.analysis.programs` (a builder under the same name,
imported only when the auditor runs).  An entry's ``builder`` takes the
device (and, for ``comms=True``, a world-1
:class:`~raft_tpu_torch.comms.Comms`) and returns ``{"fn", "args"
[, "kwargs"][, "plain"]}``: the auditor runs ``fn(*args, **kwargs)``
eagerly, measures the run and holds its outputs against ``plain()``
(:mod:`raft_tpu_torch.analysis.program_audit`).

This module is STDLIB-ONLY: hot modules import it at definition time, so
it must cost nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

#: modules that declare audit entries — the auditor imports these to
#: populate the registry
DECLARING_MODULES = (
    "raft_tpu_torch.neighbors.brute_force",
    "raft_tpu_torch.neighbors.ivf_flat",
    "raft_tpu_torch.neighbors.ivf_pq",
    "raft_tpu_torch.neighbors._build",
    "raft_tpu_torch.neighbors.ann_mnmg",
    "raft_tpu_torch.neighbors.tiering",
    "raft_tpu_torch.neighbors.mutable",
    "raft_tpu_torch.cluster.kmeans",
    "raft_tpu_torch.kernels.select_k",
    "raft_tpu_torch.kernels.fused_l2nn",
    "raft_tpu_torch.kernels.ivf_pq_lut",
)


@dataclasses.dataclass(frozen=True)
class ProgramEntry:
    """One declared hot-path program and its budgets.

    ``host_reads`` bounds the times one run makes the host wait for the
    device (``.item()``, a read to the host, a boolean-mask index, a
    stream wait).  ``collectives`` / ``collective_bytes`` bound the calls
    and payload bytes ``Comms.collective_calls`` counts in one run.
    ``transient_bytes`` caps the device memory one run allocates above its
    inputs (the card only; None skips).  ``in_place`` names the argnums
    whose tensors the outputs must share storage with (the reference's
    ``donate_argnums``).  ``comms=True``: the builder takes a world-1
    communicator.  ``fast`` marks the single-device subset."""

    name: str
    builder: Callable
    host_reads: int = 0
    collectives: int = 0
    collective_bytes: int = 0
    transient_bytes: Optional[int] = None
    in_place: Tuple[int, ...] = ()
    comms: bool = False
    fast: bool = True
    notes: str = ""


_PROGRAMS: Dict[str, ProgramEntry] = {}


@dataclasses.dataclass(frozen=True)
class _Inputs:
    """A declared program's builder: its inputs from
    ``analysis/programs.py``, run through the declared function."""

    name: str
    fn: Callable

    def __call__(self, *args):
        from raft_tpu_torch.analysis.programs import BUILDERS

        return {"fn": self.fn, **BUILDERS[self.name](*args)}


def _where(fn) -> str:
    return f"{fn.__module__}.{fn.__qualname__}"


def audit_program(name: str, *, host_reads: int = 0, collectives: int = 0,
                  collective_bytes: int = 0,
                  transient_bytes: Optional[int] = None,
                  in_place: Tuple[int, ...] = (), comms: bool = False,
                  fast: bool = True, notes: str = ""):
    """Decorator on a hot program: register it under *name* with its
    budgets and return it unchanged."""

    def deco(fn):
        prior = _PROGRAMS.get(name)
        if prior is not None and _where(prior.builder.fn) != _where(fn):
            raise ValueError(f"audit program {name!r} already registered "
                             f"by {_where(prior.builder.fn)}")
        _PROGRAMS[name] = ProgramEntry(
            name=name, builder=_Inputs(name, fn), host_reads=host_reads,
            collectives=collectives, collective_bytes=collective_bytes,
            transient_bytes=transient_bytes, in_place=tuple(in_place),
            comms=comms, fast=fast and not comms, notes=notes)
        return fn

    return deco


def load_declarations() -> None:
    """Import every declaring module (idempotent)."""
    import importlib

    for mod in DECLARING_MODULES:
        importlib.import_module(mod)


def iter_programs(fast_only: bool = False) -> List[ProgramEntry]:
    load_declarations()
    entries = [e for _, e in sorted(_PROGRAMS.items())]
    if fast_only:
        entries = [e for e in entries if e.fast]
    return entries


def get_program(name: str) -> Optional[ProgramEntry]:
    load_declarations()
    return _PROGRAMS.get(name)
