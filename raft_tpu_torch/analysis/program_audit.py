"""Level 2 — the program audit (the port's ``hlo_audit.py``; reference
``raft_tpu/analysis/hlo_audit.py``).

The JAX package lowers each registered program and reads the compiled
HLO.  Eager PyTorch has no program text, so the port RUNS each registered
program once at its audit shape (after one warm run that is not counted:
a first call pays the allocator's growth and cuBLAS's workspace) and
measures what the run does:

(a) **host syncs** — the times the host waited for the device, against
    the entry's ``host_reads``.  On the card:
    ``torch.cuda.set_sync_debug_mode("warn")`` and the warnings it
    records (a read to the host, ``.item()``, ``nonzero``, a stream
    wait).  On the CPU, where nothing waits, the same points are counted
    where they would wait on the card: ``aten._local_scalar_dense``
    (``.item()``, ``bool(t)``, ``int(t)``), the ops that size their
    output from the data (``nonzero``, ``masked_select``, ``unique``, an
    index by a boolean mask, ``repeat_interleave`` without
    ``output_size``) through a ``TorchDispatchMode``, and the explicit
    reads ``.cpu()`` / ``.numpy()`` / ``.tolist()`` / ``np.asarray(t)``
    through a ``TorchFunctionMode`` (a tensor read once is not counted
    again; a ``.to("cpu")`` is counted on the card only).
(b) **collectives** — calls and payload bytes, from the deltas of
    ``Comms.collective_calls`` (the runtime mirror of the reference's
    collective budget).
(c) **in place** — where the entry declares ``in_place`` argnums (the
    reference's ``donate_argnums``), every tensor of those arguments
    shares its storage with an output.
(d) **transient bytes** — on the card, ``torch.cuda.max_memory_allocated``
    above what was allocated before the run, under the declared ceiling;
    on the CPU reported as skipped.  Beside it the peak of the bytes the
    run's allocations asked for (the allocator's ``requested_bytes``),
    which the fingerprint locks: the allocator counts a reused block
    whole when its rest is too small to split, so its peak depends on the
    blocks earlier work left behind, while the requests do not.
(e) **launches by kernel** — on the card, the deltas of
    ``kernels/native.py`` ``LAUNCHES`` (recorded; the fingerprint pins
    them).
(f) **against the plain version** — where the entry's inputs carry a
    ``plain`` (``analysis/programs.py``: the same outputs through the
    plain versions, ``engine="torch"``, on the same inputs), the run's
    outputs are held to it (:func:`against_plain`), so every kernel the
    audit launches is checked at the audit's shapes.  Run after (a)–(e)
    are measured; its own work is not counted.

The reference's static cost attribution (its (e)) is dropped, as
``program_costs`` was: eager PyTorch has no cost analysis of a program.

Entries with ``comms=True`` run at world 1 in a process of their own
(:func:`raft_tpu_torch.testing.world.run_world`, gloo), since a process
group is process-global; pass ``comms=`` to :func:`run` to use one the
caller holds instead.
"""

from __future__ import annotations

import dataclasses
import gc
import pathlib
import sys
import tempfile
import warnings
from typing import Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from raft_tpu_torch.analysis import registry

#: bump when the record layout changes
SCHEMA = 1

#: a program's float outputs against its plain version's: within
#: PLAIN_RTOL × (max |plain| + 1) — B1's tolerance at the k-means tile in
#: ``chip_smoke.py``
PLAIN_RTOL = 1e-4

#: the text of the card's sync-debug warning
_SYNC_WARNING = "called a synchronizing CUDA operation"

#: aten ops that size their output from the data (a wait on the card)
_SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                       "_unique2", "unique_dim", "unique_consecutive",
                       "_unique"})


_PACKAGE = pathlib.Path(__file__).resolve().parents[1]


def _site(filename: str, lineno: int) -> Optional[str]:
    """``module/path.py:line`` of a frame inside the package (outside
    ``analysis/``), else None."""
    try:
        rel = pathlib.Path(filename).resolve().relative_to(_PACKAGE)
    except ValueError:
        return None
    if rel.parts and rel.parts[0] == "analysis":
        return None
    return f"{rel.as_posix()}:{lineno}"


def _caller_site() -> str:
    """The innermost package frame of the current Python stack (outside
    the package: the innermost frames, innermost first)."""
    f = sys._getframe(1)
    outer = []
    while f is not None:
        site = _site(f.f_code.co_filename, f.f_lineno)
        if site is not None:
            return site if not outer else f"{site} via {' < '.join(outer)}"
        if len(outer) < 3 and "analysis" not in f.f_code.co_filename:
            outer.append(f"{pathlib.Path(f.f_code.co_filename).name}:"
                         f"{f.f_lineno}:{f.f_code.co_name}")
        f = f.f_back
    return "? " + " < ".join(outer)


def _leaves(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in _leaves(e)]
    if isinstance(x, dict):
        return [t for k in sorted(x, key=repr) for t in _leaves(x[k])]
    return []


class _OpCounter(TorchDispatchMode):
    """The aten histogram, the dtype set and the data-sized ops of a
    run."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = {}
        self.dtypes: set = set()
        self.sites: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        if name in _SYNC_OPS or (
                name in ("index", "index_put", "index_put_") and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if len(args) > 1 and isinstance(
                        args[1], (list, tuple)) else ()))) or (
                name == "repeat_interleave"
                and kwargs.get("output_size") is None
                and args and isinstance(args[0], torch.Tensor)
                and len(args) < 3):
            self.sites.append(_caller_site())
        out = func(*args, **kwargs)
        for t in _leaves(out):
            self.dtypes.add(str(t.dtype).replace("torch.", ""))
        return out


class _ReadCounter(TorchFunctionMode):
    """Explicit reads to the host (``.cpu()``, ``.numpy()``,
    ``.tolist()``, ``np.asarray(t)``); a tensor is counted once.  On the
    CPU a ``.to(device)`` cannot tell a read from a move to the program's
    own device, so it is counted on the card only (by its warning)."""

    _READS = frozenset({"cpu", "numpy", "tolist", "__array__"})

    def __init__(self):
        super().__init__()
        self.sites: List[str] = []
        # by identity (a tensor's == is elementwise); the tensors are held
        # for the run so an id is never reused
        self._seen: Dict[int, torch.Tensor] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if (args and isinstance(args[0], torch.Tensor)
                and name in self._READS and id(args[0]) not in self._seen):
            self.sites.append(_caller_site())
            self._seen[id(args[0])] = args[0]
        out = func(*args, **kwargs)
        if name == "cpu" and isinstance(out, torch.Tensor):
            self._seen[id(out)] = out
        return out


def scope(device) -> str:
    """Where a golden is valid: the backend (``cpu``, or the card's name
    and ``sm_XY``) and torch's major.minor."""
    device = torch.device(device)
    ver = ".".join(torch.__version__.split("+")[0].split(".")[:2])
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device).replace(" ", "_")
        cc = "sm_%d%d" % torch.cuda.get_device_capability(device)
        return f"{name}-{cc}-torch{ver}"
    return f"cpu-torch{ver}"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _requested(device, which: str) -> int:
    """The allocator's ``requested_bytes`` (current or peak)."""
    return int(torch.cuda.memory_stats(device)[
        f"requested_bytes.all.{which}"])


def _calls() -> Dict[str, float]:
    """Every communicator's ``collective_calls``, summed by key (a
    program may call on a communicator of its own, a replica group's)."""
    from raft_tpu_torch import telemetry

    metric = telemetry.REGISTRY.get("raft_tpu_comms_collective_calls")
    out: Dict[str, float] = {}
    for labels, v in (metric.items() if metric is not None else ()):
        out[labels[-1]] = out.get(labels[-1], 0) + v
    return out


def against_plain(out, ref) -> dict:
    """A run's outputs *out* against its plain version's *ref*, leaf by
    leaf: float leaves within :data:`PLAIN_RTOL` × (max |ref| + 1) with
    the same non-finite slots; integer leaves (ids, labels) equal but at
    most max(4, n / 100) entries, which only a swap of near ties moves
    (the float leaves hold the values at those slots).  Returns
    ``{"ok", "max_abs_err", "ids_differ", "why"}``."""
    a, b = _leaves(out), _leaves(ref)
    why, err, differ = [], 0.0, 0
    if len(a) != len(b):
        why.append(f"{len(a)} outputs against the plain version's {len(b)}")
    for j, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape or x.dtype != y.dtype:
            why.append(f"output {j}: {tuple(x.shape)} {x.dtype} against "
                       f"{tuple(y.shape)} {y.dtype}")
            continue
        if not x.numel():
            continue
        if x.is_floating_point():
            xd, yd = x.double(), y.double()
            fin = torch.isfinite(yd)
            if not torch.equal(fin, torch.isfinite(xd)) or not torch.equal(
                    xd[~fin], yd[~fin]):
                why.append(f"output {j}: non-finite slots differ")
                continue
            if not bool(fin.any()):
                continue
            e = float((xd[fin] - yd[fin]).abs().max())
            tol = PLAIN_RTOL * (float(yd[fin].abs().max()) + 1.0)
            err = max(err, e)
            if e > tol:
                why.append(f"output {j}: max error {e:.3g} > {tol:.3g}")
        else:
            n = int((x != y).sum())
            differ += n
            if n > max(4, x.numel() // 100):
                why.append(f"output {j}: {n} of {x.numel()} entries differ")
    return {"ok": not why, "max_abs_err": err, "ids_differ": differ,
            "why": why}


def measure(entry: registry.ProgramEntry, device, comms=None) -> dict:
    """Run *entry*'s program once (after one uncounted warm run) on
    *device* and return its record: host reads, collectives and bytes,
    launches by kernel, transient bytes (None on the CPU), the aten
    histogram, the dtype set, the in-place aliases and, where the inputs
    carry one, the outputs against the plain version (``plain``)."""
    from raft_tpu_torch.kernels import native

    device = torch.device(device)
    spec = (entry.builder(device, comms) if entry.comms
            else entry.builder(device))
    fn, args = spec["fn"], tuple(spec.get("args", ()))
    kwargs = dict(spec.get("kwargs", {}))
    fn(*args, **kwargs)
    _sync(device)
    # garbage of earlier work freed now and none during the run, so the
    # peak above the inputs counts this run's tensors alone; and an empty
    # allocator cache, since a reused cached block is counted whole when
    # its rest is too small to split, which would make the peak depend on
    # what ran before
    gc.collect()
    launches0 = dict(native.LAUNCHES)
    calls0 = _calls()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        req_base = _requested(device, "current")
        torch.cuda.reset_peak_memory_stats(device)
    ops, reads = _OpCounter(), _ReadCounter()
    card_sites: List[str] = []

    def on_warning(message, *_args, **_kw):
        # called inside warnings.warn, so the stack still holds the
        # package frame that made the op wait; other warnings (the mode's
        # own first-use notice among them) are not syncs
        if _SYNC_WARNING in str(message):
            card_sites.append(_caller_site())

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        gc.disable()
        try:
            with reads, ops:
                out = fn(*args, **kwargs)
        finally:
            gc.enable()
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    _sync(device)
    transient = requested = None
    if cuda:
        transient = int(torch.cuda.max_memory_allocated(device) - base)
        requested = _requested(device, "peak") - req_base
        sites = card_sites
    else:
        sites = ops.sites + reads.sites
    calls1 = _calls()
    coll = {k: calls1.get(k, 0) - calls0.get(k, 0) for k in calls1}
    n_coll = sum(v for k, v in coll.items()
                 if not k.endswith("_bytes") and not k.endswith("_staged"))
    n_bytes = sum(v for k, v in coll.items() if k.endswith("_bytes"))
    launches = {k: v - launches0.get(k, 0)
                for k, v in native.LAUNCHES.items()
                if v - launches0.get(k, 0)}
    out_ptrs = {t.untyped_storage().data_ptr() for t in _leaves(out)}
    aliases = []
    for argnum in entry.in_place:
        for j, t in enumerate(_leaves(args[argnum])):
            if t.untyped_storage().data_ptr() in out_ptrs:
                aliases.append([argnum, j])
    expected = [[a, j] for a in entry.in_place
                for j in range(len(_leaves(args[a])))]
    plain = spec.get("plain")
    vs_plain = None if plain is None else against_plain(out, plain())
    return {
        "schema": SCHEMA,
        "program": entry.name,
        "scope": scope(device),
        "host_reads": len(sites),
        "sync_sites": sorted(sites),
        "collectives": int(n_coll),
        "collective_bytes": int(n_bytes),
        "launches": {k: int(launches[k]) for k in sorted(launches)},
        "transient_bytes": transient,
        "requested_bytes": requested,
        "ops": {k: ops.ops[k] for k in sorted(ops.ops)},
        "dtypes": sorted(ops.dtypes),
        "in_place": aliases,
        "in_place_expected": expected,
        "plain": vs_plain,
    }


@dataclasses.dataclass
class ProgramReport:
    name: str
    status: str                      # "ok" | "fail" | "skipped"
    findings: List[str]
    record: Optional[dict] = None


def check(entry: registry.ProgramEntry, rec: dict) -> List[str]:
    """Budget findings of one record (empty: within budget)."""
    findings = []
    if rec["host_reads"] > entry.host_reads:
        findings.append(f"host syncs {rec['host_reads']} > budget "
                        f"{entry.host_reads} at {rec['sync_sites']}")
    if rec["collectives"] > entry.collectives:
        findings.append(f"collective calls {rec['collectives']} > budget "
                        f"{entry.collectives}")
    if rec["collective_bytes"] > entry.collective_bytes:
        findings.append(f"collective payload {rec['collective_bytes']} B "
                        f"> budget {entry.collective_bytes} B")
    if rec["in_place"] != rec["in_place_expected"]:
        findings.append(
            f"in-place outputs {rec['in_place']} != declared "
            f"{rec['in_place_expected']} — a write meant to land in its "
            "input landed in a copy (the O(buffer) copy is back)")
    vs = rec.get("plain")
    if vs is not None and not vs["ok"]:
        findings.append(f"outputs disagree with the plain version: "
                        f"{vs['why']}")
    t = rec["transient_bytes"]
    if entry.transient_bytes is not None and t is not None \
            and t > entry.transient_bytes:
        findings.append(f"transient {t} B exceeds declared ceiling "
                        f"{entry.transient_bytes} B")
    return findings


def _entries(names, fast_only) -> List[registry.ProgramEntry]:
    if not names:
        return registry.iter_programs(fast_only=fast_only)
    out = []
    for n in names:
        e = registry.get_program(n)
        if e is None:
            raise KeyError(f"unknown audit program {n!r} (registered: "
                           f"{[p.name for p in registry.iter_programs()]})")
        out.append(e)
    return out


def _world_target(comms, payload):
    """A world-1 rank's side of :func:`measure_all`: the comms entries'
    records (or the error of each that failed)."""
    out = []
    for name in payload["names"]:
        entry = registry.get_program(name)
        try:
            out.append(measure(entry, payload["device"], comms))
        except Exception as e:  # reported per program by the parent
            out.append({"program": name, "error": repr(e)})
    return out


def measure_all(entries, device, comms=None) -> Dict[str, dict]:
    """Records of *entries* by name; a failed run's record holds
    ``error``.  Comms entries run in a world-1 process unless *comms* is
    given."""
    recs: Dict[str, dict] = {}
    remote = [e.name for e in entries if e.comms and comms is None]
    for e in entries:
        if e.name in remote:
            continue
        try:
            recs[e.name] = measure(e, device, comms)
        except Exception as ex:
            recs[e.name] = {"program": e.name, "error": repr(ex)}
    if remote:
        from raft_tpu_torch.testing.world import run_world

        dev = torch.device(device)
        with tempfile.TemporaryDirectory() as tmp:
            out = run_world(
                "raft_tpu_torch.analysis.program_audit:_world_target", 1,
                dict(names=remote, device=str(dev)), workdir=tmp,
                device="cuda" if dev.type == "cuda" else "cpu",
                timeout=600.0)[0]
        recs.update((r["program"], r) for r in out)
    return recs


def summary(entry: registry.ProgramEntry, rec: dict) -> str:
    t = rec["transient_bytes"]
    temp = ("temp skipped (cpu)" if t is None
            else f"temp {t}B<={entry.transient_bytes}B")
    launches = ",".join(f"{k}:{v}" for k, v in rec["launches"].items())
    return (f"syncs {rec['host_reads']}/{entry.host_reads}; coll "
            f"{rec['collectives']}/{entry.collectives} "
            f"{rec['collective_bytes']}B/{entry.collective_bytes}B; "
            f"launches {launches or '-'}; {temp}")


def run(names: Optional[List[str]] = None, *, device="cpu",
        fast_only: bool = False, comms=None, out=None
        ) -> Tuple[List[ProgramReport], int]:
    """Audit the registered programs (all, the fast subset, or *names*)
    on *device*.  Returns (reports, failure count) and prints one line a
    program."""
    out = out or sys.stdout
    entries = _entries(names, fast_only)
    recs = measure_all(entries, device, comms)
    reports, failed = [], 0
    for e in entries:
        rec = recs[e.name]
        if "error" in rec:
            r = ProgramReport(e.name, "fail", [f"run failed: {rec['error']}"])
        else:
            f = check(e, rec)
            r = ProgramReport(e.name, "fail" if f else "ok", f, rec)
        reports.append(r)
        failed += r.status == "fail"
        line = summary(e, r.record) if r.record else ""
        print(f"  [{r.status:>7}] {e.name:32s} {line}", file=out)
        for f in r.findings:
            print(f"           - {f}", file=out)
    ok = sum(r.status == "ok" for r in reports)
    print(f"program_audit: {ok} program(s) verified, {failed} failed",
          file=out)
    return reports, failed
