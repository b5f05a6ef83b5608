"""Golden program fingerprints: structural regression locks per hot-path
program (port of ``raft_tpu/analysis/fingerprint.py``).

The program audit checks DECLARED budgets.  This module locks the rest of
a program's run: for every registered program its fingerprint —

* **aten-op histogram** — calls per aten op in one run
  (:class:`~raft_tpu_torch.analysis.program_audit._OpCounter`): the shape
  of the computation, where the reference counts HLO opcodes;
* **kernel launches** by kernel (the card's kernels; none on the CPU);
* **collectives + payload bytes** (exact: a budget of "≤ 1" hides a
  0 → 1 drift);
* **dtype set** — every dtype an op produced (a float32 → float64 upcast
  changes it);
* **in-place aliases** — the (argnum, tensor) pairs whose storage an
  output shares;
* **transient bytes** (the card only): the peak of the bytes the run's
  allocations asked for above its inputs (the audit record's
  ``requested_bytes``, which earlier work cannot change; the audit's
  ceiling reads the allocator's own peak);

— diffed against a golden JSON committed under
``raft_tpu_torch/analysis/goldens/<scope>/``, where the scope is the
backend (``cpu``, or the card's name and ``sm_XY``) plus torch's
major.minor (:func:`~raft_tpu_torch.analysis.program_audit.scope`).  A
golden of another scope is reported as skipped and never compared.
Exact fields (collectives, bytes, launches, dtypes, aliases) fail on any
drift; counting fields get the per-field tolerances of
:data:`TOLERANCES`.  ``--update-goldens`` rewrites them deterministically
(sorted keys, no timestamps, one trailing newline) so an intended change
is reviewed as a golden diff.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.analysis import program_audit

#: committed goldens: ``<scope>/<program>.json``
GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "goldens"

#: bump when the fingerprint layout changes
SCHEMA = 1

#: ``(rel, abs)`` drift a counting field may show: up to
#: max(rel · golden, abs) before the diff fails
TOLERANCES: Dict[str, Tuple[float, int]] = {
    "ops": (0.25, 2),
    "transient_bytes": (0.25, 4096),
}

#: the record fields a fingerprint keeps
_FIELDS = ("ops", "launches", "collectives", "collective_bytes", "dtypes",
           "in_place", "transient_bytes")


@dataclasses.dataclass
class FingerprintReport:
    name: str
    status: str                 # "ok" | "fail" | "skipped" | "updated"
    findings: List[str]
    fingerprint: Optional[dict] = None


def of(record: dict) -> dict:
    """The fingerprint of one program-audit record."""
    fp = {k: record[k] for k in _FIELDS}
    fp["transient_bytes"] = record["requested_bytes"]
    fp.update(schema=SCHEMA, program=record["program"],
              scope=record["scope"])
    return fp


def dumps(fp: dict) -> str:
    """Deterministic serialization: sorted keys, fixed indent, one
    trailing newline, no timestamps."""
    return json.dumps(fp, indent=2, sort_keys=True) + "\n"


def _within(golden_v: int, current_v: int, field: str) -> bool:
    rel, abs_ = TOLERANCES[field]
    return abs(current_v - golden_v) <= max(abs_, rel * golden_v)


def diff(golden: dict, current: dict) -> List[str]:
    """Findings where *current* drifts outside *golden*'s tolerances."""
    if golden.get("schema") != current.get("schema"):
        return [f"golden schema {golden.get('schema')} != "
                f"{current.get('schema')} — regenerate with "
                "--update-goldens"]
    findings: List[str] = []
    for field in ("collectives", "collective_bytes"):
        if golden[field] != current[field]:
            findings.append(
                f"{field} {current[field]} != golden {golden[field]} — the "
                "program grew or lost a collective")
    if golden["launches"] != current["launches"]:
        findings.append(f"kernel launches {current['launches']} != golden "
                        f"{golden['launches']}")
    g_dt, c_dt = set(golden["dtypes"]), set(current["dtypes"])
    if g_dt != c_dt:
        bits = []
        if c_dt - g_dt:
            bits.append(f"gained {sorted(c_dt - g_dt)}")
        if g_dt - c_dt:
            bits.append(f"lost {sorted(g_dt - c_dt)}")
        findings.append(f"dtype set drifted ({'; '.join(bits)}) — an upcast "
                        "or a lost narrow path changes the arithmetic")
    if golden["in_place"] != current["in_place"]:
        findings.append(f"in-place aliases {current['in_place']} != golden "
                        f"{golden['in_place']} — a write in place was lost "
                        "or appeared")
    gt, ct = golden.get("transient_bytes"), current.get("transient_bytes")
    if gt is not None and ct is not None and not _within(
            gt, ct, "transient_bytes"):
        findings.append(f"transient {ct} B outside tolerance of golden "
                        f"{gt} B")
    g_ops, c_ops = golden["ops"], current["ops"]
    for op in sorted(set(g_ops) | set(c_ops)):
        gv, cv = g_ops.get(op, 0), c_ops.get(op, 0)
        if not _within(gv, cv, "ops"):
            findings.append(f"aten op `{op}` count {cv} outside tolerance "
                            f"of golden {gv}")
    return findings


def compare(fps: Dict[str, dict], names, *, golden_dir=None,
            update: bool = False, out=None
            ) -> Tuple[List[FingerprintReport], int]:
    """Diff (or with *update*, write) the fingerprints *fps* by program
    name against the goldens of their scope; *names*: every program
    expected (a missing fingerprint is a failure)."""
    out = out or sys.stdout
    gdir = pathlib.Path(golden_dir) if golden_dir is not None else GOLDEN_DIR
    reports, failed = [], 0
    for name in names:
        fp = fps.get(name)
        if fp is None:
            reports.append(FingerprintReport(name, "fail",
                                             ["the program did not run"]))
            failed += 1
            print(f"  [   fail] {name:32s} no fingerprint", file=out)
            continue
        path = gdir / fp["scope"] / f"{name}.json"
        if update:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(dumps(fp))
            reports.append(FingerprintReport(name, "updated", [], fp))
            print(f"  [updated] {name:32s} -> {fp['scope']}/{path.name}",
                  file=out)
            continue
        if not path.exists():
            others = sorted(p.parent.name
                            for p in gdir.glob(f"*/{name}.json"))
            if others:
                reports.append(FingerprintReport(name, "skipped", [], fp))
                print(f"  [skipped] {name:32s} goldens are for {others}, "
                      f"running in {fp['scope']}", file=out)
                continue
            reports.append(FingerprintReport(
                name, "fail", ["no golden committed — run `python -m "
                               "raft_tpu_torch.analysis --update-goldens`"],
                fp))
            failed += 1
            print(f"  [   fail] {name:32s} no golden", file=out)
            continue
        golden = json.loads(path.read_text())
        findings = diff(golden, fp)
        status = "fail" if findings else "ok"
        failed += status == "fail"
        reports.append(FingerprintReport(name, status, findings, fp))
        print(f"  [{status:>7}] {name:32s} ops {sum(fp['ops'].values())} "
              f"launches {sum(fp['launches'].values())} coll "
              f"{fp['collectives']}/{fp['collective_bytes']}B dtypes "
              f"{','.join(fp['dtypes'])}", file=out)
        for f in findings:
            print(f"           - {f}", file=out)
    return reports, failed


def stale_goldens(scope: str, names, golden_dir=None) -> List[str]:
    """Goldens of *scope* with no registered program."""
    gdir = pathlib.Path(golden_dir) if golden_dir is not None else GOLDEN_DIR
    return sorted(p.stem for p in (gdir / scope).glob("*.json")
                  if p.stem not in set(names))


def run(names: Optional[List[str]] = None, *, device="cpu",
        update: bool = False, golden_dir=None, comms=None, out=None
        ) -> Tuple[List[FingerprintReport], int]:
    """Fingerprint the registered programs (all, or *names*) on *device*
    and diff each against its golden — or rewrite the goldens with
    *update* (pruning the scope's stale ones).  Returns (reports,
    failures)."""
    out = out or sys.stdout
    entries = program_audit._entries(names, False)
    recs = program_audit.measure_all(entries, device, comms)
    fps = {n: of(r) for n, r in recs.items() if "error" not in r}
    all_names = [e.name for e in entries]
    reports, failed = compare(fps, all_names, golden_dir=golden_dir,
                              update=update, out=out)
    if names is None:
        sc = program_audit.scope(device)
        gdir = pathlib.Path(golden_dir or GOLDEN_DIR)
        for stale in stale_goldens(sc, all_names, gdir):
            if update:
                (gdir / sc / f"{stale}.json").unlink()
                print(f"  [ pruned] {stale:32s} stale golden removed",
                      file=out)
            else:
                failed += 1
                reports.append(FingerprintReport(stale, "fail",
                                                 ["stale golden"]))
                print(f"  [   fail] {stale:32s} STALE golden (no "
                      "registered program)", file=out)
    print(f"fingerprint: {sum(r.status == 'ok' for r in reports)} verified, "
          f"{sum(r.status == 'updated' for r in reports)} updated, "
          f"{failed} failed, "
          f"{sum(r.status == 'skipped' for r in reports)} skipped", file=out)
    return reports, failed
