"""CLI: ``python -m raft_tpu_torch.analysis [options] [paths...]`` (port
of ``raft_tpu/analysis/__main__.py``).

Default: every pass — the AST rule engine over the package, the program
audit over every registered program, the golden-fingerprint diff and the
retrace-closure certifier.

Options:
  --ast               Level 1 only (stdlib-fast)
  --audit             program audit only (the reference's --hlo)
  --fingerprints      golden fingerprint diff only
  --retrace           retrace-closure certifier only (stdlib-fast)
                      (the pass flags COMPOSE: --audit --fingerprints runs
                      exactly those two)
  --update-goldens    REGENERATE the goldens of this scope (sorted keys, no
                      timestamps), prune stale ones, then verify a clean
                      diff
  --golden-dir DIR    read and write goldens under DIR
  --device DEV        run the programs on DEV (default: cpu)
  --stale-exemptions  report exempt() markers whose rule no longer fires
                      on the marked line (a warning pass: always exit 0)
  --fast              restrict the audit to the single-device programs
  --strict            a SKIPPED program counts as a failure
  --programs a,b      audit / fingerprint only the named programs; the
                      certifier keeps obligations whose name contains one
                      of the names
  --list              list registered rules and programs, run nothing
  paths...            restrict the AST level to these files/dirs

Exit codes (as in the reference):
  0  clean — every requested pass passed
  1  findings — AST findings, audit budget failures, fingerprint drift or
     certifier violations
  2  strict-skip only — the ONLY failures are programs skipped under
     ``--strict``
"""

from __future__ import annotations

import sys


def _option(args, name):
    """The value of ``--name value`` or ``--name=value`` (removed from
    *args*), else None."""
    for i, a in enumerate(args):
        if a == name and i + 1 < len(args):
            value = args[i + 1]
            del args[i:i + 2]
            return value
        if a.startswith(name + "="):
            del args[i]
            return a.split("=", 1)[1]
    return None


def main(argv) -> int:
    args = list(argv)

    def flag(name):
        if name in args:
            args.remove(name)
            return True
        return False

    only = {p for p in ("ast", "audit", "fingerprints", "retrace")
            if flag(f"--{p}")}
    update_goldens = flag("--update-goldens")
    stale = flag("--stale-exemptions")
    fast_only = flag("--fast")
    strict = flag("--strict")
    listing = flag("--list")
    programs = _option(args, "--programs")
    names = programs.split(",") if programs else None
    device = _option(args, "--device") or "cpu"
    golden_dir = _option(args, "--golden-dir")
    if update_goldens:
        only.add("fingerprints")
    if stale and not only:
        from raft_tpu_torch.analysis import engine

        print("== analysis: stale exemptions ==")
        engine.scan_stale_exemptions(args or None)
        return 0
    if listing:
        from raft_tpu_torch.analysis import engine, registry

        print("AST rules:")
        for r in engine.iter_rules():
            doc = (r.doc.splitlines() or [""])[0]
            print(f"  {r.id:26s} [{r.severity}] {doc[:70]}")
        print("audit programs:")
        for e in registry.iter_programs():
            tags = ["fast"] if e.fast else []
            if e.comms:
                tags.append("world 1")
            print(f"  {e.name:32s} syncs<={e.host_reads} "
                  f"coll<={e.collectives} bytes<={e.collective_bytes} "
                  f"temp<={e.transient_bytes} {' '.join(tags)}")
        return 0
    run_all = not only
    bad = 0
    strict_skips = 0
    if run_all or "ast" in only:
        from raft_tpu_torch.analysis import engine

        print("== analysis: AST rules ==")
        bad += engine.run(args or None)
    if run_all or "audit" in only:
        from raft_tpu_torch.analysis import program_audit

        print(f"== analysis: program audit ({device}) ==")
        _, failed = program_audit.run(names, device=device,
                                      fast_only=fast_only)
        bad += failed
    if run_all or "fingerprints" in only:
        from raft_tpu_torch.analysis import fingerprint

        print("== analysis: fingerprints =="
              + (" (updating goldens)" if update_goldens else ""))
        reports, failed = fingerprint.run(names, device=device,
                                          update=update_goldens,
                                          golden_dir=golden_dir)
        skipped = sum(r.status == "skipped" for r in reports)
        if strict and skipped:
            print(f"fingerprint: STRICT — {skipped} skipped program(s) "
                  "count as failures")
            strict_skips += skipped
            failed += skipped
        bad += failed
        if update_goldens and not failed:
            # the other half of the update: the fresh goldens must diff
            # clean against the run that wrote them
            _, failed = fingerprint.run(names, device=device,
                                        golden_dir=golden_dir)
            bad += failed
    if run_all or "retrace" in only:
        from raft_tpu_torch.analysis import retrace

        print("== analysis: retrace closure ==")
        _, failed = retrace.run(names)
        bad += failed
    if stale:
        from raft_tpu_torch.analysis import engine

        print("== analysis: stale exemptions ==")
        engine.scan_stale_exemptions(args or None)
    if bad:
        print(f"analysis: {bad} failure(s)", file=sys.stderr)
        return 2 if strict_skips and bad == strict_skips else 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
