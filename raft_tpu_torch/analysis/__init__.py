"""Static and run-time analysis of the hot-path contracts (port of
``raft_tpu/analysis``).

Two levels, both runnable from ``python -m raft_tpu_torch.analysis``:

* **Level 1 — AST rule engine** (:mod:`.engine`, :mod:`.rules`,
  :mod:`.dataflow`, :mod:`.hotpaths`): source rules over the package —
  collective discipline, hot-path host reads, the kernel home, probe-scan
  closures, serve dispatch, static-arg hashability, dtype drift, trace
  purity, error / mutation / telemetry discipline, raw keyed sums and
  style — with ONE inline exemption syntax,
  ``# exempt(rule-id): rationale`` (the legacy ``adc-exempt`` /
  ``serve-exempt`` / ``host-ok`` markers still parse).
* **Level 2 — program audit** (:mod:`.program_audit`, :mod:`.registry`;
  the reference's ``hlo_audit``): hot-path programs declare their audit
  shape and budgets next to their definitions
  (:func:`.registry.audit_program`); the auditor runs each once and
  checks its host syncs, collectives, in-place writes and transient bytes
  and records its kernel launches.  :mod:`.fingerprint` diffs every
  program's fingerprint against goldens committed per backend and torch
  version under ``goldens/``.

* **Retrace-closure certifier** (:mod:`.retrace`): proves from source
  that serving makes no first call of a keyed program after
  ``ServeEngine.warmup()`` — warm/dispatch congruence of every serving
  class, the engine's bucket, scheduler and tuner closures, the mutable
  index's write-path rewarm, and bounded static arguments at every
  ``aot()`` call site.

Importing this package loads nothing heavy; ``registry`` is stdlib-only,
so hot modules declare audit entries for free.
"""

_SUBMODULES = ("dataflow", "engine", "fingerprint", "hotpaths", "registry",
               "retrace", "rules", "program_audit")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        mod = importlib.import_module(f"raft_tpu_torch.analysis.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'raft_tpu_torch.analysis' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_SUBMODULES))
