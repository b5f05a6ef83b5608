"""``telemetry-discipline``: ad-hoc instrumentation in hot-path-registry
modules must route through :mod:`raft_tpu_torch.telemetry`, and metric/scrape
endpoints must live in :mod:`raft_tpu_torch.telemetry.http`.

Two shapes are flagged in any module the hot-path registry
(:mod:`raft_tpu_torch.analysis.hotpaths`) covers:

* **raw clock reads** — ``time.perf_counter`` / ``time.monotonic`` (and
  their ``_ns`` forms, and from-imported spellings bound by
  ``from time import perf_counter``).  Hand-rolled timing on a hot path is
  exactly what grew the unbounded ``last_latencies`` list: it bypasses the
  bounded histograms, the span taxonomy, and the global
  ``RAFT_TPU_TELEMETRY=0`` kill switch.  Use ``telemetry.now()`` for a
  bare timestamp, ``telemetry.span(...)`` for a timed region.
* **module-level ``Counter()`` telemetry** — a fresh
  ``collections.Counter`` bound at module scope is the pre-registry
  fragment pattern (``aot_compile_counters``, ``lut_trace_counters``, …):
  not thread-safe under concurrent ``ServeEngine.search()`` callers, not
  exportable, invisible to ``telemetry.snapshot()``.  Use
  ``telemetry.legacy_counter(...)`` (same read surface, atomic ``inc``)
  or a registry counter.

And one shape is flagged ANYWHERE in the library (``raft_tpu_torch/``, not just
hot-path modules):

* **raw ``http.server`` endpoints** — ``import http.server`` /
  ``from http.server import ...`` outside ``raft_tpu_torch/telemetry/``.  A
  hand-rolled ``/metrics`` endpoint forks the scrape surface: it serves
  whatever its author exported, not the registry, and bypasses the
  torn-read-safe handlers, the health-readiness shape and the bounded
  flight recorder.  Serve scrapes through
  :class:`raft_tpu_torch.telemetry.http.TelemetryServer` (or
  ``ServeEngine.serve_http``).

The clock/Counter checks are module-wide even for function-scoped registry
entries: timing a training prologue through telemetry costs nothing, and a
module on the hot-path registry is exactly where stray instrumentation
tends to creep into the request path.  ``raft_tpu_torch/telemetry/`` itself is
the blessed implementation home and is out of scope.  Sanctioned uses
carry the unified marker (``# exempt(telemetry-discipline): why``).
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis import hotpaths
from raft_tpu_torch.analysis.engine import rule

_CLOCKS = ("perf_counter", "monotonic", "perf_counter_ns", "monotonic_ns")


def _scope(posix: str) -> bool:
    # the http.server-endpoint check covers the whole library; the
    # clock/Counter checks gate on the hot-path registry inside the rule
    return ("raft_tpu_torch/telemetry/" not in posix
            and ("raft_tpu_torch/" in posix or hotpaths.match(posix) is not None))


def _clock_read(node):
    """The raw-clock spelling this node is, or None: ``time.<clock>``
    attribute reads and bare names bound by ``from time import <clock>``
    (the laundering form the collective-discipline rule also catches)."""
    if isinstance(node, ast.Attribute) and node.attr in _CLOCKS:
        if isinstance(node.value, ast.Name) and node.value.id == "time":
            return f"time.{node.attr}"
    if isinstance(node, ast.ImportFrom) and node.module == "time":
        for a in node.names:
            if a.name in _CLOCKS:
                return f"from time import {a.name}"
    return None


def _module_counter_bind(node):
    """True for a module-level ``X = Counter()`` / ``collections.Counter()``
    binding (an annotated or plain assign)."""
    if not isinstance(node, (ast.Assign, ast.AnnAssign)):
        return False
    value = node.value
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    if isinstance(f, ast.Name) and f.id == "Counter":
        return True
    return (isinstance(f, ast.Attribute) and f.attr == "Counter"
            and isinstance(f.value, ast.Name)
            and f.value.id == "collections")


def _http_server_use(node):
    """The raw ``http.server`` spelling this node is, or None — plain and
    from-imports (``import http.server [as x]``, ``from http.server
    import ThreadingHTTPServer``, ``from http import server``)."""
    if isinstance(node, ast.Import):
        for a in node.names:
            if a.name == "http.server" or a.name.startswith("http.server."):
                return "import http.server"
    if isinstance(node, ast.ImportFrom):
        if node.module is not None and (
                node.module == "http.server"
                or node.module.startswith("http.server.")):
            return f"from {node.module} import ..."
        if node.module == "http":
            for a in node.names:
                if a.name == "server":
                    return "from http import server"
    return None


@rule("telemetry-discipline", scope=_scope,
      doc="raw time.perf_counter/monotonic and module-level Counter() "
          "telemetry in hot-path-registry modules (route through "
          "raft_tpu_torch.telemetry), and raw http.server metric "
          "endpoints "
          "anywhere in the library outside raft_tpu_torch/telemetry/ (use "
          "telemetry.http.TelemetryServer / ServeEngine.serve_http)")
def check_telemetry_discipline(ctx):
    findings, seen = [], set()
    hot = hotpaths.match(ctx.posix) is not None
    in_library = "raft_tpu_torch/" in ctx.posix
    for node in ast.walk(ctx.tree):
        if in_library:
            what = _http_server_use(node)
            if what is not None and node.lineno not in seen:
                if not ctx.exempt("telemetry-discipline", node.lineno):
                    seen.add(node.lineno)
                    findings.append((
                        node.lineno,
                        f"{what} outside raft_tpu_torch/telemetry/ — a "
                        "hand-rolled metric/scrape endpoint forks the "
                        "scrape surface (serves ad-hoc state, bypasses "
                        "the torn-read-safe handlers, /healthz shape and "
                        "the bounded flight recorder); use "
                        "telemetry.http.TelemetryServer or "
                        "ServeEngine.serve_http, or mark the line "
                        "exempt(telemetry-discipline)"))
        if not hot:
            continue
        what = _clock_read(node)
        if what is None or node.lineno in seen:
            continue
        if ctx.exempt("telemetry-discipline", node.lineno):
            continue
        seen.add(node.lineno)
        findings.append((
            node.lineno,
            f"{what} in a hot-path-registry module — raw clock reads "
            "bypass the bounded histograms, span taxonomy and the "
            "RAFT_TPU_TELEMETRY kill switch; use telemetry.now() / "
            "telemetry.span(...), or mark the line "
            "exempt(telemetry-discipline)"))
    if hot:
        for node in ctx.tree.body:
            if not _module_counter_bind(node) or node.lineno in seen:
                continue
            if ctx.exempt("telemetry-discipline", node.lineno):
                continue
            seen.add(node.lineno)
            findings.append((
                node.lineno,
                "module-level Counter() telemetry in a hot-path-registry "
                "module — plain Counters race under concurrent serve "
                "callers and are invisible to telemetry.snapshot(); use "
                "telemetry.legacy_counter(...) (same read surface, atomic "
                "inc) or a registry counter, or mark the line "
                "exempt(telemetry-discipline)"))
    return sorted(findings)
