"""``trace-impurity``: host-side impurities in hot-path bodies (port of
``raft_tpu/analysis/rules/trace_purity.py``).  The bodies are the
functions the hot-path registry names (every function of a module-wide
entry), the functions named ``*_impl`` / ``*_program`` / ``program``
anywhere in the package, and ``scan_probe_lists`` tile callbacks.  In
them:

* ``print`` — output on every batch of a serving path;
* the global random generators — ``np.random.<fn>`` module functions
  (``np.random.default_rng`` and the generator classes make a local
  generator and are fine) and ``torch.rand`` / ``randn`` / ``randint`` /
  ``randperm`` / ``rand_like`` / ``randn_like`` / ``randint_like`` /
  ``normal`` / ``bernoulli`` / ``multinomial`` without ``generator=``:
  a draw from process-global state makes a program's result depend on
  what ran before it, and on another thread's draws.

Sanctioned uses carry ``# exempt(trace-impurity): why``."""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis import hotpaths
from raft_tpu_torch.analysis.engine import rule
from raft_tpu_torch.analysis.rules.host_transfer import function_spans
from raft_tpu_torch.analysis.rules.probe_scan import scan_callbacks

_TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm",
                          "rand_like", "randn_like", "randint_like",
                          "normal", "bernoulli", "multinomial"})
_NP_LOCAL = frozenset({"default_rng", "Generator", "RandomState",
                       "SeedSequence", "PCG64", "MT19937", "Philox",
                       "SFC64", "BitGenerator"})


def _is_program_body(node) -> bool:
    return (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and (node.name.endswith("_impl")
                 or node.name.endswith("_program")
                 or node.name == "program"))


def _impurity(node, flow):
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Name) and f.id == "print":
        return "print"
    path = flow.resolve_call(node) or ""
    if path.startswith("numpy.random."):
        tail = path.split(".")[2]
        if tail not in _NP_LOCAL:
            return f"np.random.{tail}"
    if path.startswith("torch.") and path.count(".") == 1:
        tail = path.split(".", 1)[1]
        if tail in _TORCH_DRAWS and not any(
                kw.arg == "generator" for kw in node.keywords):
            return f"torch.{tail} without generator="
    return None


@rule("trace-impurity", scope=lambda p: "raft_tpu_torch/" in p,
      doc="print / global random generators inside hot-path bodies")
def check_trace_impurity(ctx):
    hits = hotpaths.match(ctx.posix) or ()
    if any(not hp.functions for hp in hits):
        spans = [(1, len(ctx.lines) + 1)]
    else:
        spans = function_spans(ctx.tree,
                               {f for hp in hits for f in hp.functions})
    for n in ast.walk(ctx.tree):
        if _is_program_body(n):
            spans.append((n.lineno, n.end_lineno or n.lineno))
    spans.extend((cb.lineno, cb.end_lineno or cb.lineno)
                 for cb in scan_callbacks(ctx.tree))
    if not spans:
        return []
    findings, seen = [], set()
    for node in ast.walk(ctx.tree):
        what = _impurity(node, ctx.flow)
        if what is None or node.lineno in seen:
            continue
        if not any(a <= node.lineno <= b for a, b in spans):
            continue
        if ctx.exempt("trace-impurity", node.lineno):
            continue
        seen.add(node.lineno)
        findings.append((
            node.lineno,
            f"{what} inside a hot-path body — output on every batch, or a "
            "draw from process-global random state (results depend on "
            "what ran before); pass a generator / move it out, or mark the "
            "line exempt(trace-impurity)"))
    return sorted(findings)
