"""``probe-scan-closure`` (legacy marker ``adc-exempt``): the hoisted-LUT
guard, scoped to ``raft_tpu_torch/neighbors/`` (port of
``raft_tpu/analysis/rules/probe_scan.py``).  ``torch.einsum``,
``torch.gather`` and ``take_along_dim`` inside a ``scan_probe_lists``
tile callback may only consume callback-local data (the gathered tile,
the step's rows); an operand closed over from the enclosing search means
per-batch-invariant LUT work crept back into the per-step body — the
per-tile recompute that hoisting the LUT removed."""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.engine import (call_name, module_level_names,
                                            rule)

_SCAN_CALLBACK_BANNED = ("einsum", "gather", "take_along_dim")


def _direct_bindings(fn) -> set:
    """Names bound in *fn*'s OWN scope: params, direct assignments, loop /
    comprehension / with targets and nested def names — not names bound
    only inside a nested def's body."""
    bound = set()
    a = fn.args
    for arg in (a.posonlyargs + a.args + a.kwonlyargs
                + ([a.vararg] if a.vararg else [])
                + ([a.kwarg] if a.kwarg else [])):
        bound.add(arg.arg)
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(node.name)
            continue
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
        stack.extend(ast.iter_child_nodes(node))
    return bound


def _tainted_names(fn, local, module_names) -> set:
    """Locals of *fn* assigned from closed-over (or already tainted)
    names: the aliases that would launder a closed-over operand."""
    assigns = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Assign):
            assigns.append(node)
        stack.extend(ast.iter_child_nodes(node))
    tainted = set()
    changed = True
    while changed:
        changed = False
        for node in assigns:
            loads = {n.id for n in ast.walk(node.value)
                     if isinstance(n, ast.Name)
                     and isinstance(n.ctx, ast.Load)}
            if any(nm in tainted
                   or (nm not in local and nm not in module_names)
                   for nm in loads):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id not in tainted:
                        tainted.add(t.id)
                        changed = True
    return tainted


def scan_callbacks(tree) -> list:
    """Every tile callback handed to a ``scan_probe_lists`` call (its 2nd
    positional argument): named defs and inline lambdas.  Shared with the
    trace-impurity rule."""
    cb_names, cb_lambdas = set(), []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and call_name(node) == "scan_probe_lists"
                and len(node.args) >= 2):
            cb = node.args[1]
            if isinstance(cb, ast.Name):
                cb_names.add(cb.id)
            elif isinstance(cb, ast.Lambda):
                cb_lambdas.append(cb)
    callbacks = list(cb_lambdas)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in cb_names:
            callbacks.append(node)
    return callbacks


@rule("probe-scan-closure",
      scope=lambda p: "raft_tpu_torch/neighbors/" in p,
      legacy_markers=("adc-exempt",),
      doc="einsum/gather/take_along_dim over closed-over operands in a "
          "scan_probe_lists tile callback (hoisted-LUT contract)")
def check_probe_scan_callbacks(ctx):
    module_names = module_level_names(ctx.tree)
    findings = []

    def check_scope(fn, inherited):
        local = (inherited | _direct_bindings(fn)) - _tainted_names(
            fn, inherited | _direct_bindings(fn), module_names)
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                check_scope(node, local)
                continue
            stack.extend(ast.iter_child_nodes(node))
            if (not isinstance(node, ast.Call)
                    or call_name(node) not in _SCAN_CALLBACK_BANNED):
                continue
            if ctx.exempt("probe-scan-closure", node.lineno):
                continue
            free = set()
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for n in ast.walk(arg):
                    if (isinstance(n, ast.Name)
                            and isinstance(n.ctx, ast.Load)
                            and n.id not in local
                            and n.id not in module_names):
                        free.add(n.id)
            if free:
                findings.append((
                    node.lineno,
                    f"{call_name(node)} over closed-over operand(s) "
                    f"{sorted(free)} inside a scan_probe_lists tile "
                    "callback — hoist per-batch-invariant LUT work out of "
                    "the probe scan and pass it per step, or mark the "
                    "line exempt(probe-scan-closure)"))

    for cb in scan_callbacks(ctx.tree):
        check_scope(cb, set())
    return findings
