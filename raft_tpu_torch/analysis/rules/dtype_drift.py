"""``dtype-drift``: 64-bit float dtypes in library code outside marked
lines (port of ``raft_tpu/analysis/rules/dtype_drift.py``).  On the card
a float64 tensor runs at 1/30 of float32's rate (67 against 2 TFLOP/s
dense on an H100 without tensor cores) and doubles the bytes, and a
float64 numpy array turned into a tensor stays float64 — so every use
(``torch.float64``, ``torch.double``, ``.double()``, ``np.float64``,
``np.double``, the string ``"float64"``) must say why it is needed:
``# exempt(dtype-drift): why`` on the line or the line above (a float64
accumulator of a reduction check, a host-side numpy table).
``raft_tpu_torch/analysis/`` names the tokens in its own rules and is out
of scope.

Names and attributes resolve through the file's value-flow, so
``f64 = torch.float64; x.to(f64)`` fires at the use (a marker at the
laundering hop sanctions the uses)."""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.engine import rule

_F64_PATHS = frozenset({
    "numpy.float64", "numpy.double", "torch.float64", "torch.double",
})
_F64_ATTRS = ("float64", "double")


def _scope(posix: str) -> bool:
    return ("raft_tpu_torch/" in posix
            and "raft_tpu_torch/analysis/" not in posix)


@rule("dtype-drift", scope=_scope,
      doc="float64 (incl. laundered aliases and .double()) in library code "
          "outside marked lines")
def check_dtype_drift(ctx):
    found = {}

    def add(lineno, name):
        if ctx.exempt("dtype-drift", lineno):
            return
        found.setdefault((lineno, name), (
            f"{name} outside a marked line — float64 on the card runs at a "
            "fraction of float32's rate and doubles the bytes; if it is "
            "needed mark the line exempt(dtype-drift) with why"))

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and node.attr in _F64_ATTRS:
            base = node.value
            if isinstance(base, ast.Name) and base.id in ("np", "numpy",
                                                          "torch"):
                add(node.lineno, f"{base.id}.{node.attr}")
                continue
            path = ctx.flow.resolve(node)
            if path in _F64_PATHS:
                add(node.lineno, path)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "double" and not node.args):
            add(node.lineno, ".double()")
        elif isinstance(node, ast.Constant) and node.value == "float64":
            add(node.lineno, '"float64"')
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            hops: list = []
            path = ctx.flow.resolve(node, trace=hops)
            if path in _F64_PATHS and not any(
                    ctx.exempt("dtype-drift", h) for h in hops):
                add(node.lineno, f"{path} (laundered as `{node.id}`)")
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and node.module in (
                "numpy", "torch"):
            for a in node.names:
                if a.name in _F64_ATTRS:
                    add(node.lineno,
                        f"`from {node.module} import {a.name}`")
    return [(lineno, msg) for (lineno, _), msg in sorted(found.items())]
