"""``serve-dispatch`` (legacy marker ``serve-exempt``): the serving
zero-compile guard, scoped to ``raft_tpu_torch/serve/`` (port of
``raft_tpu/analysis/rules/serve_path.py``).  No ``torch.compile`` and no
``torch.jit`` anywhere in the package (a compile on the request path is
what warmup exists to keep off it), and no direct kernel launch: device
work goes through the backends' keyed programs (``core.aot``), so warmup
pins every signature and ``aot_compile_counters`` stays flat under
traffic.  A direct launch is a call of ``kernels.native``'s
``library`` / ``load_all`` / ``build_all`` or of a ``raft_*`` C symbol.
Reading ``kernels.native.BUILDS`` or ``LAUNCHES`` is no launch."""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.engine import rule

_NATIVE = "raft_tpu_torch.kernels.native"
_LAUNCHERS = frozenset(f"{_NATIVE}.{f}"
                       for f in ("library", "load_all", "build_all"))


def _msg(what: str) -> str:
    return (f"{what} in raft_tpu_torch/serve/ — serving dispatches the "
            "backends' keyed programs (core.aot), so warmup pins every "
            "signature; or mark the line exempt(serve-dispatch)")


@rule("serve-dispatch",
      scope=lambda p: "raft_tpu_torch/serve/" in p,
      legacy_markers=("serve-exempt",),
      doc="torch.compile / torch.jit / direct kernel launches in serve/ — "
          "device work dispatches the backends' keyed programs")
def check_serve_hot_path(ctx):
    found = {}

    def add(lineno, what):
        if not ctx.exempt("serve-dispatch", lineno):
            found.setdefault(lineno, _msg(what))

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name in ("compile", "jit"):
                    add(node.lineno, f"`from torch import {a.name}`")
        elif isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "torch.jit"
                or node.module.startswith("torch.jit.")):
            add(node.lineno, f"`from {node.module} import ...`")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.jit" or a.name.startswith("torch.jit."):
                    add(node.lineno, f"`import {a.name}`")
        elif isinstance(node, ast.Attribute) and node.attr in (
                "compile", "jit"):
            if ctx.flow.resolve(node) in ("torch.compile", "torch.jit"):
                add(node.lineno, f"torch.{node.attr}")
        elif isinstance(node, ast.Call):
            path = ctx.flow.resolve_call(node)
            f = node.func
            if path in _LAUNCHERS:
                add(node.lineno, f"{path.rsplit('.', 1)[-1]}() of "
                    "kernels.native")
            elif (isinstance(f, ast.Attribute)
                  and f.attr.startswith("raft_")):
                add(node.lineno, f"a direct call of C symbol {f.attr}")
    return sorted(found.items())
