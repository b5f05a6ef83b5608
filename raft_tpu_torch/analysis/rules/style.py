"""Stdlib style gate (port of ``raft_tpu/analysis/rules/style.py``) — the
whitespace/line-length/bare-except/f-string/unused-import subset, as
engine rules.  ``noqa`` on the line opts out
(these predate the unified marker and stay noqa-keyed: they are style, not
hot-path contracts)."""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.engine import rule

MAX_LINE = 100


def _everywhere(posix: str) -> bool:
    return True


@rule("style-whitespace", scope=_everywhere,
      doc="tabs in indentation, trailing whitespace, lines over "
          f"{MAX_LINE} columns")
def check_whitespace(ctx):
    findings = []
    for i, line in enumerate(ctx.lines, 1):
        if "noqa" in line:
            continue
        if line.rstrip("\n") != line.rstrip():
            findings.append((i, "trailing whitespace"))
        if line.startswith("\t") or (line[: len(line) - len(line.lstrip())]
                                     .find("\t") >= 0):
            findings.append((i, "tab in indentation"))
        if len(line) > MAX_LINE:
            findings.append((i, f"line too long ({len(line)} > {MAX_LINE})"))
    return findings


@rule("style-ast", scope=_everywhere,
      doc="bare except clauses; f-strings without placeholders")
def check_ast_style(ctx):
    findings = []
    lines = ctx.lines
    # format specs are themselves JoinedStr nodes — exclude them from the
    # placeholder check
    spec_ids = {id(fv.format_spec) for fv in ast.walk(ctx.tree)
                if isinstance(fv, ast.FormattedValue)
                and fv.format_spec is not None}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            if "noqa" not in lines[node.lineno - 1]:
                findings.append((node.lineno, "bare except"))
        if isinstance(node, ast.JoinedStr) and id(node) not in spec_ids:
            if not any(isinstance(v, ast.FormattedValue)
                       for v in node.values):
                if "noqa" not in lines[node.lineno - 1]:
                    findings.append((node.lineno,
                                     "f-string without placeholders"))
    return findings


@rule("style-unused-import", scope=lambda p: not p.endswith("__init__.py"),
      doc="imports never referenced (init re-export files excluded)")
def check_unused_imports(ctx):
    findings = []
    lines = ctx.lines
    imported = {}  # alias -> lineno
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                imported[name] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue  # compiler directives, not names
            for a in node.names:
                if a.name == "*":
                    continue
                imported[a.asname or a.name] = node.lineno
    used = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
    # names in docstrings/comments don't count; __all__ strings do
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)):
            for el in ast.walk(node.value):
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    used.add(el.value)
    for name, lineno in sorted(imported.items(), key=lambda kv: kv[1]):
        if name not in used and "noqa" not in lines[lineno - 1]:
            findings.append((lineno, f"unused import: {name}"))
    return findings
