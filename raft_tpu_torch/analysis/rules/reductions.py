"""``raw-segment-sum``: a raw keyed sum — ``index_add`` / ``index_add_``,
``scatter_add`` / ``scatter_add_``, ``scatter_reduce`` with ``"sum"`` —
anywhere in ``raft_tpu_torch/`` outside ``linalg/reduce.py`` (port of
``raft_tpu/analysis/rules/reductions.py``).  Keyed row reductions go
through ``linalg/reduce.py`` (``segment_sum``, ``reduce_rows_by_key``,
``reduce_cols_by_key``), which drops out-of-range keys as the JAX package
does and sums in row order on the CPU; a raw scatter elsewhere forks
those semantics.  Scatters that are no keyed row reduction (a histogram,
a densifying scatter, a probe counter) carry
``# exempt(raw-segment-sum): why``."""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.engine import call_name, rule

_SUM_SCATTERS = ("index_add", "index_add_", "scatter_add", "scatter_add_")


def _scope(posix: str) -> bool:
    return ("raft_tpu_torch/" in posix
            and not posix.endswith("linalg/reduce.py"))


def _sum_reduce(node: ast.Call) -> bool:
    args = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "reduce"]
    return any(isinstance(a, ast.Constant) and a.value == "sum"
               for a in args)


@rule("raw-segment-sum", scope=_scope,
      doc="raw index_add/scatter_add keyed sums outside linalg/reduce.py")
def check_raw_segment_sum(ctx):
    findings = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if not (name in _SUM_SCATTERS or (
                name in ("scatter_reduce", "scatter_reduce_")
                and _sum_reduce(node))):
            continue
        if ctx.exempt("raw-segment-sum", node.lineno):
            continue
        findings.append((node.lineno,
                         f"raw keyed sum {name} outside linalg/reduce.py "
                         "— use raft_tpu_torch.linalg.reduce "
                         "(segment_sum, reduce_rows_by_key), or mark the "
                         "line exempt(raw-segment-sum) with why"))
    return findings
