"""``hot-path-host-transfer`` (legacy marker ``host-ok``): the device-
residency guard over the declared hot-path registry
(:mod:`raft_tpu_torch.analysis.hotpaths`; port of
``raft_tpu/analysis/rules/host_transfer.py``).

Inside every registered hot path these are banned: the tensor reads
``.item()``, ``.cpu()``, ``.tolist()`` and ``.numpy()``, ``np.asarray`` /
``np.array`` (of a tensor: a copy to the host), and the waits
``torch.cuda.synchronize`` and ``<stream or event>.synchronize()``.  Each
makes the host wait for the card.  Sanctioned reads carry the unified
marker with their reason; together they are the list of the port's host
reads on hot paths (PERF.md §3).  Pure-numpy arithmetic on host data
(``np.arange``, ``np.zeros``) is no transfer and is not flagged.
Registry entries may scope the rule to named functions.

Callees resolve through the file's value-flow, so ``g = np.asarray;
g(t)`` and ``from numpy import asarray as pull`` fire at the call line."""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis import hotpaths
from raft_tpu_torch.analysis.engine import call_name, rule

#: tensor methods that read the device
_READ_METHODS = ("item", "cpu", "tolist", "numpy")

#: canonical paths the value-flow resolves laundered callees to
_HOST_TRANSFER_PATHS = frozenset({
    "numpy.asarray", "numpy.array", "torch.cuda.synchronize",
})

#: the sanctioned-transfer marker for staging hot paths
_STAGING_MARKER = "tier-staging(hot-path-host-transfer)"


def _transfer_name(node, flow):
    """The banned surface this call is, or None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    cname = call_name(node)
    if isinstance(f, ast.Attribute):
        if cname in _READ_METHODS and not node.args:
            return f".{cname}()"
        if cname == "synchronize":
            return ".synchronize()"
        if (cname in ("asarray", "array") and isinstance(f.value, ast.Name)
                and f.value.id in ("np", "numpy")):
            return f"np.{cname}"
    path = flow.resolve_call(node)
    if path in _HOST_TRANSFER_PATHS:
        tail = path.rsplit(".", 1)[-1]
        return path if cname == tail else (
            f"{path} (laundered as `{cname}`)")
    return None


def _staging_call(node) -> bool:
    """``.to(..., non_blocking=True)`` / ``copy_(..., non_blocking=True)``:
    an asynchronous host↔device copy."""
    return (isinstance(node, ast.Call)
            and call_name(node) in ("to", "copy_")
            and any(kw.arg == "non_blocking"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in node.keywords))


def function_spans(tree, names):
    """(start, end) line spans of the named function defs (methods
    included) — the bodies a function-scoped registry entry covers."""
    spans = []
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in names):
            spans.append((node.lineno, node.end_lineno or node.lineno))
    return spans


@rule("hot-path-host-transfer",
      scope=lambda p: hotpaths.match(p) is not None,
      legacy_markers=("host-ok",),
      doc="host reads and waits (incl. laundered aliases) inside a "
          "declared hot path (hotpaths.HOT_PATHS)")
def check_host_transfers(ctx):
    hits = hotpaths.match(ctx.posix)
    module_wide = any(not hp.functions for hp in hits)
    spans = [] if module_wide else function_spans(
        ctx.tree, {f for hp in hits for f in hp.functions})
    staging = any(hp.staging for hp in hits)

    def in_scope(lineno):
        return module_wide or any(a <= lineno <= b for a, b in spans)

    def staging_marked(lineno):
        return staging and any(
            _STAGING_MARKER in ln
            for ln in ctx.lines[max(0, lineno - 2):lineno])

    found = {}
    for node in ast.walk(ctx.tree):
        name = _transfer_name(node, ctx.flow)
        if name is None and staging and _staging_call(node):
            name = f"{call_name(node)}(non_blocking=True) staging copy"
        if name is None or not in_scope(node.lineno):
            continue
        if (ctx.exempt("hot-path-host-transfer", node.lineno)
                or staging_marked(node.lineno)):
            continue
        found.setdefault((node.lineno, name), name)
    where = "this declared hot path" if not module_wide else ctx.posix
    return [(lineno,
             f"{name} in {where} — hot paths stay on the device (no host "
             "reads or waits); mark a sanctioned read "
             "exempt(hot-path-host-transfer) with why it is needed")
            for (lineno, _), name in sorted(found.items())]
