"""``static-arg-hashability``: unhashable literals (lists, dicts, sets,
tensor or array constructors) passed in a STATIC argument position of an
``aot()``-keyed program at a call site (port of
``raft_tpu/analysis/rules/static_args.py``).  Static args key the
signature cache by ``hash()``: an unhashable one raises only at call time,
and a freshly built tensor would give every call a new signature (a
compile each call).  Per module, the rule resolves which names are
``aot`` programs and which positions they declare static — the
``F = aot(fn, static_argnums=_STATICS)`` and ``@aot(static_argnums=...)``
idioms — then checks every call of those names."""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.engine import rule

_ARRAY_CTORS = frozenset({"array", "asarray", "zeros", "ones", "full",
                          "arange", "linspace", "tensor", "as_tensor",
                          "empty", "rand", "randn"})


def _int_tuple(node, consts):
    if isinstance(node, ast.Name):
        node = consts.get(node.id)
        if node is None:
            return None
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            if not (isinstance(el, ast.Constant)
                    and isinstance(el.value, int)):
                return None
            out.append(el.value)
        return tuple(out)
    return None


def _wrapper_call(node):
    """The keywords of an ``aot(...)`` call, else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    fname = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else "")
    return node.keywords if fname == "aot" else None


def _unhashable(node) -> str:
    if isinstance(node, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(node, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(node, ast.Call):
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in _ARRAY_CTORS
                and isinstance(f.value, ast.Name)
                and f.value.id in ("np", "numpy", "torch")):
            return f"{f.value.id}.{f.attr}(...) tensor"
    return ""


@rule("static-arg-hashability",
      scope=lambda p: "raft_tpu_torch/" in p,
      doc="unhashable literals in static positions of aot() programs")
def check_static_args(ctx):
    consts = {}
    statics = {}
    for node in ctx.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not isinstance(t, ast.Name):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List, ast.Constant)):
            consts[t.id] = node.value
        kws = _wrapper_call(node.value)
        for kw in kws or ():
            if kw.arg == "static_argnums":
                nums = _int_tuple(kw.value, consts)
                if nums:
                    statics[t.id] = nums
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            for kw in _wrapper_call(dec) or ():
                if kw.arg == "static_argnums":
                    nums = _int_tuple(kw.value, consts)
                    if nums:
                        statics[node.name] = nums
    if not statics:
        return []
    findings = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, (ast.Name, ast.Attribute))):
            continue
        name = (node.func.id if isinstance(node.func, ast.Name)
                else node.func.attr)
        if name not in statics:
            continue
        for pos in statics[name]:
            if pos >= len(node.args):
                continue
            why = _unhashable(node.args[pos])
            if not why or ctx.exempt("static-arg-hashability",
                                     node.args[pos].lineno):
                continue
            findings.append((
                node.args[pos].lineno,
                f"{why} passed as static arg {pos} of `{name}` — static "
                "args key the signature cache by hash(): unhashables raise "
                "at call time and fresh tensors give every call a new "
                "signature; pass a tuple or scalar (or make the arg "
                "dynamic), or mark the line exempt(static-arg-hashability)"))
    return findings
