"""Intra-procedural value-flow for the AST rules (port of
``raft_tpu/analysis/dataflow.py``, stdlib-only as the reference's).

Single-pass SYNTACTIC matchers fire on ``np.asarray(x)``, but one hop of
laundering defeats them entirely::

    g = np.asarray            # local rebind
    g(x)                      # invisible to the matcher

    from numpy import asarray as aa   # aliased from-import
    aa(x)                     # ditto

    def _fetch():             # helper return
        return np.asarray
    _fetch()(x)               # ditto

This module gives every rule the same cheap intra-procedural value-flow:
each scope (module, function) maps names to their ORIGIN expressions —
built from assignment chains, tuple unpacking, imports (plain, dotted,
``from``-aliased) and single-return helper functions — and
:meth:`ValueFlow.resolve` walks an arbitrary expression back to a
CANONICAL dotted path ("numpy.asarray", "torch.distributed.all_reduce",
"torch.float64") when one exists.  The flow is deliberately modest:

* **intra-procedural, flow-insensitive** — the LAST binding of a name in
  a scope wins (a lint, not an abstract interpreter); conditional rebinds
  resolve to whichever assignment textually dominates;
* **single-file** — cross-module laundering (re-exporting ``np.asarray``
  from a sibling module) is out of scope, matching the engine's
  one-file-at-a-time contract;
* **bounded** — chains are followed at most :data:`_MAX_HOPS` deep, with
  a cycle guard, so a pathological file cannot hang the gate.

Canonicalization: ``import numpy as np`` binds ``np → numpy``;
``import torch.distributed as dist`` binds ``dist → torch.distributed``;
``from torch.distributed import all_reduce as ar`` binds ``ar →
torch.distributed.all_reduce``; plain ``import torch.distributed`` binds
the root ``torch → torch`` (attribute walks recover
``torch.distributed.all_reduce``).
Python scoping is respected where it matters: class-body bindings do NOT
leak into method scopes (a method's parent scope skips the class), and
nested functions chain to their enclosing function.

Used by the ``hot-path-host-transfer`` / ``collective-discipline`` /
``dtype-drift`` / ``kernel-discipline`` / ``serve-dispatch`` /
``trace-impurity`` rules, and by ``analysis/retrace.py`` (the
parameter taint that tracks query-derived names, and the constant
resolution of ``static_argnums``).  Stdlib-only.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

#: resolution follows at most this many name→origin hops (cycle-proof)
_MAX_HOPS = 8


class Scope:
    """One lexical scope's name bindings.

    ``binds`` maps a name to its origin: ``("mod", dotted)`` for imports,
    ``("expr", node)`` for assignments, ``("fn", node)`` for function
    defs, ``("param", name)`` for function parameters.  ``is_class``
    scopes exist only so methods can SKIP them when chaining to their
    parent (Python's class-body-not-enclosing rule)."""

    __slots__ = ("node", "parent", "binds", "is_class")

    def __init__(self, node, parent: Optional["Scope"], is_class: bool):
        self.node = node
        self.parent = parent
        self.binds: Dict[str, Tuple[str, object]] = {}
        self.is_class = is_class

    def lookup(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.binds:
                return s.binds[name]
            s = s.parent
        return None


def _single_return(fn: ast.AST) -> Optional[ast.AST]:
    """The returned expression of a trivial helper — a body of (optional
    docstring +) exactly one ``return <expr>`` — else None."""
    body = list(getattr(fn, "body", ()))
    if body and isinstance(body[0], ast.Expr) and isinstance(
            body[0].value, ast.Constant) and isinstance(
            body[0].value.value, str):
        body = body[1:]
    if len(body) == 1 and isinstance(body[0], ast.Return) \
            and body[0].value is not None:
        return body[0].value
    return None


class ValueFlow:
    """Per-file value-flow index: build once, share across rules (the
    :class:`~raft_tpu_torch.analysis.engine.FileContext` caches one)."""

    def __init__(self, tree: ast.Module):
        self._scope_of: Dict[int, Scope] = {}
        self.module_scope = Scope(tree, None, False)
        self._build(tree, self.module_scope)

    # -- construction -------------------------------------------------------

    def _build(self, node: ast.AST, scope: Scope) -> None:
        """Record *node*'s scope, bind what it binds, recurse — new scopes
        open at function/class boundaries."""
        self._scope_of[id(node)] = scope
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    scope.binds[a.asname] = ("mod", a.name)
                else:
                    root = a.name.split(".")[0]
                    scope.binds[root] = ("mod", root)
        elif isinstance(node, ast.ImportFrom):
            if node.module and not node.level:
                for a in node.names:
                    if a.name != "*":
                        scope.binds[a.asname or a.name] = (
                            "mod", f"{node.module}.{a.name}")
        elif isinstance(node, ast.Assign):
            self._bind_targets(node.targets, node.value, scope)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self._bind_targets([node.target], node.value, scope)

        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope.binds.setdefault(node.name, ("fn", node))
            # method scopes skip class bodies (Python scoping)
            parent = scope
            while parent is not None and parent.is_class:
                parent = parent.parent
            inner = Scope(node, parent, False)
            args = node.args
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)
                      + [x for x in (args.vararg, args.kwarg) if x]):
                inner.binds[a.arg] = ("param", a.arg)
            # decorators/defaults evaluate in the ENCLOSING scope
            for d in node.decorator_list:
                self._build(d, scope)
            for d in list(args.defaults) + [x for x in args.kw_defaults
                                            if x is not None]:
                self._build(d, scope)
            for child in node.body:
                self._build(child, inner)
            return
        if isinstance(node, ast.ClassDef):
            scope.binds.setdefault(node.name, ("fn", node))
            inner = Scope(node, scope, True)
            for d in node.decorator_list + node.bases:
                self._build(d, scope)
            for child in node.body:
                self._build(child, inner)
            return
        if isinstance(node, ast.Lambda):
            inner = Scope(node, scope, False)
            for a in node.args.args:
                inner.binds[a.arg] = ("param", a.arg)
            self._build(node.body, inner)
            return
        for child in ast.iter_child_nodes(node):
            self._build(child, scope)

    def _bind_targets(self, targets: List[ast.AST], value: ast.AST,
                      scope: Scope) -> None:
        for t in targets:
            if isinstance(t, ast.Name):
                scope.binds[t.id] = ("expr", value)
            elif isinstance(t, (ast.Tuple, ast.List)) and isinstance(
                    value, (ast.Tuple, ast.List)) \
                    and len(t.elts) == len(value.elts):
                # elementwise tuple unpacking: a, b = np.asarray, np.array
                for te, ve in zip(t.elts, value.elts):
                    if isinstance(te, ast.Name):
                        scope.binds[te.id] = ("expr", ve)

    # -- resolution ---------------------------------------------------------

    def scope_of(self, node: ast.AST) -> Scope:
        return self._scope_of.get(id(node), self.module_scope)

    def resolve(self, node: ast.AST,
                trace: Optional[List[int]] = None) -> Optional[str]:
        """Canonical dotted path for an expression, following assignment
        chains / imports / helper returns; None when the expression does
        not root at an importable symbol (locals, params, literals).
        *trace*, when given, collects the linenos of the intermediate
        HOPS followed (the rebind/return expressions) — rules use it to
        honor sanction markers placed at the laundering hop itself (e.g.
        an exempt-marked conditional rebind to ``torch.float64``)."""
        return self._resolve(node, self.scope_of(node), _MAX_HOPS, set(),
                             trace)

    def _resolve(self, node, scope: Scope, hops: int, seen: Set[int],
                 trace: Optional[List[int]] = None) -> Optional[str]:
        if hops <= 0 or id(node) in seen:
            return None
        seen = seen | {id(node)}
        if isinstance(node, ast.Name):
            bound = scope.lookup(node.id)
            if bound is None:
                return None
            kind, val = bound
            if kind == "mod":
                return val  # type: ignore[return-value]
            if kind == "expr":
                if trace is not None and hasattr(val, "lineno"):
                    trace.append(val.lineno)
                return self._resolve(val, self.scope_of(val), hops - 1,
                                     seen, trace)
            return None  # params and fn-objects are not dotted paths
        if isinstance(node, ast.Attribute):
            base = self._resolve(node.value, scope, hops - 1, seen, trace)
            return f"{base}.{node.attr}" if base else None
        if isinstance(node, ast.Call):
            # helper returns: `_fetch()` where _fetch's body is a single
            # `return <expr>` resolves to that expression's path
            fn = self._callee_def(node.func, scope, hops - 1)
            if fn is not None:
                ret = _single_return(fn)
                if ret is not None:
                    if trace is not None:
                        trace.append(ret.lineno)
                    return self._resolve(ret, self.scope_of(ret),
                                         hops - 1, seen, trace)
        return None

    def _callee_def(self, func, scope: Scope, hops: int):
        """The FunctionDef a callee expression names, if it is a local
        helper (possibly through an assignment chain)."""
        if hops <= 0:
            return None
        if isinstance(func, ast.Name):
            bound = scope.lookup(func.id)
            if bound is None:
                return None
            kind, val = bound
            if kind == "fn" and isinstance(val, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef)):
                return val
            if kind == "expr" and isinstance(val, ast.Name):
                return self._callee_def(val, self.scope_of(val), hops - 1)
        return None

    def resolve_call(self, node: ast.Call) -> Optional[str]:
        """Canonical dotted path of a call's CALLEE (the laundering-proof
        form of "what function is this line invoking")."""
        return self._resolve(node.func, self.scope_of(node), _MAX_HOPS,
                             set())

    # -- parameter taint (the retrace certifier's query tracking) -----------

    def param_roots(self, node: ast.AST) -> Set[str]:
        """Names of enclosing-function PARAMETERS the expression derives
        from, following assignment chains: in ``q = torch.as_tensor(qb)``,
        ``param_roots(<q use>)`` yields ``{"qb"}``."""
        out: Set[str] = set()
        self._taint(node, self.scope_of(node), _MAX_HOPS, set(), out)
        return out

    def _taint(self, node, scope: Scope, hops: int, seen: Set[int],
               out: Set[str]) -> None:
        if hops <= 0 or id(node) in seen:
            return
        seen.add(id(node))
        for n in ast.walk(node):
            if not isinstance(n, ast.Name):
                continue
            bound = scope.lookup(n.id)
            if bound is None:
                continue
            kind, val = bound
            if kind == "param":
                out.add(n.id)
            elif kind == "expr" and isinstance(val, ast.AST):
                self._taint(val, self.scope_of(val), hops - 1, seen, out)

    def const_value(self, node: ast.AST):
        """Evaluate an expression to a hashable constant (int, str, tuple
        of those) through module-level name chains, or None — the
        static_argnums-resolution helper the certifier shares."""
        return self._const(node, self.scope_of(node), _MAX_HOPS)

    def _const(self, node, scope: Scope, hops: int):
        if hops <= 0:
            return None
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, (ast.Tuple, ast.List)):
            out = []
            for el in node.elts:
                v = self._const(el, scope, hops - 1)
                if v is None and not (isinstance(el, ast.Constant)
                                      and el.value is None):
                    return None
                out.append(v)
            return tuple(out)
        if isinstance(node, ast.Name):
            bound = scope.lookup(node.id)
            if bound is not None and bound[0] == "expr":
                val = bound[1]
                return self._const(val, self.scope_of(val), hops - 1)
        return None
