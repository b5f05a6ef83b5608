"""Static retrace-closure certifier: prove zero-compile serving from source
(port of ``raft_tpu/analysis/retrace.py``).

The run-time contract — ``aot_compile_counters["compiles"]`` flat over
traffic after ``ServeEngine.warmup()`` — catches a first call per request
only when a test or the smoke drives the leaking signature.  This module
proves the closure from the AST of the serving layer, stdlib only (it
parses source and runs nothing), with the reference's certificate
families and obligation names:

1. **Warm/dispatch congruence** (``serve.warm_dispatch.<Class>``) — every
   class of :data:`SERVE_MODULES` with a ``warm`` or a ``dispatch`` must
   warm what it dispatches.  Methods resolve through the module's class
   bases (``_Backend.warm`` serves every single-device backend; a base
   that lacks one of the pair is certified at each subclass instead).
   A pair is congruent when
   - ``warm`` runs the class's own ``dispatch`` on a zero block of
     ``(bucket, self.dim)`` (congruent by construction: the zero block is
     the reference's ``ShapeDtypeStruct`` / ``_q_spec`` query leaf);
   - both delegate to the same base's ``warm`` / ``dispatch``
     (``self.searcher``: certified at its own class);
   - ``warm`` fans out over every lane of one collection, or over
     ``range(...)`` lanes of one call (``self._run(lane, block)``), and
     ``dispatch`` runs one lane of it (the reference's fan-out form,
     :func:`_fanout_delegation`);
   - or their terminal calls match once the query leaf collapses to
     ``QUERY`` (on the warm side a zero block or a ``TensorSpec`` of
     ``(bucket, self.dim)``; on the dispatch side every name derived from
     a parameter), ``.compiled`` is stripped and a warm-side
     ``torch.zeros_like(x)`` reads as ``x`` (it has ``x``'s signature by
     construction: the tiered searcher's scratch probe counter).
2. **Bucket closure** (``serve.bucket_closure.*``), **scheduler closure**
   (``serve.scheduler_closure.*``), **tuner closure**
   (``serve.tuner_closure.*``) and **mutate closure**
   (``serve.mutate_closure.*``) — the engine's planner, the chooser, the
   autotuner and the mutable index stay on the warmed ladder.  Where the
   port reaches a call through one helper (``warmup`` → ``_warm`` →
   ``backend.warm``; ``_search_locked`` → ``self._dispatch`` →
   ``be.dispatch``; ``upsert`` → ``_apply_upsert`` → ``_rewarm_locked``;
   ``MutableSearcher.dispatch`` → ``MutableIndex._snapshot``, which takes
   the write lock), the obligation follows that one hop.
3. **Static-arg cardinality** (``retrace.static_cardinality``) — every
   call site of a module-level ``aot()`` program is scanned: a static
   argument fed a per-request number (``.shape``, ``.size``, ``len()``)
   keys one signature per value, unless a bounding function
   (:data:`BOUNDING_FNS`, the power-of-two ladder) or a ``min`` / ``max``
   against a bounded cap wraps it.  The exemption marker is
   ``# exempt(retrace-unbounded-static): why``, as in the reference; the
   stale-exemption scan (``engine.scan_stale_source``) knows it.

Every reference obligation keeps its name and has its counterpart here;
none is dropped.  One rationale changed: the reference holds the write
lock in ``MutableSearcher.dispatch`` so a donated in-place delta append
cannot race a read; the port donates nothing (every write builds new
tensors), and the lock makes the snapshot one consistent state.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.analysis import dataflow
from raft_tpu_torch.analysis.engine import REPO_ROOT, collect_files

#: the serving layer whose closure is certified: the engine and its
#: backends, the chooser, the tuner, and the searchers the backends
#: delegate to (sharded, tiered, mutable)
SERVE_MODULES = ("raft_tpu_torch/serve/engine.py",
                 "raft_tpu_torch/serve/schedule.py",
                 "raft_tpu_torch/serve/autotune.py",
                 "raft_tpu_torch/neighbors/ann_mnmg.py",
                 "raft_tpu_torch/neighbors/tiering.py",
                 "raft_tpu_torch/neighbors/mutable.py")

_ENGINE = "raft_tpu_torch/serve/engine.py"
_SCHEDULE = "raft_tpu_torch/serve/schedule.py"
_AUTOTUNE = "raft_tpu_torch/serve/autotune.py"
_MUTABLE = "raft_tpu_torch/neighbors/mutable.py"
_COMMON = "raft_tpu_torch/neighbors/_common.py"

#: functions that map an unbounded value onto a finite signature ladder
BOUNDING_FNS = frozenset({"bucket_dim", "_bucket_dim"})

#: the cardinality scan's exemption marker
EXEMPT_ID = "retrace-unbounded-static"

#: attribute surfaces that extract per-request-varying numbers
_UNBOUNDED_ATTRS = frozenset({"shape", "size", "ndim", "nbytes"})

#: calls that build a zero block (the port's warm-side query leaf)
_ZERO_BLOCKS = ("zeros",)
#: warm-side spec makers read as the operand whose signature they copy
_LIKE_SPECS = ("zeros_like",)


@dataclasses.dataclass
class ObligationReport:
    name: str
    status: str            # "ok" | "fail"
    findings: List[str]
    detail: str = ""


def parse_modules(rels: Sequence[str]) -> Dict[str, ast.Module]:
    """The checkout's sources at *rels* (repo-relative), parsed."""
    out: Dict[str, ast.Module] = {}
    for rel in rels:
        p = REPO_ROOT / rel
        if p.is_file():
            out[rel] = ast.parse(p.read_text())
    return out


# ---------------------------------------------------------------------------
# helpers


def _method(cls: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _function(tree: ast.Module, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _class_method(tree: ast.Module, cls: str, name: str
                  ) -> Optional[ast.FunctionDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return _method(node, name)
    return None


def _classes(tree: ast.Module) -> Dict[str, ast.ClassDef]:
    return {n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}


def _resolve(classes: Dict[str, ast.ClassDef], cls: ast.ClassDef,
             name: str, depth: int = 8) -> Optional[ast.FunctionDef]:
    """*cls*'s method *name*, through its bases defined in the module."""
    fn = _method(cls, name)
    if fn is not None or depth <= 0:
        return fn
    for b in cls.bases:
        if isinstance(b, ast.Name) and b.id in classes:
            fn = _resolve(classes, classes[b.id], name, depth - 1)
            if fn is not None:
                return fn
    return None


def _callee(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _terminal_call(fn: ast.FunctionDef) -> Optional[ast.Call]:
    """The method's LAST top-level call statement — ``return f(...)`` or a
    bare ``f(...)`` expression (a warm runs for effect)."""
    for node in reversed(fn.body):
        if isinstance(node, ast.Return) and isinstance(node.value,
                                                       ast.Call):
            return node.value
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            return node.value
    return None


def _params(fn: ast.FunctionDef) -> List[str]:
    return [a.arg for a in fn.args.args if a.arg != "self"]


def _is_bucket(node, buckets: frozenset) -> bool:
    """*node* is a warm's bucket parameter, or ``int(bucket)``."""
    if isinstance(node, ast.Call) and _callee(node) == "int" \
            and len(node.args) == 1:
        node = node.args[0]
    return isinstance(node, ast.Name) and node.id in buckets


def _is_query_block(node, buckets: frozenset) -> bool:
    """A zero block or a ``TensorSpec`` of ``(bucket, self.dim)``: the
    warm side's query leaf."""
    if not isinstance(node, ast.Call) or not node.args:
        return False
    name = _callee(node)
    if name not in _ZERO_BLOCKS and name != "TensorSpec":
        return False
    shape = node.args[0]
    return (isinstance(shape, (ast.Tuple, ast.List)) and len(shape.elts) == 2
            and _is_bucket(shape.elts[0], buckets)
            and isinstance(shape.elts[1], ast.Attribute)
            and shape.elts[1].attr == "dim")


def _warm_query_names(warm: ast.FunctionDef, buckets: frozenset
                      ) -> frozenset:
    """Names a warm binds to its query block (``block = torch.zeros(
    (bucket, self.dim), ...)``)."""
    out = set()
    for node in ast.walk(warm):
        if isinstance(node, ast.Assign) \
                and _is_query_block(node.value, buckets):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
    return frozenset(out)


def _normalize(node, query_names: frozenset,
               buckets: Optional[frozenset] = None) -> str:
    """Structural skeleton of a call/expression with the query leaf
    collapsed to QUERY, ``.compiled`` stripped and (warm side, *buckets*
    given) ``zeros_like(x)`` read as ``x``."""
    def rec(n):
        return _normalize(n, query_names, buckets)

    if isinstance(node, ast.Call):
        if buckets is not None and _is_query_block(node, buckets):
            return "QUERY"
        if buckets is not None and _callee(node) in _LIKE_SPECS \
                and len(node.args) == 1:
            return rec(node.args[0])
        callee = rec(node.func)
        if callee.endswith(".compiled"):
            callee = callee[:-len(".compiled")]
        args = [rec(a) for a in node.args]
        kws = [f"{kw.arg}={rec(kw.value)}" for kw in node.keywords]
        return f"{callee}({', '.join(args + kws)})"
    if isinstance(node, ast.Starred):
        return f"*{rec(node.value)}"
    if isinstance(node, ast.Attribute):
        return f"{rec(node.value)}.{node.attr}"
    if isinstance(node, ast.Name):
        return "QUERY" if node.id in query_names else node.id
    if isinstance(node, ast.Constant):
        return repr(node.value)
    if isinstance(node, (ast.Tuple, ast.List)):
        return f"({', '.join(rec(e) for e in node.elts)})"
    return ast.dump(node)


def _query_names(fn: ast.FunctionDef, flow: dataflow.ValueFlow
                 ) -> frozenset:
    """The method's parameters plus every local name value-flow-derived
    from them — the names that ARE the query on the dispatch side."""
    params = set(_params(fn))
    derived = set(params)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            roots = flow.param_roots(node.value)
            if roots & params:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        derived.add(t.id)
    return frozenset(derived)


def _delegation(call: ast.Call) -> Optional[Tuple[str, str]]:
    """(base skeleton, method) when the call is ``<base>.<method>(...)``."""
    if isinstance(call.func, ast.Attribute):
        return (_normalize(call.func.value, frozenset()), call.func.attr)
    return None


def _self_dispatch(warm: ast.FunctionDef) -> bool:
    """``warm`` runs the class's own ``dispatch`` on its query block."""
    buckets = frozenset(_params(warm))
    qnames = _warm_query_names(warm, buckets)
    call = _terminal_call(warm)
    if call is None or not isinstance(call.func, ast.Attribute) \
            or call.func.attr != "dispatch" \
            or not isinstance(call.func.value, ast.Name) \
            or call.func.value.id != "self" or len(call.args) != 1 \
            or call.keywords:
        return False
    q = call.args[0]
    return _is_query_block(q, buckets) or (
        isinstance(q, ast.Name) and q.id in qnames)


def _fanout_delegation(warm: ast.FunctionDef, disp: ast.FunctionDef
                       ) -> Optional[str]:
    """The fan-out forms: ``warm`` loops a lane collection and warms every
    member while ``dispatch`` delegates to one member of it (the
    reference's replica form), or ``warm`` loops ``range(...)`` lanes and
    runs one call with the lane and its query block while ``dispatch``
    runs the same call with one lane (the port's lane wire,
    ``self._run(lane, block)``).  Returns what is fanned over, or None."""
    loop = None
    for node in reversed(warm.body):
        if isinstance(node, ast.For):
            loop = node
            break
    if loop is None or not isinstance(loop.target, ast.Name):
        return None
    lane = loop.target.id
    dc = _terminal_call(disp)
    if dc is None:
        return None
    coll = _normalize(loop.iter, frozenset())
    # (a) a collection of searchers, each warmed
    body_call = None
    for node in reversed(loop.body):
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            body_call = node.value
            break
    bdel = None if body_call is None else _delegation(body_call)
    if bdel is not None and bdel[1] == "warm" and bdel[0] == lane:
        ddel = _delegation(dc)
        base = dc.func.value if isinstance(dc.func, ast.Attribute) else None
        if ddel is not None and ddel[1] == "dispatch" \
                and isinstance(base, ast.Subscript) \
                and _normalize(base.value, frozenset()) == coll:
            return coll
        return None
    # (b) range(...) lanes of one call taking (lane, query block)
    if not (isinstance(loop.iter, ast.Call) and _callee(loop.iter)
            == "range"):
        return None
    buckets = frozenset(_params(warm))
    qnames = _warm_query_names(warm, buckets)
    dnames = frozenset(_params(disp))
    target = _normalize(dc.func, frozenset())
    for node in ast.walk(loop):
        if not (isinstance(node, ast.Call) and len(node.args) == 2
                and _normalize(node.func, frozenset()) == target):
            continue
        lane_arg, q_arg = node.args
        if not (isinstance(lane_arg, ast.Name) and lane_arg.id == lane):
            continue
        if not (_is_query_block(q_arg, buckets) or (
                isinstance(q_arg, ast.Name) and q_arg.id in qnames)):
            continue
        if len(dc.args) == 2 and isinstance(dc.args[1], ast.Name) \
                and dc.args[1].id in dnames and not dc.keywords:
            return f"{coll} via `{target}`"
    return None


# ---------------------------------------------------------------------------
# certificate 1: warm/dispatch congruence


def certify_warm_dispatch(files: Dict[str, ast.Module],
                          flows: Dict[str, dataflow.ValueFlow]
                          ) -> List[ObligationReport]:
    reports: List[ObligationReport] = []
    pairs = 0
    for posix, tree in files.items():
        flow = flows[posix]
        classes = _classes(tree)
        bases = {b.id for c in classes.values() for b in c.bases
                 if isinstance(b, ast.Name) and b.id in classes}
        for cls in classes.values():
            own = _method(cls, "warm") or _method(cls, "dispatch")
            warm = _resolve(classes, cls, "warm")
            disp = _resolve(classes, cls, "dispatch")
            if warm is None and disp is None:
                continue
            if own is None and not (warm and disp):
                continue       # inherits half a pair and adds nothing
            name = f"serve.warm_dispatch.{cls.name}"
            if warm is None or disp is None:
                if cls.name in bases:
                    continue   # a base: certified at its subclasses
                missing = "warm" if warm is None else "dispatch"
                reports.append(ObligationReport(
                    name, "fail",
                    [f"class defines {'dispatch' if warm is None else 'warm'}"
                     f" but no {missing}() — its signatures can never be "
                     "warmed (every dispatch is a potential first call)"]))
                continue
            pairs += 1
            if _self_dispatch(warm):
                reports.append(ObligationReport(
                    name, "ok", [],
                    "warm() runs its own dispatch() on a (bucket, dim) "
                    "zero block"))
                continue
            fanout = _fanout_delegation(warm, disp)
            if fanout is not None:
                reports.append(ObligationReport(
                    name, "ok", [],
                    f"fans warm() out across every lane of `{fanout}`; "
                    "dispatch() runs one lane of it"))
                continue
            wc, dc = _terminal_call(warm), _terminal_call(disp)
            if wc is None or dc is None:
                reports.append(ObligationReport(
                    name, "fail",
                    ["warm()/dispatch() terminal call not found — the "
                     "certifier cannot prove the pair congruent"]))
                continue
            wdel, ddel = _delegation(wc), _delegation(dc)
            if (wdel and ddel and wdel[0] == ddel[0]
                    and wdel[1] == "warm" and ddel[1] == "dispatch"):
                reports.append(ObligationReport(
                    name, "ok", [],
                    f"delegates both to `{wdel[0]}` (certified at its "
                    "class)"))
                continue
            buckets = frozenset(_params(warm))
            wn = _normalize(wc, _warm_query_names(warm, buckets), buckets)
            dn = _normalize(dc, _query_names(disp, flow))
            findings = []
            if wn != dn:
                findings.append(
                    f"warm() runs `{wn}` but dispatch() calls `{dn}` — "
                    "the steady-state signature space is NOT the warmed "
                    "space (a dispatch-only argument keys signatures "
                    "warmup never ran)")
            if "QUERY" not in wn:
                findings.append(
                    "warm() has no (bucket, dim) query block — it cannot "
                    "enumerate (bucket, dtype) signatures")
            reports.append(ObligationReport(
                name, "fail" if findings else "ok", findings,
                "" if findings else f"`{wn}`"))
    if pairs == 0:
        reports.append(ObligationReport(
            "serve.warm_dispatch", "fail",
            ["no warm/dispatch class pairs found in the serving layer — "
             "the certificate has nothing to prove (moved modules? update "
             "SERVE_MODULES)"]))
    return reports


def certify_backend_coverage(files: Dict[str, ast.Module]
                             ) -> List[ObligationReport]:
    """Every class ``_make_backend`` can return must be a class of the
    serving module — a new backend kind cannot ship outside the
    congruence certificate."""
    tree = files.get(_ENGINE)
    if tree is None:
        return [ObligationReport("serve.backends_cover", "fail",
                                 [f"{_ENGINE} not found"])]
    classes = _classes(tree)
    maker = _function(tree, "_make_backend")
    if maker is None:
        return [ObligationReport(
            "serve.backends_cover", "fail",
            ["_make_backend not found — backend construction moved; "
             "update the certificate"])]
    findings = []
    returned = []
    for n in ast.walk(maker):
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Call) \
                and isinstance(n.value.func, ast.Name):
            returned.append(n.value.func.id)
            if n.value.func.id not in classes:
                findings.append(
                    f"_make_backend returns `{n.value.func.id}` which is "
                    "not a class in the serving module — the certifier "
                    "cannot see its warm/dispatch pair")
    if not returned:
        findings.append("_make_backend has no class-constructor returns")
    return [ObligationReport(
        "serve.backends_cover", "fail" if findings else "ok", findings,
        f"backends: {', '.join(returned)}")]


# ---------------------------------------------------------------------------
# certificate 2: bucket closure in ServeEngine


def _reaches(tree: ast.Module, fn: ast.FunctionDef, attr: str,
             arg_names: Optional[set] = None) -> bool:
    """*fn* calls ``.attr(...)`` (with one of *arg_names* among its names,
    when given), directly or through one helper it calls — a method of
    the module's classes (``self.m(...)``) or a module function — whose
    parameter at the passed position is named in the inner call."""
    def direct(f, names):
        for n in ast.walk(f):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == attr:
                if names is None or names & {
                        x.id for x in ast.walk(n) if isinstance(x, ast.Name)}:
                    return True
        return False

    if direct(fn, arg_names):
        return True
    helpers = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            helpers.setdefault(node.name, node)
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call):
            continue
        name = _callee(n)
        helper = helpers.get(name)
        if helper is None or helper is fn:
            continue
        if arg_names is None:
            if direct(helper, None):
                return True
            continue
        params = [a.arg for a in helper.args.args]
        if params and params[0] == "self":
            params = params[1:]
        passed = set()
        for pos, a in enumerate(n.args):
            if pos < len(params) and arg_names & {
                    x.id for x in ast.walk(a) if isinstance(x, ast.Name)}:
                passed.add(params[pos])
        if passed and direct(helper, passed):
            return True
    return False


def _engine_obligations(tree: ast.Module, cls: ast.ClassDef
                        ) -> List[ObligationReport]:
    out: List[ObligationReport] = []

    def obligation(name, ok, why_fail, detail=""):
        out.append(ObligationReport(
            f"serve.bucket_closure.{name}", "ok" if ok else "fail",
            [] if ok else [why_fail], detail))

    # warmup(): the default enumeration is the power-of-two ladder up to
    # max_batch, every bucket is warmed (backend.warm) and recorded
    warmup = _method(cls, "warmup")
    if warmup is None:
        obligation("warmup", False,
                   "ServeEngine.warmup() not found — the warmable set has "
                   "no definition to certify against")
    else:
        src_dump = ast.dump(warmup)
        ladder = ("LShift" in src_dump or "Mult" in src_dump) \
            and any(isinstance(n, ast.While) for n in ast.walk(warmup))
        obligation(
            "warmup.ladder", ladder,
            "warmup()'s default bucket enumeration no longer doubles up "
            "to max_batch — it must generate the SAME ladder _bucket_for "
            "picks from, or the planner emits unwarmed buckets")
        obligation(
            "warmup.prelowers", _reaches(tree, warmup, "warm"),
            "warmup() never reaches the backend's warm() — nothing is "
            "warmed")
        records = any(isinstance(n, ast.Attribute)
                      and n.attr == "_warmed" for n in ast.walk(warmup))
        obligation(
            "warmup.records", records,
            "warmup() does not record buckets in the warmed registry — "
            "_bucket_for cannot see what was warmed")

    # _bucket_for(): ladder pick clamped to max_batch, or a warmed member
    bucket_for = _method(cls, "_bucket_for")
    if bucket_for is None:
        obligation("bucket_for", False,
                   "ServeEngine._bucket_for() not found — bucket choice "
                   "moved; re-prove the closure and update the certifier")
    else:
        uses_ladder = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id in BOUNDING_FNS for n in ast.walk(bucket_for))
        obligation(
            "bucket_for.ladder", uses_ladder,
            "_bucket_for no longer derives its bucket from bucket_dim — "
            "the planner's buckets and warmup()'s ladder diverged")
        clamps = any(isinstance(n, ast.Attribute) and n.attr == "max_batch"
                     for n in ast.walk(bucket_for))
        obligation(
            "bucket_for.clamped", clamps,
            "_bucket_for does not clamp to max_batch — it can emit a "
            "bucket above every warmed signature")

    # _search_locked(): the dispatched block is allocated AT the chosen
    # bucket, and oversize requests take the public solo path
    search = _method(cls, "_search_locked") or _method(cls, "search")
    if search is None:
        obligation("dispatch_path", False,
                   "ServeEngine._search_locked()/search() not found")
        return out
    bucket_names = set()
    for n in ast.walk(search):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            f = n.value.func
            if isinstance(f, ast.Attribute) and f.attr == "_bucket_for":
                bucket_names.update(t.id for t in n.targets
                                    if isinstance(t, ast.Name))
    obligation(
        "dispatch.bucket_chosen", bool(bucket_names),
        "_search_locked never consults _bucket_for — dispatch shapes are "
        "no longer drawn from the certified ladder")
    block_names = set()
    for n in ast.walk(search):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            args = n.value.args
            if args and isinstance(args[0], (ast.Tuple, ast.List)) \
                    and args[0].elts \
                    and isinstance(args[0].elts[0], ast.Name) \
                    and args[0].elts[0].id in bucket_names:
                block_names.update(t.id for t in n.targets
                                   if isinstance(t, ast.Name))
    obligation(
        "dispatch.block_at_bucket", bool(block_names),
        "the assembled super-batch block is not allocated at the chosen "
        "bucket — dispatch sees raw ragged shapes (one signature per "
        "distinct total)")
    obligation(
        "dispatch.receives_block",
        bool(block_names) and _reaches(tree, search, "dispatch",
                                       block_names),
        "backend.dispatch() does not receive the bucket-shaped block — "
        "the padded assembly and the dispatch diverged")
    obligation(
        "dispatch.solo_fallback", _reaches(tree, search, "solo"),
        "no solo fallback call — oversize requests would dispatch through "
        "the coalesced path with an unwarmed bucket")
    return out


def certify_bucket_closure(files: Dict[str, ast.Module]
                           ) -> List[ObligationReport]:
    tree = files.get(_ENGINE)
    if tree is None:
        return [ObligationReport("serve.bucket_closure", "fail",
                                 [f"{_ENGINE} not found"])]
    cls = _classes(tree).get("ServeEngine")
    if cls is None:
        return [ObligationReport(
            "serve.bucket_closure", "fail",
            ["class ServeEngine not found — the engine moved; update the "
             "certificate"])]
    return _engine_obligations(tree, cls)


# ---------------------------------------------------------------------------
# certificate 2b: the continuous-batching chooser stays inside the warmed
# signature space


def certify_scheduler_closure(files: Dict[str, ast.Module]
                              ) -> List[ObligationReport]:
    """``choose_batches`` picks buckets ONLY through its ``bucket_for``
    parameter, the engine feeds it ``self._bucket_for`` over the warmed
    set, and the streaming ``submit()`` loop dispatches only through
    ``search()``, gated by the quantum rule."""
    out: List[ObligationReport] = []

    def obligation(name, ok, why_fail, detail=""):
        out.append(ObligationReport(
            f"serve.scheduler_closure.{name}", "ok" if ok else "fail",
            [] if ok else [why_fail], detail))

    sched = files.get(_SCHEDULE)
    if sched is None:
        return [ObligationReport(
            "serve.scheduler_closure", "fail",
            [f"{_SCHEDULE} not found — the chooser moved; update "
             "SERVE_MODULES and re-prove the closure"])]
    chooser = _function(sched, "choose_batches")
    if chooser is None:
        obligation("chooser", False,
                   "choose_batches not found in schedule.py — the chooser "
                   "renamed; update the certificate")
    else:
        obligation(
            "chooser.ladder_param",
            "bucket_for" in [a.arg for a in chooser.args.args],
            "choose_batches no longer takes the engine's bucket_for ladder "
            "— bucket choice left the certified space")
        bindings, via_param = 0, 0
        for n in ast.walk(chooser):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name) and t.id == "bucket":
                        bindings += 1
                        if isinstance(n.value, ast.Call) and isinstance(
                                n.value.func, ast.Name) \
                                and n.value.func.id == "bucket_for":
                            via_param += 1
        obligation(
            "chooser.bucket_via_ladder",
            bindings >= 1 and bindings == via_param,
            f"{bindings - via_param} of {bindings} bucket bindings in "
            "choose_batches do not come from the bucket_for ladder — the "
            "chooser can emit a signature warmup() never ran",
            f"{via_param} binding(s), all via bucket_for")

    engine = files.get(_ENGINE)
    if engine is None:
        obligation("engine", False, f"{_ENGINE} not found")
        return out
    fed = False
    for n in ast.walk(engine):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "choose_batches":
            for arg in n.args:
                if isinstance(arg, ast.Lambda) and any(
                        isinstance(x, ast.Attribute)
                        and x.attr == "_bucket_for" for x in ast.walk(arg)):
                    fed = True
    obligation(
        "engine.feeds_ladder", fed,
        "the engine's choose_batches call does not pass self._bucket_for "
        "— the chooser's buckets diverged from the certified ladder")
    loop = _function(engine, "_sched_loop")
    serve_pending = _function(engine, "_serve_pending")
    gated = loop is not None and any(
        isinstance(n, ast.Call) and _callee(n) == "should_dispatch"
        for n in ast.walk(loop))
    obligation(
        "stream.quantum_gated", gated,
        "_sched_loop no longer consults should_dispatch — the streaming "
        "path lost its quantum decision rule")
    through_search = serve_pending is not None and any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr == "search" for n in ast.walk(serve_pending))
    obligation(
        "stream.through_search", through_search,
        "the submit() queue no longer drains through search() — the "
        "streaming path escaped the certified dispatch pipeline")
    return out


# ---------------------------------------------------------------------------
# certificate 2c: the autotuner explores and promotes ONLY inside the
# warmed signature space

#: tuner stages that run after warm_candidates(): none may warm or key a
#: new program
_TUNER_HOT_FNS = ("explore", "_halve", "_measure_real", "_replay",
                  "_dispatch", "_recall_probe", "_live_ids")
_TUNER_COMPILE_NAMES = frozenset(
    {"warm", "warmup", "warm_candidates", "compiled", "compile", "aot",
     "mesh_aot", "_make_backend"})


def certify_tuner_closure(files: Dict[str, ast.Module]
                          ) -> List[ObligationReport]:
    """The candidate space derives from the engine's warmed signatures,
    every shadow-replay bucket binds through ``_bucket_for``, no post-warm
    tuner stage reaches a warm or a new program, promotion goes through
    ``refresh`` / ``apply_tuning`` (never a raw backend assignment), and
    ``apply_tuning`` checks a promoted cap against the warmed registry."""
    out: List[ObligationReport] = []

    def obligation(name, ok, why_fail, detail=""):
        out.append(ObligationReport(
            f"serve.tuner_closure.{name}", "ok" if ok else "fail",
            [] if ok else [why_fail], detail))

    tuner = files.get(_AUTOTUNE)
    if tuner is None:
        return [ObligationReport(
            "serve.tuner_closure", "fail",
            [f"{_AUTOTUNE} not found — the tuner moved; update "
             "SERVE_MODULES and re-prove the closure"])]
    cands = _function(tuner, "candidates")
    obligation(
        "candidates_from_warmed", cands is not None and any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "warmed_signatures" for n in ast.walk(cands)),
        "AutoTuner.candidates() no longer reads warmed_signatures() — the "
        "candidate space left the certified warmed ladder")
    bindings, via_ladder = 0, 0
    for fname in ("_replay", "_live_ids"):
        fn = _function(tuner, fname)
        if fn is None:
            continue
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name) and t.id == "bucket":
                        bindings += 1
                        if isinstance(n.value, ast.Call) and isinstance(
                                n.value.func, ast.Attribute) \
                                and n.value.func.attr == "_bucket_for":
                            via_ladder += 1
    obligation(
        "shadow_bucket_via_ladder",
        bindings >= 1 and bindings == via_ladder,
        f"{bindings - via_ladder} of {bindings} bucket bindings in the "
        "tuner's shadow replay do not come from the engine's _bucket_for "
        "ladder — a shadow dispatch can key an unwarmed signature",
        f"{via_ladder} binding(s), all via _bucket_for")
    offenders: List[str] = []
    for fname in _TUNER_HOT_FNS:
        fn = _function(tuner, fname)
        if fn is None:
            offenders.append(f"{fname}() not found — stage renamed; "
                             "update the certificate")
            continue
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and _callee(n) in \
                    _TUNER_COMPILE_NAMES:
                offenders.append(
                    f"{fname}() calls `{_callee(n)}` at line {n.lineno}")
    obligation(
        "explore_no_compile", not offenders,
        "a post-warm tuner stage can reach a warm or a new program — "
        "exploration is no longer zero-compile by construction: "
        + "; ".join(offenders),
        f"{len(_TUNER_HOT_FNS)} stage(s) clean")
    promote = _function(tuner, "promote")
    rollback = _function(tuner, "maybe_rollback")
    obligation(
        "promote_via_refresh", promote is not None and all(
            any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == attr for n in ast.walk(promote))
            for attr in ("refresh", "apply_tuning")),
        "AutoTuner.promote() no longer swaps through ServeEngine.refresh + "
        "apply_tuning — promotion escaped the certified atomic-swap "
        "surface")
    raw_swap = []
    for fn in (promote, rollback):
        if fn is None:
            continue
        for n in ast.walk(fn):
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = (n.targets if isinstance(n, ast.Assign)
                           else [n.target])
                raw_swap += [f"{fn.name}() line {t.lineno}" for t in targets
                             if isinstance(t, ast.Attribute)
                             and t.attr == "_backend"]
    obligation(
        "no_raw_backend_swap", rollback is not None and not raw_swap,
        "promotion/rollback assigns _backend directly (bypassing the "
        "refresh swap's warm-before-swap protocol): "
        + ("; ".join(raw_swap) or "maybe_rollback() not found"))
    engine = files.get(_ENGINE)
    apply_fn = None if engine is None else _function(engine, "apply_tuning")
    obligation(
        "engine_caps_in_ladder", apply_fn is not None and any(
            isinstance(n, ast.Attribute) and n.attr == "_warmed"
            for n in ast.walk(apply_fn)),
        "ServeEngine.apply_tuning no longer checks max_batch against the "
        "warmed registry — a promoted cap could leave the certified "
        "ladder")
    return out


# ---------------------------------------------------------------------------
# certificate 2d: the mutable index keeps reads zero-compile across writes

_MUTATE_MODULES = (_MUTABLE, _COMMON,
                   "raft_tpu_torch/neighbors/ivf_flat.py",
                   "raft_tpu_torch/neighbors/ivf_pq.py")


def certify_mutate_closure(files: Dict[str, ast.Module]
                           ) -> List[ObligationReport]:
    """The tombstone mask acts inside the families' probe scan, both
    families thread it, the bitmap grows only up the ``bucket_dim``
    ladder, a write that changes the served shapes rewarms every recorded
    signature before it returns, the dispatch snapshots under the write
    lock, compaction promotes only through ``ServeEngine.refresh``, and
    the engine routes ``MutableIndex`` to its backend."""
    out: List[ObligationReport] = []

    def obligation(name, ok, why_fail, detail=""):
        out.append(ObligationReport(
            f"serve.mutate_closure.{name}", "ok" if ok else "fail",
            [] if ok else [why_fail], detail))

    trees: Dict[str, ast.Module] = dict(files)
    for rel, tree in parse_modules([r for r in _MUTATE_MODULES
                                    if r not in trees]).items():
        trees[rel] = tree
    mut = trees.get(_MUTABLE)
    if mut is None:
        return [ObligationReport(
            "serve.mutate_closure", "fail",
            [f"{_MUTABLE} not found — the mutable index moved; update "
             "_MUTATE_MODULES and re-prove the closure"])]

    common = trees.get(_COMMON)
    scan = None if common is None else _function(common, "scan_probe_lists")
    has_param = scan is not None and any(
        a.arg == "tombstones" for a in scan.args.args + scan.args.kwonlyargs)
    applies = scan is not None and any(
        isinstance(n, ast.Call) and _callee(n) == "tombstone_hit"
        for n in ast.walk(scan))
    obligation(
        "mask_in_scan", has_param and applies,
        "scan_probe_lists no longer takes/applies a `tombstones` bitmap "
        "inside the scan — deletes would need per-write signatures (or "
        "post-hoc filtering that breaks top-k)")

    threaded = []
    for rel in ("raft_tpu_torch/neighbors/ivf_flat.py",
                "raft_tpu_torch/neighbors/ivf_pq.py"):
        tree = trees.get(rel)
        if tree is None or not any(
                isinstance(n, ast.Call) and _callee(n) == "scan_probe_lists"
                and any(kw.arg == "tombstones" for kw in n.keywords)
                for n in ast.walk(tree)):
            threaded.append(rel)
    obligation(
        "families_thread_mask", not threaded,
        "family searches no longer pass `tombstones=` to "
        "scan_probe_lists: " + ", ".join(threaded), "ivf_flat + ivf_pq")

    tw = _function(mut, "_tomb_words")
    via_ladder = tw is not None and any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
        and n.func.id in BOUNDING_FNS for n in ast.walk(tw))
    users = sum(1 for n in ast.walk(mut)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "_tomb_words")
    obligation(
        "tomb_buckets_via_ladder", via_ladder and users >= 2,
        "_tomb_words no longer routes tombstone-bitmap capacity through "
        "bucket_dim (or stopped being the one sizing door) — bitmap growth "
        "could key one serve signature per max-id value",
        f"{users} sizing site(s), all via bucket_dim")

    upsert = _class_method(mut, "MutableIndex", "upsert")
    obligation(
        "writes_rewarm_signatures",
        upsert is not None and _reaches(mut, upsert, "_rewarm_locked"),
        "MutableIndex.upsert no longer rewarms the recorded serve "
        "signatures on a shape change — the first read after a delta "
        "growth would make its first call on the request path")

    def holds_lock(fn):
        return fn is not None and any(
            isinstance(n, ast.With) and any(
                isinstance(item.context_expr, ast.Attribute)
                and item.context_expr.attr == "_lock" for item in n.items)
            for n in ast.walk(fn))

    dispatch = _class_method(mut, "MutableSearcher", "dispatch")
    locked = holds_lock(dispatch)
    if not locked and dispatch is not None:
        # one hop: a method of the module's classes the dispatch calls
        methods = [m for c in _classes(mut).values() for m in c.body
                   if isinstance(m, ast.FunctionDef)]
        called = {_callee(n) for n in ast.walk(dispatch)
                  if isinstance(n, ast.Call)}
        locked = any(m.name in called and holds_lock(m) for m in methods)
    obligation(
        "dispatch_snapshots_under_lock", locked,
        "MutableSearcher.dispatch no longer snapshots the core under the "
        "write lock (itself or one call away) — a read could see a "
        "half-applied write")

    compact = _class_method(mut, "MutableIndex", "compact")
    via_refresh = compact is not None and any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr == "refresh" for n in ast.walk(compact))
    raw = [f"line {t.lineno}" for n in ast.walk(mut)
           if isinstance(n, (ast.Assign, ast.AugAssign))
           for t in (n.targets if isinstance(n, ast.Assign) else [n.target])
           if isinstance(t, ast.Attribute) and t.attr == "_backend"]
    obligation(
        "compact_promotes_via_refresh", via_refresh and not raw,
        "MutableIndex.compact no longer promotes through "
        "ServeEngine.refresh (or assigns a backend directly: "
        + (", ".join(raw) or "-") + ") — the swap escaped the certified "
        "warm-before-swap surface")

    engine = files.get(_ENGINE)
    mk = None if engine is None else _function(engine, "_make_backend")
    obligation(
        "backend_registered", mk is not None and any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id == "_MutableBackend" for n in ast.walk(mk)),
        "_make_backend no longer returns _MutableBackend for MutableIndex "
        "— mutable serving would fall through to another backend")
    return out


# ---------------------------------------------------------------------------
# certificate 3: static-arg value cardinality at aot() call sites


def _aot_statics(tree: ast.Module, flow: dataflow.ValueFlow
                 ) -> Dict[str, Tuple[int, ...]]:
    """Module-level names bound to ``aot()`` / ``mesh_aot()`` /
    ``AotFunction`` wrappers → their static argnums (resolved through
    module constants)."""
    out: Dict[str, Tuple[int, ...]] = {}

    def wrapper_statics(call) -> Optional[Tuple[int, ...]]:
        if not isinstance(call, ast.Call):
            return None
        if _callee(call) not in ("aot", "mesh_aot", "AotFunction",
                                 "MeshAotFunction"):
            return None
        for kw in call.keywords:
            if kw.arg == "static_argnums":
                v = flow.const_value(kw.value)
                if isinstance(v, int):
                    return (v,)
                if isinstance(v, tuple) and all(
                        isinstance(x, int) for x in v):
                    return v
                return None
        if _callee(call) in ("AotFunction", "MeshAotFunction") \
                and len(call.args) >= 2:
            v = flow.const_value(call.args[1])
            if isinstance(v, tuple) and all(isinstance(x, int) for x in v):
                return v
        return ()

    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            nums = wrapper_statics(node.value)
            if nums:
                out[node.targets[0].id] = nums
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                nums = wrapper_statics(dec)
                if nums:
                    out[node.name] = nums
    return out


def _bounded(expr: ast.AST, flow: dataflow.ValueFlow, hops: int = 8,
             seen: Optional[frozenset] = None) -> bool:
    """True when the expression's VALUE cardinality is finite over a
    serving process's life: constants, caller-owned parameters passed
    verbatim, module symbols, and anything routed through a bounding
    ladder.  ``.shape`` / ``.size`` / ``len()`` extractions are
    per-request data unless a bounding call wraps them.  A name whose
    binding chain loops back to itself (``metric = DistanceType(metric)``,
    the coercion rebind) roots at the caller-owned parameter."""
    if hops <= 0:
        return False
    seen = seen or frozenset()

    def rec(e):
        return _bounded(e, flow, hops - 1, seen)

    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Attribute):
        return expr.attr not in _UNBOUNDED_ATTRS
    if isinstance(expr, ast.Subscript):
        return rec(expr.value)
    if isinstance(expr, ast.Name):
        if expr.id in seen:
            return True
        bound = flow.scope_of(expr).lookup(expr.id)
        if bound is None:
            return True
        kind, val = bound
        if kind in ("mod", "fn", "param"):
            return True
        return _bounded(val, flow, hops - 1, seen | {expr.id})
    if isinstance(expr, ast.Call):
        fname = _callee(expr)
        if fname in BOUNDING_FNS:
            return True
        if fname == "len":
            return False
        if fname in ("min", "max"):
            return any(rec(a) for a in expr.args)
        return all(rec(a) for a in expr.args)
    if isinstance(expr, ast.BinOp):
        return rec(expr.left) and rec(expr.right)
    if isinstance(expr, ast.UnaryOp):
        return rec(expr.operand)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(rec(e) for e in expr.elts)
    if isinstance(expr, ast.IfExp):
        return rec(expr.body) and rec(expr.orelse)
    return True


def scan_static_cardinality(posix: str, tree: ast.Module,
                            flow: dataflow.ValueFlow, lines: List[str],
                            respect_exemptions: bool = True
                            ) -> List[Tuple[int, str]]:
    """(line, finding) for each unbounded static argument at this file's
    keyed-program call sites.  The exemption marker (:data:`EXEMPT_ID`)
    on the argument's line or the line above sanctions it (not with
    ``respect_exemptions=False``: the stale-exemption scan's raw
    findings)."""
    statics = _aot_statics(tree, flow)
    if not statics:
        return []

    def exempt(lineno):
        return respect_exemptions and any(
            f"exempt({EXEMPT_ID})" in ln and ":" in ln.split(
                f"exempt({EXEMPT_ID})", 1)[1]
            for ln in lines[max(0, lineno - 2):lineno])

    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in statics):
            continue
        for pos in statics[node.func.id]:
            if pos >= len(node.args):
                continue
            arg = node.args[pos]
            if _bounded(arg, flow) or exempt(arg.lineno):
                continue
            findings.append((arg.lineno,
                f"{posix}:{arg.lineno}: static arg {pos} of "
                f"`{node.func.id}` has unbounded value cardinality "
                f"(`{ast.unparse(arg)[:80]}`) — a data-dependent static "
                "keys one signature per distinct value (a first call per "
                "request); route it through bucket_dim or a bounded cap, "
                f"or mark the line exempt({EXEMPT_ID}) with why"))
    return findings


def raw_cardinality_lines(posix: str, src: str) -> List[int]:
    """The lines of *src* holding an unbounded static argument, markers
    ignored (what the stale-exemption scan checks this marker against)."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    return [ln for ln, _ in scan_static_cardinality(
        posix, tree, dataflow.ValueFlow(tree), src.splitlines(),
        respect_exemptions=False)]


# ---------------------------------------------------------------------------
# the runner


def run(names: Optional[Sequence[str]] = None, *, out=None,
        roots: Optional[Sequence[str]] = None
        ) -> Tuple[List[ObligationReport], int]:
    """Run the certificates; *names* keeps obligations whose name holds
    one of them (the CLI's ``--programs``), *roots* replaces the
    cardinality scan's file set (default: ``raft_tpu_torch/``).  Prints
    one line per obligation and returns (reports, failures)."""
    import sys

    out = out or sys.stdout
    serve_files = parse_modules(SERVE_MODULES)
    serve_flows = {rel: dataflow.ValueFlow(t) for rel, t in
                   serve_files.items()}
    reports: List[ObligationReport] = []
    reports.extend(certify_warm_dispatch(serve_files, serve_flows))
    reports.extend(certify_backend_coverage(serve_files))
    reports.extend(certify_bucket_closure(serve_files))
    reports.extend(certify_scheduler_closure(serve_files))
    reports.extend(certify_tuner_closure(serve_files))
    reports.extend(certify_mutate_closure(serve_files))

    card: List[str] = []
    scan_roots = list(roots) if roots is not None else [
        str(REPO_ROOT / "raft_tpu_torch")]
    for f in collect_files(scan_roots):
        src = f.read_text()
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        card.extend(msg for _, msg in scan_static_cardinality(
            f.as_posix(), tree, dataflow.ValueFlow(tree), src.splitlines()))
    reports.append(ObligationReport(
        "retrace.static_cardinality", "fail" if card else "ok", card,
        f"{len(scan_roots)} root(s) scanned"))

    if names:
        reports = [r for r in reports if any(n in r.name for n in names)]
    failed = 0
    for r in reports:
        failed += r.status == "fail"
        print(f"  [{r.status:>7}] {r.name:44s} {r.detail}", file=out)
        for f in r.findings:
            print(f"           - {f}", file=out)
    ok = sum(r.status == "ok" for r in reports)
    print(f"retrace: {ok} obligation(s) certified, {failed} failed",
          file=out)
    return reports, failed
