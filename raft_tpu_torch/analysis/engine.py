"""Level 1 — the AST rule engine (port of ``raft_tpu/analysis/engine.py``;
stdlib-only, like the reference's, so the gate costs no torch import).

A rule is (id, severity, scope predicate, check function, optional legacy
markers).  Rules register themselves via :func:`rule` at import of
:mod:`raft_tpu_torch.analysis.rules`; the engine parses each file once and
hands every in-scope rule the same :class:`FileContext`.

Exemptions — ONE unified inline syntax::

    torch.einsum(...)  # exempt(probe-scan-closure): the legacy baseline

``# exempt(<rule-id>[, <rule-id>...]): <rationale>`` on the flagged line or
the line above sanctions a finding of the named rule(s).  The rationale is
REQUIRED — a marker without one does not exempt anything and is itself
flagged (``exemption-hygiene``), so there are no blanket allowlists.  The
pre-existing spellings remain parsed for back-compat and map onto rule ids:

    ========================  =========================
    legacy marker             rule id
    ========================  =========================
    ``adc-exempt``            ``probe-scan-closure``
    ``serve-exempt``          ``serve-dispatch``
    ``host-ok``               ``hot-path-host-transfer``
    ``noqa``                  every rule
    ========================  =========================

The default roots are the port's package (``raft_tpu_torch/``);
``python -m raft_tpu_torch.analysis --ast`` runs this level alone.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: unified marker: ``exempt(rule-a, rule-b): rationale`` inside a comment
_EXEMPT_RE = re.compile(r"exempt\(\s*([a-z0-9_\-,\s]+?)\s*\)\s*:?\s*(.*)")

#: legacy spellings → the rule id each one sanctions (back-compat)
LEGACY_MARKERS = {
    "adc-exempt": "probe-scan-closure",
    "serve-exempt": "serve-dispatch",
    "host-ok": "hot-path-host-transfer",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    lineno: int
    message: str
    severity: str = "error"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered contract check.

    ``scope`` is a predicate over the file's posix path string — scoping is
    path-shaped (package dirs, module names), as the reference's rules are
    keyed, and works on quarantine tmp-paths too.
    """

    id: str
    severity: str
    doc: str
    scope: Callable[[str], bool]
    check: Callable[["FileContext"], List[Tuple[int, str]]]
    legacy_markers: Tuple[str, ...] = ()


_RULES: Dict[str, Rule] = {}


def rule(id: str, *, scope: Callable[[str], bool], severity: str = "error",
         legacy_markers: Tuple[str, ...] = (), doc: str = ""):
    """Decorator: register ``fn(ctx) -> [(lineno, message)]`` as a rule."""

    def deco(fn):
        _RULES[id] = Rule(id, severity, doc or (fn.__doc__ or "").strip(),
                          scope, fn, legacy_markers)
        return fn

    return deco


def iter_rules() -> List[Rule]:
    _ensure_rules_loaded()
    return [r for _, r in sorted(_RULES.items())]


def get_rule(rule_id: str) -> Optional[Rule]:
    _ensure_rules_loaded()
    return _RULES.get(rule_id)


def _ensure_rules_loaded():
    # rules modules self-register on import; idempotent
    import raft_tpu_torch.analysis.rules  # noqa: F401


# ---------------------------------------------------------------------------
# per-file context


def call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def module_level_names(tree: ast.Module) -> set:
    """Names bound at module level (imports, defs, assignments) — the
    shared "not a closed-over operand / not a local" baseline several
    rules resolve against."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                names.add(node.target.id)
    return names


class FileContext:
    """One parsed file, shared by every rule that runs on it.

    ``ignore_exemptions`` makes :meth:`exempt` always answer False — the
    stale-exemption scan re-runs the rules in this mode to learn which
    findings each marker WOULD sanction (a marker sanctioning nothing is
    dead weight; see :func:`scan_stale_exemptions`)."""

    def __init__(self, posix: str, src: str, *,
                 ignore_exemptions: bool = False):
        self.posix = posix
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src)
        self.ignore_exemptions = ignore_exemptions
        self._module_names: Optional[set] = None
        self._flow = None

    @property
    def module_names(self) -> set:
        if self._module_names is None:
            self._module_names = module_level_names(self.tree)
        return self._module_names

    @property
    def flow(self):
        """The file's shared intra-procedural value-flow index
        (:class:`raft_tpu_torch.analysis.dataflow.ValueFlow`), built lazily
        once and reused by every dataflow-ported rule."""
        if self._flow is None:
            from raft_tpu_torch.analysis import dataflow

            self._flow = dataflow.ValueFlow(self.tree)
        return self._flow

    def _marker_lines(self, lineno: int) -> List[str]:
        # the flagged line and the line above carry markers (the
        # reference's contract)
        return self.lines[max(0, lineno - 2):lineno]

    def exempt(self, rule_id: str, lineno: int) -> bool:
        """True when *lineno* (or the line above) sanctions *rule_id* via
        the unified marker, a legacy spelling, or ``noqa``."""
        if self.ignore_exemptions:
            return False
        legacy = {m for m, rid in LEGACY_MARKERS.items() if rid == rule_id}
        r = _RULES.get(rule_id)
        if r is not None:
            legacy.update(r.legacy_markers)
        for ln in self._marker_lines(lineno):
            if "noqa" in ln:
                return True
            if any(m in ln for m in legacy):
                return True
            m = _EXEMPT_RE.search(ln)
            if m is not None:
                ids = {p.strip() for p in m.group(1).split(",")}
                if rule_id in ids and m.group(2).strip():
                    return True
        return False


# ---------------------------------------------------------------------------
# engine-level hygiene: a marker that cannot exempt anything is a finding


def _check_marker_hygiene(ctx: FileContext) -> List[Finding]:
    findings = []
    for i, ln in enumerate(ctx.lines, 1):
        hash_at = ln.find("#")
        if hash_at < 0:
            continue
        comment = ln[hash_at:]
        m = _EXEMPT_RE.search(comment)
        if m is None:
            continue
        if not m.group(2).strip():
            findings.append(Finding(
                "exemption-hygiene", i,
                "exempt(...) marker without a rationale — the unified "
                "exemption syntax is `# exempt(rule-id): why this use is "
                "sanctioned`; a bare marker exempts nothing "
                "(no blanket allowlists)"))
    return findings


# ---------------------------------------------------------------------------
# runners


def check_source(posix: str, src: str, *,
                 respect_exemptions: bool = True) -> List[Finding]:
    """Run every in-scope rule over one source blob (the quarantine-test
    entry point: no file needs to exist).  ``respect_exemptions=False``
    returns the RAW findings a marker-less file would produce — the
    stale-exemption scan's substrate."""
    _ensure_rules_loaded()
    try:
        ctx = FileContext(posix, src,
                          ignore_exemptions=not respect_exemptions)
    except SyntaxError as e:
        return [Finding("syntax", e.lineno or 0, f"syntax error: {e.msg}")]
    findings = _check_marker_hygiene(ctx)
    for r in iter_rules():
        if not r.scope(posix):
            continue
        findings.extend(Finding(r.id, lineno, msg, r.severity)
                        for lineno, msg in r.check(ctx))
    return sorted(findings, key=lambda f: (f.lineno, f.rule))


def check_file(path: pathlib.Path) -> List[Finding]:
    path = pathlib.Path(path)
    return check_source(path.as_posix(), path.read_text())


# ---------------------------------------------------------------------------
# stale-exemption scan: markers whose rule no longer fires are dead weight


@dataclasses.dataclass(frozen=True)
class StaleMarker:
    lineno: int
    rules: Tuple[str, ...]   # the marker's rule ids that no longer fire
    text: str                # the marker line, stripped


def _comment_tokens(src: str) -> List[Tuple[int, str]]:
    """(lineno, text) of the GENUINE comment tokens — a marker quoted
    inside a string literal (quarantine-test snippets, docstrings citing
    the syntax) is not a marker and must not be scanned."""
    import io
    import tokenize

    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError):
        pass  # partial files: whatever tokenized before the error stands
    return out


def scan_stale_source(posix: str, src: str) -> List[StaleMarker]:
    """Markers in one source blob that sanction NOTHING anymore: the rules
    are re-run with exemptions ignored, and a marker at line L is live only
    if a raw finding of one of its rules lands at L or L+1 (the two lines
    :meth:`FileContext.exempt` lets it cover).  Dead exemptions accumulate
    as the rules sharpen — each one is a line a future reader must
    re-justify, and a rationale pointing at code that moved on.  Legacy
    spellings are scanned through their rule-id mapping; bare ``noqa`` is
    NOT scanned (it also silences external linters).  The retrace
    certifier's cardinality marker (``retrace.EXEMPT_ID``) is scanned the
    same way, against its raw cardinality findings."""
    from raft_tpu_torch.analysis import retrace

    try:
        raw = check_source(posix, src, respect_exemptions=False)
    except RecursionError:  # pathological file: skip, never crash the scan
        return []
    fired: Dict[int, set] = {}
    for f in raw:
        fired.setdefault(f.lineno, set()).add(f.rule)
    for lineno in retrace.raw_cardinality_lines(posix, src):
        fired.setdefault(lineno, set()).add(retrace.EXEMPT_ID)
    known = ({r.id for r in iter_rules()} | set(LEGACY_MARKERS.values())
             | {retrace.EXEMPT_ID})
    lines = src.splitlines()
    stale: List[StaleMarker] = []
    for i, comment in _comment_tokens(src):
        ids: set = set()
        m = _EXEMPT_RE.search(comment)
        if m is not None and m.group(2).strip():
            ids.update(p.strip() for p in m.group(1).split(","))
        for legacy, rid in LEGACY_MARKERS.items():
            if legacy in comment:
                ids.add(rid)
        # a marker naming an UNKNOWN rule id is hygiene's problem (typo),
        # not staleness — scan only ids a rule actually owns
        ids &= known
        if not ids:
            continue
        covered = fired.get(i, set()) | fired.get(i + 1, set())
        dead = tuple(sorted(r for r in ids if r not in covered))
        if len(dead) == len(ids):
            # every rule the marker names is silent — the whole marker is
            # stale (a PARTIALLY live comma-list still earns its keep)
            text = lines[i - 1].strip() if i <= len(lines) else comment
            stale.append(StaleMarker(i, dead, text[:120]))
    return stale


def scan_stale_exemptions(roots: Optional[Sequence[str]] = None, *,
                          out=sys.stdout) -> int:
    """Report stale exemption markers under *roots* (default: the repo
    surface).  Returns the stale-marker count; prints one line each.
    A warning pass: the count is informational (the CLI exits 0)."""
    if roots is None:
        roots = [str(REPO_ROOT / r) for r in DEFAULT_ROOTS]
    n = 0
    for f in collect_files(roots):
        for sm in scan_stale_source(f.as_posix(), f.read_text()):
            print(f"{f}:{sm.lineno}: stale exemption "
                  f"({', '.join(sm.rules)}) — the rule no longer fires "
                  f"here: {sm.text}", file=out)
            n += 1
    print(f"stale-exemptions: {n} stale marker(s)", file=out)
    return n


DEFAULT_ROOTS = ("raft_tpu_torch",)

#: the checkout this engine ships in — the default roots anchor here, so
#: ``python -m raft_tpu_torch.analysis`` works from any cwd
REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def collect_files(roots: Sequence[str]) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for r in roots:
        p = pathlib.Path(r)
        if not p.exists() and not p.is_absolute() and (REPO_ROOT / p).exists():
            p = REPO_ROOT / p   # convenience fallback for explicit
            #                     relative paths given from a foreign cwd
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py" and p.exists():
            files.append(p)
    return files


def run(roots: Optional[Sequence[str]] = None, *,
        out=sys.stdout) -> int:
    """Check *roots* (files/dirs; defaults to the repo surface), print
    findings, return the number of error-severity findings.  The DEFAULT
    roots always anchor at the checkout (a generic name must not resolve
    against some other project in the caller's cwd); explicit *roots*
    resolve cwd-first as passed."""
    if roots is None:
        roots = [str(REPO_ROOT / r) for r in DEFAULT_ROOTS]
    files = collect_files(roots)
    bad = 0
    for f in files:
        for fd in check_file(f):
            print(f"{f}:{fd.lineno}: [{fd.rule}] {fd.message}", file=out)
            if fd.severity == "error":
                bad += 1
    if not bad:
        print(f"analysis: {len(files)} files clean "
              f"({len(iter_rules())} rules)", file=out)
    return bad
