"""The port's AST rule engine (``raft_tpu_torch/analysis``) against the JAX
package's (``raft_tpu/analysis``): the marker parser, marker hygiene, the
stale-marker scan and ``ValueFlow.resolve`` agree on the same sources for
the rules that name no jax (same rule id, same line); every port rule
fires bare, is exempted by its marker and not by a marker without a
rationale; the shipped tree is clean and every hot-path function name
resolves."""

import ast
import pathlib
import subprocess
import sys

import pytest

from raft_tpu.analysis import dataflow as jflow
from raft_tpu.analysis import engine as jengine
from raft_tpu_torch.analysis import dataflow as tflow
from raft_tpu_torch.analysis import engine as tengine
from raft_tpu_torch.analysis import hotpaths

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the rules both packages run with the same logic (they name no jax)
SHARED = ("exemption-hygiene", "error-discipline", "mutation-discipline",
          "telemetry-discipline", "style-whitespace", "style-ast",
          "style-unused-import")

SHARED_SOURCES = {
    "swallow": (
        "import os\n"
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:  # exempt(error-discipline): teardown\n"
        "        pass\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        pass\n"
        "    try:\n"
        "        g()\n"
        "    except:  # exempt(error-discipline)\n"
        "        return None\n"),
    "mutation": (
        "def poke(m, core):\n"
        "    m._mut_core = None\n"
        "    core.words_main[3] |= 1  # exempt(mutation-discipline): replay\n"
        "    core.tomb_main_bits = 0  # exempt(mutation-discipline)\n"
        "    core.delta_live[1] = True\n"),
    "telemetry": (
        "import time\n"
        "from time import perf_counter\n"
        "import collections\n"
        "from http.server import HTTPServer\n"
        "C = collections.Counter()\n"
        "def f():\n"
        "    t = time.perf_counter()\n"
        "    # exempt(telemetry-discipline): a sanctioned wall clock\n"
        "    u = time.monotonic()\n"
        "    return t, u, perf_counter, HTTPServer, C\n"),
    "style": (
        "import json\n"
        "import os, sys  # noqa\n"
        "x = f'plain'\n"
        "y = 1   \n"
        "z = '" + "a" * 110 + "'\n"
        "try:\n"
        "    pass\n"
        "except:\n"
        "    pass\n"),
    "legacy": (
        "import numpy as np\n"
        "def f(x):\n"
        "    # exempt(error-discipline, telemetry-discipline): both\n"
        "    try:\n"
        "        return np.asarray(x)  # host-ok\n"
        "    except BaseException:\n"
        "        return None  # exempt(style-ast):\n"),
}


def _pair(name, sub="serve/engine_like.py"):
    return f"raft_tpu/{sub}", f"raft_tpu_torch/{sub}", SHARED_SOURCES[name]


def _shared(findings):
    return sorted((f.rule, f.lineno) for f in findings if f.rule in SHARED)


@pytest.mark.parametrize("name", sorted(SHARED_SOURCES))
@pytest.mark.parametrize("sub", ["serve/engine_like.py",
                                 "neighbors/_build.py",
                                 "telemetry/registry.py", "linalg/x.py"])
def test_shared_rules_agree_with_reference(name, sub):
    jp, tp, src = _pair(name, sub)
    want = _shared(jengine.check_source(jp, src))
    got = _shared(tengine.check_source(tp, src))
    assert got == want


@pytest.mark.parametrize("name", sorted(SHARED_SOURCES))
def test_raw_findings_agree_with_reference(name):
    jp, tp, src = _pair(name)
    want = _shared(jengine.check_source(jp, src, respect_exemptions=False))
    got = _shared(tengine.check_source(tp, src, respect_exemptions=False))
    assert got == want


@pytest.mark.parametrize("name", sorted(SHARED_SOURCES))
def test_marker_parser_agrees_with_reference(name):
    jp, tp, src = _pair(name)
    jctx = jengine.FileContext(jp, src)
    tctx = tengine.FileContext(tp, src)
    jengine._ensure_rules_loaded()
    tengine._ensure_rules_loaded()
    for rid in SHARED[1:] + ("hot-path-host-transfer",
                             "probe-scan-closure", "serve-dispatch"):
        for line in range(1, len(src.splitlines()) + 2):
            assert tctx.exempt(rid, line) == jctx.exempt(rid, line), \
                (rid, line)
    assert tengine.LEGACY_MARKERS == jengine.LEGACY_MARKERS
    assert tengine._EXEMPT_RE.pattern == jengine._EXEMPT_RE.pattern


def test_stale_scan_agrees_with_reference():
    src = ("def f(m):\n"
           "    m.x = 1  # exempt(mutation-discipline): no longer fires\n"
           "    y = 0\n"
           "    m._mut_core = 2  # exempt(mutation-discipline): still fires\n"
           "    s = 'exempt(error-discipline): inside a string'\n")
    want = [(s.lineno, s.rules) for s in jengine.scan_stale_source(
        "raft_tpu/serve/x.py", src)]
    got = [(s.lineno, s.rules) for s in tengine.scan_stale_source(
        "raft_tpu_torch/serve/x.py", src)]
    assert got == want == [(2, ("mutation-discipline",))]


FLOW_SOURCE = """
import numpy as np
import torch
import torch.distributed as dist
from numpy import asarray as pull
from torch.distributed import all_reduce as ar
import os.path

g = np.asarray
h = g

def helper():
    return dist.broadcast

class K:
    np = None
    def m(self, x):
        a, b = np.array, torch.float64
        return pull(x), h(x), helper()(x), a(x), b, ar(x), os.path.join

def local(param):
    return param.item(), torch.cuda.synchronize()
"""


def _resolutions(mod):
    tree = ast.parse(FLOW_SOURCE)
    flow = mod.ValueFlow(tree)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            out.append((node.lineno, node.col_offset,
                        flow.resolve_call(node)))
        elif isinstance(node, (ast.Name, ast.Attribute)):
            out.append((node.lineno, node.col_offset, flow.resolve(node)))
    return sorted(out, key=lambda t: (t[0], t[1], str(t[2])))


def test_valueflow_resolve_agrees_with_reference():
    got, want = _resolutions(tflow), _resolutions(jflow)
    assert got == want
    paths = {p for _, _, p in got}
    assert {"numpy.asarray", "torch.distributed.broadcast",
            "torch.distributed.all_reduce", "torch.float64",
            "numpy.array", "torch.cuda.synchronize",
            "os.path.join"} <= paths


# ---------------------------------------------------------------------------
# each port rule: bare, marked, marked without a rationale

RULE_CASES = {
    "collective-discipline": (
        "raft_tpu_torch/serve/x.py",
        "import torch.distributed as dist\n"
        "def f(t):\n"
        "    {m}\n"
        "    dist.all_reduce(t)\n"),
    "hot-path-host-transfer": (
        "raft_tpu_torch/serve/x.py",
        "def f(t):\n"
        "    {m}\n"
        "    return t.item()\n"),
    "kernel-discipline": (
        "raft_tpu_torch/neighbors/x.py",
        "import ctypes\n"
        "def f(p):\n"
        "    {m}\n"
        "    return ctypes.CDLL(p)\n"),
    "probe-scan-closure": (
        "raft_tpu_torch/neighbors/x.py",
        "import torch\n"
        "def search(q, lut, phys):\n"
        "    def tile(rows):\n"
        "        {m}\n"
        "        return torch.gather(lut, 1, rows)\n"
        "    return scan_probe_lists(phys, tile)\n"),
    "serve-dispatch": (
        "raft_tpu_torch/serve/x.py",
        "import torch\n"
        "def f(fn):\n"
        "    {m}\n"
        "    return torch.compile(fn)\n"),
    "static-arg-hashability": (
        "raft_tpu_torch/neighbors/x.py",
        "from raft_tpu_torch.core.aot import aot\n"
        "F = aot(lambda x, k: x, static_argnums=(1,))\n"
        "def f(x):\n"
        "    {m}\n"
        "    return F(x, [1, 2])\n"),
    "dtype-drift": (
        "raft_tpu_torch/linalg/x.py",
        "import torch\n"
        "def f(x):\n"
        "    {m}\n"
        "    return x.to(torch.float64)\n"),
    "trace-impurity": (
        "raft_tpu_torch/neighbors/x.py",
        "import torch\n"
        "def _search_impl(q):\n"
        "    {m}\n"
        "    return q + torch.rand(q.shape)\n"),
    "raw-segment-sum": (
        "raft_tpu_torch/stats/x.py",
        "def f(out, ids, v):\n"
        "    {m}\n"
        "    return out.index_add_(0, ids, v)\n"),
    "error-discipline": (
        "raft_tpu_torch/comms/x.py",
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    {m}\n"
        "    except Exception:\n"
        "        pass\n"),
    "mutation-discipline": (
        "raft_tpu_torch/serve/x.py",
        "def f(core):\n"
        "    {m}\n"
        "    core.main_x = None\n"),
    "telemetry-discipline": (
        "raft_tpu_torch/serve/x.py",
        "import time\n"
        "def f():\n"
        "    {m}\n"
        "    return time.perf_counter()\n"),
}


def _ids(findings):
    return {f.rule for f in findings}


@pytest.mark.parametrize("rid", sorted(RULE_CASES))
def test_rule_fires_bare(rid):
    posix, tmpl = RULE_CASES[rid]
    bare = tmpl.format(m="# no marker here")
    assert rid in _ids(tengine.check_source(posix, bare))


@pytest.mark.parametrize("rid", sorted(RULE_CASES))
def test_rule_exempted_by_marker(rid):
    posix, tmpl = RULE_CASES[rid]
    src = tmpl.format(m=f"# exempt({rid}): the reason this one is needed")
    found = tengine.check_source(posix, src)
    assert rid not in _ids(found) and "exemption-hygiene" not in _ids(found)
    # and the marker is live (not stale)
    assert tengine.scan_stale_source(posix, src) == []


@pytest.mark.parametrize("rid", sorted(RULE_CASES))
def test_rule_not_exempted_without_rationale(rid):
    posix, tmpl = RULE_CASES[rid]
    found = _ids(tengine.check_source(posix, tmpl.format(m=f"# exempt({rid})")))
    assert rid in found and "exemption-hygiene" in found


def test_collectives_laundered_and_in_comms():
    src = ("from torch.distributed import broadcast as b\n"
           "import torch\n"
           "def helper():\n"
           "    return torch.distributed.all_gather\n"
           "def f(t):\n"
           "    b(t)\n"
           "    helper()([t], t)\n"
           "    torch.distributed.barrier()\n")
    lines = {f.lineno for f in tengine.check_source(
        "raft_tpu_torch/neighbors/x.py", src)
        if f.rule == "collective-discipline"}
    assert lines == {1, 4, 6, 7}
    assert not [f for f in tengine.check_source(
        "raft_tpu_torch/comms/x.py", src)
        if f.rule == "collective-discipline"]


def test_host_transfer_scoped_to_declared_functions():
    src = ("def _knn_scan_impl(x):\n"
           "    return x.cpu()\n"
           "def knn(x):\n"
           "    return x.cpu().numpy()\n")
    got = [f.lineno for f in tengine.check_source(
        "raft_tpu_torch/neighbors/brute_force.py", src)
        if f.rule == "hot-path-host-transfer"]
    assert got == [2]


def test_staging_marker_only_in_staging_paths():
    src = ("def _stage(self, t, dev):\n"
           "    # tier-staging(hot-path-host-transfer): the one staged copy\n"
           "    return t.to(dev, non_blocking=True)\n"
           "def _refine(self, t, dev):\n"
           "    return t.to(dev, non_blocking=True)\n")
    got = [f.lineno for f in tengine.check_source(
        "raft_tpu_torch/neighbors/tiering.py", src)
        if f.rule == "hot-path-host-transfer"]
    assert got == [5]


def test_kernel_symbols_declared():
    src = ("from raft_tpu_torch.kernels import native\n"
           "def f(x):\n"
           "    lib = native.library('select_k')\n"
           "    lib.raft_select_k(x)\n"
           "    lib.raft_not_declared(x)\n")
    got = [f.lineno for f in tengine.check_source(
        "raft_tpu_torch/kernels/x.py", src) if f.rule == "kernel-discipline"]
    assert got == [5]
    # the runtime loader may load its library; nvcc stays in kernels/
    src2 = "import ctypes\nL = ctypes.CDLL('x')\nN = 'nvcc'\n"
    got2 = [f.lineno for f in tengine.check_source(
        "raft_tpu_torch/native.py", src2) if f.rule == "kernel-discipline"]
    assert got2 == [3]


def test_trace_impurity_allows_local_generators():
    src = ("import numpy as np\nimport torch\n"
           "def _x_impl(q, g):\n"
           "    r = np.random.default_rng(0)\n"
           "    a = torch.rand(3, generator=g)\n"
           "    print(q)\n"
           "    return np.random.rand(3), r, a\n")
    got = [f.lineno for f in tengine.check_source(
        "raft_tpu_torch/neighbors/x.py", src) if f.rule == "trace-impurity"]
    assert got == [6, 7]


def test_raw_segment_sum_home_and_scatter_reduce():
    src = ("def f(o, i, v):\n"
           "    o.scatter_reduce_(0, i, v, 'sum')\n"
           "    o.scatter_reduce_(0, i, v, 'amax')\n"
           "    return o.scatter_add(0, i, v)\n")
    got = [f.lineno for f in tengine.check_source(
        "raft_tpu_torch/x.py", src) if f.rule == "raw-segment-sum"]
    assert got == [2, 4]
    assert not [f for f in tengine.check_source(
        "raft_tpu_torch/linalg/reduce.py", src)
        if f.rule == "raw-segment-sum"]


# ---------------------------------------------------------------------------
# the shipped tree


def test_every_reference_rule_is_mapped_or_dropped():
    import raft_tpu_torch.analysis.rules as trules

    jengine._ensure_rules_loaded()
    doc = trules.__doc__
    for r in jengine.iter_rules():
        if r.id.startswith("style-"):
            assert "``style-*``" in doc
            continue
        name = "pallas-discipline" if r.id == "pallas-discipline" else r.id
        assert f"``{name}``" in doc, r.id
    port = {r.id for r in tengine.iter_rules()}
    for r in jengine.iter_rules():
        assert (r.id in port or r.id == "pallas-discipline"), r.id
    assert "kernel-discipline" in port


def test_shipped_tree_is_clean():
    import io

    out = io.StringIO()
    assert tengine.run(out=out) == 0, out.getvalue()


def test_no_stale_exemptions():
    import io

    out = io.StringIO()
    assert tengine.scan_stale_exemptions(out=out) == 0, out.getvalue()


def test_every_exemption_has_a_rationale():
    files = tengine.collect_files([str(ROOT / "raft_tpu_torch")])
    bad = []
    for f in files:
        for i, c in tengine._comment_tokens(f.read_text()):
            m = tengine._EXEMPT_RE.search(c)
            if m is not None and not m.group(2).strip():
                bad.append(f"{f}:{i}")
    assert bad == []


def test_hotpath_function_scopes_resolve():
    for hp in hotpaths.HOT_PATHS:
        path = ROOT / hp.pattern
        assert path.exists(), hp.pattern
        if not hp.functions:
            continue
        tree = ast.parse(path.read_text())
        defined = {n.name for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        missing = sorted(set(hp.functions) - defined)
        assert missing == [], (hp.pattern, missing)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "raft_tpu_torch.analysis",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


def test_cli_ast_exit_codes(tmp_path):
    out = _cli("--ast")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "files clean" in out.stdout
    bad = tmp_path / "raft_tpu_torch" / "serve" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\nf = torch.compile\n")
    out = _cli("--ast", str(bad))
    assert out.returncode == 1 and "serve-dispatch" in out.stdout
    out = _cli("--stale-exemptions")
    assert out.returncode == 0
    assert "stale-exemptions: 0 stale marker(s)" in out.stdout
