"""Nothing the benchmark loads is JAX or the JAX package (top-level
module names compared whole: ``raft_tpu_torch`` is the port, allowed),
and the reference imports nothing of the port."""

import ast
import json
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "raft_tpu"}


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not FORBIDDEN & set(_imports(path)), path


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "raft_tpu_torch" not in set(_imports(path)), path


_PROBE = r"""
import json, sys, time
sys.path.insert(0, ROOT)
from perf_bench.tests import tiny
from perf_bench.harness import cell
for w in ("ivf_pq-sift1m.batch", "ivf_flat-sift1m.open"):
    c = tiny.cell_of(w)
    for name in [m["name"] for m in c.per_layer + c.end_to_end]:
        c.reader(name)
    tiny.run(c, seconds=0.3, trace=True)
print(json.dumps({"loaded": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": cell.forbidden_modules()}))
"""


def test_a_run_loads_no_jax_module():
    """A whole traced run of each cell, every reader and entry loaded, in
    a fresh process: no forbidden top-level module is in sys.modules."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.replace("ROOT", repr(str(ROOT)))],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
             "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert not FORBIDDEN & set(got["loaded"])
    assert "raft_tpu_torch" in got["loaded"]


def test_reference_alone_does_not_load_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perf_bench.reference.ivf; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('raft_tpu_torch', 'raft_tpu', 'jax')))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
