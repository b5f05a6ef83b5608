"""The port's retrace-closure certifier (``raft_tpu_torch/analysis/
retrace.py``) against the JAX package's (``raft_tpu/analysis/retrace.py``):
the counterparts of the reference's ``TestRetraceCertifier``
(``tests/test_lowering_locks.py``), the seven static-cardinality snippets
through both packages' scans (the verdicts agree snippet for snippet),
the port's head certified with no failure, the CLI's ``--retrace`` in
process, the stale-exemption scan on the certifier's marker, and seeded
mutations of the port's own sources — each parsed from a string, never
written to the tree — each failing its named obligation.  AST only."""

import ast
import io

import pytest

from raft_tpu.analysis import dataflow as jflow
from raft_tpu.analysis import retrace as jretrace
from raft_tpu_torch.analysis import dataflow
from raft_tpu_torch.analysis import engine
from raft_tpu_torch.analysis import retrace
from raft_tpu_torch.analysis.__main__ import main as analysis_main


@pytest.fixture(scope="module")
def head():
    return retrace.run(out=io.StringIO())


# ---------------------------------------------------------------------------
# counterparts of TestRetraceCertifier


def test_head_closure_certified(head):
    reports, failed = head
    assert failed == 0, [
        (r.name, r.findings) for r in reports if r.status == "fail"]
    names = {r.name for r in reports}
    assert any(n.startswith("serve.warm_dispatch._") for n in names)
    assert "serve.backends_cover" in names
    assert any(n.startswith("serve.bucket_closure") for n in names)
    assert "retrace.static_cardinality" in names


def test_every_backend_class_certified(head):
    reports, _ = head
    certified = {r.name.rsplit(".", 1)[-1] for r in reports
                 if r.name.startswith("serve.warm_dispatch.")
                 and r.status == "ok"}
    for cls in ("_BruteForceBackend", "_IvfFlatBackend", "_IvfPqBackend",
                "_MutableBackend", "_TieredBackend", "_ShardedBackend",
                "_ReplicaBackend", "_ShardedMutableBackend",
                "ShardedSearcher", "TieredSearcher", "MutableSearcher"):
        assert cls in certified, certified


def test_mutate_closure_certified():
    reports, failed = retrace.run(["mutate_closure"], out=io.StringIO())
    assert failed == 0, [
        (r.name, r.findings) for r in reports if r.status == "fail"]
    names = {r.name for r in reports}
    for ob in ("mask_in_scan", "families_thread_mask",
               "tomb_buckets_via_ladder", "writes_rewarm_signatures",
               "dispatch_snapshots_under_lock",
               "compact_promotes_via_refresh", "backend_registered"):
        assert f"serve.mutate_closure.{ob}" in names, names


def test_every_reference_obligation_has_its_counterpart(head):
    """The reference's obligation names at its head, against the port's
    (the class-named congruence obligations name each package's own
    classes)."""
    jreports, _ = jretrace.run(out=io.StringIO())
    want = {r.name for r in jreports
            if not r.name.startswith("serve.warm_dispatch.")}
    got = {r.name for r in head[0]}
    assert want <= got, sorted(want - got)


# the reference's seven snippets; {imp} is each package's import line and
# {ladder} its bounding function
SNIPPETS = {
    "leaky": ("def fn(q, n):\n    return q[:n]\n\n"
              "F = aot(fn, static_argnums=(1,))\n\n"
              "def serve(q):\n"
              "    return F(q, q.shape[0])\n", True),
    "fixed": ("def fn(q, n):\n    return q[:n]\n\n"
              "F = aot(fn, static_argnums=(1,))\n\n"
              "def serve(q):\n"
              "    return F(q, {ladder}(q.shape[0]))\n", False),
    "capped": ("def fn(q, t):\n    return q[:t]\n\n"
               "F = aot(fn, static_argnums=(1,))\n\n"
               "def serve(q):\n"
               "    return F(q, min(16384, q.shape[0]))\n", False),
    "leaky2": ("def fn(q, n):\n    return q[:n]\n\n"
               "F = aot(fn, static_argnums=(1,))\n\n"
               "def serve(batches):\n"
               "    return F(batches, len(batches))\n", True),
    "keyed": ("def fn(q, k):\n    return q[:k]\n\n"
              "F = aot(fn, static_argnums=(1,))\n\n"
              "def knn(q, k):\n"
              "    return F(q, k)\n", False),
    "coerce": ("def fn(q, m, a):\n    return q\n\n"
               "F = aot(fn, static_argnums=(2, 3))\n\n"
               "def distance(x, metric, arg):\n"
               "    metric = DistanceType(metric)\n"
               "    arg = float(arg)\n"
               "    return F(x, x, metric, arg)\n", False),
    "sanctioned": ("def fn(q, n):\n    return q[:n]\n\n"
                   "F = aot(fn, static_argnums=(1,))\n\n"
                   "def rebuild(q):\n"
                   "    # exempt(retrace-unbounded-static): one-shot build "
                   "path\n"
                   "    return F(q, q.shape[0])\n", False),
}

IMPORTS = {
    "jax": ("from raft_tpu.core.aot import aot, _bucket_dim\n\n",
            "_bucket_dim"),
    "port": ("from raft_tpu_torch.core.aot import aot\n"
             "from raft_tpu_torch.core.buckets import bucket_dim\n\n",
             "bucket_dim"),
}


def _snippet(name, pkg):
    body, leaks = SNIPPETS[name]
    imp, ladder = IMPORTS[pkg]
    return imp + body.format(ladder=ladder), leaks


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_static_cardinality_verdicts_agree(name):
    verdicts = {}
    for pkg, mod, flow in (("jax", jretrace, jflow),
                           ("port", retrace, dataflow)):
        src, leaks = _snippet(name, pkg)
        tree = ast.parse(src)
        found = mod.scan_static_cardinality(
            f"{name}.py", tree, flow.ValueFlow(tree), src.splitlines())
        verdicts[pkg] = bool(found)
    assert verdicts["jax"] == verdicts["port"] == leaks


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_static_cardinality_through_run(tmp_path, name):
    """The reference's run-level snippet tests (a tmp module as the scan's
    root): ``leaky`` and ``leaky2`` fail, the other five pass."""
    src, leaks = _snippet(name, "port")
    (tmp_path / f"{name}.py").write_text(src)
    reports, failed = retrace.run(["static_cardinality"],
                                  roots=[str(tmp_path)], out=io.StringIO())
    assert failed == int(leaks)
    if leaks:
        assert any("unbounded" in f for f in reports[-1].findings)


def test_names_filter():
    reports, _ = retrace.run(["bucket_closure"], out=io.StringIO())
    assert reports
    assert all("bucket_closure" in r.name for r in reports)


def test_incongruent_warm_dispatch_fails():
    """A backend whose dispatch passes an argument its warm never does."""
    src = ("import torch\n\n"
           "class _LeakyBackend:\n"
           "    def warm(self, bucket, dtype):\n"
           "        self.fn.compiled(*self._args(\n"
           "            TensorSpec((bucket, self.dim), dtype)))\n"
           "    def dispatch(self, qb):\n"
           "        return self.fn(*self._args(qb), qb.dtype)\n")
    tree = ast.parse(src)
    reports = retrace.certify_warm_dispatch(
        {"engine.py": tree}, {"engine.py": dataflow.ValueFlow(tree)})
    leaky = [r for r in reports
             if r.name == "serve.warm_dispatch._LeakyBackend"]
    assert leaky and leaky[0].status == "fail"
    # and the congruent twin passes
    tree = ast.parse(src.replace(", qb.dtype)", ")"))
    reports = retrace.certify_warm_dispatch(
        {"engine.py": tree}, {"engine.py": dataflow.ValueFlow(tree)})
    assert reports[0].status == "ok", reports[0].findings


def test_missing_warm_fails():
    src = ("class _NoWarm:\n"
           "    def dispatch(self, qb):\n"
           "        return self.fn(qb)\n")
    tree = ast.parse(src)
    reports = retrace.certify_warm_dispatch(
        {"m.py": tree}, {"m.py": dataflow.ValueFlow(tree)})
    assert reports and reports[0].status == "fail"


# ---------------------------------------------------------------------------
# the CLI and the stale-exemption scan


def test_cli_retrace_in_process(capsys, monkeypatch):
    assert analysis_main(["--retrace"]) == 0
    out = capsys.readouterr().out
    assert "== analysis: retrace closure ==" in out
    assert "0 failed" in out
    # a certificate with nothing to prove is a finding: exit 1
    monkeypatch.setattr(retrace, "SERVE_MODULES", ())
    assert analysis_main(["--retrace", "--programs", "warm_dispatch"]) == 1


def test_stale_scan_knows_the_certifier_marker():
    live = ("from raft_tpu_torch.core.aot import aot\n\n"
            "F = aot(lambda q, n: q, static_argnums=(1,))\n\n"
            "def serve(q):\n"
            "    # exempt(retrace-unbounded-static): a one-shot path\n"
            "    return F(q, q.shape[0])\n")
    assert not engine.scan_stale_source("raft_tpu_torch/x/m.py", live)
    stale = live.replace("q.shape[0]", "8")
    found = engine.scan_stale_source("raft_tpu_torch/x/m.py", stale)
    assert [s.rules for s in found] == [(retrace.EXEMPT_ID,)]


# ---------------------------------------------------------------------------
# seeded mutations of the port's sources (parsed from strings)


def _mutated(rel, old, new):
    """The serving files with *rel*'s source edited; the edit must hit."""
    files = retrace.parse_modules(retrace.SERVE_MODULES)
    src = (retrace.REPO_ROOT / rel).read_text()
    assert src.count(old) == 1, (rel, old)
    files[rel] = ast.parse(src.replace(old, new))
    return files


def _status(reports, name):
    got = [r.status for r in reports if r.name == name]
    assert got, name
    return got[0]


MUTATIONS = {
    "bucket_for_unclamped": (
        "raft_tpu_torch/serve/engine.py",
        "b = min(bucket_dim(total), self.max_batch)",
        "b = bucket_dim(total)",
        retrace.certify_bucket_closure,
        "serve.bucket_closure.bucket_for.clamped"),
    "dispatch_extra_static": (
        "raft_tpu_torch/neighbors/tiering.py",
        "return self._dispatch(qb, self._acc)",
        "return self._dispatch(qb, self._acc, self.k)",
        None,
        "serve.warm_dispatch.TieredSearcher"),
    "upsert_without_rewarm": (
        "raft_tpu_torch/neighbors/mutable.py",
        "                self._rewarm_locked()\n",
        "                pass\n",
        retrace.certify_mutate_closure,
        "serve.mutate_closure.writes_rewarm_signatures"),
    "chooser_own_bucket": (
        "raft_tpu_torch/serve/schedule.py",
        "bucket = bucket_for(total)",
        "bucket = bucket_dim(total)",
        retrace.certify_scheduler_closure,
        "serve.scheduler_closure.chooser.bucket_via_ladder"),
    "compact_raw_backend": (
        "raft_tpu_torch/neighbors/mutable.py",
        "            engine.refresh(self)\n",
        "            engine.refresh(self)\n            engine._backend = None\n",
        retrace.certify_mutate_closure,
        "serve.mutate_closure.compact_promotes_via_refresh"),
    "scan_without_tombstones": (
        "raft_tpu_torch/neighbors/_common.py",
        "dead = tombstone_hit(ids, tombstones)",
        "dead = ids < 0",
        retrace.certify_mutate_closure,
        "serve.mutate_closure.mask_in_scan"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_seeded_mutation_fails_its_obligation(name):
    rel, old, new, certify, obligation = MUTATIONS[name]
    files = _mutated(rel, old, new)
    if rel == "raft_tpu_torch/neighbors/_common.py":
        # outside the serving modules: the mutate closure reads it too
        files[rel] = ast.parse(
            (retrace.REPO_ROOT / rel).read_text().replace(old, new))
    if certify is None:
        reports = retrace.certify_warm_dispatch(
            files, {k: dataflow.ValueFlow(t) for k, t in files.items()})
    else:
        reports = certify(files)
    assert _status(reports, obligation) == "fail"
    # the unmutated sources certify the same obligation
    clean = retrace.parse_modules(retrace.SERVE_MODULES)
    if certify is None:
        reports = retrace.certify_warm_dispatch(
            clean, {k: dataflow.ValueFlow(t) for k, t in clean.items()})
    else:
        reports = certify(clean)
    assert _status(reports, obligation) == "ok"
