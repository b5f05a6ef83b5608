"""The harness finds configurations, mixes, entries and metric readers by
name: a dummy set added as new files plus new entries in a copy of the
benchmark is found and run, and no file that was there is edited."""

import hashlib
import json
import pathlib
import shutil

import pytest

from perf_bench.harness import spec
from perf_bench.tests import tiny

BENCH = pathlib.Path(__file__).resolve().parents[1]


def _digests(root: pathlib.Path):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


@pytest.fixture()
def copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_every_cell_resolves():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = spec.load(w["name"])
        assert c.config["name"] == w["config"]
        assert c.entry().__name__
        for m in c.per_layer + c.end_to_end:
            assert hasattr(c.reader(m["name"]), "read")
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        # every per-layer metric moves a metric this cell reports
        assert {m["moves"] for m in c.per_layer} <= names


def test_new_files_and_entries_are_found(copy):
    before = _digests(copy / "perf_bench")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    # a new configuration: the IVF-Flat one under another name
    cfg = json.loads((copy / "perf_bench/configs/ivf_flat-sift1m.json")
                     .read_text())
    cfg["name"] = "dummy_flat"
    (copy / "perf_bench/configs/dummy_flat.json").write_text(
        json.dumps(cfg))
    bench["configs"].append({"name": "dummy_flat", "source": "test",
                             "file": "perf_bench/configs/dummy_flat.json",
                             "reduced": [], "why": "test"})
    # a new mix: a closed loop of 50 queries a call
    (copy / "perf_bench/traffic/dummy_batch.json").write_text(json.dumps(
        {"kind": "batch", "queries_per_call": 50}))
    # a new per-layer metric with its reader
    (copy / "perf_bench/metrics/dummy.calls.py").write_text(
        "def read(ctx):\n    return float(ctx.window.attempted)\n")
    bench["workloads"].append({"name": "dummy_flat.batch",
                               "config": "dummy_flat",
                               "traffic": "dummy_batch", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("dummy_flat.batch")
    bench["end_to_end"][2]["workloads"].append("dummy_flat.batch")
    bench["per_layer"].append({"name": "dummy.calls", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "test", "moves": "qps",
                               "workloads": ["dummy_flat.batch"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    c = tiny.shrink(spec.load("dummy_flat.batch", copy))
    assert c.traffic["kind"] == "batch"
    assert c.bench_dir == (copy / "perf_bench").resolve()
    assert [m["name"] for m in c.per_layer] == ["dummy.calls"]
    out = tiny.run(c, seconds=0.3, trace=True)
    assert out["metrics"]["dummy.calls"]["value"] == out["attempted"] >= 1
    assert out["correct"]
    after = _digests(copy / "perf_bench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/dummy_flat.json",
                                        "traffic/dummy_batch.json",
                                        "metrics/dummy.calls.py"}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load("no_such.cell")
