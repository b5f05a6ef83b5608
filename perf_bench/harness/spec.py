"""A cell of ``BENCHMARK.json`` and the files it is found by.

Nothing here names a cell, a configuration, a mix or a metric: a cell is
resolved through ``BENCHMARK.json`` to ``configs/<config>.json`` (by the
configuration entry's ``file``), ``traffic/<traffic>.json``, the entry
module ``entries/<entry>.py`` that the configuration names and one reader
``metrics/<metric>.py`` per per-layer metric, so a later cell, mix,
configuration or metric is new files and new entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import types
from typing import Dict, List

#: the benchmark's own folder and the checkout's root (its parent)
BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: pathlib.Path

    def entry(self) -> types.ModuleType:
        return load_module(self.bench_dir / "entries"
                           / f"{self.config['entry']}.py")

    def reader(self, metric: str) -> types.ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py")


def load_module(path: pathlib.Path) -> types.ModuleType:
    """Import the file *path* as a module of its own (names with dots,
    such as a metric's, are file names here, not packages)."""
    if not path.is_file():
        raise FileNotFoundError(f"perf_bench: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"perf_bench_{path.parent.name}_{path.stem.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, e2e_names=None) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's; a
    per-layer one is every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell *workload* of ``<root>/BENCHMARK.json``."""
    bench = _read_json(root / "BENCHMARK.json")
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"perf_bench: no workload {workload!r} in "
                       f"BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    bench_dir = (root / bench["paths"][0]).resolve()
    traffic = _read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, e2e_names)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic_name=w["traffic"], traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, bench_dir=bench_dir)
