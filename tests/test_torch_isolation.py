"""The port stands alone: importing raft_tpu_torch pulls in neither jax nor
any raft_tpu module, no file of the port (or chip_smoke.py) imports them,
and entry points asked for no device raise when CUDA is absent."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "raft_tpu_torch"
_PROBE = """
import importlib, pkgutil, sys
import raft_tpu_torch
for m in pkgutil.walk_packages(raft_tpu_torch.__path__, "raft_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "raft_tpu" or n.startswith("raft_tpu."))
print("BAD", bad)
"""


def test_import_leaves_jax_and_raft_tpu_out():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_raft_tpu_import_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "raft_tpu"), (f, name)


def test_entry_points_raise_without_cuda(monkeypatch):
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.core.handle import Handle, resolve_device
    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
    from raft_tpu_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((64, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_flat.build(ivf_flat.IndexParams(n_lists=4), x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_flat.index_from_arrays({}, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_pq.build(ivf_pq.IndexParams(n_lists=4), x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_pq.index_from_arrays({}, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans.centers_from_array(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Handle()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pairwise_distance(x, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brute_force.knn(x, x, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(x, 3)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_engine_policy():
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.kernels.engine import resolve_engine

    assert resolve_engine("select_k", "cpu") == "torch"
    assert resolve_engine("l2nn", "cuda") == "cuda"
    assert resolve_engine("l2nn", "cuda",
                          metric=DistanceType.InnerProduct) == "torch"
    with pytest.raises(ValueError):
        resolve_engine("select_k", "cpu", engine="cuda")
    with pytest.raises(ValueError):
        resolve_engine("l2nn", "cuda", metric=DistanceType.InnerProduct,
                       engine="cuda")
    with pytest.raises(ValueError):
        resolve_engine("gram", "cpu")
    # B5 serves the metrics it accumulates; the others resolve to the
    # plain path, and an explicit "cuda" for them raises
    for metric in (DistanceType.L1, DistanceType.L2SqrtUnexpanded,
                   DistanceType.L2Unexpanded, DistanceType.Linf,
                   DistanceType.Canberra, DistanceType.LpUnexpanded,
                   DistanceType.HammingUnexpanded):
        assert resolve_engine("pairwise", "cuda", metric=metric) == "cuda"
        assert resolve_engine("pairwise", "cpu", metric=metric) == "torch"
        assert resolve_engine("pairwise", "cuda", metric=metric,
                              engine="torch") == "torch"
        with pytest.raises(ValueError):
            resolve_engine("pairwise", "cpu", metric=metric, engine="cuda")
    for metric in (DistanceType.L2Expanded, DistanceType.CosineExpanded,
                   DistanceType.BrayCurtis, DistanceType.JensenShannon):
        assert resolve_engine("pairwise", "cuda", metric=metric) == "torch"
        with pytest.raises(ValueError):
            resolve_engine("pairwise", "cuda", metric=metric, engine="cuda")
    # B4 takes every LUT row on the card (a wide one in chunks), so the
    # plain version runs only on the CPU or when asked for
    assert resolve_engine("pq_lut", "cpu") == "torch"
    assert resolve_engine("pq_lut", "cuda") == "cuda"
    assert resolve_engine("pq_lut", "cuda", engine="torch") == "torch"
    with pytest.raises(ValueError):
        resolve_engine("pq_lut", "cpu", engine="cuda")


def test_kernel_sources_ship_with_the_package():
    from raft_tpu_torch.kernels import native

    for name in native.SOURCES:
        assert (native.CSRC / f"{name}.cu").is_file()
