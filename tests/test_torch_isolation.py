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
    from raft_tpu_torch.neighbors import ivf_flat

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((64, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_flat.build(ivf_flat.IndexParams(n_lists=4), x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_flat.index_from_arrays({}, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans.centers_from_array(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Handle()
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
        resolve_engine("pq_lut", "cpu")


def test_kernel_sources_ship_with_the_package():
    from raft_tpu_torch.kernels import native

    for name in native.SOURCES:
        assert (native.CSRC / f"{name}.cu").is_file()
