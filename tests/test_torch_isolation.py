"""The port stands alone: importing raft_tpu_torch pulls in neither jax nor
any raft_tpu module, no file of the port (or chip_smoke.py) imports them
or the JAX package's ``bench`` folder,
and entry points asked for no device raise when CUDA is absent — the
distributed ones included, none of which drops to gloo on the CPU.  The
native runtime's loader reads ``native/`` and builds under ``build/``
only, never into the JAX package's library path."""

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
print("COMMS", sorted(n for n in sys.modules
                      if n.startswith("raft_tpu_torch.comms.")))
"""
#: the distributed layer's modules
DISTRIBUTED = ("comms/__init__.py", "comms/comms.py", "comms/comms_types.py",
               "comms/hostcomm.py", "comms/self_tests.py",
               "comms/session.py", "cluster/kmeans_mnmg.py",
               "neighbors/knn_mnmg.py", "neighbors/ann_mnmg.py",
               "serve/spmd.py", "telemetry/aggregate.py",
               "testing/world.py", "native.py", "neighbors/mutable.py",
               "neighbors/serialize.py")


def test_import_leaves_jax_and_raft_tpu_out():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    # the walk imported the communicator package
    assert ("COMMS ['raft_tpu_torch.comms.comms', "
            "'raft_tpu_torch.comms.comms_types', "
            "'raft_tpu_torch.comms.hostcomm', "
            "'raft_tpu_torch.comms.self_tests', "
            "'raft_tpu_torch.comms.session']") in out.stdout, out.stdout


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
    assert {PORT / f for f in DISTRIBUTED} <= set(files)
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "raft_tpu", "bench"), (
                f, name)


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
    # the session's default device is the card: no process group is
    # created, NCCL or gloo
    from raft_tpu_torch.comms import CommsSession

    with pytest.raises(RuntimeError, match="no CUDA device"):
        CommsSession().init()
    assert not torch.distributed.is_initialized()
    # kmeans_mnmg.fit, knn_mnmg and the sharded ANN entry points over a
    # gloo world of one (a process of its own: the process group is
    # process-global)
    out = subprocess.run([sys.executable, "-c", _MNMG_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == ("RAISED:fit,knn_mnmg,predict,"
                                      "shard_brute_force,build_sharded,"
                                      "load_mutable"), \
        out.stdout


_MNMG_PROBE = """
import numpy as np, torch
from raft_tpu_torch.cluster import KMeansParams, kmeans_mnmg
from raft_tpu_torch.comms import CommsSession
from raft_tpu_torch.neighbors import ann_mnmg, ivf_flat, serialize
from raft_tpu_torch.neighbors.knn_mnmg import knn_mnmg

session = CommsSession(device="cpu").init()
torch.cuda.is_available = lambda: False
x = np.zeros((64, 4), np.float32)
raised = []
for name, call in (
        ("fit", lambda: kmeans_mnmg.fit(KMeansParams(n_clusters=2),
                                        session.comms, x, centroids=x[:2])),
        ("knn_mnmg", lambda: knn_mnmg(session.comms, x, x, 3)),
        ("predict", lambda: kmeans_mnmg.predict(KMeansParams(n_clusters=2),
                                                session.comms, x, x[:2])),
        ("shard_brute_force",
         lambda: ann_mnmg.shard_brute_force(x, session.comms)),
        ("build_sharded",
         lambda: ivf_flat.build_sharded(ivf_flat.IndexParams(n_lists=2), x,
                                        session.comms)),
        ("load_mutable",
         lambda: serialize.load_mutable("no_archive", comms=session.comms))):
    try:
        call()
    except RuntimeError as e:
        if "no CUDA device" in str(e):
            raised.append(name)
assert session.comms.backend == "gloo"
session.destroy()
print("RAISED:" + ",".join(raised))
"""


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


def test_mutable_build_and_serialize_modules_stand_alone(monkeypatch,
                                                        tmp_path):
    """The mutable index, the device pack and the archive writers are part
    of the walk above, import neither jax nor raft_tpu, and their entry
    points asked for no device raise when CUDA is absent."""
    from raft_tpu_torch.neighbors import (_build, ivf_flat, mutable,
                                          serialize)

    for mod in (_build, mutable, serialize):
        path = pathlib.Path(mod.__file__)
        assert path.parent == PORT / "neighbors"
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "raft_tpu")
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=4),
                         np.random.default_rng(0).random((64, 4)).astype(
                             np.float32), device="cpu")
    serialize.save_ivf_flat(tmp_path / "f", idx)
    serialize.save_mutable(tmp_path / "m", mutable.MutableIndex(
        idx, np.zeros((64, 4), np.float32)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serialize.load_ivf_flat(tmp_path / "f")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serialize.load_mutable(tmp_path / "m")


def test_tiering_and_ann_modules_stand_alone(monkeypatch):
    """The tiered index and the ``approx_knn_*`` surface are part of the
    walk above, import neither jax nor raft_tpu, and their entry points
    asked for no device raise when CUDA is absent."""
    from raft_tpu_torch.neighbors import ann, ivf_flat, tiering

    for mod in (tiering, ann):
        path = pathlib.Path(mod.__file__)
        assert path.parent == PORT / "neighbors"
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "raft_tpu")
    x = np.random.default_rng(0).random((64, 4)).astype(np.float32)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=4), x, device="cpu")
    t = tiering.tier(idx, hot_fraction=0.5, tile_phys=2)
    assert t.device.type == "cpu" and t.hot_scan[0].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ann.approx_knn_build_index(ann.IVFFlatParam(nlist=4), x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiering.tier(ivf_flat.build(ivf_flat.IndexParams(n_lists=4), x))


def test_native_loader_stands_alone():
    """The port's native loader is its own: it imports nothing of the JAX
    package, reads the checkout's ``native/`` sources and builds under
    ``build/``, never into ``native/libraft_tpu_runtime.so``."""
    from raft_tpu_torch import native

    for name in _imports(PORT / "native.py"):
        assert name.split(".")[0] not in ("jax", "jaxlib", "raft_tpu")
    assert native.SOURCE_DIR == ROOT / "native"
    assert native.BUILD_DIR.is_relative_to(ROOT / "build")
    assert native.library_path().parent == native.BUILD_DIR
    assert "libraft_tpu_runtime.so" not in native.library_path().name


#: the sparse, spectral and single-linkage modules
SPARSE = ("core/logger.py", "sparse/__init__.py", "sparse/types.py",
          "sparse/op.py", "sparse/convert.py", "sparse/linalg.py",
          "sparse/distance.py", "sparse/neighbors.py",
          "sparse/solver/__init__.py", "sparse/solver/mst.py",
          "sparse/solver/lanczos.py", "spectral/__init__.py",
          "spectral/matrix.py", "spectral/solvers.py",
          "spectral/partition.py", "cluster/single_linkage.py")


def test_sparse_spectral_linkage_stand_alone(monkeypatch):
    """The sparse, spectral and single-linkage modules import neither jax
    nor raft_tpu; their entry points asked for no device raise when CUDA
    is absent, and run with ``device="cpu"``."""
    import importlib

    from raft_tpu_torch import sparse, spectral
    from raft_tpu_torch.sparse import distance, neighbors

    sl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")
    for f in SPARSE:
        assert (PORT / f).is_file(), f
        for name in _imports(PORT / f):
            assert name.split(".")[0] not in ("jax", "jaxlib", "raft_tpu"), (
                f, name)
    rng = np.random.default_rng(0)
    x = rng.random((40, 3)).astype(np.float32)
    r = np.r_[np.arange(39), np.arange(1, 40)]
    c = np.r_[np.arange(1, 40), np.arange(39)]
    v = np.ones(78, np.float32)
    eig = spectral.LanczosEigenSolver(spectral.EigenSolverConfig(2))
    km = spectral.KMeansClusterSolver(spectral.ClusterSolverConfig(2))

    def calls(device):
        return {
            "lanczos_smallest": lambda: sparse.lanczos_smallest(
                lambda u: u * torch.arange(40, device=u.device), 2, n=40,
                device=device),
            "partition": lambda: spectral.partition(
                sparse.from_triplets(r, c, v, (40, 40), device=device), eig,
                km),
            "single_linkage": lambda: sl.single_linkage(x, n_clusters=2,
                                                        device=device),
            "pairwise_distance": lambda: distance.pairwise_distance(
                sparse.CSR(np.arange(41), np.zeros(40, np.int32), x[:, 0],
                           (40, 3), device=device),
                sparse.dense_to_csr(x, device=device)),
            "knn_graph": lambda: neighbors.knn_graph(x, c=2, device=device),
        }

    for name, call in calls("cpu").items():
        assert call() is not None, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in calls(None).items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


#: the dense long tail, the compile probe and the new core modules
DENSE = ("kernels/probe.py", "label/__init__.py", "label/classlabels.py",
         "label/merge_labels.py", "solver/__init__.py",
         "solver/linear_assignment.py", "util/__init__.py",
         "util/itertools.py", "util/math.py", "util/seive.py",
         "util/tiling.py", "core/interruptible.py", "core/mdarray.py",
         "core/handle.py", "linalg/__init__.py", "linalg/types.py",
         "linalg/elementwise.py", "linalg/matrix_vector.py",
         "linalg/reduce.py", "linalg/blas.py", "linalg/decompositions.py",
         "matrix/ops.py", "distance/kernels.py")


def test_dense_modules_stand_alone(monkeypatch):
    """The dense modules, the probe and the new core modules import
    neither jax, raft_tpu nor bench; their entry points asked for no
    device raise when CUDA is absent, and run with ``device="cpu"``."""
    from raft_tpu_torch import label, linalg, matrix, solver
    from raft_tpu_torch.core import handle, mdarray
    from raft_tpu_torch.distance import KernelParams, gram_matrix
    from raft_tpu_torch.kernels import probe

    for f in DENSE:
        assert (PORT / f).is_file(), f
        for name in _imports(PORT / f):
            assert name.split(".")[0] not in ("jax", "jaxlib", "raft_tpu",
                                              "bench"), (f, name)
    lab = np.array([5, 3, 5, 9], np.int32)
    costs = np.random.default_rng(0).random((4, 4)).astype(np.float32)

    def calls(device):
        return {
            "make_monotonic": lambda: label.make_monotonic(lab,
                                                           device=device),
            "get_unique_labels": lambda: label.get_unique_labels(
                lab, device=device),
            "merge_labels": lambda: label.merge_labels(
                np.zeros(4, np.int32), np.zeros(4, np.int32),
                np.ones(4, bool), device=device),
            "solve_lap": lambda: solver.solve_lap(costs, device=device),
            "LinearAssignmentProblem": lambda: solver.LinearAssignmentProblem(
                4, device=device).solve(costs),
            "gram_matrix": lambda: gram_matrix(costs, costs, KernelParams(),
                                               device=device),
            "eye": lambda: matrix.eye(3, device=device),
            "fill": lambda: matrix.fill((2, 2), 1.0, device=device),
            "map_offset": lambda: linalg.map_offset((2, 2), lambda i: i,
                                                    device=device),
        }

    for name, call in calls("cpu").items():
        assert call() is not None, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in calls(None).items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for call in (probe.probe, handle.default_handle,
                 lambda: mdarray.make_device_matrix(None, 2, 2),
                 lambda: mdarray.as_device_array([1.0])):
        monkeypatch.setattr(handle, "_default_handle", None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
