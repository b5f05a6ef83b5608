"""The port's public surface against the JAX package's: every name that
``raft_tpu``'s dense long tail, label, solver, util, matrix, distance and
core packages export, the top-level names and the testing and telemetry
helpers, exists in ``raft_tpu_torch`` under the same name.  Left out, and
listed here: the JAX package's XLA-bound core (ahead-of-time compilation,
the persistent compile cache and ``prewarm``, which the port has yet to
decide on, ROADMAP §A) and its Pallas engine gates, which the port does
not carry over (ROADMAP §C): no environment variable sends a card path
to its plain version."""

import importlib

import pytest

#: the XLA-bound core: not part of this surface (ROADMAP §A item 2)
XLA_BOUND = {"AotFunction", "aot", "enable_persistent_cache",
             "try_enable_persistent_cache", "prewarm"}


def _public(mod):
    names = getattr(mod, "__all__", None) or [
        n for n in dir(mod) if not n.startswith("_")]
    return {n for n in names
            if not isinstance(getattr(mod, n), type(importlib))
            or n == "interruptible"}


@pytest.mark.parametrize("pkg", ["linalg", "matrix", "label", "solver",
                                 "util", "distance", "core", "testing"])
def test_package_exports(pkg):
    jmod = importlib.import_module(f"raft_tpu.{pkg}")
    tmod = importlib.import_module(f"raft_tpu_torch.{pkg}")
    want = _public(jmod) - XLA_BOUND
    if pkg == "distance":
        # the JAX package's shim modules of the Pallas engine gates
        want -= {"pallas_fused_l2nn", "pallas_kernels"}
    missing = sorted(n for n in want if not hasattr(tmod, n))
    assert missing == [], missing


def test_top_level_and_helpers():
    import raft_tpu
    import raft_tpu_torch

    for name in ("Handle", "LogicError", "RaftError", "expects"):
        assert hasattr(raft_tpu, name) and hasattr(raft_tpu_torch, name)
        assert name in raft_tpu_torch.__all__
    from raft_tpu.telemetry import http as jhttp
    from raft_tpu_torch.telemetry import http as thttp
    from raft_tpu_torch.testing import faults

    assert callable(jhttp.serve) and callable(thttp.serve)
    srv = thttp.serve(0, health=lambda: {"ready": True})
    try:
        import json
        import urllib.request

        with urllib.request.urlopen(f"{srv.url}/healthz", timeout=10) as r:
            assert r.status == 200 and json.load(r) == {"ready": True}
    finally:
        srv.close()
    faults.install_plan("dispatch:n=1:raise")
    assert faults.active_plan() is not None
    faults.clear_plan()
    assert faults.active_plan() is None


def test_lanczos_alias_stays_lazy():
    import raft_tpu_torch.linalg as tl
    from raft_tpu_torch.sparse import solver

    assert tl.lanczos_smallest is solver.lanczos_smallest
    with pytest.raises(AttributeError):
        tl.no_such_name


@pytest.mark.parametrize("var", ["RAFT_TPU_PALLAS", "RAFT_TPU_PALLAS_NN",
                                 "RAFT_TPU_PALLAS_SELECT_K",
                                 "RAFT_TPU_PALLAS_PQ_LUT",
                                 "RAFT_TPU_PALLAS_EXPERIMENTAL",
                                 "RAFT_TPU_PALLAS_INTERPRET"])
@pytest.mark.parametrize("value", ["0", "1", "force"])
def test_no_environment_gate(monkeypatch, var, value):
    """The JAX package's Pallas gates are not carried over: the engine is
    chosen by the device (and an explicit ``engine=``), whatever the
    environment says."""
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.kernels import engine

    monkeypatch.setenv(var, value)
    for name in ("ENV_GATES", "env_value", "env_enabled",
                 "experimental_unlocked", "interpret_requested"):
        assert not hasattr(engine, name)
    for kind, metric in (("l2nn", None), ("select_k", None),
                         ("pq_lut", None), ("pairwise", DistanceType.L1)):
        assert engine.resolve_engine(kind, "cuda", metric) == "cuda"
        assert engine.resolve_engine(kind, "cpu", metric) == "torch"
