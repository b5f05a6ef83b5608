"""The port's AOT core (``raft_tpu_torch/core/aot.py``, ``prewarm.py``)
against the JAX package's ``raft_tpu/core/aot.py`` / ``prewarm.py``:
the bucket ladder, per-signature cache sizes along the reference tests'
call sequences, the keyed ``pairwise_distance`` / ``fused_l2_nn`` /
``select_k`` against the JAX functions on seeded inputs, the serving
engine's zero-compile contract after ``warmup()``, the persistent kernel
cache's directory and ``prewarm`` on a CPU grid."""

import importlib

import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu.distance import fused_l2_nn as j_fused_l2_nn
from raft_tpu.distance import pairwise_distance as j_pairwise
from raft_tpu.matrix import select_k as j_select_k
from raft_tpu_torch import native as runtime_native
from raft_tpu_torch.core import aotstore
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.distance import fused_l2_nn, pairwise_distance
from raft_tpu_torch.kernels import native as kernels_native
from raft_tpu_torch.matrix import select_k
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.serve import ServeEngine

# the package exports the functions ``aot`` and ``prewarm``, which shadow
# the submodules of those names
aot = importlib.import_module("raft_tpu_torch.core.aot")
jaot = importlib.import_module("raft_tpu.core.aot")
prewarm = importlib.import_module("raft_tpu_torch.core.prewarm")


def test_bucket_dim_matches_reference():
    got = [bucket_dim(n) for n in range(1, 5001)]
    want = [jaot._bucket_dim(n) for n in range(1, 5001)]
    assert got == want


def _reference_sizes_per_signature():
    """``tests/test_aot.py::test_aot_caches_per_signature``'s sequence
    through the JAX package's ``aot``: cache sizes after each call."""
    f = jaot.aot(lambda x: x * 2.0)
    sizes = []
    for a in (np.ones((16, 4), np.float32), np.ones((16, 4), np.float32) + 1,
              np.ones((32, 4), np.float32), np.ones((16, 4), np.float64)):
        f(a)
        sizes.append(f.cache_size)
    return sizes


def test_cache_per_signature_matches_reference():
    calls = {"n": 0}

    @aot.aot
    def f(x):
        calls["n"] += 1
        return x * 2.0

    sizes = []
    for a in (torch.ones((16, 4)), torch.ones((16, 4)) + 1,
              torch.ones((32, 4)), torch.ones((16, 4), dtype=torch.float64)):
        out = f(a)
        sizes.append(f.cache_size)
    torch.testing.assert_close(out, torch.full((16, 4), 2.0,
                                               dtype=torch.float64))
    assert sizes == _reference_sizes_per_signature() == [1, 1, 2, 3]
    assert calls["n"] == 4            # eager: every call runs the body


def test_bucketing_bounds_signatures_like_reference():
    """The port's callers pad to ``bucket_dim`` before the keyed call (as
    ``knn`` and the IVF searches do); the signatures they make match the
    reference's ``aot(bucket=True)`` call for call."""
    jf = jaot.aot(lambda x: x.sum(axis=1), bucket=True)
    f = aot.aot(lambda x: x.sum(dim=1))
    assert "bucket" not in aot.aot.__code__.co_varnames
    for n in (9, 11, 13, 16):
        x = torch.ones((n, 3))
        out = f(torch.cat([x, x.new_zeros((bucket_dim(n) - n, 3))]))
        jout = jf(np.ones((n, 3), np.float32))
        assert out.shape[0] == jout.shape[0] == 16
        torch.testing.assert_close(out[:n], torch.full((n,), 3.0))
        assert f.cache_size == jf.cache_size
    assert f.cache_size == 1


def test_static_args_key_the_cache():
    f = aot.aot(lambda x, k: x[:, :k], static_argnums=(1,))
    jf = jaot.aot(lambda x, k: x[:, :k], static_argnums=(1,))
    for k in (3, 3, 5):
        assert f(torch.ones((4, 8)), k).shape == (4, k)
        jf(np.ones((4, 8), np.float32), k)
        assert f.cache_size == jf.cache_size
    assert f.cache_size == 2


def test_first_calls_count_once_per_signature():
    f = aot.aot(lambda x: x + 1)
    c0 = aot.aot_compile_counters["compiles"]
    for n in (4, 4, 8, 4, 8):
        f(torch.zeros(n))
    assert aot.aot_compile_counters["compiles"] - c0 == 2
    assert aot.aot_compile_counters[f"compiles:{f.__qualname__}"] >= 2


def test_compiled_from_specs_warms_the_signature():
    f = aot.aot(lambda x, y: x @ y.T)
    out = f.compiled(aot.TensorSpec((8, 4), torch.float32, "cpu"),
                     ((16, 4), torch.float32, "cpu"))
    assert out.shape == (8, 16) and not out.any()
    c0 = aot.aot_compile_counters["compiles"]
    f(torch.ones((8, 4)), torch.ones((16, 4)))
    assert aot.aot_compile_counters["compiles"] == c0
    assert f.cache_size == 1


def test_nested_calls_run_inline():
    inner = aot.aot(lambda x: x * 3)
    outer = aot.aot(lambda x: inner(x) + 1)
    c0 = aot.aot_compile_counters["compiles"]
    torch.testing.assert_close(outer(torch.ones(4)), torch.full((4,), 4.0))
    assert aot.aot_compile_counters["compiles"] - c0 == 1
    assert inner.cache_size == 0


def _metric(name):
    from raft_tpu_torch.distance.distance_types import DISTANCE_TYPES

    return DISTANCE_TYPES[name]


@pytest.fixture(scope="module")
def seeded():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((300, 24)).astype(np.float32),
            rng.standard_normal((200, 24)).astype(np.float32))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine",
                                    "inner_product", "l1"])
def test_keyed_pairwise_matches_jax(seeded, metric):
    """The prewarm grid's metrics: rtol 1e-4 / atol 1e-4 against the JAX
    function (expanded forms in float32 cancel at ~1e-5 of the norms)."""
    x, y = seeded
    from raft_tpu_torch.distance.pairwise import _distance_aot

    got = pairwise_distance(x, y, metric, device="cpu")
    want = np.asarray(j_pairwise(x, y, metric))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the call went through the keyed program: the same signature again
    # is no first call
    c0 = aot.aot_compile_counters["compiles"]
    _distance_aot(torch.as_tensor(x), torch.as_tensor(y), _metric(metric),
                  2.0, None)
    assert aot.aot_compile_counters["compiles"] == c0


def test_keyed_fused_l2_nn_matches_jax(seeded):
    """Indices equal, distances rtol 1e-5 / atol 1e-4."""
    x, y = seeded
    from raft_tpu_torch.distance.fused_l2_nn import _fused_l2_nn_aot

    c0 = _fused_l2_nn_aot.cache_size
    kv = fused_l2_nn(torch.as_tensor(x), torch.as_tensor(y), sqrt=True)
    jkv = j_fused_l2_nn(x, y, sqrt=True)
    np.testing.assert_array_equal(kv.key.numpy(), np.asarray(jkv.key))
    np.testing.assert_allclose(kv.value.numpy(), np.asarray(jkv.value),
                               rtol=1e-5, atol=1e-4)
    assert _fused_l2_nn_aot.cache_size >= max(c0, 1)


@pytest.mark.parametrize("select_min", [True, False])
def test_keyed_select_k_matches_jax(seeded, select_min):
    """Bit for bit: values and positions."""
    x, _ = seeded
    from raft_tpu_torch.matrix.select_k import _select_k_aot

    v, i = select_k(torch.as_tensor(x), 7, select_min=select_min)
    jv, ji = j_select_k(x, 7, select_min=select_min)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    c0 = aot.aot_compile_counters["compiles"]
    _select_k_aot(torch.as_tensor(x), 7, select_min, None, None)
    assert aot.aot_compile_counters["compiles"] == c0


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(3)
    c = rng.uniform(-3, 3, (20, 16))
    x = (c[rng.integers(0, 20, 3000)]
         + rng.standard_normal((3000, 16))).astype(np.float32)
    reqs = [(c[rng.integers(0, 20, n)] + rng.standard_normal((n, 16))
             ).astype(np.float32) for n in (1, 7, 64, 30, 5, 17, 33, 2)]
    return x, reqs


def _backends(x):
    xt = torch.as_tensor(x)
    return {
        "brute_force": (xt, None),
        "ivf_flat": (tivf.build(tivf.IndexParams(n_lists=16), xt,
                                device="cpu"),
                     tivf.SearchParams(n_probes=4)),
        "ivf_pq": (tpq.build(tpq.IndexParams(n_lists=16, pq_dim=8), xt,
                             device="cpu"),
                   tpq.SearchParams(n_probes=4)),
    }


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq"])
def test_zero_compiles_after_warmup(dataset, kind):
    """The JAX package's contract (``tests/test_serve.py::
    test_zero_compiles_after_warmup``): after ``warmup()``, closed-loop
    traffic over the warmed buckets leaves ``"compiles"`` flat; a bucket
    past the ladder is a first call."""
    x, reqs = dataset
    index, params = _backends(x)[kind]
    eng = ServeEngine(index, 5, params, max_batch=64, device="cpu",
                      scheduler=False, admission=False)
    try:
        eng.warmup()
        c0 = aot.aot_compile_counters["compiles"]
        for _ in range(3):
            res = eng.search(reqs)
            assert [r[0].shape[0] for r in res] == [len(q) for q in reqs]
        assert aot.aot_compile_counters["compiles"] == c0, \
            dict(aot.aot_compile_counters)
        # the contrapositive: a never-warmed batch shape does compile
        eng._backend.dispatch(torch.zeros((3, 16)))
        assert aot.aot_compile_counters["compiles"] > c0
    finally:
        eng.close()


def test_engine_dispatches_the_keyed_programs():
    from raft_tpu_torch.serve import engine

    assert isinstance(engine._BruteForceBackend.fn, aot.AotFunction)
    assert isinstance(engine._IvfFlatBackend.fn, aot.AotFunction)
    assert isinstance(engine._IvfPqBackend.fn, aot.AotFunction)
    assert engine._IvfPqBackend.fn.__qualname__ == "_full_search_impl"


@pytest.fixture
def restore_build_dirs(monkeypatch):
    monkeypatch.setattr(kernels_native, "BUILD_DIR", kernels_native.BUILD_DIR)
    monkeypatch.setattr(runtime_native, "BUILD_DIR", runtime_native.BUILD_DIR)


def test_persistent_cache_scoped_by_fingerprint(tmp_path, monkeypatch,
                                                restore_build_dirs):
    monkeypatch.setattr(aot, "_machine_fingerprint", lambda: "fp-a")
    d = aot.enable_persistent_cache(str(tmp_path / "cache"))
    assert d == str(tmp_path / "cache" / "fp-a")
    assert kernels_native.BUILD_DIR == runtime_native.BUILD_DIR == \
        tmp_path / "cache" / "fp-a"
    assert aot.cache_dir() == d
    monkeypatch.setattr(aot, "_machine_fingerprint", lambda: "fp-b")
    d2 = aot.enable_persistent_cache(str(tmp_path / "cache"))
    assert d2 != d and (tmp_path / "cache" / "fp-b").is_dir()
    # the library names live under the scoped directory
    assert str(kernels_native._target("probe")).startswith(d2)
    assert str(runtime_native.library_path()).startswith(d2)


def test_persistent_cache_base_precedence(tmp_path, monkeypatch,
                                          restore_build_dirs):
    monkeypatch.setattr(aot, "_machine_fingerprint", lambda: "fp")
    monkeypatch.setenv("RAFT_TPU_CACHE_DIR", str(tmp_path / "env"))
    assert aot.enable_persistent_cache() == str(tmp_path / "env" / "fp")
    assert aot.enable_persistent_cache(str(tmp_path / "x")) == \
        str(tmp_path / "x" / "fp")
    monkeypatch.delenv("RAFT_TPU_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert aot.cache_base() == tmp_path / "home" / ".cache" / "raft_tpu"
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert aot.try_enable_persistent_cache(str(blocker)) is None


def test_fingerprint_names_toolchain_and_machine(monkeypatch):
    monkeypatch.setattr(aot, "_nvcc_release", lambda: "release 12.8")
    a = aot._machine_fingerprint()
    monkeypatch.setattr(aot, "_nvcc_release", lambda: "release 12.9")
    assert aot._machine_fingerprint() != a and len(a) == 12


def test_prewarm_cpu_grid_counts_signatures():
    shapes = ((64, 48, 8), (32, 16, 4))
    r = prewarm.prewarm(shapes=shapes, select_k_shapes=((16, 100, 5),),
                        device="cpu", extra=[lambda: None])
    assert r["n_signatures"] == 2 * (5 + 1) + 1 + 1
    assert len(r["signatures"]) == r["n_signatures"]
    assert r["cache_dir"] == str(kernels_native.BUILD_DIR)
    assert r["seconds"] >= 0
    c0 = aot.aot_compile_counters["compiles"]
    prewarm.prewarm(shapes=shapes, select_k_shapes=((16, 100, 5),),
                    device="cpu")
    assert aot.aot_compile_counters["compiles"] == c0
    # a prewarmed signature is warm for the public call
    x = torch.zeros((64, 8))
    y = torch.zeros((48, 8))
    pairwise_distance(x, y, "l1", device="cpu")
    assert aot.aot_compile_counters["compiles"] == c0


def test_prewarm_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prewarm.prewarm()


def test_stubs_say_why():
    with pytest.raises(NotImplementedError, match="mesh"):
        aot.mesh_aot(lambda x: x)
    with pytest.raises(NotImplementedError, match="enable_persistent_cache"):
        aotstore.install()


def test_surface_exports_the_aot_core():
    import raft_tpu

    for name in ("AotFunction", "aot", "enable_persistent_cache",
                 "try_enable_persistent_cache", "prewarm"):
        assert hasattr(raft_tpu.core, name)
        assert hasattr(raft_tpu_torch.core, name)
    assert callable(raft_tpu_torch.prewarm)
    assert "prewarm" in raft_tpu_torch.__all__
