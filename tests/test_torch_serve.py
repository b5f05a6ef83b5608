"""The port's ServeEngine, over IVF-Flat, IVF-PQ and brute force:
coalesced serving equals solo search per request, and matches the JAX
ServeEngine (``scheduler=False, admission=False``) on the same
carried-across index or dense dataset (ids identical wherever distances
are not tied, distances to rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest

from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.serve.engine import ServeEngine as JaxServeEngine
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.serve import ServeEngine

K = 10
SIZES = [1, 7, 0, 64, 30, 100, 5, 17]   # 100 > max_batch: served solo


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(0)
    c = rng.uniform(-3, 3, (30, 16))
    x = (c[rng.integers(0, 30, 2500)] + rng.standard_normal((2500, 16))
         ).astype(np.float32)
    jidx = jax_ivf.build(jax_ivf.IndexParams(n_lists=20), jnp.asarray(x))
    tidx = tivf.index_from_arrays(
        {n: np.asarray(getattr(jidx, n)) for n in tivf.ARRAY_FIELDS},
        int(jidx.metric), device="cpu")
    reqs = [(c[rng.integers(0, 30, n)] + rng.standard_normal((n, 16))
             ).astype(np.float32) for n in SIZES]
    return jidx, tidx, reqs


def test_coalesced_equals_solo(served):
    _, tidx, reqs = served
    eng = ServeEngine(tidx, K, tivf.SearchParams(n_probes=5), max_batch=64)
    assert eng.warmup() == 4                      # buckets 8, 16, 32, 64
    out = eng.search(reqs)
    assert eng.stats["solo_fallbacks"] == 1
    assert eng.stats["super_batches"] == 3
    for q, (d, i) in zip(reqs, out):
        assert d.shape == (q.shape[0], K) and i.dtype == np.int32
        sd, si = tivf.search(tivf.SearchParams(n_probes=5), tidx, q, K)
        np.testing.assert_array_equal(d, sd.numpy())
        np.testing.assert_array_equal(i, si.numpy())
    assert len(eng.last_latencies) == len(reqs)


def test_matches_jax_serve_engine(served):
    jidx, tidx, reqs = served
    eng = ServeEngine(tidx, K, tivf.SearchParams(n_probes=5), max_batch=64)
    jeng = JaxServeEngine(jidx, K, jax_ivf.SearchParams(n_probes=5),
                          max_batch=64, scheduler=False, admission=False)
    jeng.warmup()
    eng.warmup()
    for (gd, gi), (rd, ri) in zip(eng.search(reqs), jeng.search(reqs)):
        rd, ri = np.asarray(rd), np.asarray(ri)
        np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
        tied = np.zeros_like(rd, dtype=bool)
        close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
        tied[:, 1:] |= close
        tied[:, :-1] |= close
        np.testing.assert_array_equal(gi[~tied], ri[~tied])


def test_bad_request_fails_alone(served):
    _, tidx, reqs = served
    eng = ServeEngine(tidx, K, tivf.SearchParams(n_probes=5), max_batch=64)
    out = eng.search([reqs[1], np.zeros((3, 5), np.float32), reqs[4]])
    assert isinstance(out[1], Exception)
    assert eng.stats["ingest_errors"] == 1
    assert out[0][0].shape == (7, K) and out[2][0].shape == (30, K)


def _assert_close_outside_ties(got, ref):
    for (gd, gi), (rd, ri) in zip(got, ref):
        rd, ri = np.asarray(rd), np.asarray(ri)
        np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
        tied = np.zeros_like(rd, dtype=bool)
        close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
        tied[:, 1:] |= close
        tied[:, :-1] |= close
        np.testing.assert_array_equal(gi[~tied], ri[~tied])


@pytest.fixture(scope="module")
def served_pq():
    rng = np.random.default_rng(1)
    c = rng.uniform(-3, 3, (30, 32))
    x = (c[rng.integers(0, 30, 3000)] + rng.standard_normal((3000, 32))
         ).astype(np.float32)
    jidx = jax_pq.build(jax_pq.IndexParams(n_lists=20, pq_dim=8),
                        jnp.asarray(x))
    tidx = tpq.index_from_arrays(
        {n: np.asarray(getattr(jidx, n)) for n in tpq.ARRAY_FIELDS},
        int(jidx.metric), int(jidx.codebook_kind), jidx.pq_bits,
        jidx.dataset_dtype, device="cpu")
    reqs = [(c[rng.integers(0, 30, n)] + rng.standard_normal((n, 32))
             ).astype(np.float32) for n in SIZES]
    return jidx, tidx, reqs


@pytest.mark.parametrize("lut_dtype", ["float32", "float8_e4m3"])
def test_ivf_pq_coalesced_equals_solo(served_pq, lut_dtype):
    _, tidx, reqs = served_pq
    params = tpq.SearchParams(n_probes=5, lut_dtype=lut_dtype)
    eng = ServeEngine(tidx, K, params, max_batch=64)
    # the fp8 engine clamps its super-batch to the combined-LUT cap
    cap = tpq.hoisted_batch_cap(tidx, 5, lut_dtype)
    assert eng.max_batch == (64 if cap is None else min(64, cap))
    eng.warmup()
    out = eng.search(reqs)
    assert eng.stats["solo_fallbacks"] >= 1
    for q, (d, i) in zip(reqs, out):
        assert d.shape == (q.shape[0], K) and i.dtype == np.int32
        sd, si = tpq.search(params, tidx, q, K)
        np.testing.assert_array_equal(d, sd.numpy())
        np.testing.assert_array_equal(i, si.numpy())


def test_ivf_pq_matches_jax_serve_engine(served_pq):
    jidx, tidx, reqs = served_pq
    eng = ServeEngine(tidx, K, tpq.SearchParams(n_probes=5), max_batch=64)
    jeng = JaxServeEngine(jidx, K, jax_pq.SearchParams(n_probes=5),
                          max_batch=64, scheduler=False, admission=False)
    jeng.warmup()
    eng.warmup()
    _assert_close_outside_ties(eng.search(reqs), jeng.search(reqs))


@pytest.fixture(scope="module")
def served_dense():
    rng = np.random.default_rng(2)
    c = rng.uniform(-3, 3, (30, 16))
    x = (c[rng.integers(0, 30, 1500)] + rng.standard_normal((1500, 16))
         ).astype(np.float32)
    reqs = [(c[rng.integers(0, 30, n)] + rng.standard_normal((n, 16))
             ).astype(np.float32) for n in SIZES]
    return x, reqs


@pytest.mark.parametrize("metric", [DistanceType.L1,
                                    DistanceType.L2SqrtExpanded], ids=str)
def test_brute_force_coalesced_equals_solo(served_dense, metric):
    x, reqs = served_dense
    # index tiles of 512 rows: two full tiles and a ragged one per scan
    eng = ServeEngine(x, K, metric=metric, max_batch=64,
                      batch_size_index=512, device="cpu")
    assert eng.warmup() == 4
    out = eng.search(reqs)
    assert eng.stats["solo_fallbacks"] == 1
    for q, (d, i) in zip(reqs, out):
        assert d.shape == (q.shape[0], K) and i.dtype == np.int32
        sd, si = tbf.knn(x, q, K, metric, batch_size_index=512, device="cpu")
        np.testing.assert_array_equal(d, sd.numpy())
        np.testing.assert_array_equal(i, si.numpy())


@pytest.mark.parametrize("metric", [DistanceType.L1,
                                    DistanceType.L2SqrtExpanded], ids=str)
def test_brute_force_matches_jax_serve_engine(served_dense, metric):
    x, reqs = served_dense
    eng = ServeEngine(x, K, metric=metric, max_batch=64,
                      batch_size_index=512, device="cpu")
    jeng = JaxServeEngine(jnp.asarray(x), K, metric=int(metric),
                          max_batch=64, batch_size_index=512,
                          scheduler=False, admission=False)
    jeng.warmup()
    eng.warmup()
    _assert_close_outside_ties(eng.search(reqs), jeng.search(reqs))
