"""Per-type serving ladders: the port's ServeEngine warmed in float32,
bfloat16 and float16 over brute force, IVF-Flat and IVF-PQ (the JAX index
carried across), against the JAX ServeEngine on the same requests.

Brute force and IVF-PQ compute a half-type request in float32 in both
packages (the scan widens it), so their results match the JAX engine's
on the same typed requests: distances to rtol 1e-5, ids equal wherever
distances are not tied.  IVF-Flat: the JAX engine scores a half-type
batch in that type, while the port widens the request exactly to float32
as its solo search does; its half-type results are held to the JAX
engine's float32 ladder on the same requests widened (same tolerance),
and share at least 90 % of the ids of the JAX half-type ladder.  Every
coalesced request is bit for bit its solo search in its own type, and a
super-batch never mixes types.  bfloat16 requests reach the port as
tensors made from the JAX side's ``ml_dtypes`` bits (``.view(np.uint16)``)
or as those arrays themselves."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.serve.engine import ServeEngine as JaxServeEngine
from raft_tpu_torch.core import coststore
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.serve import AutoTuner, ServeEngine, TunerConfig

K = 7
SIZES = (5, 15, 17, 3, 9)
BACKENDS = ("brute_force", "ivf_flat", "ivf_pq")
TYPES = {"float32": (np.float32, torch.float32, jnp.float32),
         "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16),
         "float16": (np.float16, torch.float16, jnp.float16)}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """A JAX-side array as a tensor of its own type (bfloat16 through its
    bits: the port's host has no numpy bfloat16)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    c = rng.uniform(-3, 3, (12, 16))
    x = (c[rng.integers(0, 12, 400)] + rng.standard_normal((400, 16))
         ).astype(np.float32)
    reqs = [(c[rng.integers(0, 12, n)] + rng.standard_normal((n, 16))
             ).astype(np.float32) for n in SIZES]
    return x, reqs


@pytest.fixture(scope="module")
def engines(data):
    """{backend: (jax engine, port engine, port index, port params)},
    both warmed at bucket 32 in all three types."""
    x, _ = data
    jflat = jax_ivf.build(jax_ivf.IndexParams(n_lists=8), jnp.asarray(x))
    jpq = jax_pq.build(jax_pq.IndexParams(n_lists=8, pq_dim=8),
                       jnp.asarray(x))
    tflat = tivf.index_from_arrays(
        {n: np.asarray(getattr(jflat, n)) for n in tivf.ARRAY_FIELDS},
        int(jflat.metric), device="cpu")
    tpqi = tpq.index_from_arrays(
        {n: np.asarray(getattr(jpq, n)) for n in tpq.ARRAY_FIELDS},
        int(jpq.metric), jpq.codebook_kind, jpq.pq_bits, jpq.dataset_dtype,
        device="cpu")
    made = {
        "brute_force": (x, x, None, None),
        "ivf_flat": (jflat, tflat, jax_ivf.SearchParams(n_probes=3),
                     tivf.SearchParams(n_probes=3)),
        "ivf_pq": (jpq, tpqi, jax_pq.SearchParams(n_probes=3),
                   tpq.SearchParams(n_probes=3))}
    out = {}
    for name, (jidx, tidx, jp, tp) in made.items():
        je = JaxServeEngine(jidx, K, jp, max_batch=32, scheduler=False,
                            admission=False)
        je.warmup([32], dtypes=[t[2] for t in TYPES.values()])
        te = ServeEngine(tidx, K, tp, max_batch=32, device="cpu")
        te.warmup([32], dtypes=[t[1] for t in TYPES.values()])
        out[name] = (je, te, tidx, tp)
    yield out
    for _je, te, _t, _p in out.values():
        te.close()


def _typed(reqs, tname):
    return [r.astype(TYPES[tname][0]) for r in reqs]


def _close(d_t, i_t, d_j, i_j):
    d_j = np.asarray(d_j, np.float32)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
    # ids equal wherever the distance is not tied within the tolerance
    same = i_t == np.asarray(i_j)
    tied = np.zeros_like(same)
    tied[:, 1:] |= np.isclose(d_j[:, 1:], d_j[:, :-1], rtol=1e-5)
    tied[:, :-1] |= np.isclose(d_j[:, :-1], d_j[:, 1:], rtol=1e-5)
    assert (same | tied).all()


@pytest.mark.parametrize("tname", list(TYPES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_ladder_matches_jax_engine(engines, data, backend, tname):
    je, te, _, _ = engines[backend]
    typed = _typed(data[1], tname)
    port = te.search([_to_torch(r) for r in typed])
    if backend == "ivf_flat" and tname != "float32":
        ref = je.search([r.astype(np.float32) for r in typed])
        half = je.search(typed)
        hit = np.mean([np.mean(np.asarray(h[1]) == p[1])
                       for h, p in zip(half, port)])
        assert hit >= 0.9
    else:
        ref = je.search(typed)
    for (d_t, i_t), (d_j, i_j) in zip(port, ref):
        assert d_t.dtype == np.float32 and i_t.dtype == np.int32
        _close(d_t, i_t, d_j, i_j)


@pytest.mark.parametrize("backend", BACKENDS)
def test_warmed_signature_keys_equal_jax(engines, backend):
    je, te, _, _ = engines[backend]
    assert te.warmed_signatures() == {k: list(v) for k, v in
                                      je.warmed_signatures().items()}
    assert set(te.warmed_signatures()) == set(TYPES)
    for tname, (_np, tt, jt) in TYPES.items():
        assert te.warmed_buckets(tt) == te.warmed_buckets(tname) \
            == te.warmed_buckets(jt) == [32]


def _solo(backend, tidx, tp, q):
    if backend == "brute_force":
        return tbf.knn(tidx, q, K, device="cpu")
    fam = tivf if backend == "ivf_flat" else tpq
    return fam.search(tp, tidx, q, K)


@pytest.mark.parametrize("tname", list(TYPES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_coalesced_equals_solo_in_own_type(engines, data, backend, tname):
    _, te, tidx, tp = engines[backend]
    reqs = [_to_torch(r) for r in _typed(data[1], tname)]
    sb = te.stats["super_batches"]
    outs = te.search(reqs)
    assert te.stats["super_batches"] - sb == 2   # 49 rows, bucket 32
    for q, (d, i) in zip(reqs, outs):
        sd, si = _solo(backend, tidx, tp, q)
        np.testing.assert_array_equal(d, sd.numpy())
        np.testing.assert_array_equal(i, si.numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_super_batch_never_mixes_types(engines, data, backend):
    """One call of three types: each type packs on its own ladder (the
    IVF-PQ backend widens every float type, so there they share one)."""
    _, te, tidx, tp = engines[backend]
    reqs = [_to_torch(data[1][j].astype(TYPES[t][0])) for j, t in
            enumerate(["float32", "bfloat16", "float16", "bfloat16",
                       "float32"])]
    sb = te.stats["super_batches"]
    outs = te.search(reqs)
    assert te.stats["super_batches"] - sb == (2 if backend == "ivf_pq"
                                              else 3)
    for q, (d, i) in zip(reqs, outs):
        sd, si = _solo(backend, tidx, tp, q)
        np.testing.assert_array_equal(d, sd.numpy())
        np.testing.assert_array_equal(i, si.numpy())


def test_bfloat16_bits_and_ml_dtypes_arrays_agree(engines, data):
    """A bfloat16 request as a tensor, as ``ml_dtypes`` bits, or as its
    two-byte raw items: the same request, the same answer."""
    _, te, _, _ = engines["brute_force"]
    q = data[1][1].astype(ml_dtypes.bfloat16)
    forms = [_to_torch(q), q, q.view("V2")]
    outs = te.search(forms)
    for d, i in outs[1:]:
        np.testing.assert_array_equal(d, outs[0][0])
        np.testing.assert_array_equal(i, outs[0][1])


def test_ivf_pq_widening_and_dataset_type_refusal(engines, data):
    _, te, tidx, tp = engines["ivf_pq"]
    q = data[1][0]
    for t in ("bfloat16", "float16"):
        qi = te._backend.ingest(_to_torch(q.astype(TYPES[t][0])))
        assert qi.dtype == torch.float32
        assert torch.equal(qi, _to_torch(q.astype(TYPES[t][0])).float())
    # an int8 request against a float32-dataset index fails alone
    bad = (q * 10).astype(np.int8)
    outs = te.search([bad, q])
    assert isinstance(outs[0], Exception) and "dataset dtype" in str(
        outs[0])
    np.testing.assert_array_equal(outs[1][1],
                                  _solo("ivf_pq", tidx, tp, q)[1].numpy())
    # ...and is taken, widened, by an int8-dataset index
    xi = np.clip(data[0] * 20, -127, 127).astype(np.int8)
    idx8 = tpq.build(tpq.IndexParams(n_lists=8, pq_dim=8), xi,
                     device="cpu")
    eng = ServeEngine(idx8, K, tp, max_batch=32, device="cpu")
    try:
        eng.warmup([32])
        (d, i), = eng.search([bad])
        sd, si = tpq.search(tp, idx8, bad, K)
        np.testing.assert_array_equal(i, si.numpy())
        np.testing.assert_array_equal(d, sd.numpy())
    finally:
        eng.close()


def test_cost_rows_per_type(data, tmp_path):
    """Service times land in (type, bucket) rows; close() persists every
    type's rows and the next engine over the same program seeds them."""
    x, reqs = data
    prev = coststore.install(str(tmp_path / "costs"))
    try:
        eng = ServeEngine(x, K, max_batch=32, device="cpu")
        eng.warmup([16, 32], dtypes=("float32", "bfloat16"))
        eng.search([_to_torch(r.astype(ml_dtypes.bfloat16)) for r in reqs])
        eng.search(reqs)
        rows = eng._cost.rows()
        assert {dt for dt, _b in rows} == {"float32", "bfloat16"}
        eng.close()
        eng2 = ServeEngine(x, K, max_batch=32, device="cpu")
        assert eng2._cost.rows() == rows
        eng2.close()
    finally:
        coststore.install(prev)


def test_autotuner_replays_per_type(data):
    """Shadow traffic of two types replays on each type's own ladder:
    every request is served, nothing is warmed."""
    x, reqs = data
    eng = ServeEngine(x, K, max_batch=32, device="cpu")
    try:
        eng.warmup([8, 16, 32], dtypes=("float32", "float16"))
        eng.search(reqs)
        eng.search([_to_torch(r.astype(np.float16)) for r in reqs])
        tuner = AutoTuner(eng, TunerConfig(seed=0, shadow_requests=10,
                                           pairs=1))
        sigs = eng.warmed_signatures()
        score = tuner._measure_real(tuner.candidates()[0],
                                    tuner.shadow_traffic(10, 0))
        assert score.served == 1.0
        assert {str(q.dtype) for q in eng.shadow_samples()} == {
            "torch.float32", "torch.float16"}
        tuner.run()
        assert eng.warmed_signatures() == sigs
    finally:
        eng.close()
