"""Parity of the port's IVF-PQ with raft_tpu.

Same seeded numpy inputs through both packages: the code packing is
bit-identical at 4–8 bits and the PCA-balanced rotation equal; on a model
the JAX package trained, the port's encode gives the same codes except at
near-ties and its list-side tables match to rtol 1e-5.  A JAX-built index
carried across with ``index_from_arrays`` searches alike for the three
metrics: float32 LUTs give distances to rtol 1e-5 and ids identical
wherever distances are not tied, bfloat16 LUTs the same up to rounding
flips of single LUT entries (see ``_assert_search_parity``); the fp8 LUT
keeps ≥ 0.95 of the JAX top-10.  A port-built index reaches recall@10 within 0.03 of a
JAX-built one.  JAX indexes are built once per module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import min_cluster_and_distance as jax_nn
from raft_tpu.distance.distance_types import DistanceType as JaxDT
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ivf_pq as tpq

K = 10
METRICS = ["L2Expanded", "L2SqrtExpanded", "InnerProduct"]


def _data(n=3000, d=32, nq=150, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (40, d))
    x = (c[rng.integers(0, 40, n)] + rng.standard_normal((n, d))
         ).astype(np.float32)
    q = (c[rng.integers(0, 40, nq)] + rng.standard_normal((nq, d))
         ).astype(np.float32)
    return x, q


def _carry(jidx):
    arrays = {name: np.asarray(getattr(jidx, name))
              for name in tpq.ARRAY_FIELDS}
    return tpq.index_from_arrays(arrays, int(jidx.metric),
                                 int(jidx.codebook_kind), jidx.pq_bits,
                                 jidx.dataset_dtype, device="cpu")


@pytest.fixture(scope="module")
def jax_index():
    """JAX-built indexes by (metric, pq_bits), built once per module."""
    x, q = _data()
    built = {}

    def get(metric="L2Expanded", pq_bits=8):
        key = (metric, pq_bits)
        if key not in built:
            built[key] = jax_pq.build(
                jax_pq.IndexParams(n_lists=24, pq_dim=8, pq_bits=pq_bits,
                                   metric=JaxDT[metric]), jnp.asarray(x))
        return built[key]

    return get, x, q


def _ties(rd):
    tied = np.zeros_like(rd, dtype=bool)
    close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    return tied


def _assert_search_parity(got, ref, lut_dtype="float32"):
    """Distances to rtol 1e-5, ids identical wherever distances are not
    tied.  A bfloat16 LUT entry that the two packages compute an ulp apart
    in float32 (rotation GEMM, cross sums) can round to neighbouring
    bfloat16 values, moving a score by one bfloat16 step (2^-7 relative):
    there at most 1% of the distances may differ by up to that step, and
    the rows holding one keep ≥ 0.9 of the JAX top-10."""
    gd, gi = (t.numpy() for t in got)
    rd, ri = (np.asarray(a) for a in ref)
    close = np.isclose(gd, rd, rtol=1e-5, atol=1e-5)
    if lut_dtype == "float32":
        np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
    else:
        assert np.mean(~close) <= 0.01, np.mean(~close)
        np.testing.assert_allclose(gd, rd, rtol=2.0 ** -7, atol=1e-5)
    exact = close.all(axis=1)
    tied = _ties(rd)
    np.testing.assert_array_equal(gi[exact][~tied[exact]],
                                  ri[exact][~tied[exact]])
    for a, b in zip(gi[~exact], ri[~exact]):
        assert len(set(a) & set(b)) >= 0.9 * K


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
def test_pack_unpack_bit_identical(pq_bits):
    rng = np.random.default_rng(pq_bits)
    codes = rng.integers(0, 1 << pq_bits, (300, 11))
    ref = np.asarray(jax_pq._pack_codes(jnp.asarray(codes), pq_bits))
    got = tpq._pack_codes(torch.from_numpy(codes), pq_bits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape[1] == tpq._code_bytes(11, pq_bits)
    back = tpq._unpack_codes(got, 11, pq_bits)
    ref_back = np.asarray(jax_pq._unpack_codes(jnp.asarray(ref), 11, pq_bits))
    np.testing.assert_array_equal(back.numpy(), ref_back)
    np.testing.assert_array_equal(back.numpy(), codes)


def test_pca_rotation_and_pq_dim_match():
    rng = np.random.default_rng(3)
    sample = (rng.standard_normal((2000, 16))
              * np.linspace(0.2, 3.0, 16)).astype(np.float32)
    ref = jax_pq._pca_balanced_rotation(sample, 4)
    got = tpq._pca_balanced_rotation(sample, 4)
    np.testing.assert_array_equal(got, ref)
    for dim in (3, 16, 100, 128, 960):
        assert tpq._calc_pq_dim(dim) == jax_pq._calc_pq_dim(dim)


def test_encode_and_list_tables_on_carried_model(jax_index):
    get, x, _ = jax_index
    jidx = get()
    tidx = _carry(jidx)
    labels = np.asarray(jax_nn(jnp.asarray(x), jidx.centers).key)
    resid = ((x - np.asarray(jidx.centers)[labels])
             @ np.asarray(jidx.rotation)).astype(np.float32)
    ref = np.asarray(jax_pq._encode(jnp.asarray(resid), jidx.codebooks,
                                    jnp.asarray(labels), False))
    got = tpq._encode(torch.from_numpy(resid), tidx.codebooks).numpy()
    diff = np.nonzero(got != ref)
    if diff[0].size:
        # a differing code is a near-tie: both codewords lie within 1e-5
        # (relative) of each other for that subvector
        cb = np.asarray(jidx.codebooks, np.float64)
        sub = resid.reshape(len(x), 8, -1).astype(np.float64)
        r, m = diff
        da = ((sub[r, m] - cb[m, got[r, m]]) ** 2).sum(-1)
        db = ((sub[r, m] - cb[m, ref[r, m]]) ** 2).sum(-1)
        assert np.all(np.abs(da - db) <= 1e-5 * np.maximum(da, db) + 1e-6)
    assert diff[0].size <= len(x) * 8 // 1000
    np.testing.assert_allclose(
        tpq._build_list_adc(tidx.rot_centers, tidx.codebooks).numpy(),
        np.asarray(jidx.list_adc), rtol=1e-5, atol=1e-4)
    codes = jnp.asarray(ref)
    csum_ref = np.asarray(jax_pq._csum_for_codes(
        codes, jnp.asarray(labels), jidx.centers, jidx.rotation,
        jidx.codebooks, False))
    csum = tpq._csum_for_codes(torch.from_numpy(ref.astype(np.int64)),
                               torch.from_numpy(np.array(labels)),
                               tidx.rot_centers, tidx.codebooks).numpy()
    np.testing.assert_allclose(csum, csum_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(csum_ref).max())
    # the stored per-candidate sums, re-derived from the packed block
    packed = tpq._csum_for_packed(tidx.list_codes, tidx.owner,
                                  tidx.rot_centers, tidx.codebooks, 8).numpy()
    live = (np.arange(tidx.capacity)[None, :]
            < tidx.phys_sizes.numpy()[:, None])
    stored = np.asarray(jidx.list_csum)
    np.testing.assert_allclose(packed[live], stored[live], rtol=1e-5,
                               atol=1e-5 * np.abs(stored).max())


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_search_carried_index_matches_jax(jax_index, metric, lut_dtype):
    get, _, q = jax_index
    jidx = get(metric)
    tidx = _carry(jidx)
    assert tidx.metric == DistanceType[metric]
    sp_j = jax_pq.SearchParams(n_probes=6, lut_dtype=lut_dtype)
    sp_t = tpq.SearchParams(n_probes=6, lut_dtype=lut_dtype)
    # batch_size_query=64 → batches of 64, 64 and a 22-row tail padded to 32
    ref = jax_pq.search(sp_j, jidx, jnp.asarray(q), K, batch_size_query=64)
    got = tpq.search(sp_t, tidx, q, K, batch_size_query=64, engine="torch")
    _assert_search_parity(got, ref, lut_dtype)
    back = tpq.index_to_arrays(tidx)
    np.testing.assert_array_equal(back["list_codes"],
                                  np.asarray(jidx.list_codes))


@pytest.mark.parametrize("pq_bits", [4, 5])
def test_search_carried_index_narrow_codes(jax_index, pq_bits):
    get, _, q = jax_index
    jidx = get("L2Expanded", pq_bits)
    tidx = _carry(jidx)
    ref = jax_pq.search(jax_pq.SearchParams(n_probes=6), jidx,
                        jnp.asarray(q), K)
    got = tpq.search(tpq.SearchParams(n_probes=6), tidx, q, K)
    _assert_search_parity(got, ref)


@pytest.mark.parametrize("metric", METRICS)
def test_fp8_lut_keeps_the_top10(jax_index, metric):
    get, _, q = jax_index
    jidx = get(metric)
    tidx = _carry(jidx)
    _, ri = jax_pq.search(jax_pq.SearchParams(n_probes=6,
                                              lut_dtype="float8_e4m3"),
                          jidx, jnp.asarray(q), K)
    _, gi = tpq.search(tpq.SearchParams(n_probes=6, lut_dtype="float8_e4m3"),
                       tidx, q, K)
    ri, gi = np.asarray(ri), gi.numpy()
    overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(gi, ri)])
    assert overlap >= 0.95, overlap


def _recall(ids, x, q):
    d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :K]
    return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)])


def test_port_built_index_recall_matches_jax_built():
    x, q = _data(n=5000, seed=1)
    params = dict(n_lists=32, pq_dim=16, kmeans_n_iters=10)
    jidx = jax_pq.build(jax_pq.IndexParams(**params), jnp.asarray(x))
    tidx = tpq.build(tpq.IndexParams(**params), x, device="cpu")
    assert tidx.size == 5000 and tidx.pq_dim == 16
    live = tidx.list_indices[tidx.list_indices >= 0]
    assert torch.equal(torch.sort(live).values,
                       torch.arange(5000, dtype=torch.int32))
    # the rotation is orthonormal (the PCA-balanced basis)
    eye = tidx.rotation.T @ tidx.rotation
    torch.testing.assert_close(eye, torch.eye(32), atol=1e-5, rtol=0)
    _, ri = jax_pq.search(jax_pq.SearchParams(n_probes=8), jidx,
                          jnp.asarray(q), K)
    _, gi = tpq.search(tpq.SearchParams(n_probes=8), tidx, q, K)
    r_jax, r_port = _recall(np.asarray(ri), x, q), _recall(gi.numpy(), x, q)
    assert r_port >= r_jax - 0.03, (r_port, r_jax)


@pytest.mark.parametrize("dim,params", [
    (32, dict(rotation_kind="default")),                  # identity
    (32, dict(rotation_kind="default", force_random_rotation=True)),
    (30, dict()),                        # pq_dim 8 ∤ 30: random (30, 32)
])
def test_rotation_kinds(dim, params):
    x, q = _data(n=2000, d=dim, seed=6)
    idx = tpq.build(tpq.IndexParams(n_lists=16, pq_dim=8, kmeans_n_iters=5,
                                    **params), x, device="cpu")
    rot = idx.rotation
    assert rot.shape == (dim, -(-dim // 8) * 8)
    torch.testing.assert_close(rot @ rot.T, torch.eye(dim), atol=1e-5,
                               rtol=0)
    if params == dict(rotation_kind="default"):
        assert torch.equal(rot, torch.eye(dim))
    _, i = tpq.search(tpq.SearchParams(n_probes=16), idx, q, K)
    assert _recall(i.numpy(), x, q) >= 0.5


def test_integer_dataset_and_extend_into_empty_index():
    x, q = _data(n=1500, seed=4)
    xu = np.clip(x * 20 + 128, 0, 255).astype(np.uint8)
    qu = np.clip(q * 20 + 128, 0, 255).astype(np.uint8)
    ids = np.random.default_rng(5).permutation(10_000)[:1500].astype(np.int32)
    jp = jax_pq.IndexParams(n_lists=12, pq_dim=8, add_data_on_build=False)
    jempty = jax_pq.build(jp, jnp.asarray(xu))
    tempty = _carry(jempty)
    assert tempty.size == 0 and tempty.dataset_dtype == "uint8"
    jidx = jax_pq.extend(jempty, jnp.asarray(xu), jnp.asarray(ids))
    tidx = tpq.extend(tempty, xu, ids)
    np.testing.assert_array_equal(tidx.list_sizes.numpy(),
                                  np.asarray(jidx.list_sizes))
    got = tpq.search(tpq.SearchParams(4), tidx, qu, K)
    ref = jax_pq.search(jax_pq.SearchParams(n_probes=4), jidx,
                        jnp.asarray(qu), K)
    _assert_search_parity(got, ref)
    # float32 queries are accepted against an integer index; int8 are not
    tpq.search(tpq.SearchParams(4), tidx, qu.astype(np.float32), K)
    with pytest.raises(Exception, match="dtype"):
        tpq.search(tpq.SearchParams(4), tidx, qu.astype(np.int8), K)
    with pytest.raises(Exception, match="duplicate"):
        tpq.extend(tempty, xu[:3], np.array([1, 1, 2], np.int32))


def test_empty_batch_and_not_ported_errors(jax_index):
    get, x, q = jax_index
    tidx = _carry(get())
    d, i = tpq.search(tpq.SearchParams(4), tidx, q[:0], K)
    assert d.shape == (0, K) and i.shape == (0, K)
    # extend into a non-empty index is ported: it refuses live ids
    with pytest.raises(ValueError, match="already live"):
        tpq.extend(tidx, x[:10], np.arange(10, dtype=np.int32))
    # build_sharded is ported (tests/test_torch_ann_mnmg.py); it needs a
    # communicator
    with pytest.raises(Exception, match="needs a Comms"):
        tpq.build_sharded(tpq.IndexParams(n_lists=4), x[:200], None)
    # PER_CLUSTER, the float16 sum and the legacy search are ported
    # (tests/test_torch_ivf_pq_variants.py); what stays refused is an
    # unknown codebook kind or internal distance type
    with pytest.raises(Exception, match="codebook_kind"):
        tpq.build(tpq.IndexParams(n_lists=4, codebook_kind=2), x[:200],
                  device="cpu")
    with pytest.raises(Exception, match="internal_distance_dtype"):
        tpq.search(tpq.SearchParams(4, internal_distance_dtype="bfloat16"),
                   tidx, q[:4], K)
    arrays = tpq.index_to_arrays(tidx)
    with pytest.raises(ValueError):
        tpq.index_from_arrays(arrays, 0, codebook_kind=2, device="cpu")
    with pytest.raises(Exception, match="lut_dtype"):
        tpq.search(tpq.SearchParams(4, lut_dtype="int8"), tidx, q[:4], K)


def test_batch_cap_matches_jax(jax_index):
    get, _, _ = jax_index
    jidx = get()
    tidx = _carry(jidx)
    for lut in ("float32", "bfloat16", "float8_e4m3"):
        assert (tpq.hoisted_batch_cap(tidx, 20, lut)
                == jax_pq.hoisted_batch_cap(jidx, 20, lut, True))
    ip = dataclasses.replace(jidx, metric=JaxDT.InnerProduct)
    assert jax_pq.hoisted_batch_cap(ip, 20, "float8_e4m3", True) is None
    tidx.metric = DistanceType.InnerProduct
    assert tpq.hoisted_batch_cap(tidx, 20, "float8_e4m3") is None


@pytest.mark.parametrize("k", [10, 30])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "float16",
                                       "float8_e4m3"])
@pytest.mark.parametrize("metric", METRICS)
def test_fused_scan_equals_per_step_scan(jax_index, metric, lut_dtype, k):
    """On a carried index the scan's fused form (scan mode's plain twin,
    one select over the steps' winners) equals the per-step form (raw
    scores, epilogue, live mask, per-step select, running merge) bit for
    bit, for every LUT type (the fp8 scale included), k below and above
    24, and a solo query."""
    from raft_tpu_torch.distance.pairwise import _dot_fixed_rows
    from raft_tpu_torch.matrix.select_k import select_k
    from raft_tpu_torch.neighbors.ivf_flat import _coarse_distances

    get, _, q = jax_index
    tidx = _carry(get(metric))
    for qs in (torch.from_numpy(q[:40]), torch.from_numpy(q[40:41])):
        coarse = _coarse_distances(qs, tidx.centers, tidx.metric)
        _, probes = select_k(coarse, 6, select_min=True, engine="torch")
        rot_q = _dot_fixed_rows(qs, tidx.rotation.T)
        inp = tpq.scan_inputs(qs, probes, rot_q, tidx, lut_dtype)
        select_min = metric != "InnerProduct"
        steps = tpq._scan_steps(inp, tidx, k, select_min, "torch")
        out = [tpq._select_scanned(*steps, inp.phys, tidx.list_indices, k,
                                   select_min, "torch"),
               tpq._scan_per_step(inp, tidx, k, select_min, "torch",
                                  "torch")]
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1], out[1][1])
