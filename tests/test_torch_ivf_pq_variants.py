"""Parity of the port's IVF-PQ variants with raft_tpu: PER_CLUSTER
codebooks, ``internal_distance_dtype="float16"`` and the legacy search
(``hoisted_lut=False``).

The JAX package builds PER_CLUSTER indexes (3,000 × 32, n_lists 32,
pq_dim 8) that are carried into the port through ``index_from_arrays``
and through its archives.  Tolerances:

* float32 and bfloat16 LUTs, hoisted or legacy: distances to rtol 1e-5
  and ids equal wherever distances are not tied; bfloat16 up to one
  bfloat16 step on at most 1% of the distances
  (:func:`_assert_search_parity`, the helper of ``test_torch_ivf_pq.py``);
* fp8 LUTs: at least 0.95 of the JAX top-10 kept (the per-query affine
  rounds LUT entries the packages compute an ulp apart to neighbouring
  fp8 values);
* the float16 sum: distances within 2^-9 of the batch's largest distance
  (a float16 step of the summed terms, which the two packages may round
  from LUT entries an ulp apart) and at least 0.95 of the JAX top-10;
* encode: codes equal except where the two nearest codewords of a
  subvector lie within 1e-5 (relative) of each other — sub-cap lists
  train codebooks with duplicated codewords, whose argmin tie can go
  either way; list tables to rtol 1e-5.

The PER_CLUSTER training sample cannot equal the JAX package's (its seed
comes from ``jax.random``), so it is held to its rules; the port-built
index's recall lies within 0.03 of the JAX-built one's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import min_cluster_and_distance as jax_nn
from raft_tpu.distance.distance_types import DistanceType as JaxDT
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors import serialize as jax_ser
from raft_tpu_torch.kernels import ivf_pq_lut
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import serialize

K = 10
METRICS = ["L2Expanded", "L2SqrtExpanded", "InnerProduct"]
PC = jax_pq.CodebookKind.PER_CLUSTER


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
    """JAX-built indexes by (metric, codebook kind), built once."""
    x, q = _data()
    built = {}

    def get(metric="L2Expanded", kind=PC):
        key = (metric, int(kind))
        if key not in built:
            built[key] = jax_pq.build(jax_pq.IndexParams(
                n_lists=32, pq_dim=8, metric=JaxDT[metric],
                codebook_kind=kind), jnp.asarray(x))
        return built[key]

    return get, x, q


def _ties(rd, rtol=1e-5):
    tied = np.zeros_like(rd, dtype=bool)
    close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=rtol, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    return tied


def _assert_search_parity(got, ref, lut_dtype="float32", tie_d=None):
    """``test_torch_ivf_pq.py``'s tolerance: distances to rtol 1e-5 and
    ids identical wherever distances are not tied; bfloat16 LUTs may move
    up to 1% of the distances by one bfloat16 step, and a row holding one
    keeps ≥ 0.9 of the JAX top-10.  *tie_d*, the JAX distances of the
    best k + 1, also marks a tie with the first candidate left out."""
    gd, gi = (t.numpy() for t in got)
    rd, ri = (np.asarray(a) for a in ref)
    close = np.isclose(gd, rd, rtol=1e-5, atol=1e-5)
    if lut_dtype == "float32":
        np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
    else:
        assert np.mean(~close) <= 0.01, np.mean(~close)
        np.testing.assert_allclose(gd, rd, rtol=2.0 ** -7, atol=1e-5)
    exact = close.all(axis=1)
    tied = _ties(rd if tie_d is None else np.asarray(tie_d))[:, :K]
    np.testing.assert_array_equal(gi[exact][~tied[exact]],
                                  ri[exact][~tied[exact]])
    for a, b in zip(gi[~exact], ri[~exact]):
        assert len(set(a) & set(b)) >= 0.9 * K


def _overlap(gi, ri):
    return np.mean([len(set(a) & set(b)) / K
                    for a, b in zip(np.asarray(gi), np.asarray(ri))])


def _both(jidx, tidx, q, **sp):
    ref = jax_pq.search(jax_pq.SearchParams(**sp), jidx, jnp.asarray(q), K)
    got = tpq.search(tpq.SearchParams(**sp), tidx, q, K)
    return got, ref


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_per_cluster_carried_search_matches_jax(jax_index, metric,
                                                lut_dtype):
    get, _, q = jax_index
    jidx = get(metric)
    tidx = _carry(jidx)
    assert tidx.per_cluster and tidx.pq_dim == 8
    assert tuple(tidx.codebooks.shape) == (32, 256, 4)
    got, ref = _both(jidx, tidx, q, n_probes=6, lut_dtype=lut_dtype)
    _assert_search_parity(got, ref, lut_dtype)


@pytest.mark.parametrize("metric", METRICS)
def test_per_cluster_fp8_keeps_the_top10(jax_index, metric):
    get, _, q = jax_index
    jidx = get(metric)
    got, ref = _both(jidx, _carry(jidx), q, n_probes=6,
                     lut_dtype="float8_e4m3")
    assert _overlap(got[1], ref[1]) >= 0.95


def test_per_cluster_archives_both_ways(tmp_path, jax_index):
    get, _, q = jax_index
    jidx = get("L2Expanded")
    jax_ser.save_ivf_pq(tmp_path / "jax", jidx)
    tidx = serialize.load_ivf_pq(tmp_path / "jax", device="cpu")
    carried = _carry(jidx)
    for name in tpq.ARRAY_FIELDS:
        assert torch.equal(getattr(tidx, name), getattr(carried, name))
    assert tidx.codebook_kind == tpq.CodebookKind.PER_CLUSTER
    serialize.save_ivf_pq(tmp_path / "port", tidx)
    back = jax_ser.load_ivf_pq(tmp_path / "port")
    assert back.codebook_kind == PC
    for name in tpq.ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jidx, name)))


def test_per_cluster_v1_archive_recomputes_tables(tmp_path, jax_index):
    """A version 1 archive (no list-side tables) of a PER_CLUSTER index:
    the port recomputes ``list_adc`` / ``list_csum`` from the model and
    the codes, to rtol 1e-5 of the JAX package's."""
    import json
    import zlib

    get, _, _ = jax_index
    jidx = get("L2Expanded")
    arrays = {n: np.asarray(getattr(jidx, n)) for n in tpq.ARRAY_FIELDS
              if n not in ("list_adc", "list_csum")}
    aux = {"metric": 0, "codebook_kind": 1, "pq_bits": 8,
           "dataset_dtype": "float32"}
    header = {"magic": "raft-tpu-index", "version": 1, "kind": "ivf_pq",
              "aux": aux,
              "checksums": {k: zlib.crc32(np.ascontiguousarray(a).tobytes())
                            & 0xFFFFFFFF for k, a in arrays.items()}}
    np.savez(tmp_path / "v1.npz", **arrays, __header__=np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8))
    tidx = serialize.load_ivf_pq(tmp_path / "v1.npz", device="cpu")
    np.testing.assert_allclose(tidx.list_adc.numpy(),
                               np.asarray(jidx.list_adc), rtol=1e-5,
                               atol=1e-4)
    live = (np.arange(tidx.capacity)[None, :]
            < tidx.phys_sizes.numpy()[:, None])
    stored = np.asarray(jidx.list_csum)
    np.testing.assert_allclose(tidx.list_csum.numpy()[live], stored[live],
                               rtol=1e-5, atol=1e-5 * np.abs(stored).max())


def test_per_cluster_encode_and_list_tables(jax_index):
    get, x, _ = jax_index
    jidx = get("L2Expanded")
    tidx = _carry(jidx)
    labels = np.asarray(jax_nn(jnp.asarray(x), jidx.centers).key)
    resid = ((x - np.asarray(jidx.centers)[labels])
             @ np.asarray(jidx.rotation)).astype(np.float32)
    ref = np.asarray(jax_pq._encode(jnp.asarray(resid), jidx.codebooks,
                                    jnp.asarray(labels), True))
    lab_t = torch.from_numpy(labels.astype(np.int64))
    got = tpq._encode(torch.from_numpy(resid), tidx.codebooks, lab_t,
                      True).numpy()
    r, m = np.nonzero(got != ref)
    if r.size:
        cb = np.asarray(jidx.codebooks, np.float64)[labels[r]]  # (n, k, ds)
        sub = resid.reshape(len(x), 8, -1).astype(np.float64)[r, m]
        da = ((sub - cb[np.arange(r.size), got[r, m]]) ** 2).sum(-1)
        db = ((sub - cb[np.arange(r.size), ref[r, m]]) ** 2).sum(-1)
        assert np.all(np.abs(da - db) <= 1e-5 * np.maximum(da, db) + 1e-6)
    assert r.size <= len(x) * 8 // 100
    np.testing.assert_allclose(
        tpq._build_list_adc(tidx.rot_centers, tidx.codebooks, True).numpy(),
        np.asarray(jidx.list_adc), rtol=1e-5, atol=1e-4)
    csum_ref = np.asarray(jax_pq._csum_for_codes(
        jnp.asarray(ref), jnp.asarray(labels), jidx.centers, jidx.rotation,
        jidx.codebooks, True))
    csum = tpq._csum_for_codes(torch.from_numpy(ref.astype(np.int64)),
                               lab_t, tidx.rot_centers, tidx.codebooks,
                               True).numpy()
    np.testing.assert_allclose(csum, csum_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(csum_ref).max())
    packed = tpq._csum_for_packed(tidx.list_codes, tidx.owner,
                                  tidx.rot_centers, tidx.codebooks, 8,
                                  per_cluster=True).numpy()
    live = (np.arange(tidx.capacity)[None, :]
            < tidx.phys_sizes.numpy()[:, None])
    stored = np.asarray(jidx.list_csum)
    np.testing.assert_allclose(packed[live], stored[live], rtol=1e-5,
                               atol=1e-5 * np.abs(stored).max())


def test_per_cluster_extend_matches_jax(jax_index):
    get, x, q = jax_index
    jidx = get("L2Expanded")
    tidx = _carry(jidx)
    rng = np.random.default_rng(9)
    new = x[rng.integers(0, len(x), 400)] + 0.05 * rng.standard_normal(
        (400, x.shape[1])).astype(np.float32)
    ids = np.arange(10_000, 10_400, dtype=np.int32)
    jext = jax_pq.extend(jidx, jnp.asarray(new), jnp.asarray(ids))
    text = tpq.extend(tidx, new, ids)
    np.testing.assert_array_equal(text.list_sizes.numpy(),
                                  np.asarray(jext.list_sizes))
    got, ref = _both(jext, text, q, n_probes=6)
    # the new rows lie next to stored ones and often take their codes,
    # so a tie can also sit just past the k-th candidate
    wide, _ = jax_pq.search(jax_pq.SearchParams(n_probes=6), jext,
                            jnp.asarray(q), K + 1)
    _assert_search_parity(got, ref, tie_d=wide)


def test_cluster_sample_take_matches_jax():
    counts = np.array([0, 3, 255, 256, 257, 1000])
    a = jax_pq._cluster_sample_take(counts, 256,
                                    np.random.default_rng(5))
    b = tpq._cluster_sample_take(counts, 256, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)


def test_per_cluster_training_sample_rules(monkeypatch):
    """The sample each list trains on: a pool at or above the cap enters
    ``cap`` distinct members; a smaller pool enters whole once, its other
    slots drawn from the pool; an empty list trains on zeros."""
    seen = {}
    lloyd = tpq._lloyd_kmeans

    def spy(gen, data, k, iters, engine):
        seen["data"] = data.clone()
        return lloyd(gen, data, k, iters, engine)

    monkeypatch.setattr(tpq, "_lloyd_kmeans", spy)
    rng = np.random.default_rng(2)
    n_lists, pq_dim, ds, k = 4, 2, 3, 16
    cap = max(4 * k, 256)
    sizes = [0, 40, 200, 300]                  # subvectors: × pq_dim
    labels = np.repeat(np.arange(n_lists), sizes)
    resid = rng.standard_normal((labels.size, pq_dim * ds)).astype(
        np.float32)
    out = tpq._train_codebooks_cluster(
        torch.Generator().manual_seed(0), torch.from_numpy(resid),
        torch.from_numpy(labels), n_lists, pq_dim, k, 2, "torch")
    assert tuple(out.shape) == (n_lists, k, ds)
    data = seen["data"].numpy()
    assert data.shape == (n_lists, cap, ds)
    assert not data[0].any() and not out[0].any()
    subs = resid.reshape(-1, ds)
    for lst in range(1, n_lists):
        pool = {tuple(v) for v in subs[np.repeat(labels, pq_dim) == lst]}
        rows = [tuple(v) for v in data[lst]]
        assert set(rows) <= pool
        if len(pool) >= cap:
            assert len(set(rows)) == cap            # no repeats
        else:
            assert set(rows[:len(pool)]) == pool    # whole, once


def test_port_built_per_cluster_recall_matches_jax_built():
    x, q = _data(n=5000, seed=1)
    params = dict(n_lists=32, pq_dim=16, kmeans_n_iters=10)
    jidx = jax_pq.build(jax_pq.IndexParams(codebook_kind=PC, **params),
                        jnp.asarray(x))
    tidx = tpq.build(tpq.IndexParams(
        codebook_kind=tpq.CodebookKind.PER_CLUSTER, **params), x,
        device="cpu")
    assert tidx.per_cluster and tidx.size == 5000
    assert tuple(tidx.codebooks.shape) == (32, 256, 2)
    d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :K]
    _, ri = jax_pq.search(jax_pq.SearchParams(n_probes=8), jidx,
                          jnp.asarray(q), K)
    _, gi = tpq.search(tpq.SearchParams(n_probes=8), tidx, q, K)
    r_jax, r_port = _overlap(ri, truth), _overlap(gi, truth)
    assert r_port >= r_jax - 0.03, (r_port, r_jax)


@pytest.mark.parametrize("hoisted", [True, False])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_float16_internal_distance_matches_jax(jax_index, metric, lut_dtype,
                                               hoisted):
    get, _, q = jax_index
    jidx = get(metric)
    got, ref = _both(jidx, _carry(jidx), q, n_probes=6, lut_dtype=lut_dtype,
                     internal_distance_dtype="float16", hoisted_lut=hoisted)
    gd, rd = got[0].numpy(), np.asarray(ref[0])
    np.testing.assert_allclose(gd, rd, rtol=0,
                               atol=2.0 ** -9 * np.abs(rd).max())
    assert _overlap(got[1], ref[1]) >= 0.95


@pytest.mark.parametrize("kind", ["PER_SUBSPACE", "PER_CLUSTER"])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16",
                                       "float8_e4m3"])
@pytest.mark.parametrize("metric", METRICS)
def test_legacy_search_matches_jax(jax_index, metric, lut_dtype, kind):
    get, _, q = jax_index
    jidx = get(metric, jax_pq.CodebookKind[kind])
    got, ref = _both(jidx, _carry(jidx), q, n_probes=6, lut_dtype=lut_dtype,
                     hoisted_lut=False)
    if lut_dtype == "float8_e4m3":
        assert _overlap(got[1], ref[1]) >= 0.95
    else:
        _assert_search_parity(got, ref, lut_dtype)


def test_hoisted_lut_default(jax_index):
    """``hoisted_lut=None`` (the default) is the hoisted search; only
    ``False`` picks the legacy one."""
    get, _, q = jax_index
    tidx = _carry(get())
    legacy = tpq.search(tpq.SearchParams(6, hoisted_lut=False), tidx, q, K)
    hoisted = tpq.search(tpq.SearchParams(6, hoisted_lut=True), tidx, q, K)
    default = tpq.search(tpq.SearchParams(6), tidx, q, K)
    assert torch.equal(default[0], hoisted[0])
    assert torch.equal(default[1], hoisted[1])
    assert not torch.equal(hoisted[0], legacy[0])


@pytest.mark.parametrize("k", [10, 30])
@pytest.mark.parametrize("acc", [0, 1])
@pytest.mark.parametrize("lut_dtype", ["float32", "float8_e4m3"])
def test_per_cluster_fused_scan_equals_per_step(jax_index, lut_dtype, acc,
                                                k):
    """PER_CLUSTER's per-probe float32 tables (and fp8 combined ones)
    through scan mode's plain twin equal the per-step path bit for bit,
    with the float32 and the float16-rounded-once sums."""
    from raft_tpu_torch.distance.pairwise import _dot_fixed_rows

    get, _, q = jax_index
    tidx = _carry(get())
    for qs in (torch.from_numpy(q[:40]), torch.from_numpy(q[40:41])):
        probes = tpq.coarse_probes(qs, tidx, 6, "torch")
        rot_q = _dot_fixed_rows(qs, tidx.rotation.T)
        inp = tpq.scan_inputs(qs, probes, rot_q, tidx, lut_dtype)
        assert inp.ords is not None and inp.tables.shape[1] == 6
        steps = tpq._scan_steps(inp, tidx, k, True, "torch", acc=acc)
        out = [tpq._select_scanned(*steps, inp.phys, tidx.list_indices, k,
                                   True, "torch"),
               tpq._scan_per_step(inp, tidx, k, True, "torch", "torch",
                                  acc=acc)]
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
def test_sum_types_of_the_plain_lookup(lut_dtype):
    """The plain lookup's float16 sums: the sequential one equals numpy's
    float16 additions in subspace order bit for bit (the JAX package's
    legacy ``lut_step``), the rounded-once one the float32 sum of the
    float16-rounded terms rounded to float16."""
    rng = np.random.default_rng(4)
    nq, cap, pq_dim, bits = 6, 50, 12, 8
    kcb = 1 << bits
    codes = rng.integers(0, kcb, (nq * cap, pq_dim))
    packed = tpq._pack_codes(torch.from_numpy(codes), bits).reshape(
        nq, cap, -1)
    lut = torch.from_numpy((rng.random((nq, pq_dim * kcb)) - 0.4) * 90).to(
        lut_dtype)
    at = codes.reshape(nq, cap, pq_dim) + np.arange(pq_dim) * kcb
    terms = lut.float().numpy()[np.arange(nq)[:, None, None], at]
    seq = np.zeros((nq, cap), np.float16)
    for m in range(pq_dim):
        seq = seq + terms[..., m].astype(np.float16)
    got = ivf_pq_lut._lut_score_plain(packed, lut, pq_dim, bits, kcb,
                                      ivf_pq_lut.SUM_HALF_SEQUENTIAL)
    np.testing.assert_array_equal(got.numpy(), seq.astype(np.float32))
    once = ivf_pq_lut._lut_score_plain(packed, lut, pq_dim, bits, kcb,
                                       ivf_pq_lut.SUM_HALF_ONCE)
    want = terms.astype(np.float16).astype(np.float32).sum(-1)
    np.testing.assert_allclose(once.numpy(), want.astype(np.float16),
                               rtol=2.0 ** -10, atol=0)
    assert torch.equal(once, once.half().float())


def test_hoisted_batch_cap_matches_jax(jax_index):
    """The four cases (PER_SUBSPACE / PER_CLUSTER × float32 / fp8 LUT) and
    the legacy path's absent cap, against the JAX package's."""
    get, _, _ = jax_index
    for kind in (jax_pq.CodebookKind.PER_SUBSPACE, PC):
        jidx = get("L2Expanded", kind)
        tidx = _carry(jidx)
        for lut in ("float32", "float8_e4m3"):
            for hoisted in (True, False):
                assert (tpq.hoisted_batch_cap(tidx, 20, lut, hoisted)
                        == jax_pq.hoisted_batch_cap(jidx, 20, lut, hoisted))
        ip = dataclasses.replace(jidx, metric=JaxDT.InnerProduct)
        tip = _carry(ip)
        assert (tpq.hoisted_batch_cap(tip, 20, "float32")
                == jax_pq.hoisted_batch_cap(ip, 20, "float32", True))
    # PER_CLUSTER builds per-probe tables even at the float32 LUT
    assert tpq.hoisted_batch_cap(_carry(get("L2Expanded", PC)), 20,
                                 "float32") is not None
