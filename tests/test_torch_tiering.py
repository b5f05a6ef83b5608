"""The port's host/device tiering against the resident index and against
raft_tpu.

The reference's ``tests/test_tiering.py`` cases in the port: tiered search
equals the resident family search bit for bit over kind × query dtype ×
hot fraction with ragged cold tiles (``tile_phys=17``), at wide k and
after ``retier``; the exact re-rank lifts IVF-PQ recall, refuses without
a dataset and rebuilds IVF-Flat's store from its own rows; the archives
round-trip.  Then against raft_tpu on one carried index (the same
``Index`` leaves in both packages): the port's tiered search gives the
JAX package's ids wherever distances are not tied and its distances to
rtol 1e-5 plus 1e-6 × 2‖q‖² (``_assert_parity``), and ``save_tiered`` archives are read
across in both directions.  The tiered ServeEngine backend serves
coalesced requests equal to solo ``tiering.search`` and re-tiers through
``refresh``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as jax_flat
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors import serialize as jax_ser
from raft_tpu.neighbors import tiering as jax_tiering
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, serialize, tiering

K = 10


def make_data(n=3000, dim=32, n_queries=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, dim)).astype(np.float32)
    q = (x[:n_queries]
         + 0.01 * rng.normal(0, 1, (n_queries, dim)).astype(np.float32))
    return x, q


def build_index(kind, x):
    if kind == "ivf_flat":
        return ivf_flat.build(ivf_flat.IndexParams(n_lists=32, seed=1), x,
                              device="cpu")
    return ivf_pq.build(ivf_pq.IndexParams(n_lists=32, pq_dim=8, pq_bits=8,
                                           seed=1), x, device="cpu")


def _mod(kind):
    return ivf_flat if kind == "ivf_flat" else ivf_pq


def family_search(kind, index, q, k, n_probes=8):
    mod = _mod(kind)
    return mod.search(mod.SearchParams(n_probes=n_probes), index, q, k)


def assert_same(a, b, msg=""):
    assert torch.equal(a[1], b[1]), f"indices differ {msg}"
    assert torch.equal(a[0], b[0]), f"distances differ {msg}"


@pytest.fixture(scope="module")
def built():
    x, q = make_data()
    return x, q, {kind: build_index(kind, x)
                  for kind in ("ivf_flat", "ivf_pq")}


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hot_fraction", [0.0, 0.5, 1.0])
def test_grid(built, kind, dtype, hot_fraction):
    x, q, idx = built
    qt = torch.from_numpy(q).to(getattr(torch, dtype))
    full = family_search(kind, idx[kind], qt, K)
    # tile_phys=17 forces ragged cold tiles
    t = tiering.tier(idx[kind], hot_fraction=hot_fraction, tile_phys=17)
    cold_rows = t.n_phys - t.hot_rows
    assert len(t.cold_tiles) == -(-cold_rows // 17)
    if hot_fraction == 0.0:
        assert len(t.cold_tiles) >= 2 and cold_rows % 17
    out = tiering.search(t, qt, K, params=_mod(kind).SearchParams(8))
    assert_same(full, out, f"({kind}, {dtype}, hot={hot_fraction})")


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_wide_k_stacked_scan(built, kind):
    x, q, idx = built
    full = family_search(kind, idx[kind], q, 40, n_probes=12)
    t = tiering.tier(idx[kind], hot_fraction=0.5, tile_phys=23)
    out = tiering.search(t, q, 40, params=_mod(kind).SearchParams(12))
    assert_same(full, out, f"({kind}, k=40)")


@pytest.mark.parametrize("variant", ["per_cluster", "float16", "legacy",
                                     "fp8"])
def test_ivf_pq_variants_tier_bit_identical(variant):
    """The slice's IVF-PQ variants hold the tiered ≡ resident contract:
    PER_CLUSTER tables, the float16 sum, the legacy scan, the fp8 LUT."""
    x, q = make_data()
    kw = dict(n_lists=32, pq_dim=8, seed=1)
    if variant == "per_cluster":
        kw["codebook_kind"] = ivf_pq.CodebookKind.PER_CLUSTER
    index = ivf_pq.build(ivf_pq.IndexParams(**kw), x, device="cpu")
    sp = ivf_pq.SearchParams(
        n_probes=8,
        internal_distance_dtype="float16" if variant == "float16"
        else "float32",
        hoisted_lut=variant != "legacy",
        lut_dtype="float8_e4m3" if variant == "fp8" else "float32")
    full = ivf_pq.search(sp, index, q, K)
    t = tiering.tier(index, hot_fraction=0.3, tile_phys=17)
    assert_same(full, tiering.search(t, q, K, params=sp), variant)


def test_retier_preserves_results(built):
    x, q, idx = built
    full = family_search("ivf_pq", idx["ivf_pq"], q, K)
    t = tiering.tier(idx["ivf_pq"], hot_fraction=0.25, tile_phys=16)
    s = t.searcher(K, ivf_pq.SearchParams(n_probes=8))
    tiering.search(t, q, K, params=ivf_pq.SearchParams(n_probes=8))
    hot = s.hotness()
    assert hot.sum() == q.shape[0] * 8
    r0 = tiering.tier_counters.get("retiers", 0)
    t2 = tiering.retier(t, hot, tile_phys=31)
    assert tiering.tier_counters.get("retiers", 0) == r0 + 1
    # the hottest lists moved onto the device
    assert t2.hot_lists[np.argsort(-hot, kind="stable")[0]]
    out = tiering.search(t2, q, K, params=ivf_pq.SearchParams(n_probes=8))
    assert_same(full, out, "(after retier)")
    back = tiering.to_index(t2)
    for name in ivf_pq.ARRAY_FIELDS:
        assert torch.equal(getattr(back, name), getattr(idx["ivf_pq"], name))


def test_tier_stats_and_staging_counters(built):
    x, q, idx = built
    t = tiering.tier(idx["ivf_flat"], hot_fraction=0.5, tile_phys=17)
    s = t.searcher(K, ivf_flat.SearchParams(8))
    b0 = tiering.tier_counters.get("prefetch_bytes", 0)
    c0 = tiering.tier_counters.get("cold_tiles", 0)
    tiering.search(t, q, K, params=ivf_flat.SearchParams(8))
    assert (tiering.tier_counters.get("cold_tiles", 0) - c0
            == len(t.cold_tiles))
    assert (tiering.tier_counters.get("prefetch_bytes", 0) - b0
            == len(t.cold_tiles) * t.tile_bytes())
    st = s.tier_stats()
    assert (st["hot_rows"] + sum(int(c.sum()) for c in t.cold_counts)
            == st["total_rows"])
    assert st["cold_tiles"] == len(t.cold_tiles) and st["tile_bytes"] > 0
    resident = sum(getattr(idx["ivf_flat"], f).numel()
                   * getattr(idx["ivf_flat"], f).element_size()
                   for f in ("list_data", "list_indices", "list_norms"))
    assert st["device_bytes"] < resident


def test_refine_lifts_recall():
    # the reference's triage configuration: refine_ratio=4 at n_probes=16
    # lifts recall@10 past 0.85 while the unrefined scan stays under 0.75
    x, q = make_data(n_queries=256)
    index = build_index("ivf_pq", x)
    t = tiering.tier(index, hot_fraction=0.5, dataset=x)
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :K]

    def recall(i):
        return sum(len(set(r.tolist()) & set(g.tolist()))
                   for r, g in zip(i.numpy(), truth)) / truth.size

    plain = tiering.search(t, q, K, params=ivf_pq.SearchParams(n_probes=16))
    refined = tiering.search(t, q, K, params=ivf_pq.SearchParams(
        n_probes=16, refine_ratio=4))
    r_plain, r_ref = recall(plain[1]), recall(refined[1])
    assert r_plain <= 0.75, r_plain
    assert r_ref >= 0.85, (r_plain, r_ref)


def test_pq_refine_requires_dataset(built):
    x, q, idx = built
    t = tiering.tier(idx["ivf_pq"], hot_fraction=0.5)
    with pytest.raises(Exception, match="refine"):
        tiering.search(t, q, K, params=ivf_pq.SearchParams(
            n_probes=8, refine_ratio=4))


def test_ivf_flat_refine_store_self_builds(built):
    x, q, idx = built
    t = tiering.tier(idx["ivf_flat"], hot_fraction=0.5)
    np.testing.assert_array_equal(t.refine_store.numpy(), x)
    out = tiering.search(t, q, K, params=ivf_flat.SearchParams(
        n_probes=8, refine_ratio=2))
    full = family_search("ivf_flat", idx["ivf_flat"], q, K)
    assert torch.equal(out[1], full[1])


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_roundtrip(tmp_path, built, kind):
    x, q, idx = built
    t = tiering.tier(idx[kind], hot_fraction=0.5, tile_phys=17,
                     dataset=x if kind == "ivf_pq" else None)
    path = tmp_path / "tiered"
    serialize.save_tiered(path, t)
    t2 = serialize.load_tiered(path, device="cpu")
    sp = _mod(kind).SearchParams(n_probes=8)
    assert_same(tiering.search(t, q, K, params=sp),
                tiering.search(t2, q, K, params=sp), f"({kind} roundtrip)")
    assert t2.tile_phys == t.tile_phys
    assert len(t2.cold_tiles) == len(t.cold_tiles)
    np.testing.assert_array_equal(t2.hot_lists, t.hot_lists)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_load_tiered_restores_on_the_host(tmp_path, built, monkeypatch,
                                          kind):
    """``load_tiered`` restores the family index on the host and tiers it
    onto the asked device (so an index larger than the card loads): the
    index handed to ``tier`` lies on the CPU, the device is the caller's,
    and the loaded index searches with the saved one's bits."""
    x, q, idx = built
    t = tiering.tier(idx[kind], hot_fraction=0.5, tile_phys=17,
                     dataset=x if kind == "ivf_pq" else None)
    serialize.save_tiered(tmp_path / "tiered", t)
    seen = []
    tier = tiering.tier

    def spy(index, **kw):
        seen.append((index.device, kw.get("device")))
        return tier(index, **kw)

    monkeypatch.setattr(tiering, "tier", spy)
    back = serialize.load_tiered(tmp_path / "tiered", device="cpu")
    assert seen == [(torch.device("cpu"), torch.device("cpu"))]
    assert all(v.device.type == "cpu" for v in back.host.values()
               if isinstance(v, torch.Tensor))
    sp = _mod(kind).SearchParams(n_probes=8)
    assert_same(tiering.search(t, q, K, params=sp),
                tiering.search(back, q, K, params=sp), f"({kind} load)")


def test_serve_engine_tiered_backend(built):
    from raft_tpu_torch.serve import ServeEngine

    x, q, idx = built
    t = tiering.tier(idx["ivf_pq"], hot_fraction=0.5, tile_phys=17,
                     dataset=x)
    sp = ivf_pq.SearchParams(n_probes=8, refine_ratio=4)
    eng = ServeEngine(t, K, sp, max_batch=64)
    assert eng.backend == "tiered_ivf_pq"
    eng.warmup()
    s = t.searcher(K, sp)
    assert s.hotness().sum() == 0          # warm runs count nothing
    reqs = [q[:40], q[7:19], q[:64]]
    outs = eng.search(reqs)
    for j, req in enumerate(reqs):
        solo = tiering.search(t, req, K, params=sp)
        np.testing.assert_array_equal(outs[j][1], solo[1].numpy())
        np.testing.assert_array_equal(outs[j][0], solo[0].numpy())
    assert eng._health()["tiering"]["cold_tiles"] == len(t.cold_tiles)
    # re-tiering from the served counts swaps through refresh
    before = eng.search([q[:32]])[0]
    t2 = tiering.retier(t, eng._backend.searcher.hotness(), tile_phys=31)
    eng.refresh(t2)
    after = eng.search([q[:32]])[0]
    np.testing.assert_array_equal(before[1], after[1])
    np.testing.assert_array_equal(before[0], after[0])
    eng.close()


def _jax_family(kind, idx):
    """The port-built *idx* carried into the JAX package."""
    if kind == "ivf_flat":
        return jax_flat.Index(
            **{n: jnp.asarray(getattr(idx, n).numpy())
               for n in ivf_flat.ARRAY_FIELDS},
            metric=jax_flat.DistanceType(int(idx.metric)))
    return jax_pq.Index(
        **{n: jnp.asarray(getattr(idx, n).numpy())
           for n in ivf_pq.ARRAY_FIELDS},
        metric=jax_pq.DistanceType(int(idx.metric)),
        codebook_kind=jax_pq.CodebookKind(int(idx.codebook_kind)),
        pq_bits=idx.pq_bits)


def _assert_parity(got, ref, q):
    """Distances to rtol 1e-5 plus 1e-6 × 2‖q‖² (the expanded form
    ‖q‖² + ‖x‖² − 2q·x rounds at the norms' scale, and these queries lie
    next to dataset rows), ids equal wherever distances are not tied."""
    gd, gi = (t.numpy() for t in got)
    rd, ri = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(gd, rd, rtol=1e-5,
                               atol=2e-6 * float((q * q).sum(1).max()))
    tied = np.zeros_like(rd, dtype=bool)
    close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(gi[~tied], ri[~tied])


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_tiered_search_matches_raft_tpu(built, kind):
    x, q, idx = built
    jidx = _jax_family(kind, idx[kind])
    jt = jax_tiering.tier(jidx, hot_fraction=0.4, tile_phys=17)
    t = tiering.tier(idx[kind], hot_lists=jt.hot_lists, tile_phys=17)
    np.testing.assert_array_equal(t.hot_lists, jt.hot_lists)
    jsp = (jax_flat if kind == "ivf_flat" else jax_pq).SearchParams(8)
    _assert_parity(tiering.search(t, q, K, _mod(kind).SearchParams(8)),
                   jax_tiering.search(jt, jnp.asarray(q), K, params=jsp), q)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_tiered_archives_read_across(tmp_path, built, kind):
    x, q, idx = built
    t = tiering.tier(idx[kind], hot_fraction=0.5, tile_phys=17,
                     dataset=x if kind == "ivf_pq" else None)
    serialize.save_tiered(tmp_path / "port", t)
    jt = jax_ser.load_tiered(tmp_path / "port")
    np.testing.assert_array_equal(jt.hot_lists, t.hot_lists)
    assert jt.tile_phys == t.tile_phys
    assert len(jt.cold_tiles) == len(t.cold_tiles)
    jsp = (jax_flat if kind == "ivf_flat" else jax_pq).SearchParams(8)
    sp = _mod(kind).SearchParams(8)
    _assert_parity(tiering.search(t, q, K, sp),
                   jax_tiering.search(jt, jnp.asarray(q), K, params=jsp), q)
    jax_ser.save_tiered(tmp_path / "jax", jt)
    back = serialize.load_tiered(tmp_path / "jax", device="cpu")
    np.testing.assert_array_equal(back.hot_lists, t.hot_lists)
    assert_same(tiering.search(t, q, K, sp), tiering.search(back, q, K, sp),
                f"({kind}, read from the JAX archive)")
    if kind == "ivf_pq":
        np.testing.assert_array_equal(back.refine_store.numpy(), x)
