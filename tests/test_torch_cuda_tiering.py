"""Slice 10 on the card: kernel B4's scan mode with PER_CLUSTER's float32
per-probe tables and with the float16 sum, B4's raw mode with the
sequential float16 sum, and tiered ≡ resident with staged tiles racing the
scans on both lanes.

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_tiering.py -q -m cuda``.
Tolerances: scan mode bit for bit against the per-step path (raw mode +
the PyTorch epilogue + B2, each score summed in m order by one thread,
with the same sum type); the float32 and the sequential float16 sums bit
for bit against the plain twin where the twin sums in the same order
(the sequential one); the float16-rounded-once sum within one float16
step of the raw sum (2^-10 of its terms' magnitude: the twin's float32
sum runs in another order before the one rounding) and the float32 sum
within 1e-5 of Σ|terms|.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _data(n=20_000, dim=32, nq=300, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (64, dim))
    x = (c[rng.integers(0, 64, n)]
         + rng.standard_normal((n, dim))).astype(np.float32)
    q = (c[rng.integers(0, 64, nq)]
         + rng.standard_normal((nq, dim))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def pc_index():
    from raft_tpu_torch.neighbors import ivf_pq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, q = _data()
    idx = ivf_pq.build(ivf_pq.IndexParams(
        n_lists=32, pq_dim=16, kmeans_n_iters=5,
        codebook_kind=ivf_pq.CodebookKind.PER_CLUSTER), x, device="cuda")
    return idx, x, q


def _batch(idx, q, n_probes, lut_dtype):
    from raft_tpu_torch.distance.pairwise import _dot_fixed_rows
    from raft_tpu_torch.neighbors import ivf_pq

    probes = ivf_pq.coarse_probes(q, idx, n_probes, "cuda")
    rot_q = _dot_fixed_rows(q, idx.rotation.T)
    return ivf_pq.scan_inputs(q, probes, rot_q, idx, lut_dtype)


@pytest.mark.parametrize("acc", [0, 1])
@pytest.mark.parametrize("nq", [1, 8, 300])
def test_scan_per_probe_f32_tables_equal_per_step(dev, pc_index, nq, acc):
    """PER_CLUSTER's float32 tables (one per (query, probe)) through
    scan mode equal the per-step path bit for bit, plain sum and the
    float16 flag, at a solo query, 8 queries (split steps) and the
    batch; the plain twin agrees within the module's tolerances."""
    from raft_tpu_torch.kernels import ivf_pq_lut, native
    from raft_tpu_torch.neighbors import ivf_pq

    idx, _, q = pc_index
    qt = torch.as_tensor(q[:nq], device=dev)
    inp = _batch(idx, qt, 8, "float32")
    assert inp.ords is not None and inp.tables.dtype == torch.float32
    kcb = idx.codebooks.shape[1]
    for k in (10, 40):
        native.reset_launches()
        vals, slots = ivf_pq_lut.lut_scan_topk(
            idx.list_codes, inp.phys, idx.phys_sizes, inp.tables, inp.ords,
            inp.base, inp.csum, inp.scale, idx.pq_dim, idx.pq_bits, kcb,
            min(k, idx.capacity), True, acc=acc)
        assert native.LAUNCHES["lut_scan"] == 1
        got = ivf_pq._select_scanned(vals, slots, inp.phys,
                                     idx.list_indices, k, True, "cuda")
        ref = ivf_pq._scan_per_step(inp, idx, k, True, "cuda", "cuda",
                                    acc=acc)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        pv, _ = ivf_pq_lut.lut_scan_topk_plain(
            idx.list_codes, inp.phys, idx.phys_sizes, inp.tables, inp.ords,
            inp.base, inp.csum, inp.scale, idx.pq_dim, idx.pq_bits, kcb,
            min(k, idx.capacity), True, acc=acc)
        fin = torch.isfinite(pv)
        assert torch.equal(fin, torch.isfinite(vals))
        terms = idx.pq_dim * float(inp.tables.abs().max())
        tol = (2.0 ** -10 if acc else 1e-5) * terms + 1e-5 * pv.abs()
        assert bool(((vals - pv).abs() <= tol)[fin].all())


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("shape", [(1, 1000, 64, 8), (37, 257, 16, 8),
                                   (37, 333, 17, 7), (5, 999, 10, 5)])
def test_raw_mode_float16_sums(dev, shape, lut_dtype):
    """Raw mode's sequential float16 sum equals its plain twin bit for
    bit; the rounded-once sum lies within one float16 step of it."""
    from raft_tpu_torch.kernels import ivf_pq_lut
    from raft_tpu_torch.neighbors.ivf_pq import _pack_codes

    nq, cap, pq_dim, bits = shape
    kcb = 1 << bits
    g = torch.Generator(device="cpu").manual_seed(nq * cap + bits)
    codes = torch.randint(0, kcb, (5 * cap, pq_dim), generator=g)
    block = _pack_codes(codes, bits).reshape(5, cap, -1).to(dev)
    rows = torch.randint(0, 5, (nq,), generator=g,
                         dtype=torch.int32).to(dev)
    lut = ((torch.rand(nq, pq_dim * kcb, generator=g) - 0.3) * 60).to(
        lut_dtype).to(dev)
    gathered = block[rows.long()]
    seq = ivf_pq_lut.lut_score_rows(block, rows, lut, pq_dim, bits, kcb,
                                    ivf_pq_lut.SUM_HALF_SEQUENTIAL)
    seq_ref = ivf_pq_lut._lut_score_plain(gathered, lut, pq_dim, bits, kcb,
                                          ivf_pq_lut.SUM_HALF_SEQUENTIAL)
    assert torch.equal(seq, seq_ref)
    once = ivf_pq_lut.lut_score_rows(block, rows, lut, pq_dim, bits, kcb,
                                     ivf_pq_lut.SUM_HALF_ONCE)
    once_ref = ivf_pq_lut._lut_score_plain(gathered, lut, pq_dim, bits, kcb,
                                           ivf_pq_lut.SUM_HALF_ONCE)
    mag = ivf_pq_lut._lut_score_plain(gathered, lut.float().abs(), pq_dim,
                                      bits, kcb)
    assert bool(((once - once_ref).abs() <= 2.0 ** -10 * mag).all())
    # every float16 sum is a float16 value
    assert torch.equal(once, once.half().float())
    assert torch.equal(seq, seq.half().float())


def _resident_and_tiered(kind, dev, tile_phys):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, tiering

    x, q = _data(n=30_000, nq=512, seed=3)
    if kind == "ivf_flat":
        idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=64,
                                                  kmeans_n_iters=5),
                             x, device=dev)
        sp = ivf_flat.SearchParams(n_probes=12)
    else:
        idx = ivf_pq.build(ivf_pq.IndexParams(n_lists=64, pq_dim=16,
                                              kmeans_n_iters=5),
                           x, device=dev)
        sp = ivf_pq.SearchParams(n_probes=12)
    t = tiering.tier(idx, hot_fraction=0.25, tile_phys=tile_phys, dataset=x)
    assert all(a.is_pinned() for tile in t.cold_tiles for a in tile)
    return idx, t, sp, q


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_tiered_equals_resident_with_staging_racing_scans(dev, kind):
    """Many small cold tiles, each copied on the lane the previous one
    did not use while the scan stream is held busy: the tiered engine's
    results equal the resident engine's bit for bit for every request of
    several coalesced calls (which alternate the engine's lanes)."""
    from raft_tpu_torch.neighbors import tiering
    from raft_tpu_torch.serve import ServeEngine

    idx, t, sp, q = _resident_and_tiered(kind, dev, tile_phys=7)
    assert len(t.cold_tiles) >= 8
    resident = ServeEngine(idx, 10, sp, max_batch=128)
    tiered = ServeEngine(t, 10, sp, max_batch=128)
    resident.warmup()
    tiered.warmup()
    reqs = [q[a:b] for a, b in ((0, 100), (100, 101), (101, 300),
                                (300, 333), (333, 512))]
    for _ in range(3):
        want = resident.search(reqs)
        torch.cuda._sleep(20_000_000)        # the lanes' scans run late
        got = tiered.search(reqs)
        for (wd, wi), (gd, gi) in zip(want, got):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gd, wd)
    # eager searches on the current stream, held busy before each
    for _ in range(3):
        torch.cuda._sleep(20_000_000)
        got = tiering.search(t, q, 10, params=sp)
        want = resident._backend.solo(q)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    stats = tiered._health()["tiering"]
    assert stats["device_bytes"] < sum(
        v.numel() * v.element_size() for v in vars(idx).values()
        if isinstance(v, torch.Tensor))
    resident.close()
    tiered.close()


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_load_tiered_keeps_the_family_on_the_host(dev, kind, tmp_path):
    """``load_tiered`` restores the family leaves on the host and puts
    only the model tables and the hot block on the card; the loaded index
    searches with the resident index's bits."""
    from raft_tpu_torch.neighbors import serialize, tiering

    idx, t, sp, q = _resident_and_tiered(kind, dev, tile_phys=64)
    serialize.save_tiered(tmp_path / "tiered", t)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    back = serialize.load_tiered(tmp_path / "tiered")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    assert all(v.device.type == "cpu" for v in back.host.values()
               if isinstance(v, torch.Tensor))
    assert all(a.is_pinned() for tile in back.cold_tiles for a in tile)
    assert held <= back.device_bytes() + (1 << 20)
    got = tiering.search(back, q, 10, params=sp)
    want = tiering.search(t, q, 10, params=sp)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
