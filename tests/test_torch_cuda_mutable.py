"""The mutable index on the card: kernel B4's scan mode with a tombstone
bitmap against the per-step path, the write/read race between a writer
and scans on both stream lanes, and the mutable backend of
``ServeEngine`` at a small size.

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_mutable.py -q -m cuda``.
Tolerances: scan mode bit for bit against raw mode + the PyTorch epilogue
+ the live and tombstone masks + B2 (both sum in m order in one thread);
its plain twin to 1e-5 × Σ_m |lut term| (another summation order).
"""

import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _scan_data(dev, nq, n_steps, cap, pq_dim, pq_bits, lut_dtype, n_luts,
               seed):
    """A random code block (7 rows, the last a dummy), ids, a bitmap that
    kills about 30% of them and every id of row 2, and the scan's
    per-(query, step) inputs."""
    from raft_tpu_torch.neighbors.ivf_pq import _pack_codes

    g = torch.Generator(device="cpu").manual_seed(seed)
    kcb = 1 << pq_bits
    n_rows = 7
    codes = torch.randint(0, kcb, (n_rows * cap, pq_dim), generator=g)
    block = _pack_codes(codes, pq_bits).reshape(n_rows, cap, -1)
    sizes = torch.tensor([cap, cap // 2, 40, 0, cap - 1, 3, 0],
                         dtype=torch.int32)
    n_ids = n_rows * cap * 3
    ids = torch.randperm(n_ids, generator=g)[:n_rows * cap].to(
        torch.int32).reshape(n_rows, cap)
    ids[torch.arange(cap)[None, :] >= sizes[:, None]] = -1
    dead = torch.rand(n_ids, generator=g) < 0.3
    dead[ids[2, :40].long()] = True          # row 2: every slot dead
    words = torch.zeros((n_ids + 31) // 32, dtype=torch.int64)
    nz = torch.nonzero(dead)[:, 0]
    words.index_add_(0, nz >> 5, torch.ones_like(nz) << (nz & 31))
    words = (((words + 2**31) % 2**32) - 2**31).to(torch.int32)
    phys = torch.randint(0, n_rows, (nq, n_steps), generator=g,
                         dtype=torch.int32)
    phys[:, -1] = n_rows - 1
    phys[:, 0] = 2                           # an all-dead first step
    shape = (nq, pq_dim * kcb) if n_luts == 1 else (nq, n_luts, pq_dim * kcb)
    lut = (torch.rand(shape, generator=g) * 400).to(lut_dtype)
    probe_ord = (torch.randint(0, n_luts, (nq, n_steps), generator=g,
                               dtype=torch.int32) if n_luts > 1 else None)
    base = torch.rand(nq, n_steps, generator=g) * 100 - 50
    csum = torch.rand(n_rows, cap, generator=g) * 40 - 20
    scale = (torch.rand(nq, generator=g) * 2 + 0.5
             if lut_dtype == torch.float8_e4m3fn else None)
    out = [block, sizes, ids, words, phys, lut, probe_ord, base, csum, scale]
    return [t.to(dev) if t is not None else None for t in out], dead


@pytest.mark.parametrize("lut_dtype,n_luts", [(torch.float32, 1),
                                              (torch.float8_e4m3fn, 3)])
@pytest.mark.parametrize("nq", [1, 37, 600])
def test_lut_scan_tombstones_equal_per_step(dev, nq, lut_dtype, n_luts):
    """Scan mode with a bitmap: each step's (values, slots) equal raw
    mode + epilogue + both masks + B2 over the candidates in slot order
    (fill slot −1), bit for bit, for kk below and above 24 and a solo
    query (each step split over several blocks); after the one select
    the (distances, ids) equal the per-step path's with the same bitmap,
    and no dead id comes back."""
    from raft_tpu_torch.kernels import ivf_pq_lut, native
    from raft_tpu_torch.kernels.select_k import select_k_blockwise
    from raft_tpu_torch.neighbors._common import (scan_probe_lists,
                                                  tombstone_hit)
    from raft_tpu_torch.neighbors.ivf_pq import _select_scanned

    n_steps, cap, pq_dim, pq_bits = 8, 1100, 16, 8
    (block, sizes, ids, words, phys, lut, probe_ord, base, csum, scale), \
        dead = _scan_data(dev, nq, n_steps, cap, pq_dim, pq_bits, lut_dtype,
                          n_luts, nq + 11)
    kcb = 1 << pq_bits
    slots_all = torch.arange(cap, device=dev)
    engine = "cuda" if dev.type == "cuda" else "torch"

    def step_scores(s):
        rows = phys[:, s]
        d = ivf_pq_lut.lut_score_rows(
            block, rows, ivf_pq_lut._lut_slice(lut, probe_ord, s), pq_dim,
            pq_bits, kcb)
        if scale is not None:
            d = d / scale[:, None]
        return d + base[:, s, None] + csum[rows.long()]

    for k in (10, 40):
        kk = min(k, cap)
        native.reset_launches()
        vals, slots = ivf_pq_lut.lut_scan_topk(
            block, phys, sizes, lut, probe_ord, base, csum, scale, pq_dim,
            pq_bits, kcb, kk, True, ids, words)
        torch.cuda.synchronize()
        assert native.LAUNCHES["lut_scan_tombstones"] == 1
        for s in range(n_steps):
            rows = phys[:, s].long()
            live = ((slots_all[None, :] < sizes[rows][:, None])
                    & ~tombstone_hit(ids[rows], words))
            order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
            d = torch.where(live, step_scores(s), float("inf"))
            rv, rp = select_k_blockwise(torch.gather(d, 1, order), kk)
            rs = torch.where(rp.long() < live.sum(1, keepdim=True),
                             torch.gather(order, 1, rp.long()), -1)
            assert torch.equal(vals[:, s], rv), (k, s)
            assert torch.equal(slots[:, s], rs.to(torch.int32)), (k, s)
        assert bool((slots[:, 0] == -1).all())      # the all-dead step
        got = _select_scanned(vals, slots, phys, ids, k, True, engine)
        ref = scan_probe_lists(phys, lambda rows, s: step_scores(s), ids,
                               sizes, k, select_min=True,
                               dtype=torch.float32, engine=engine,
                               xs=(range(n_steps),), tombstones=words)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        back = got[1][got[1] >= 0].long().cpu()
        assert not bool(dead[back].any())
        pv, ps = ivf_pq_lut.lut_scan_topk_plain(
            block, phys, sizes, lut, probe_ord, base, csum, scale, pq_dim,
            pq_bits, kcb, kk, True, ids, words)
        fin = torch.isfinite(pv)
        assert torch.equal(fin, torch.isfinite(vals))
        assert torch.equal(ps[~fin], slots[~fin])
        assert bool(((vals - pv).abs()[fin]
                     <= 1e-5 * (pv.abs()[fin] + 400.0 * pq_dim)).all())
    # without the two inputs: the unmasked result, as before
    v0, s0 = ivf_pq_lut.lut_scan_topk(block, phys, sizes, lut, probe_ord,
                                      base, csum, scale, pq_dim, pq_bits,
                                      kcb, 10)
    assert bool((s0 >= 0).all())


def _index(kind, dev, n=20_000, dim=32, seed=0):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (64, dim))
    x = (c[rng.integers(0, 64, n)]
         + rng.standard_normal((n, dim))).astype(np.float32)
    if kind == "ivf_flat":
        bp = ivf_flat.IndexParams(n_lists=32, kmeans_n_iters=5)
        sp = ivf_flat.SearchParams(n_probes=8)
        return ivf_flat.build(bp, x, device=dev), x, bp, sp
    bp = ivf_pq.IndexParams(n_lists=32, pq_dim=16, kmeans_n_iters=5)
    sp = ivf_pq.SearchParams(n_probes=8)
    return ivf_pq.build(bp, x, device=dev), x, bp, sp


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_writer_never_races_scans_on_both_lanes(dev, kind):
    """A writer deletes, in batches, the ids the queries find first, and
    upserts rows, while requests of several super-batches run on both
    stream lanes: no result holds an id whose delete returned before the
    request entered the engine."""
    from raft_tpu_torch.neighbors import mutable
    from raft_tpu_torch.serve import ServeEngine

    main, x, bp, sp = _index(kind, dev)
    mut = mutable.MutableIndex(main, x, build_params=bp)
    eng = ServeEngine(mut, 10, sp, max_batch=64)
    eng.warmup()
    rng = np.random.default_rng(1)
    q = x[rng.integers(0, x.shape[0], 256)] + 0.01
    _, first = mutable.search(mut, q, 10, params=sp)
    victims = np.unique(first.cpu().numpy()[:, :3].ravel())
    batches = np.array_split(victims, 40)
    deleted = [0]                       # delete batches that have returned
    reads = [0]                         # reader calls begun
    stop = threading.Event()
    errors = []

    def writer():
        try:
            for b, ids in enumerate(batches):
                # one write batch per read call, so the two interleave
                seen_reads = reads[0]
                while reads[0] == seen_reads and not stop.is_set():
                    stop.wait(0.001)
                if stop.is_set():
                    break
                mut.delete(ids)
                deleted[0] = b + 1
                mut.upsert(rng.random((16, x.shape[1])).astype(np.float32)
                           * 6 - 3, np.arange(100_000 + 16 * b,
                                              100_016 + 16 * b))
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(repr(e))

    t = threading.Thread(target=writer)
    t.start()
    seen = set()
    for _ in range(60):
        done = deleted[0]
        seen.add(done)
        gone = set(np.concatenate(batches[:done]).tolist()) if done else set()
        reads[0] += 1
        outs = eng.search([q[:100], q[100:180], q[180:]])
        for out in outs:
            assert not isinstance(out, BaseException), out
            assert not (set(out[1].ravel().tolist()) & gone)
    stop.set()
    t.join(60)
    assert not errors, errors
    # the reads ran while the writes did
    assert len(seen) > 5 and eng.stats["dispatch_errors"] == 0
    _, i = mutable.search(mut, q, 10, params=sp)
    assert not (set(i.cpu().numpy().ravel().tolist())
                & set(victims.tolist()))


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_mutable_backend_on_card(dev, kind):
    """The mutable backend serves coalesced requests equal to the solo
    search bit for bit; a faulted refresh is contained by the Compactor
    and the next tick promotes; IVF-PQ's scan runs B4 with the mask; at
    full probe coverage IVF-Flat's merged distances equal the compacted
    index's bit for bit."""
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_flat, mutable
    from raft_tpu_torch.serve import ServeEngine
    from raft_tpu_torch.testing import faults

    main, x, bp, sp = _index(kind, dev, n=8_000)
    mut = mutable.MutableIndex(main, x, build_params=bp)
    rng = np.random.default_rng(2)
    mut.upsert(rng.random((300, x.shape[1])).astype(np.float32),
               np.arange(300))
    mut.delete(np.arange(400, 700))
    mut.upsert(rng.random((50, x.shape[1])).astype(np.float32),
               np.arange(9000, 9050))
    eng = ServeEngine(mut, 10, sp, max_batch=64)
    eng.warmup()
    reqs = [x[:7], x[7:40], x[40:41]]
    native.reset_launches()
    outs = eng.search(reqs)
    if kind == "ivf_pq":
        # main and delta
        assert native.LAUNCHES["lut_scan_tombstones"] >= 2
    for r, (d, i) in zip(reqs, outs):
        sd, si = mutable.search(mut, r, 10, params=sp)
        assert np.array_equal(d, sd.cpu().numpy())
        assert np.array_equal(i, si.cpu().numpy())
        assert not (set(i.ravel().tolist()) & set(range(400, 700)))
    if kind == "ivf_flat":
        full = ivf_flat.SearchParams(n_probes=bp.n_lists)
        d0, _ = mutable.search(mut, x[:16], 10, params=full)
    comp = mutable.Compactor(mut, eng, delta_fraction=0.01,
                             tomb_fraction=0.01)
    with faults.plan("refresh:stage=pre_swap:raise"):
        assert comp.tick() is False
    assert comp.errors == 1 and mut.delta_rows == 0
    if kind == "ivf_flat":
        d1, _ = mutable.search(mut, x[:16], 10, params=full)
        assert torch.equal(d0, d1)
    mut.upsert(rng.random((200, x.shape[1])).astype(np.float32),
               np.arange(200))
    assert comp.tick() is True and comp.errors == 1
    assert eng.stats["refreshes"] == 1
    (d, i), = eng.search([x[:5]])
    assert i.shape == (5, 10) and mut.size == 8_000 - 300 + 50
