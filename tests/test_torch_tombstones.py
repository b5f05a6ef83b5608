"""The tombstone mask against raft_tpu.

``tombstone_hit`` equals the JAX package's on ids inside, past and below
the bitmap; ``scan_probe_lists`` with a bitmap equals raft_tpu's (values
and ids, exactly: the same float32 scores go in) at k = 10 (the running
merge) and k = 32 (the stacked select), with a step whose every slot is
dead; kernel B4's plain twin with the mask — the IVF-PQ search's scan
mode on the CPU — matches the JAX package's IVF-PQ search through a
``raft_tpu`` ``MutableIndex`` whose main holds the same deletions
(distances rtol 1e-5, ids equal wherever the distances are not tied), and
no deleted id comes back.

One difference is the port's by design: where the probed rows hold fewer
than k live candidates, the JAX package's stacked select (k >= 24) fills
the result with DEAD ids at the sentinel distance; the port gives −1
there, so a deleted id never comes back (ROADMAP §C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import _common as jax_common
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors import mutable as jax_mut
from raft_tpu_torch.kernels import ivf_pq_lut
from raft_tpu_torch.neighbors import _common as tcommon
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import mutable as tmut


def _bitmap(dead_ids, n_words):
    words = np.zeros(n_words, np.uint32)
    for j in dead_ids:
        words[j >> 5] |= np.uint32(1 << (j & 31))
    return words


def test_tombstone_hit_matches_jax():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    ids = np.concatenate([rng.integers(0, 64 * 32, 500),
                          [-1, -7, 0, 64 * 32 - 1, 64 * 32, 10**6]]
                         ).astype(np.int32)
    ref = np.asarray(jax_common.tombstone_hit(jnp.asarray(ids),
                                              jnp.asarray(words)))
    got = tcommon.tombstone_hit(torch.as_tensor(ids),
                                torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), ref)


def _scan_case(seed, nq=9, n_rows=12, cap=24, n_steps=8):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, cap + 1, n_rows).astype(np.int32)
    sizes[3], sizes[-1] = cap, 0                 # row 3 full, dummy empty
    ids = rng.permutation(n_rows * cap * 2)[:n_rows * cap].astype(
        np.int32).reshape(n_rows, cap)
    ids[np.arange(cap)[None, :] >= sizes[:, None]] = -1
    dead = set(rng.choice(ids[ids >= 0], size=ids[ids >= 0].size // 4,
                          replace=False).tolist())
    dead |= set(ids[3].tolist())                 # every slot of row 3
    words = _bitmap(sorted(dead), (n_rows * cap * 2 + 31) // 32)
    probes = rng.integers(0, n_rows - 1, (nq, n_steps)).astype(np.int32)
    probes[:, 1] = 3                             # an all-dead step
    # scores exact in float32 (multiples of 1/64), distinct per query
    table = (rng.permutation(n_rows * cap).reshape(n_rows, cap) / 64.0
             ).astype(np.float32)
    qoff = (np.arange(nq) * 1000.0).astype(np.float32)
    return sizes, ids, dead, words, probes, table, qoff


@pytest.mark.parametrize("k", [10, 32])
@pytest.mark.parametrize("select_min", [True, False])
def test_scan_probe_lists_with_bitmap_matches_jax(k, select_min):
    sizes, ids, dead, words, probes, table, qoff = _scan_case(k)
    ref = jax_common.scan_probe_lists(
        jnp.asarray(probes),
        lambda rows: jnp.asarray(table)[rows] + jnp.asarray(qoff)[:, None],
        jnp.asarray(ids), jnp.asarray(sizes), k, select_min, jnp.float32,
        tombstones=jnp.asarray(words))
    tt = torch.as_tensor(table)
    got = tcommon.scan_probe_lists(
        torch.as_tensor(probes),
        lambda rows: tt[rows.long()] + torch.as_tensor(qoff)[:, None],
        torch.as_tensor(ids), torch.as_tensor(sizes), k, select_min,
        torch.float32, tombstones=torch.from_numpy(words.view(np.int32)))
    rd, ri = (np.asarray(a) for a in ref)
    gd, gi = (t.numpy() for t in got)
    np.testing.assert_array_equal(gd, rd)
    live = np.isfinite(rd)
    assert live.all()            # enough live candidates for every slot
    np.testing.assert_array_equal(gi, ri)
    assert not (set(gi.ravel().tolist()) & dead)


def test_fewer_live_than_k_gives_minus_one_not_dead_ids():
    sizes, ids, dead, words, probes, table, qoff = _scan_case(3, n_steps=2)
    k = 40                       # more than the two steps' live candidates
    ref = jax_common.scan_probe_lists(
        jnp.asarray(probes), lambda rows: jnp.asarray(table)[rows],
        jnp.asarray(ids), jnp.asarray(sizes), k, True, jnp.float32,
        tombstones=jnp.asarray(words))
    tt = torch.as_tensor(table)
    got = tcommon.scan_probe_lists(
        torch.as_tensor(probes), lambda rows: tt[rows.long()],
        torch.as_tensor(ids), torch.as_tensor(sizes), k, True,
        torch.float32, tombstones=torch.from_numpy(words.view(np.int32)))
    rd, ri = (np.asarray(a) for a in ref)
    gd, gi = (t.numpy() for t in got)
    np.testing.assert_array_equal(gd, rd)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(gi[fin], ri[fin])
    assert (gi[~fin] == -1).all()
    # the JAX package's fill holds dead ids at the sentinel
    assert set(ri[~fin].tolist()) & dead


def _assert_search_parity(got, ref):
    gd, gi = (np.asarray(t) for t in got)
    rd, ri = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
    tied = np.zeros_like(rd, dtype=bool)
    close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(gi[~tied], ri[~tied])


@pytest.mark.parametrize("k", [10, 32])
@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
def test_b4_twin_with_mask_matches_jax_mutable_search(k, metric):
    """The port's IVF-PQ scan through B4's plain twin with the bitmap, on
    the JAX package's index, against ``raft_tpu``'s MutableIndex whose main
    holds the same deletions (no delta)."""
    from raft_tpu.distance.distance_types import DistanceType as JaxDT

    rng = np.random.default_rng(5)
    x = rng.random((1536, 24)).astype(np.float32)
    q = rng.random((40, 24)).astype(np.float32)
    jidx = jax_pq.build(jax_pq.IndexParams(n_lists=8, pq_dim=8,
                                           kmeans_n_iters=4, seed=1,
                                           metric=JaxDT[metric]),
                        jnp.asarray(x))
    jm = jax_mut.MutableIndex(jidx, jnp.asarray(x))
    dead = rng.choice(1536, 500, replace=False)
    jm.delete(dead)
    sp = dict(n_probes=4)
    ref = jax_mut.search(jm, jnp.asarray(q), k,
                         params=jax_pq.SearchParams(**sp))
    arrays = {n: np.asarray(getattr(jidx, n)) for n in tpq.ARRAY_FIELDS}
    tidx = tpq.index_from_arrays(arrays, int(jidx.metric), 0, 8,
                                 device="cpu")
    tm = tmut.MutableIndex(tidx, x)
    tm.delete(dead)
    got = tmut.search(tm, q, k, params=tpq.SearchParams(**sp))
    _assert_search_parity(got, ref)
    assert not (set(got[1].numpy().ravel().tolist())
                & set(dead.tolist()))
    # the same scan called on its own: B4's plain twin with the mask
    words = torch.from_numpy(_bitmap(dead, tm._mut_core.n_words)
                             .view(np.int32))
    d, i = tpq._full_search_impl(torch.as_tensor(q), tidx, k, 4, "float32",
                                 ("torch", "torch"), words)
    assert torch.equal(d, got[0]) and torch.equal(i, got[1])


def test_plain_twin_with_mask_drops_dead_slots_inside_the_step():
    """Kernel B4's plain twin: a step whose best kk slots are all dead
    still returns its best live ones (dead slots never enter the
    step's select), and fill slots are −1."""
    g = torch.Generator().manual_seed(1)
    cap, pq_dim, bits, kk = 64, 4, 8, 5
    codes = torch.randint(0, 256, (2, cap, pq_dim), generator=g,
                          dtype=torch.uint8)
    lut = torch.rand(1, pq_dim * 256, generator=g)
    sizes = torch.tensor([cap, 0], dtype=torch.int32)
    ids = torch.arange(2 * cap, dtype=torch.int32).reshape(2, cap)
    phys = torch.tensor([[0, 1]], dtype=torch.int32)
    base = torch.zeros(1, 2)
    v0, s0 = ivf_pq_lut.lut_scan_topk_plain(codes, phys, sizes, lut, None,
                                            base, None, None, pq_dim, bits,
                                            256, kk)
    dead = s0[0, 0].long()                       # kill the step's best kk
    words = torch.from_numpy(_bitmap(dead.tolist(), 4).view(np.int32))
    v1, s1 = ivf_pq_lut.lut_scan_topk_plain(codes, phys, sizes, lut, None,
                                            base, None, None, pq_dim, bits,
                                            256, kk, True, ids, words)
    scores = ivf_pq_lut._lut_score_plain(codes[:1], lut, pq_dim, bits, 256)
    scores[0, dead] = float("inf")
    best = torch.sort(scores[0], stable=True)
    assert torch.equal(v1[0, 0], best.values[:kk])
    assert torch.equal(s1[0, 0], best.indices[:kk].to(torch.int32))
    assert bool((s1[0, 1] == -1).all()) and bool(torch.isinf(v1[0, 1]).all())
    assert bool((s0[0, 1] == torch.arange(kk)).all())   # unmasked: as before
