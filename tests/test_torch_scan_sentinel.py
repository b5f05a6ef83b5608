"""IVF-PQ search when live candidates score the sentinel (±inf), against
raft_tpu.

The reference scans the probed lists with a running merge seeded with
(sentinel, −1) below ``_SCAN_STACK_MIN_K`` = 24, where the seed wins
ties, and with one select over the stacked masked tiles at or above it,
where a live candidate at the sentinel keeps its id.

* End to end, L2: a JAX-built index, saved by ``raft_tpu`` and read by
  ``load_ivf_pq``, is searched by both packages with a batch that holds
  queries so large that every candidate's score overflows to +inf (the
  squared distance to the centre) while no LUT entry does.  At k = 10 and
  k = 32 the port's (distances, ids) equal raft_tpu's on those rows
  exactly and on the others to rtol 1e-5, ids equal where distances are
  not tied; the port's scan mode equals its per-step path bit for bit.
* Both sentinels: per-step scores with live candidates at +inf or −inf
  (and steps with fewer live slots than k) go through raft_tpu's
  ``scan_probe_lists`` and through the port's per-step selects and
  ``_select_scanned``: equal bit for bit for select-min and select-max at
  k = 10 and k = 32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.distance_types import DistanceType as JaxDT
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors import serialize as jax_ser
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import serialize as tser

N_PROBES = 4
#: a query scale whose square overflows float32 (1e40) while its products
#: with the codebooks do not: every L2 score is +inf, every LUT finite
HUGE = 1e20
HUGE_ROWS = (3, 11)


def _data(seed=4, n=2000, d=32, nq=16):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (20, d))
    x = (c[rng.integers(0, 20, n)] + rng.standard_normal((n, d))
         ).astype(np.float32)
    q = (c[rng.integers(0, 20, nq)] + rng.standard_normal((nq, d))
         ).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """(JAX index, the port's index read from its archive, queries), built
    once per module."""
    x, q = _data()
    jidx = jax_pq.build(jax_pq.IndexParams(n_lists=16, pq_dim=8),
                        jnp.asarray(x))
    path = tmp_path_factory.mktemp("pq") / "pq"
    jax_ser.save_ivf_pq(path, jidx)
    q[list(HUGE_ROWS)] = HUGE
    return jidx, tser.load_ivf_pq(path, device="cpu"), q


def _search_both(index, k):
    jidx, tidx, q = index
    ref = jax_pq.search(jax_pq.SearchParams(n_probes=N_PROBES), jidx,
                        jnp.asarray(q), k)
    got = tpq.search(tpq.SearchParams(n_probes=N_PROBES), tidx, q, k,
                     engine="torch")
    return ([np.asarray(a) for a in ref], [t.numpy() for t in got])


@pytest.mark.parametrize("k", [10, 32])
def test_overflowing_queries_match_raft_tpu(index, k):
    (rd, ri), (gd, gi) = _search_both(index, k)
    huge = list(HUGE_ROWS)
    # every candidate of those rows scores the sentinel in both packages
    assert (rd[huge] == np.inf).all()
    np.testing.assert_array_equal(gd[huge], rd[huge])
    np.testing.assert_array_equal(gi[huge], ri[huge])
    if k < 24:
        # the seed (sentinel, −1) wins every tie
        assert (ri[huge] == -1).all()
    else:
        # the stacked select keeps live candidates at the sentinel
        assert (ri[huge] >= 0).all()
    rest = np.setdiff1d(np.arange(rd.shape[0]), huge)
    np.testing.assert_allclose(gd[rest], rd[rest], rtol=1e-5, atol=1e-5)
    r = rd[rest]
    tied = np.zeros_like(r, dtype=bool)
    close = np.isclose(r[:, 1:], r[:, :-1], rtol=1e-5, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(gi[rest][~tied], ri[rest][~tied])


@pytest.mark.parametrize("k", [10, 32])
def test_overflowing_queries_scan_mode_equals_per_step(index, k):
    """Scan mode's plain twin and one select equal the per-step path (raw
    scores, live mask, per-step select, running merge or stacked select)
    bit for bit on the batch with the overflowing queries."""
    from raft_tpu_torch.distance.pairwise import _dot_fixed_rows
    from raft_tpu_torch.matrix.select_k import select_k
    from raft_tpu_torch.neighbors.ivf_flat import _coarse_distances

    _, tidx, q = index
    qs = torch.from_numpy(q)
    coarse = _coarse_distances(qs, tidx.centers, tidx.metric)
    _, probes = select_k(coarse, N_PROBES, select_min=True, engine="torch")
    rot_q = _dot_fixed_rows(qs, tidx.rotation.T)
    inp = tpq.scan_inputs(qs, probes, rot_q, tidx, "float32")
    fused = tpq._select_scanned(*tpq._scan_steps(inp, tidx, k, True, "torch"),
                                inp.phys, tidx.list_indices, k, True,
                                "torch")
    per_step = tpq._scan_per_step(inp, tidx, k, True, "torch", "torch")
    assert torch.equal(fused[0], per_step[0])
    assert torch.equal(fused[1], per_step[1])


@pytest.mark.parametrize("k", [10, 32])
@pytest.mark.parametrize("select_min", [True, False])
def test_select_scanned_matches_raft_tpu_scan(select_min, k):
    from raft_tpu.neighbors._common import scan_probe_lists
    from raft_tpu_torch.matrix.select_k import select_k
    from raft_tpu_torch.neighbors.ivf_pq import _select_scanned

    rng = np.random.default_rng(k + select_min)
    nq, n_steps, cap, n_rows = 12, 5, 40, 9
    sentinel = np.float32(np.inf if select_min else -np.inf)
    sizes = rng.integers(0, cap + 1, n_rows).astype(np.int32)
    sizes[:3] = (cap, 2, 0)
    ids = rng.permutation(n_rows * cap * 2)[:n_rows * cap].astype(
        np.int32).reshape(n_rows, cap)
    ids[np.arange(cap)[None, :] >= sizes[:, None]] = -1
    phys = rng.integers(0, n_rows, (nq, n_steps)).astype(np.int32)
    phys[0] = (1, 2, 2, 1, 2)           # 4 live slots in all, 2 at ±inf
    phys[1] = 0                         # full rows only
    scores = rng.standard_normal((nq, n_steps, cap)).astype(np.float32)
    scores[rng.random(scores.shape) < 0.3] = sentinel
    scores[0, 0, 1] = sentinel
    scores[0, 3, 0] = sentinel
    scores[2] = sentinel                # every candidate at the sentinel

    ref = scan_probe_lists(jnp.asarray(phys),
                           lambda col, s: jnp.asarray(scores)[:, s],
                           jnp.asarray(ids), jnp.asarray(sizes), k,
                           select_min, jnp.float32,
                           xs=(jnp.arange(n_steps),))
    # scan mode's per-step winners: each step's masked tile, its best kk
    kk = min(k, cap)
    t_scores, t_phys = torch.from_numpy(scores), torch.from_numpy(phys)
    live = (torch.arange(cap)[None, None, :]
            < torch.from_numpy(sizes)[t_phys.long()][:, :, None])
    masked = torch.where(live, t_scores, torch.tensor(float(sentinel)))
    runs = [select_k(masked[:, s], kk, select_min, engine="torch")
            for s in range(n_steps)]
    vals = torch.stack([r[0] for r in runs], 1)
    slots = torch.stack([r[1] for r in runs], 1)
    got = _select_scanned(vals, slots, t_phys, torch.from_numpy(ids), k,
                          select_min, "torch")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
