"""Parity of the port's IVF-Flat with raft_tpu.

An index the JAX package built is carried across with
``index_from_arrays`` and searched by both packages: ids identical
wherever the distances are not tied, distances to rtol 1e-5, for all four
metrics and a bucketed tail batch.  A port-built index reaches recall@10
within 0.02 of the JAX-built one against exact neighbours.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.distance_types import DistanceType as JaxDT
from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ivf_flat as tivf

K = 10


def _data(n=3000, d=16, nq=150, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (40, d))
    x = (c[rng.integers(0, 40, n)] + rng.standard_normal((n, d))
         ).astype(np.float32)
    q = (c[rng.integers(0, 40, nq)] + rng.standard_normal((nq, d))
         ).astype(np.float32)
    return x, q


def _carry(jidx):
    arrays = {name: np.asarray(getattr(jidx, name))
              for name in tivf.ARRAY_FIELDS}
    return tivf.index_from_arrays(arrays, int(jidx.metric),
                                  jidx.adaptive_centers, device="cpu")


def _assert_search_parity(got, ref):
    gd, gi = (t.numpy() for t in got)
    rd, ri = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
    # a slot is tied when its distance is within 1e-5 of a neighbour slot's
    tied = np.zeros_like(rd, dtype=bool)
    close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(gi[~tied], ri[~tied])


@pytest.mark.parametrize("metric", ["L2Expanded", "L2SqrtExpanded",
                                    "InnerProduct", "CosineExpanded"])
def test_search_carried_index_matches_jax(metric):
    x, q = _data()
    jidx = jax_ivf.build(jax_ivf.IndexParams(n_lists=24,
                                             metric=JaxDT[metric]),
                         jnp.asarray(x))
    tidx = _carry(jidx)
    assert tidx.metric == DistanceType[metric]
    sp_j, sp_t = jax_ivf.SearchParams(n_probes=6), tivf.SearchParams(6)
    # batch_size_query=64 → batches of 64, 64 and a 22-row tail padded to 32
    ref = jax_ivf.search(sp_j, jidx, jnp.asarray(q), K, batch_size_query=64)
    got = tivf.search(sp_t, tidx, q, K, batch_size_query=64, engine="torch")
    _assert_search_parity(got, ref)
    back = tivf.index_to_arrays(tidx)
    np.testing.assert_array_equal(back["chunk_table"],
                                  np.asarray(jidx.chunk_table))


def _recall(ids, x, q):
    d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :K]
    return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)])


def test_port_built_index_recall_matches_jax_built():
    x, q = _data(n=5000, seed=1)
    params = dict(n_lists=64, kmeans_n_iters=10)
    jidx = jax_ivf.build(jax_ivf.IndexParams(**params), jnp.asarray(x))
    tidx = tivf.build(tivf.IndexParams(**params), x, device="cpu")
    assert tidx.size == 5000
    # the list balance is the algorithm's: the port's padding tracks the
    # JAX package's on the same data
    assert abs(tidx.padding_fraction - jidx.padding_fraction) < 0.05
    live = tidx.list_indices[tidx.list_indices >= 0]
    every_id = torch.arange(5000, dtype=torch.int32)
    assert torch.equal(torch.sort(live).values, every_id)
    _, ri = jax_ivf.search(jax_ivf.SearchParams(n_probes=8), jidx,
                           jnp.asarray(q), K)
    _, gi = tivf.search(tivf.SearchParams(n_probes=8), tidx, q, K)
    r_jax, r_port = _recall(np.asarray(ri), x, q), _recall(gi.numpy(), x, q)
    assert r_port >= r_jax - 0.02, (r_port, r_jax)


def test_wide_k_stacked_scan_and_empty_batch():
    x, q = _data(n=2000, seed=2)
    jidx = jax_ivf.build(jax_ivf.IndexParams(n_lists=16), jnp.asarray(x))
    tidx = _carry(jidx)
    sp_j, sp_t = jax_ivf.SearchParams(n_probes=4), tivf.SearchParams(4)
    ref = jax_ivf.search(sp_j, jidx, jnp.asarray(q[:40]), 30)
    got = tivf.search(sp_t, tidx, q[:40], 30)
    _assert_search_parity(got, ref)
    d, i = tivf.search(sp_t, tidx, q[:0], K)
    assert d.shape == (0, K) and i.shape == (0, K)


def test_extend_into_non_empty_index_is_refused():
    # a non-empty index takes new rows (tests/test_torch_extend.py); it
    # refuses ids already live and rows of another storage type
    x, _ = _data(n=600, seed=3)
    tidx = tivf.build(tivf.IndexParams(n_lists=8), x, device="cpu")
    with pytest.raises(ValueError, match="already live"):
        tivf.extend(tidx, x[:10], np.arange(10, dtype=np.int32))
    with pytest.raises(Exception, match="storage type"):
        tivf.extend(tidx, x[:10].astype(np.int8))


def test_extend_empty_index_with_ids_and_adaptive_centers():
    x, q = _data(n=1500, seed=4)
    ids = np.random.default_rng(5).permutation(10_000)[:1500].astype(np.int32)
    jp = jax_ivf.IndexParams(n_lists=12, adaptive_centers=True,
                             add_data_on_build=False)
    jempty = jax_ivf.build(jp, jnp.asarray(x))
    tempty = _carry(jempty)
    assert tempty.size == 0 and tempty.adaptive_centers
    jidx = jax_ivf.extend(jempty, jnp.asarray(x), jnp.asarray(ids))
    tidx = tivf.extend(tempty, x, ids)
    np.testing.assert_allclose(tidx.centers.numpy(), np.asarray(jidx.centers),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tidx.list_sizes.numpy(),
                                  np.asarray(jidx.list_sizes))
    got = tivf.search(tivf.SearchParams(4), tidx, q, K)
    ref = jax_ivf.search(jax_ivf.SearchParams(n_probes=4), jidx,
                         jnp.asarray(q), K)
    _assert_search_parity(got, ref)
    with pytest.raises(Exception, match="duplicate"):
        tivf.extend(tempty, x[:3], np.array([1, 1, 2], np.int32))
