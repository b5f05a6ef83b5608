"""The port's ε-neighbourhood against ``raft_tpu``, and
``ivf_flat.build_and_search``.

``eps_neighbors_l2sq`` / ``eps_neighbors`` against the JAX package's on the
same seeded inputs, at float32 and bfloat16 (ε rounded to the inputs'
type in both), in one batch and in several: adjacency equal except at
pairs whose float64 squared distance lies within 1e-5 × (‖x‖² + ‖y‖²) of
ε — the rounding of the expanded form both packages compute in float32 —
and degrees equal to the adjacency's row sums.  A row's adjacency is the
same bits in every batch size.  ``build_and_search`` gives the bits of
``build`` then ``search``, and a recall@10 within 0.02 of the JAX
package's ``build_and_search``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import epsilon_neighborhood as jax_eps
from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu_torch import neighbors
from raft_tpu_torch.neighbors import epsilon_neighborhood as teps
from raft_tpu_torch.neighbors import ivf_flat as tivf

_DTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: with parallel test workers on the cores,
    PyTorch's spinning thread pool runs these small ops ~30× slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(dtype, m=300, n=500, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (m, dim)).astype(np.float32)
    y = rng.normal(0, 0.5, (n, dim)).astype(np.float32)
    tdt, jdt = _DTYPES[dtype]
    tx, ty = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    # the values both packages see, widened exactly to float64
    x64, y64 = tx.double().numpy(), ty.double().numpy()
    return tx, ty, jnp.asarray(x, jdt), jnp.asarray(y, jdt), x64, y64


def _edge(x64, y64, eps):
    d = ((x64[:, None, :] - y64[None]) ** 2).sum(-1)
    scale = (x64 ** 2).sum(1)[:, None] + (y64 ** 2).sum(1)[None]
    return d, np.abs(d - eps) <= 1e-5 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch_size", [8192, 64])
def test_eps_neighbors_l2sq_matches_jax(dtype, batch_size):
    tx, ty, jx, jy, x64, y64 = _inputs(dtype)
    eps = 0.9
    adj, vd = teps.eps_neighbors_l2sq(tx, ty, eps, batch_size=batch_size)
    jadj, jvd = jax_eps.eps_neighbors_l2sq(jx, jy, eps,
                                           batch_size=batch_size)
    assert adj.dtype == torch.bool and vd.dtype == torch.int32
    assert adj.shape == (300, 500)
    eps_t = float(torch.tensor(eps, dtype=tx.dtype))
    d, edge = _edge(x64, y64, eps_t)
    adj, jadj = adj.numpy(), np.asarray(jadj)
    np.testing.assert_array_equal(adj[~edge], jadj[~edge])
    np.testing.assert_array_equal(adj[~edge], (d <= eps_t)[~edge])
    np.testing.assert_array_equal(vd.numpy(), adj.sum(1))
    np.testing.assert_array_equal(np.asarray(jvd), jadj.sum(1))
    assert 0 < adj.sum() < adj.size


def test_bfloat16_eps_is_rounded_to_the_input_type():
    """bfloat16(0.3) is 0.30078125: a pair at squared distance
    0.546875² + 0.03125² = 0.30004883 (both bfloat16 values) is inside
    the bfloat16 ball in both packages, and outside the float32 one."""
    x = np.zeros((1, 2), np.float32)
    y = np.array([[0.546875, 0.03125]], np.float32)
    y16 = torch.from_numpy(y).bfloat16()
    d = float((y16.double() ** 2).sum())
    assert 0.3 < d <= 0.30078125
    adj, _ = teps.eps_neighbors_l2sq(torch.from_numpy(x).bfloat16(), y16,
                                     0.3)
    jadj, _ = jax_eps.eps_neighbors_l2sq(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(y, jnp.bfloat16), 0.3)
    assert bool(adj[0, 0]) and bool(jadj[0, 0])
    f32, _ = teps.eps_neighbors_l2sq(torch.from_numpy(x),
                                     torch.from_numpy(y16.float().numpy()),
                                     0.3)
    assert not bool(f32[0, 0])


def test_rows_are_batch_independent():
    tx, ty, *_ = _inputs("float32", m=40, n=2000, dim=16, seed=3)
    a0, v0 = teps.eps_neighbors_l2sq(tx, ty, 6.0)
    for bs in (1, 7, 64):
        a, v = teps.eps_neighbors_l2sq(tx, ty, 6.0, batch_size=bs)
        assert torch.equal(a, a0) and torch.equal(v, v0)


def test_eps_neighbors_is_the_squared_radius():
    tx, ty, jx, jy, x64, y64 = _inputs("float32", seed=5)
    adj, vd = teps.eps_neighbors(tx, ty, 0.95)
    adj2, vd2 = teps.eps_neighbors_l2sq(tx, ty, 0.95 ** 2)
    assert torch.equal(adj, adj2) and torch.equal(vd, vd2)
    jadj, _ = jax_eps.eps_neighbors(jx, jy, 0.95)
    _, edge = _edge(x64, y64, float(np.float32(0.95 ** 2)))
    np.testing.assert_array_equal(adj.numpy()[~edge],
                                  np.asarray(jadj)[~edge])
    empty, vde = teps.eps_neighbors_l2sq(tx[:0], ty, 1.0)
    assert empty.shape == (0, 500) and vde.shape == (0,)


def test_neighbors_exports():
    for name in ("eps_neighbors", "eps_neighbors_l2sq", "ball_cover",
                 "knn", "haversine_knn", "ivf_flat", "ivf_pq"):
        assert name in neighbors.__all__ and hasattr(neighbors, name)
    assert neighbors.eps_neighbors is teps.eps_neighbors


def _recall(ids, x, q, k=10):
    d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, truth)])


def test_ivf_flat_build_and_search():
    rng = np.random.default_rng(1)
    c = rng.uniform(-3, 3, (40, 16))
    x = (c[rng.integers(0, 40, 4000)] + rng.standard_normal((4000, 16))
         ).astype(np.float32)
    q = (c[rng.integers(0, 40, 100)] + rng.standard_normal((100, 16))
         ).astype(np.float32)
    ip = tivf.IndexParams(n_lists=32, kmeans_n_iters=10)
    sp = tivf.SearchParams(n_probes=8)
    d, i = tivf.build_and_search(x, q, 10, ip, sp, device="cpu")
    d0, i0 = tivf.search(sp, tivf.build(ip, x, device="cpu"), q, 10)
    assert torch.equal(d, d0) and torch.equal(i, i0)
    _, ji = jax_ivf.build_and_search(
        jnp.asarray(x), jnp.asarray(q), 10,
        jax_ivf.IndexParams(n_lists=32, kmeans_n_iters=10),
        jax_ivf.SearchParams(n_probes=8))
    assert abs(_recall(i.numpy(), x, q) - _recall(np.asarray(ji), x, q)
               ) <= 0.02
