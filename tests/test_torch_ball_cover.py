"""The port's random ball cover against brute force and ``raft_tpu``.

The cases of ``tests/test_ball_cover.py`` on the CPU — exactness against a
float64 brute-force oracle, all-kNN, Haversine, ``eps_nn``, a forced
second pass, landmark skew, duplicates with large k, k beyond the smallest
list, validation — and against the JAX package: the same landmarks from
the same seed, labels equal except at near ties, radii to 1e-5 relative,
and search from a carried JAX index.

Tolerances: ids equal to the oracle's wherever the oracle's distances are
not tied within 1e-5 relative (the boundary slot included, against the
(k+1)-th distance); distances within 1e-5 absolute of the float64
oracle's (the scan scores in the direct Σ(q−x)² form, so self-pairs are
exactly 0); JAX-carried search: distances to rtol 1e-5 and atol 1e-5 of
the JAX package's; adjacency equal to the oracle's except at pairs whose
float64 distance lies within 1e-5 of ε.  Query batches of 1, 7 and all
rows give the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

from raft_tpu.distance.distance_types import DistanceType as JaxDT
from raft_tpu.neighbors import ball_cover as jax_bc
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ball_cover as bc

TIE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: with parallel test workers on the cores,
    PyTorch's spinning thread pool runs these small ops ~30× slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hav(q, x):
    dlat = q[:, None, 0] - x[None, :, 0]
    dlon = q[:, None, 1] - x[None, :, 1]
    h = (np.sin(dlat / 2) ** 2 + np.cos(q[:, None, 0])
         * np.cos(x[None, :, 0]) * np.sin(dlon / 2) ** 2)
    return 2.0 * np.arcsin(np.sqrt(np.clip(h, 0, 1)))


def _oracle(x, q, metric=DistanceType.L2SqrtExpanded):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    return _hav(q64, x64) if metric == DistanceType.Haversine \
        else cdist(q64, x64)


def _assert_exact(x, q, d, i, k, metric=DistanceType.L2SqrtExpanded):
    """Ids equal to the oracle's except at near ties; distances to 1e-5."""
    ref = _oracle(x, q, metric)
    kk = min(k + 1, x.shape[0])
    ridx = np.argsort(ref, axis=1, kind="stable")[:, :kk]
    rd = np.take_along_axis(ref, ridx, axis=1)
    d, i = d.numpy(), i.numpy()
    np.testing.assert_allclose(d, rd[:, :k], rtol=0, atol=1e-5)
    close = np.abs(rd[:, 1:] - rd[:, :-1]) <= TIE * np.maximum(rd[:, 1:],
                                                               1e-6)
    tied = np.zeros_like(rd, dtype=bool)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    tied = tied[:, :k]
    np.testing.assert_array_equal(i[~tied], ridx[:, :k][~tied])


@pytest.mark.parametrize("n,dim,k", [(1500, 3, 7), (2000, 8, 11)])
def test_knn_exact(n, dim, k):
    rng = np.random.default_rng(n)
    x = rng.random((n, dim)).astype(np.float32)
    q = rng.random((100, dim)).astype(np.float32)
    index = bc.build_index(x, device="cpu")
    d, i = bc.knn_query(index, q, k)
    _assert_exact(x, q, d, i, k)


def test_same_bits_in_every_batch():
    rng = np.random.default_rng(3)
    x = rng.random((2500, 3)).astype(np.float32)
    q = rng.random((64, 3)).astype(np.float32)
    index = bc.build_index(x, device="cpu")
    d0, i0 = bc.knn_query(index, q, 9)
    for bs in (1, 7):
        d, i = bc.knn_query(index, q, 9, batch_size_query=bs)
        np.testing.assert_array_equal(d.numpy(), d0.numpy())
        np.testing.assert_array_equal(i.numpy(), i0.numpy())


def test_all_knn():
    rng = np.random.default_rng(0)
    x = rng.random((900, 4)).astype(np.float32)
    d, i = bc.all_knn_query(bc.build_index(x, device="cpu"), 5)
    np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(900))
    np.testing.assert_array_equal(d.numpy()[:, 0], 0.0)


def test_all_knn_matches_bruteforce():
    rng = np.random.default_rng(17)
    x = rng.random((800, 6)).astype(np.float32)
    d, i = bc.all_knn_query(bc.build_index(x, device="cpu"), 8)
    _assert_exact(x, x, d, i, 8)


def test_haversine_self():
    rng = np.random.default_rng(1)
    x = np.stack([rng.uniform(-1.2, 1.2, 800), rng.uniform(-3.0, 3.0, 800)],
                 1).astype(np.float32)
    q = x[:50] + 0.001
    index = bc.build_index(x, DistanceType.Haversine, device="cpu")
    _, i = bc.knn_query(index, q, 3)
    np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(50))


@pytest.mark.parametrize("n,k", [(700, 5), (1200, 17)])
def test_haversine_vs_host_oracle(n, k):
    rng = np.random.default_rng(n)
    x = np.stack([rng.uniform(-1.4, 1.4, n), rng.uniform(-np.pi, np.pi, n)],
                 1).astype(np.float32)
    q = np.stack([rng.uniform(-1.4, 1.4, 80),
                  rng.uniform(-np.pi, np.pi, 80)], 1).astype(np.float32)
    index = bc.build_index(x, DistanceType.Haversine, device="cpu")
    d, i = bc.knn_query(index, q, k)
    _assert_exact(x, q, d, i, k, DistanceType.Haversine)


def _assert_adjacency(adj, vd, x, q, eps, metric=DistanceType.L2SqrtExpanded):
    ref_d = _oracle(x, q, metric)
    adj = adj.numpy()
    edge = np.abs(ref_d - eps) <= TIE
    np.testing.assert_array_equal(adj[~edge], (ref_d <= eps)[~edge])
    np.testing.assert_array_equal(vd.numpy(), adj.sum(1))


def test_eps_nn():
    rng = np.random.default_rng(2)
    x = rng.random((600, 4)).astype(np.float32)
    q = rng.random((80, 4)).astype(np.float32)
    index = bc.build_index(x, device="cpu")
    adj, vd = bc.eps_nn(index, q, 0.35)
    assert adj.shape == (80, 600) and str(vd.dtype) == "torch.int32"
    _assert_adjacency(adj, vd, x, q, 0.35)
    adj7, vd7 = bc.eps_nn(index, q, 0.35, batch_size_query=7)
    np.testing.assert_array_equal(adj7.numpy(), adj.numpy())
    np.testing.assert_array_equal(vd7.numpy(), vd.numpy())


def test_eps_nn_clustered_and_haversine():
    rng = np.random.default_rng(19)
    c1 = rng.normal(0, 0.1, (400, 3)).astype(np.float32)
    c2 = rng.normal(3, 0.1, (400, 3)).astype(np.float32)
    x = np.concatenate([c1, c2])
    q = np.concatenate([c1[:30], c2[:30]])
    index = bc.build_index(x, device="cpu")
    for eps in (0.3, 4.0):
        _assert_adjacency(*bc.eps_nn(index, q, eps), x, q, eps)
    h = np.stack([rng.uniform(-1.2, 1.2, 500), rng.uniform(-3, 3, 500)],
                 1).astype(np.float32)
    hidx = bc.build_index(h, DistanceType.Haversine, device="cpu")
    _assert_adjacency(*bc.eps_nn(hidx, h[:40], 0.2), h, h[:40], 0.2,
                      DistanceType.Haversine)


def test_forced_second_pass(monkeypatch):
    """One initial probe cannot certify queries near shell A against
    shell B's landmarks: the failing queries get one more pass over
    exactly the landmarks their certificate leaves open (shell B's stay
    pruned), and the result is exact."""
    rng = np.random.default_rng(7)
    a = rng.normal(0, 1, (800, 6)).astype(np.float32)
    b = rng.normal(8, 1, (800, 6)).astype(np.float32)
    x = np.concatenate([a, b])
    q = rng.normal(0, 1, (64, 6)).astype(np.float32)
    calls = []
    orig = bc._scan_landmarks

    def counting(index, qb, probe_ids, k, engine=None):
        calls.append((probe_ids.shape[1], qb.shape[0],
                      int((probe_ids < index.n_landmarks).sum())))
        return orig(index, qb, probe_ids, k, engine)

    monkeypatch.setattr(bc, "_scan_landmarks", counting)
    index = bc.build_index(x, seed=3, device="cpu")
    d, i = bc.knn_query(index, q, 9, initial_probes=1)
    assert len(calls) == 2 and calls[0] == (1, 64, 64)
    # the second pass covers the failing queries, not every landmark
    assert 0 < calls[1][1] <= 64
    assert calls[1][2] < calls[1][1] * (index.n_landmarks - 1)
    _assert_exact(x, q, d, i, 9)


def test_adversarial_landmark_skew():
    rng = np.random.default_rng(11)
    blob = rng.normal(0, 0.05, (1980, 5)).astype(np.float32)
    outliers = rng.uniform(-20, 20, (20, 5)).astype(np.float32)
    x = np.concatenate([blob, outliers])
    q = np.concatenate([rng.normal(0, 0.05, (40, 5)),
                        outliers[:10] + 0.01]).astype(np.float32)
    index = bc.build_index(x, seed=5, device="cpu")
    d, i = bc.knn_query(index, q, 12)
    _assert_exact(x, q, d, i, 12)


def test_duplicates_and_large_k():
    rng = np.random.default_rng(13)
    base = rng.random((300, 4)).astype(np.float32)
    x = np.concatenate([base, base[:100]])       # 100 exact duplicates
    q = base[:60] + 1e-4
    index = bc.build_index(x, seed=1, device="cpu")
    d, i = bc.knn_query(index, q, 96)
    _assert_exact(x, q, d, i, 96)
    # of a duplicate pair at equal distance, the lower id comes first
    ids = i.numpy()
    for row in ids:
        pos = {v: p for p, v in enumerate(row.tolist())}
        for j in range(100):
            if j + 300 in pos:
                assert j in pos and pos[j] < pos[j + 300]


def test_k_exceeding_smallest_list():
    rng = np.random.default_rng(23)
    x = rng.random((500, 3)).astype(np.float32)
    q = rng.random((40, 3)).astype(np.float32)
    index = bc.build_index(x, n_landmarks=100, seed=2, device="cpu")
    assert int(index.list_sizes.min()) < 50
    d, i = bc.knn_query(index, q, 50)
    _assert_exact(x, q, d, i, 50)


def test_query_validation():
    rng = np.random.default_rng(29)
    x = rng.random((100, 4)).astype(np.float32)
    index = bc.build_index(x, device="cpu")
    with pytest.raises(LogicError):
        bc.knn_query(index, rng.random((5, 3)).astype(np.float32), 3)
    with pytest.raises(LogicError):
        bc.build_index(x, DistanceType.InnerProduct, device="cpu")
    with pytest.raises(LogicError):
        bc.build_index(x, DistanceType.Haversine, device="cpu")
    d, i = bc.knn_query(index, np.zeros((0, 4), np.float32), 3)
    assert d.shape == (0, 3) and i.shape == (0, 3)
    adj, vd = bc.eps_nn(index, np.zeros((0, 4), np.float32), 0.1)
    assert adj.shape == (0, 100) and vd.shape == (0,)


# ---------------------------------------------------------------------------
# against raft_tpu

def _labels_port(index, n):
    lab = np.full(n, -1)
    ct = index.chunk_table.numpy()
    idx = index.list_indices.numpy()
    sizes = index.phys_sizes.numpy()
    for lm in range(ct.shape[0]):
        for r in ct[lm]:
            lab[idx[r, :sizes[r]]] = lm
    return lab


def _labels_jax(jidx, n):
    lab = np.full(n, -1)
    idx = np.asarray(jidx.list_indices)
    for lm, s in enumerate(np.asarray(jidx.list_sizes)):
        lab[idx[lm, :s]] = lm
    return lab


@pytest.mark.parametrize("metric", ["L2SqrtExpanded", "L2SqrtUnexpanded",
                                    "Haversine"])
def test_build_matches_jax(metric):
    rng = np.random.default_rng(31)
    if metric == "Haversine":
        x = np.stack([rng.uniform(-1.2, 1.2, 3000),
                      rng.uniform(-3, 3, 3000)], 1).astype(np.float32)
    else:
        x = rng.normal(0, 1, (3000, 3)).astype(np.float32)
    jidx = jax_bc.build_index(jnp.asarray(x), JaxDT[metric], seed=4)
    tidx = bc.build_index(x, DistanceType[metric], seed=4, device="cpu")
    np.testing.assert_array_equal(tidx.landmarks.numpy(),
                                  np.asarray(jidx.landmarks))
    lt, lj = _labels_port(tidx, 3000), _labels_jax(jidx, 3000)
    diff = lt != lj
    if diff.any():   # only where two landmarks are near-tied for the row
        d = _oracle(tidx.landmarks.numpy(), x[diff],
                    DistanceType[metric]).T
        two = np.sort(d, axis=1)[:, :2]
        assert (two[:, 1] - two[:, 0] <= TIE * np.maximum(two[:, 0],
                                                          1e-6)).all()
    np.testing.assert_allclose(tidx.radii.numpy(), np.asarray(jidx.radii),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tidx.list_sizes.numpy(),
                                  np.asarray(jidx.list_sizes))


def test_search_from_carried_jax_index():
    rng = np.random.default_rng(37)
    x = rng.normal(0, 1, (2000, 3)).astype(np.float32)
    q = rng.normal(0, 1, (50, 3)).astype(np.float32)
    jidx = jax_bc.build_index(jnp.asarray(x), seed=2)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in bc.ARRAY_FIELDS}
    tidx = bc.index_from_arrays(arrays, int(jidx.metric), device="cpu")
    assert tidx.metric == DistanceType.L2SqrtExpanded
    jd, ji = jax_bc.knn_query(jidx, jnp.asarray(q), 6)
    td, ti = bc.knn_query(tidx, q, 6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    _assert_exact(x, q, td, ti, 6)
    jadj, jvd = jax_bc.eps_nn(jidx, jnp.asarray(q), 0.4)
    tadj, tvd = bc.eps_nn(tidx, q, 0.4)
    edge = np.abs(_oracle(x, q) - 0.4) <= TIE
    np.testing.assert_array_equal(tadj.numpy()[~edge],
                                  np.asarray(jadj)[~edge])
