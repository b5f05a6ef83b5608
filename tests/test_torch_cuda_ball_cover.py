"""Random ball cover and the ε-neighbourhood on the card: ``knn_query``
gives the same bits in query batches of 1, 7 and 4,096, its ids equal
``torch.cdist``'s except at near ties (1e-5 relative) with kernel B2
launched; ``eps_nn`` and ``eps_neighbors_l2sq`` at float32 against
``torch.cdist`` (adjacency equal except at pairs within 1e-5 of ε, or
1e-5 × ε for the squared radius; degrees the row sums).

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_ball_cover.py -q -m cuda``.
"""

import math

import pytest
import torch

from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.kernels import native
from raft_tpu_torch.neighbors import ball_cover as bc
from raft_tpu_torch.neighbors import eps_neighbors_l2sq

pytestmark = pytest.mark.cuda


def _haversine(a, b):
    a, b = a.double(), b.double()
    h = (torch.sin((a[:, None, 0] - b[None, :, 0]) / 2) ** 2
         + torch.cos(a[:, None, 0]) * torch.cos(b[None, :, 0])
         * torch.sin((a[:, None, 1] - b[None, :, 1]) / 2) ** 2)
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


@pytest.fixture(scope="module", params=["l2", "haversine"])
def case(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if request.param == "l2":
        comps = torch.randn(256, 3, generator=gen, device="cuda")
        draw = (lambda n: comps[torch.randint(0, 256, (n,), generator=gen,
                                              device="cuda")]
                + 0.7 * torch.randn(n, 3, generator=gen, device="cuda"))
        metric = DistanceType.L2SqrtExpanded

        def dist(a, b):
            return torch.cdist(a, b,
                               compute_mode="donot_use_mm_for_euclid_dist")
    else:
        comps = torch.stack([
            (torch.rand(256, generator=gen, device="cuda") * 2 - 1) * 1.4,
            (torch.rand(256, generator=gen, device="cuda") * 2 - 1)
            * math.pi], 1)
        draw = (lambda n: comps[torch.randint(0, 256, (n,), generator=gen,
                                              device="cuda")]
                + 0.02 * torch.randn(n, 2, generator=gen, device="cuda"))
        metric = DistanceType.Haversine
        dist = _haversine
    x, q = draw(100_000), draw(512)
    return bc.build_index(x, metric, seed=1), x, q, dist


def test_same_bits_at_1_7_and_4096_queries(case):
    index, x, q, _ = case
    d0, i0 = bc.knn_query(index, q, 10, batch_size_query=4096)
    for bs in (1, 7):
        d, i = bc.knn_query(index, q, 10, batch_size_query=bs)
        assert torch.equal(d, d0) and torch.equal(i, i0)


def test_knn_query_against_cdist(case):
    index, x, q, dist = case
    native.reset_launches()
    d, i = bc.knn_query(index, q, 10)
    assert native.LAUNCHES["select_k"] > 0
    ref = dist(q, x)
    rd, ri = torch.topk(ref, 11, dim=1, largest=False)
    rd = rd.double()
    assert torch.allclose(d.double(), rd[:, :10], rtol=1e-5, atol=1e-6)
    gap = (rd[:, 1:] - rd[:, :-1]).abs() <= 1e-5 * rd[:, 1:]
    tied = gap[:, :10].clone()
    tied[:, 1:] |= gap[:, :9]
    assert not bool(((i.long() != ri[:, :10]) & ~tied).any())


def test_eps_nn_against_cdist(case):
    index, x, q, dist = case
    eps = float(bc.knn_query(index, q, 10)[0][:, -1].median())
    adj, vd = bc.eps_nn(index, q, eps)
    ref = dist(q, x)
    edge = (ref - eps).abs() <= 1e-5
    assert not bool(((adj != (ref <= eps)) & ~edge).any())
    assert torch.equal(vd, adj.sum(1, dtype=torch.int32))
    assert 0 < int(vd.sum()) < adj.numel()


def test_eps_neighbors_l2sq_against_cdist():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(3000, 64, generator=gen, device="cuda")
    y = torch.randn(50_000, 64, generator=gen, device="cuda")
    eps = 100.0
    adj, vd = eps_neighbors_l2sq(x, y, eps, batch_size=1024)
    ref = torch.cdist(x, y, compute_mode="donot_use_mm_for_euclid_dist") ** 2
    edge = (ref - eps).abs() <= 1e-5 * eps
    assert not bool(((adj != (ref <= eps)) & ~edge).any())
    assert torch.equal(vd, adj.sum(1, dtype=torch.int32))
    one, _ = eps_neighbors_l2sq(x, y, eps)
    assert torch.equal(one, adj)
