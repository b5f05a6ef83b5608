"""The sparse graph path on the card against the same calls on the CPU:
SpMV and the ELL SpMV (rtol 1e-5), Lanczos from one ``v0`` (eigenvalues
at rtol 1e-4 and atol 1e-5, as the CPU parity tests hold them to the JAX
package's; the same subspace), Borůvka bit for bit (stable sorts on both
devices), and ``knn_graph`` (ids equal except at near ties) with kernel
B2 launched.

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_sparse.py -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch import sparse as ts
from raft_tpu_torch.distance import DistanceType
from raft_tpu_torch.kernels import native as kn
from raft_tpu_torch.sparse import neighbors

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def graph():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    # six planted communities: each vertex draws 10 partners inside its
    # own and 1 outside, so the 6 smallest Laplacian eigenpairs stand
    # apart from the bulk
    rng = np.random.default_rng(0)
    n, parts = 20_004, 6
    size = n // parts
    comm = np.arange(n) // size
    r = np.repeat(np.arange(n), 11)
    inside = comm[r] * size + rng.integers(0, size, len(r))
    c = np.where(np.tile(np.arange(11) < 10, n), inside,
                 rng.integers(0, n, len(r)))
    keep = r != c
    r, c = r[keep], c[keep]
    v = rng.uniform(0.5, 1.5, len(r)).astype(np.float32)
    cpu = ts.symmetrize(ts.from_triplets(r, c, v, (n, n), device="cpu"))
    return cpu, cpu.to("cuda")


def test_spmv_card_equals_cpu(graph):
    cpu, card = graph
    x = torch.randn(cpu.shape[1], generator=torch.Generator().manual_seed(1))
    want = ts.spmv(cpu, x)
    torch.testing.assert_close(ts.spmv(card, x.cuda()).cpu(), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        ts.ell_spmv(ts.csr_to_ell(card), x.cuda()).cpu(),
        ts.ell_spmv(ts.csr_to_ell(cpu), x), rtol=1e-5, atol=1e-5)


def test_lanczos_card_equals_cpu(graph):
    cpu, card = graph
    lap_c, lap_g = ts.laplacian(cpu), ts.laplacian(card)
    v0 = torch.randn(cpu.shape[0], generator=torch.Generator().manual_seed(2))
    vals_c, vecs_c = ts.lanczos_smallest(lap_c, 6, v0=v0)
    vals_g, vecs_g = ts.lanczos_smallest(lap_g, 6, v0=v0.cuda())
    # the CSR path's values are its vectors' Rayleigh quotients on L
    torch.testing.assert_close(vals_g.cpu(), vals_c, rtol=1e-4, atol=1e-5)
    rq_g = (vecs_g * ts.spmm(lap_g, vecs_g)).sum(0)
    torch.testing.assert_close(rq_g, vals_g, rtol=1e-5, atol=1e-5)
    norm1 = float(ts.spmv(
        ts.CSR(lap_c.indptr, lap_c.indices, lap_c.data.abs(), lap_c.shape),
        torch.ones(cpu.shape[0])).max())
    s = torch.linalg.svdvals(vecs_g.cpu().double().T @ vecs_c.double())
    torch.testing.assert_close(s, torch.ones_like(s), rtol=0, atol=1e-3)
    res = ts.spmm(lap_g, vecs_g) - vecs_g * vals_g
    assert float(torch.linalg.matrix_norm(res)) < 1e-3 * norm1


def test_boruvka_card_bit_for_bit(graph):
    cpu, card = graph
    a, b = ts.boruvka_mst(cpu), ts.boruvka_mst(card)
    for x, y in zip(a, b):
        torch.testing.assert_close(y.cpu(), x, rtol=0, atol=0)


def test_knn_graph_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8192, 32, generator=g)
    kn.reset_launches()
    card = neighbors.knn_graph(x.cuda(), DistanceType.L2SqrtExpanded, c=15)
    assert kn.LAUNCHES["select_k"] >= 2
    cpu = neighbors.knn_graph(x, DistanceType.L2SqrtExpanded, c=15)
    k = neighbors.build_k(8192, 15)
    dv, dc = card.vals.cpu().view(-1, k), cpu.vals.view(-1, k)
    torch.testing.assert_close(dv, dc, rtol=1e-4, atol=1e-4)
    gap = torch.full_like(dc, float("inf"))
    diff = (dc[:, 1:] - dc[:, :-1]).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], diff)
    gap[:, :-1] = torch.minimum(gap[:, :-1], diff)
    clear = gap > 1e-4 * dc.abs().clamp_min(1)
    assert torch.equal(card.cols.cpu().view(-1, k)[clear],
                       cpu.cols.view(-1, k)[clear])
