"""Kernel B6 and the dense long tail on the card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one; run
them on a machine with a card with
``python -m pytest --noconftest tests/test_torch_cuda_dense.py -q -m cuda``.
Tolerances: B6 exactly x + 1; sums and products within γ(n)·Σ|terms| of
float64 (γ(n) = n·u / (1 − n·u), u = 2⁻²⁴: any float32 summation order);
a factorization's reconstruction error and ‖VᵀV − I‖ within 10× the
CPU's on the same input or 1e-5 (the Jacobi SVD 1e-4), its values within
1e-4 of the largest;
least squares within 1e-4 of float64; the LAP objective within n·ε_eff of
scipy's optimum, integer costs exactly; the labels exactly.
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


def _gamma(n):
    u = 2.0 ** -24
    return n * u / (1 - n * u)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 128 * 128, 1_000_003])
def test_add_one_is_exact(dev, n):
    from raft_tpu_torch.kernels import native, probe

    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev) * 1e4
    before = native.LAUNCHES["add_one"]
    got = probe.add_one(x)
    torch.cuda.synchronize()
    assert torch.equal(got, x + 1)
    assert native.LAUNCHES["add_one"] - before == (1 if n else 0)


def test_add_one_layouts_and_types(dev):
    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.kernels import probe

    x = torch.arange(64.0, device=dev).reshape(8, 8)
    assert torch.equal(probe.add_one(x.T), x.T + 1)     # not contiguous
    with pytest.raises(LogicError, match="float32"):
        probe.add_one(x.double())


def test_probe_on_the_card(dev):
    from raft_tpu_torch.kernels import probe

    rows = probe.probe(dev)
    assert [r["ok"] for r in rows] == [True, True], rows
    assert rows[1]["mismatched_ids"] == 0


def test_reductions_and_gemm(dev):
    from raft_tpu_torch import linalg, matrix

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(2048, 512, generator=g, device=dev)
    x64 = x.double()
    for got, ref, n in ((linalg.reduce(x), x64.sum(1), 512),
                        (linalg.row_norm(x), (x64 * x64).sum(1), 512),
                        (linalg.col_norm(x), (x64 * x64).sum(0), 2048)):
        assert bool(((got.double() - ref).abs() <= _gamma(n) * ref).all())
    assert torch.equal(linalg.coalesced_reduction(x, reduce_op=torch.fmax),
                       x.amax(1))
    assert torch.equal(matrix.argmin(x).cpu(), x.cpu().argmin(1))
    a = torch.rand(512, 512, generator=g, device=dev)
    b = torch.rand(512, 512, generator=g, device=dev)
    c64 = a.double() @ b.double()
    err = (linalg.gemm(a, b, 2.0, 0.5, a, trans_b=True).double()
           - (2 * (a.double() @ b.double().T) + 0.5 * a.double())).abs()
    assert bool((err <= 2 * _gamma(512) * (2 * c64.abs().max() + 1)).all())


def _rec(a, u, s, v):
    return float((a - (u * s[None, :]) @ v.T).norm() / a.norm())


def _orth(v):
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    return float((v.T @ v - eye).abs().max())


@pytest.mark.parametrize("name", ["svd_qr", "svd_jacobi", "svd_eig"])
def test_svd_card_against_cpu(dev, name):
    """svd_qr (cuSOLVER gesvd) and svd_eig are held to 10× the CPU's
    errors; svd_jacobi is cuSOLVER's gesvdj at PyTorch's own tolerance,
    which left 2.4e-5 of reconstruction error on the smoke's blobs
    (against gesvd's 1.1e-6): it is held to 1e-4."""
    from raft_tpu_torch import linalg

    g = torch.Generator().manual_seed(2)
    a = torch.randn(20_000, 96, generator=g)
    a[:, 0] *= 5
    fn = getattr(linalg, name)
    u, s, v = fn(a.to(dev))
    uc, sc, vc = fn(a)
    floor = 1e-4 if name == "svd_jacobi" else 1e-5
    for card, cpu in ((_rec(a.to(dev), u, s, v), _rec(a, uc, sc, vc)),
                      (_orth(v), _orth(vc))):
        assert card <= max(10 * cpu, floor), (card, cpu)
    assert float((s.cpu() - sc).abs().max() / sc[0]) <= 1e-4


@pytest.mark.parametrize("n", [64, 300, 1000])
def test_eig_card_against_cpu(dev, n):
    from raft_tpu_torch import linalg

    g = torch.Generator().manual_seed(n)
    m = torch.randn(n, n, generator=g)
    a = (m + m.T) / 2
    v, w = linalg.eig_dc(a.to(dev))
    vc, wc = linalg.eig_dc(a)
    assert v.dtype == torch.float32
    res = float((a.to(dev) @ v - v * w[None, :]).norm() / a.norm())
    res_c = float((a @ vc - vc * wc[None, :]).norm() / a.norm())
    assert res <= max(10 * res_c, 1e-5)
    assert _orth(v) <= max(10 * _orth(vc), 1e-5)
    assert float((w.cpu() - wc).abs().max() / wc.abs().max()) <= 1e-4


@pytest.mark.parametrize("fn", ["lstsq_svd_qr", "lstsq_eig", "lstsq_qr",
                                "lstsq_svd_jacobi"])
def test_lstsq_against_float64(dev, fn):
    from raft_tpu_torch import linalg

    g = torch.Generator().manual_seed(3)
    a = torch.randn(50_000, 64, generator=g) + 2.0
    w = torch.randn(64, generator=g)
    b = a @ w + 0.01 * torch.randn(50_000, generator=g)
    w64 = torch.linalg.lstsq(a.double(), b.double()[:, None]).solution[:, 0]
    got = getattr(linalg, fn)(a.to(dev), b.to(dev)).double().cpu()
    assert float((got - w64).norm() / w64.norm()) <= 1e-4


def test_gram_rbf_against_float64(dev):
    from raft_tpu_torch.distance import KernelParams, KernelType, gram_matrix

    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(3000, 128, generator=g, device=dev) * 3
    gamma = 1.0 / (128 * float(x.var()))
    k = gram_matrix(x, x, KernelParams(KernelType.RBF, gamma=gamma))
    x64 = x[:200].double()
    d64 = torch.cdist(x64, x.double()) ** 2
    ref = torch.exp(-gamma * d64)
    nrm = (x64 ** 2).sum(1)[:, None] + (x.double() ** 2).sum(1)[None, :]
    u = 2.0 ** -24
    tol = ref * torch.expm1(gamma * ((2 * _gamma(128) + 3 * u) * nrm
                                     + u * d64)) + 4 * u * ref
    assert bool(((k[:200].double() - ref).abs() <= tol).all())


def test_lap_against_scipy(dev):
    from scipy.optimize import linear_sum_assignment

    from raft_tpu_torch import solver

    g = torch.Generator(device=dev).manual_seed(5)
    c = torch.rand(4, 256, 256, generator=g, device=dev) * 100
    res = solver.solve_lap(c)
    assert bool(res.converged.all())
    c_h = c.cpu().numpy()
    eps_eff = max(1e-6, float(c.max() - c.min()) * 8 * 2.0 ** -23)
    for b in range(4):
        r = res.row_assignment[b].cpu().numpy()
        ri, ci = linear_sum_assignment(c_h[b])
        opt = float(c_h[b][ri, ci].astype(np.float64).sum())
        got = float(c_h[b][np.arange(256), r].astype(np.float64).sum())
        assert got - opt <= 256 * eps_eff + _gamma(256) * got
    # integer costs, ε < 1/n: optimal; below 1,000 the float32 floor
    # (spread·8·2⁻²³ = 9.5e-4) stays under ε = 1/1,024, above 4,000 it
    # does not, and those costs are solved in float64
    for hi, dt in ((1000, torch.float32), (4000, torch.float64)):
        ci_ = torch.randint(0, hi, (512, 512), generator=g, device=dev)
        res = solver.solve_lap(ci_, epsilon=1.0 / 1024)
        h = ci_.cpu().numpy()
        ri, cj = linear_sum_assignment(h)
        r = res.row_assignment.cpu().numpy()
        assert int(h[np.arange(512), r].sum()) == int(h[ri, cj].sum())
        assert res.objective.dtype == dt


def test_labels_on_the_card(dev):
    from raft_tpu_torch import label

    rng = np.random.default_rng(6)
    lab = rng.integers(-500, 500, 20_000).astype(np.int32) * 3
    want = np.unique(lab, return_inverse=True)[1]
    assert np.array_equal(label.make_monotonic(lab, device=dev).cpu()
                          .numpy(), want)
    assert np.array_equal(label.make_monotonic(torch.as_tensor(
        lab, device=dev)).cpu().numpy(), want)
    la = np.arange(1000) // 10 * 10            # classes of ten
    lb = rng.integers(0, 50, 1000)
    mask = rng.random(1000) < 0.05
    card = label.merge_labels(la, lb, mask, device=dev).cpu().numpy()
    host = label.merge_labels(la, lb, mask, device="cpu").numpy()
    assert np.array_equal(card, host)
