"""Dense factorizations: eig, SVD, QR, randomized SVD, least squares and
the Cholesky rank-1 update (port of ``raft_tpu/linalg/decompositions.py``;
reference raft/linalg/{eig,svd,qr,rsvd,lstsq,cholesky_r1_update}.cuh).

The factorizations are ``torch.linalg`` (cuSOLVER on the card, LAPACK on
the host), as the JAX package leaves them to ``jnp.linalg``.  On the card
the SVD's name picks the reference's cuSOLVER algorithm: ``svd_qr`` (and
``lstsq_svd_qr``, the randomized SVD's small SVD) QR iteration
(``gesvd``), ``svd_jacobi`` (and ``lstsq_svd_jacobi``) Jacobi sweeps
(``gesvdj``, PyTorch's default, less accurate: on the blobs of
``chip_smoke.py``'s dense phase its reconstruction error was 2.4e-5
against ``gesvd``'s and the CPU's 1.1e-6, NVIDIA H100 80GB HBM3,
700.00 W).  The other variants (Jacobi against divide-and-conquer eig)
stay as named entry points over one backend.  Eigenvectors and singular
vectors are defined up to sign
(and within a repeated value up to rotation), and cuSOLVER picks its own:
compare results by reconstruction, orthogonality and subspace, never
element by element.  Tensors stay where they are.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects


def _svd(a, driver: str):
    """Reduced SVD (U, S, Vᵀ); *driver* is the cuSOLVER algorithm on the
    card (LAPACK's own on the host)."""
    return torch.linalg.svd(a, full_matrices=False,
                            driver=driver if a.is_cuda else None)


#: the float32 sizes PyTorch sends to cuSOLVER's Jacobi eigensolver
#: (``syevj``) on the card, rows 32 to 512; ``syevd`` serves the rest
_SYEVJ_ROWS = (32, 512)


def eig_dc(a) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition, divide-and-conquer flavour (reference
    ``eigDC``, cuSOLVER ``syevd``): (eigenvectors, eigenvalues),
    ascending.  PyTorch solves a float32 matrix of 32 to 512 rows on the
    card with ``syevj`` instead, whose tolerance left ‖VᵀV − I‖ near 3e-5
    on a 128² Gram matrix (the dense phase of ``chip_smoke.py``, NVIDIA
    H100 80GB HBM3, 700.00 W; the CPU's 1e-6): such a matrix is solved in
    float64 and its factors come back in float32."""
    n = a.shape[-1]
    if (a.is_cuda and a.dtype == torch.float32
            and _SYEVJ_ROWS[0] <= n <= _SYEVJ_ROWS[1]):
        # exempt(dtype-drift): syevj errs on float32 of 32-512 rows (PERF.md 6)
        w, v = torch.linalg.eigh(a.double())
        return v.float(), w.float()
    w, v = torch.linalg.eigh(a)
    return v, w


def eig_jacobi(a, tol: float = 1e-7, sweeps: int = 15):
    """Jacobi-flavour symmetric eig (reference ``eigJacobi``); *tol* and
    *sweeps* are accepted for the reference's signature."""
    return eig_dc(a)


def eig_sel_dc(a, n_eig_vals: int, smallest: bool = True):
    """The *n_eig_vals* smallest (or largest) eigenpairs (reference
    ``eigSelDC``): (vectors (n, n_eig), values (n_eig,)), ascending."""
    v, w = eig_dc(a)
    if smallest:
        return v[:, :n_eig_vals], w[:n_eig_vals]
    return v[:, -n_eig_vals:], w[-n_eig_vals:]


def svd_qr(a, gen_left_vec: bool = True, gen_right_vec: bool = True):
    """SVD by QR iteration (reference ``svdQR``, cuSOLVER ``gesvd``):
    (U, S, V) with a = U diag(S) Vᵀ — V itself, the reference's output
    convention."""
    u, s, vt = _svd(a, "gesvd")
    return (u if gen_left_vec else None, s,
            vt.T if gen_right_vec else None)


def svd_eig(a):
    """SVD through the eigendecomposition of the Gram matrix aᵀa
    (reference ``svdEig``), for tall and skinny *a*: singular values
    descending."""
    v, w = eig_dc(a.T @ a)
    w = torch.flip(w, (0,))
    v = torch.flip(v, (1,))
    s = torch.sqrt(torch.clamp_min(w, 0))
    u = (a @ v) / torch.clamp_min(s, 1e-30)[None, :]
    return u, s, v


def svd_jacobi(a, gen_left_vec: bool = True, gen_right_vec: bool = True,
               tol: float = 1e-7, sweeps: int = 15):
    """SVD by Jacobi sweeps (reference ``svdJacobi``, cuSOLVER
    ``gesvdj``); *tol* and *sweeps* are accepted for the reference's
    signature (PyTorch sets its own)."""
    u, s, vt = _svd(a, "gesvdj")
    return (u if gen_left_vec else None, s,
            vt.T if gen_right_vec else None)


def svd_reconstruction(u, s, v):
    """U diag(S) Vᵀ (reference ``svdReconstruction``)."""
    return (u * s[None, :]) @ v.T


def evaluate_svd_by_reconstruction(a, u, s, v, tol: float = 1e-4) -> bool:
    """Whether the relative Frobenius error of the reconstruction is under
    *tol* (reference ``evaluateSVDByL2Norm``); reads one value back."""
    rec = svd_reconstruction(u, s, v)
    err = torch.linalg.norm(a - rec) / torch.clamp_min(torch.linalg.norm(a),
                                                       1e-30)
    return bool(err < tol)


def qr_get_q(a):
    """The Q factor alone (reference ``qrGetQ``)."""
    return torch.linalg.qr(a)[0]


def qr_get_qr(a):
    """(Q, R) (reference ``qrGetQR``)."""
    q, r = torch.linalg.qr(a)
    return q, r


def rsvd_fixed_rank(a, k: int, p: int = 10, n_iters: int = 2,
                    generator: Optional[torch.Generator] = None,
                    use_bbt: bool = False, *, omega=None):
    """Randomized SVD of rank *k* with oversampling *p* (reference
    ``rsvdFixedRank``: Halko et al.'s range finder with *n_iters* power
    iterations): (U (m, k), S (k,), V (n, k)).  The Gaussian test matrix
    Ω (n, min(k + p, m, n)) is *omega* when given, else drawn from
    *generator* on *a*'s device (``None``: a generator seeded 0, as the
    JAX package's default key is ``PRNGKey(0)``; the two draw different
    numbers).  *use_bbt* is accepted for the reference's signature."""
    m, n = a.shape
    q = min(k + p, min(m, n))
    if omega is None:
        if generator is None:
            generator = torch.Generator(device=a.device).manual_seed(0)
        omega = torch.randn((n, q), generator=generator, device=a.device,
                            dtype=a.dtype)
    expects(tuple(omega.shape) == (n, q),
            f"rsvd: omega must be ({n}, {q}), got {tuple(omega.shape)}")
    qmat = qr_get_q(a @ omega.to(a.dtype))
    for _ in range(n_iters):
        z = qr_get_q(a.T @ qmat)
        qmat = qr_get_q(a @ z)
    ub, s, vbt = _svd(qmat.T @ a, "gesvd")
    return (qmat @ ub)[:, :k], s[:k], vbt.T[:, :k]


def rsvd_perc(a, perc: float, p: int = 10, n_iters: int = 2,
              generator: Optional[torch.Generator] = None, *, omega=None):
    """:func:`rsvd_fixed_rank` with the rank a fraction of min(m, n)
    (reference ``rsvdPerc``)."""
    k = max(1, int(perc * min(a.shape)))
    return rsvd_fixed_rank(a, k, p, n_iters, generator, omega=omega)


def _scale_rows(w, b):
    """w[:, None] · b for a matrix right-hand side, w · b for a vector."""
    return w[:, None] * b if b.ndim == 2 else w * b


def _lstsq_svd(a, b, driver: str):
    u, s, vt = _svd(a, driver)
    s_inv = torch.where(s > 1e-10 * s[0], 1.0 / s, torch.zeros_like(s))
    return vt.T @ _scale_rows(s_inv, u.T @ b)


def lstsq_svd_qr(a, b):
    """argmin_w ‖a·w − b‖ through the SVD by QR iteration (reference
    ``lstsqSvdQR``); singular values under 1e-10 of the largest count as
    0."""
    return _lstsq_svd(a, b, "gesvd")


def lstsq_svd_jacobi(a, b):
    """:func:`lstsq_svd_qr` through the Jacobi SVD (reference
    ``lstsqSvdJacobi``)."""
    return _lstsq_svd(a, b, "gesvdj")


def lstsq_eig(a, b):
    """The normal equations through the eigendecomposition of aᵀa
    (reference ``lstsqEig``); eigenvalues under 1e-10 of the largest count
    as 0."""
    v, w = eig_dc(a.T @ a)
    top = torch.clamp_min(w[-1], 1e-30)
    w_inv = torch.where(w > 1e-10 * top, 1.0 / w, torch.zeros_like(w))
    return v @ _scale_rows(w_inv, v.T @ (a.T @ b))


def lstsq_qr(a, b):
    """Through a = QR and a triangular solve (reference ``lstsqQR``)."""
    q, r = torch.linalg.qr(a)
    rhs = q.T @ b
    out = torch.linalg.solve_triangular(
        r, rhs[:, None] if rhs.ndim == 1 else rhs, upper=True)
    return out[:, 0] if rhs.ndim == 1 else out


def cholesky_r1_update(l_factor, x, lower: bool = True):
    """Border the Cholesky factor L of A (n × n) by one row and column:
    x[:n] is the new off-diagonal block and x[n] the new diagonal entry;
    returns the (n + 1) × (n + 1) factor (reference
    linalg/cholesky_r1_update.cuh ``choleskyRank1Update``).  With
    ``lower=False`` the factors are upper triangular."""
    n = l_factor.shape[0]
    expects(x.shape[0] == n + 1, "x must have n+1 entries")
    if not lower:
        l_factor = l_factor.T
    b, d = x[:n], x[n]
    if n > 0:
        y = torch.linalg.solve_triangular(l_factor, b[:, None],
                                          upper=False)[:, 0]
    else:
        y = b[:0]
    diag_new = torch.sqrt(torch.clamp_min(d - torch.sum(y * y), 0))
    top = torch.cat([l_factor, torch.zeros((n, 1), dtype=l_factor.dtype,
                                           device=l_factor.device)], dim=1)
    out = torch.cat([top, torch.cat([y, diag_new[None]])[None, :]], dim=0)
    return out if lower else out.T
