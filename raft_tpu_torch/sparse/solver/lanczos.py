"""Restarted Lanczos eigensolver (port of
``raft_tpu/sparse/solver/lanczos.py``; reference
``sparse/solver/lanczos.cuh:68,132`` ``computeSmallestEigenvectors`` /
``computeLargestEigenvectors``).

The JAX package's design, run eagerly on the card, with its restart
brought back to the reference's:

- The Krylov build takes one SpMV and, for full reorthogonalisation, two
  passes of two skinny products against the basis built so far (``Qⱼ @
  w``, ``Qⱼᵀ @ c``) a step, with no host read: the breakdown test is a
  ``torch.where``.
- The projected problem is an m×m ``torch.linalg.eigh``.
- Smallest eigenpairs of a CSR come from the largest of the spectral
  complement σI − A (σ the Gershgorin bound), their values as the
  vectors' Rayleigh quotients on A; a callable runs on −A.
- The restart loop locks converged Ritz pairs and deflates them out of
  the operator.  Each round reads one flag on the host, for the loop's
  condition; the solve then reads the locked count once.  Partial
  convergence (degenerate spectra) is completed by deflated power
  iteration from random starts.

Three departures from the JAX package, each a fault it shows on planted
communities (16 communities of 1,000 vertices on the CPU; 62,500 on the
card):

- Thick restart: a round starts from the unlocked Ritz vectors, the next
  Lanczos vector and their couplings (the Krylov–Schur relation A·yᵢ =
  θᵢ·yᵢ + bᵢ·q), so the wanted subspace carries over, as the reference's
  implicit restart keeps it.  The JAX package restarts from one vector,
  a weighted sum of the Ritz vectors; a cluster of 15 eigenvalues 0.01
  apart at 1M vertices then stays unresolved after 15 restarts
  (residuals up to 0.67 against a tolerance of 6e-5).
- Locking stops at the first pair not converged: the JAX package locks
  every converged pair, so a converged bulk eigenvalue (17.12) can take
  the last slot while a nearly degenerate extremal pair (8.151 / 8.153)
  still converges, and the solve returns the wrong set.
- The deflated operator sends the locked directions below the spectrum
  (the first round's lowest Ritz value less the Ritz range, at most 0);
  the JAX package sends them to 0, which is the TOP of −A's spectrum for
  a positive semi-definite A (a Laplacian on the callable smallest
  path): there its restarts converge onto locked directions and lock
  spurious zero eigenpairs.

The JAX package caches a compiled solve per callable (``_CALLABLE_PROGS``,
``jax.tree_util.Partial``); PyTorch compiles nothing, so any callable is
taken as it is.  The start vector and the repair draws come from a
``torch.Generator`` seeded by ``seed`` (``seed + 1`` for the repairs),
not from ``jax.random``: pass ``v0`` to start where another solver
started.

Counters: ``raft_tpu_lanczos_matvecs_total`` (operator applications),
``raft_tpu_lanczos_restarts_total`` (restart rounds) and
``raft_tpu_lanczos_solves_total``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.core.logger import traced
from raft_tpu_torch.sparse.linalg import apply_matvec, matvec_operand
from raft_tpu_torch.sparse.op import segment_reduce
from raft_tpu_torch.sparse.types import CSR


def _counter(name: str, help: str):
    return telemetry.counter(f"raft_tpu_lanczos_{name}_total", help)


def _gershgorin_upper(csr: CSR) -> torch.Tensor:
    """An upper bound on the eigenvalues: max_i (a_ii + Σ_{j≠i} |a_ij|)."""
    rows = csr.row_ids()
    n = csr.shape[0]
    absrow = segment_reduce(torch.abs(csr.data), rows, n)
    is_diag = (csr.indices == torch.clamp(rows, 0, n - 1)) & csr.mask()
    diag = segment_reduce(torch.where(is_diag, csr.data, 0), rows, n)
    return torch.max(diag + (absrow - torch.abs(diag)))


def _lanczos_decomp(matvec: Callable, m: int, v0=None, kept=None):
    """m columns of a Lanczos decomposition A·Qₘ = Qₘ·H + β·q·eₘᵀ with
    full reorthogonalisation: (Q (m+1, n) basis, H (m, m), β 0-d).  From a
    start vector *v0* H is tridiagonal; from *kept* = (Y (p, n) Ritz
    vectors, θ (p,), b (p,), q (n,) the next Lanczos vector) — a thick
    restart — the first p rows of Q are Y, row p is q, and H holds
    diag(θ) with b in row and column p (A·yᵢ = θᵢ·yᵢ + bᵢ·q)."""
    if kept is None:
        n, p, dtype, dev = v0.shape[0], 0, v0.dtype, v0.device
    else:
        Y, theta, bcoef, q = kept
        n, p, dtype, dev = q.shape[0], Y.shape[0], q.dtype, q.device
    fi = torch.finfo(dtype)
    tiny = fi.tiny ** 0.5
    ulp = fi.eps
    Q = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    H = torch.zeros((m, m), dtype=dtype, device=dev)
    if kept is None:
        Q[0] = v0 / torch.clamp_min(torch.linalg.vector_norm(v0), tiny)
    else:
        Q[:p] = Y
        Q[p] = q
        H[:p, :p] = torch.diag(theta)
        H[p, :p] = bcoef
        H[:p, p] = bcoef
    beta = torch.zeros((), dtype=dtype, device=dev)
    for j in range(p, m):
        v = Q[j]
        w = matvec(v)
        H[j, j] = torch.dot(w, v)
        # two passes against every basis vector built so far (the rows
        # past j are zero and would add nothing)
        Qj = Q[:j + 1]
        w = w - Qj.T @ (Qj @ w)
        w = w - Qj.T @ (Qj @ w)
        b = torch.linalg.vector_norm(w)
        # breakdown is judged RELATIVE to the recurrence's scale: noise of
        # ~ulp·scale after an exact breakdown must not become a basis
        # vector (the JAX package's comment at lanczos.py:87-94)
        good = b > 128.0 * ulp * torch.clamp_min(torch.max(torch.abs(H)),
                                                 tiny)
        b = torch.where(good, b, 0.0)
        if j + 1 < m:
            H[j, j + 1] = b
            H[j + 1, j] = b
        else:
            beta = b
        Q[j + 1] = torch.where(good, w / torch.clamp_min(b, tiny), 0.0)
    return Q, H, beta


def _ritz(Q, H, beta, k: int):
    """The k largest eigenpairs of the projected H: (values, Ritz vectors
    (n, k), residuals |β·sₘᵢ|, couplings β·sₘᵢ, and the floor below the
    Ritz spectrum: its lowest value less its width, at most 0)."""
    m = H.shape[0]
    evals, S = torch.linalg.eigh(H)  # ascending
    floor = torch.clamp_max(2 * evals[0] - evals[-1], 0.0)
    sel = torch.arange(m - 1, m - k - 1, -1, device=H.device)
    evals, S = evals[sel], S[:, sel]
    couple = beta * S[m - 1, :]
    return evals, Q[:m].T @ S, torch.abs(couple), couple, floor


def _solve(apply_fn: Callable, v0: torch.Tensor, tol: float,
           max_restarts: int, k: int, m: int):
    """The restarted solve for the k largest eigenpairs: (evals, vecs,
    resid) of the last round and (locked (k, n), lvals (k,), nl 0-d) of
    the locked pairs."""
    n = v0.shape[0]
    dtype = v0.dtype
    dev = v0.device
    eps = torch.finfo(dtype).tiny ** 0.5
    ulp = torch.finfo(dtype).eps
    matvecs = _counter("matvecs", "Lanczos operator applications")
    restarts = _counter("restarts", "Lanczos restart rounds")
    slot = torch.arange(k, device=dev)
    locked = torch.zeros((k, n), dtype=dtype, device=dev)
    lvals = torch.zeros((k,), dtype=dtype, device=dev)
    nl = torch.zeros((), dtype=torch.int64, device=dev)
    floor = torch.zeros((), dtype=dtype, device=dev)

    # the operator deflated by the locked vectors U, P·A·P + f·UᵀU with
    # P = I − UᵀU: a round hunts the REMAINING spectrum, and the locked
    # directions sit at the floor f, below it
    def mv(v):
        c = locked @ v
        w = apply_fn(v - locked.T @ c)
        return w - locked.T @ (locked @ w) + floor * (locked.T @ c)

    Q, H, beta = _lanczos_decomp(mv, m, v0=v0)
    matvecs.inc(m)
    # the first round sees the whole spectrum: its floor holds for the
    # solve
    evals, vecs, resid, couple, floor = _ritz(Q, H, beta, k)
    for _ in range(max_restarts):
        scale = torch.maximum(
            torch.max(torch.abs(evals)),
            torch.max(torch.where(slot < nl, torch.abs(lvals), 0.0)))
        conv = resid <= tol * torch.clamp_min(scale, 1e-30)
        # lock the converged pairs in extremal order up to the first one
        # not converged (a pair past it must not take a slot the better
        # pair still needs), reorthogonalised against the locked ones; a
        # duplicate leaves a remainder of ~ulp (the test is relative, as
        # in the JAX package)
        open_ = torch.ones((), dtype=torch.bool, device=dev)
        took = []
        for i in range(k):
            open_ = open_ & conv[i]
            u = vecs[:, i]
            u = u - locked.T @ (locked @ u)
            nrm = torch.linalg.vector_norm(u)
            take = open_ & (nl < k) & (nrm > 128.0 * ulp)
            row = torch.clamp_max(nl, k - 1).view(1)
            cur = locked.index_select(0, row)[0]
            locked.index_copy_(0, row, torch.where(
                take, u / torch.clamp_min(nrm, eps), cur)[None])
            lvals.index_copy_(0, row, torch.where(
                take, evals[i], lvals.index_select(0, row)[0]).view(1))
            nl = nl + take.to(nl.dtype)
            took.append(take)
        restarts.inc()
        # nothing left to chase: every wanted slot filled, or every pair
        # converged (an exhausted operator)
        if bool((nl >= k) | conv.all()):  # the round's one host read
            break
        # thick restart: the Ritz vectors not locked, the next Lanczos
        # vector and their couplings carry the subspace into the next
        # round (the reference restarts implicitly, keeping the wanted
        # Ritz subspace; the JAX package restarts from one vector); a
        # locked pair's slot becomes a zero row at the floor, never
        # selected
        keep = ~torch.stack(took)
        Y = torch.where(keep[:, None], vecs.T, 0.0)
        Q, H, beta = _lanczos_decomp(mv, m, kept=(
            Y, torch.where(keep, evals, floor),
            torch.where(keep, couple, 0.0), Q[m]))
        matvecs.inc(m - k)
        evals, vecs, resid, couple, _ = _ritz(Q, H, beta, k)
    return evals, vecs, resid, locked, lvals, nl


def _power_repair(apply_fn: Callable, basis: torch.Tensor, u: torch.Tensor,
                  shift: float, eps: float, iters: int = 64) -> torch.Tensor:
    """Deflated, spectrum-shifted power iteration: the repair engine of
    :func:`_lanczos`'s tail."""
    for _ in range(iters):
        w = apply_fn(u) + shift * u
        w = w - basis.T @ (basis @ w)
        nrm = torch.linalg.vector_norm(w)
        u = torch.where(nrm > eps, w / torch.clamp_min(nrm, eps), u)
    _counter("matvecs", "Lanczos operator applications").inc(iters)
    return u


def _lanczos(apply_fn: Callable, n: int, k: int, *, device: torch.device,
             ncv: Optional[int] = None,
             max_restarts: int = 15, tol: float = 1e-6, seed: int = 0,
             dtype=torch.float32, v0=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest eigenpairs: the solve and its host-side tail repair;
    ``apply_fn(v)`` is A·v."""
    expects(1 <= k < n, "lanczos: need 1 <= k < n")
    # larger single rounds beat many small restarted ones on dense bulk
    # spectra (the JAX package's sizing)
    m = int(ncv) if ncv is not None else min(n - 1, max(4 * k + 32, 64))
    expects(k < m <= n, "lanczos: need k < ncv <= n")
    # residuals bottom out near eps·scale: an unreachable tol would turn
    # convergence detection (and locking) off
    tol = max(float(tol), float(torch.finfo(dtype).eps) * 10)
    if v0 is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        v0 = torch.randn(n, generator=gen, device=device, dtype=dtype)
    v0 = torch.as_tensor(v0, device=device).to(dtype)
    _counter("solves", "Lanczos solves").inc()

    evals, vecs, resid, locked, lvals, nl = _solve(
        apply_fn, v0, tol, max_restarts, k, m)

    eps = float(torch.finfo(dtype).tiny) ** 0.5
    ulp = float(torch.finfo(dtype).eps)
    n_locked = int(nl)  # the solve's single host read
    if n_locked == 0:
        return evals, vecs
    if n_locked >= k:  # success: no further read
        order = torch.argsort(-lvals, stable=True)
        return lvals[order], locked.T[:, order]
    locked_vals = [float(v) for v in lvals[:n_locked].cpu()]

    # Partial convergence (rare): fill with the best unconverged Ritz
    # pairs, then complete a degenerate remainder by deflated power
    # iteration from random starts, so callers always get k columns of
    # eigenvector quality (the JAX package's repair, lanczos.py:385-457).
    extra_vals, extra_vecs = [], []

    def free_part(u):
        u = u - locked.T @ (locked @ u)
        for v in extra_vecs:
            u = u - v * torch.dot(v, u)
        return u

    for i in range(k):
        if n_locked + len(extra_vals) >= k:
            break
        u = free_part(vecs[:, i])
        nrm = float(torch.linalg.vector_norm(u))
        if nrm <= 128.0 * ulp:  # relative duplicate test
            continue
        extra_vals.append(float(evals[i]))
        extra_vecs.append(u / nrm)

    # A direction degenerate with a locked eigenvalue is unreachable from
    # the Krylov sequence; power-iterate random starts on the deflated,
    # shifted operator while the found direction beats the k-th best.
    shift_mag = max(float(torch.max(torch.abs(lvals[:max(n_locked, 1)]))),
                    float(torch.max(torch.abs(evals))), 1.0)
    shift = shift_mag
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    margin = float(tol) * shift_mag
    for _ in range(2 * k + 4):  # bound on repair attempts
        # deflate against everything found so far, repairs included
        basis = (locked if not extra_vecs
                 else torch.cat([locked, torch.stack(extra_vecs)], dim=0))
        u = free_part(torch.randn(n, generator=gen, device=device,
                                  dtype=dtype))
        nrm = float(torch.linalg.vector_norm(u))
        if nrm <= eps:
            break  # deflated space exhausted
        u = free_part(_power_repair(apply_fn, basis, u / nrm, shift, eps))
        nrm = float(torch.linalg.vector_norm(u))
        if nrm <= eps:
            break
        u = u / nrm
        lam = float(torch.dot(u, apply_fn(u)))
        if n_locked + len(extra_vals) >= k:
            # full: keep hunting only while each new dominant direction
            # beats the current k-th best value
            cur = sorted(locked_vals + extra_vals, reverse=True)
            if lam <= cur[k - 1] + margin:
                break
        extra_vals.append(lam)
        extra_vecs.append(u)
    all_vals = torch.tensor(locked_vals + extra_vals, dtype=dtype,
                            device=device)
    all_vecs = torch.cat([locked[:n_locked].T]
                         + [v[:, None] for v in extra_vecs], dim=1)
    order = torch.argsort(-all_vals, stable=True)[:k]
    return all_vals[order], all_vecs[:, order]


def _rayleigh_ascending(op, vecs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Rayleigh quotients vᵀAv of *vecs* on the unshifted operator,
    ascending, with the vectors in that order (one SpMV a column).  The
    shifted solve's Ritz values θ ≈ σ − λ are accurate relative to σ, and
    σ − θ keeps their absolute error however small λ is; a converged
    vector's quotient errs by the square of its angle to the eigenvector."""
    av = torch.stack([apply_matvec(op, vecs[:, i])
                      for i in range(vecs.shape[1])], dim=1)
    _counter("matvecs", "Lanczos operator applications").inc(vecs.shape[1])
    vals = (vecs * av).sum(dim=0)
    order = torch.argsort(vals, stable=True)
    return vals[order], vecs[:, order]


def _callable_device(device, v0) -> torch.device:
    if device is None and isinstance(v0, torch.Tensor):
        return v0.device
    return resolve_device(device)


@traced("raft_tpu.sparse.lanczos_smallest")
def lanczos_smallest(a: Union[CSR, Callable], n_components: int, *,
                     n: Optional[int] = None, ncv: Optional[int] = None,
                     max_restarts: int = 15, tol: float = 1e-6,
                     seed: int = 0, v0=None, dtype=torch.float32,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenpairs of a symmetric operator (reference
    ``computeSmallestEigenvectors``, sparse/solver/lanczos.cuh:68): (values
    (k,) ascending, vectors (n, k)).  *a* is a :class:`CSR` (solved on its
    device) or a ``matvec`` callable (pass *n*; it runs on *device*,
    ``None`` meaning *v0*'s device or the card)."""
    if isinstance(a, CSR):
        expects(a.shape[0] == a.shape[1], "lanczos: matrix must be square")
        sigma = _gershgorin_upper(a)
        op = matvec_operand(a)
        _, vecs = _lanczos(lambda v: sigma * v - apply_matvec(op, v),
                           a.shape[0], n_components, device=a.device,
                           ncv=ncv,
                           max_restarts=max_restarts, tol=tol, seed=seed,
                           dtype=a.data.dtype, v0=v0)
        return _rayleigh_ascending(op, vecs)
    expects(n is not None, "lanczos with a matvec callable needs n")
    evals, vecs = _lanczos(lambda v: -a(v), n, n_components,
                           device=_callable_device(device, v0),
                           ncv=ncv, max_restarts=max_restarts, tol=tol,
                           seed=seed, dtype=dtype, v0=v0)
    return -evals, vecs


@traced("raft_tpu.sparse.lanczos_largest")
def lanczos_largest(a: Union[CSR, Callable], n_components: int, *,
                    n: Optional[int] = None, ncv: Optional[int] = None,
                    max_restarts: int = 15, tol: float = 1e-6,
                    seed: int = 0, v0=None, dtype=torch.float32,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest eigenpairs (reference ``computeLargestEigenvectors``,
    sparse/solver/lanczos.cuh:132): (values (k,) descending, vectors (n,
    k)); the same operator contract as :func:`lanczos_smallest`."""
    if isinstance(a, CSR):
        expects(a.shape[0] == a.shape[1], "lanczos: matrix must be square")
        op = matvec_operand(a)
        return _lanczos(lambda v: apply_matvec(op, v), a.shape[0],
                        n_components, device=a.device, ncv=ncv,
                        max_restarts=max_restarts, tol=tol, seed=seed,
                        dtype=a.data.dtype, v0=v0)
    expects(n is not None, "lanczos with a matvec callable needs n")
    return _lanczos(a, n, n_components, device=_callable_device(device, v0),
                    ncv=ncv, max_restarts=max_restarts,
                    tol=tol, seed=seed, dtype=dtype, v0=v0)
