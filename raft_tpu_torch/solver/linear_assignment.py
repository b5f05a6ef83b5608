"""Batched linear assignment (port of
``raft_tpu/solver/linear_assignment.py``; reference
solver/linear_assignment.cuh:53 ``LinearAssignmentProblem``).

The JAX package's design, kept here: Bertsekas' forward auction with
ε-scaling instead of the reference's Hungarian alternating trees.  Every
round is dense row-parallel work over the batch — each unassigned row
bids for its best column (best and second-best value), each column goes
to its highest bidder (the lowest row among equal bids), the previous
owner is evicted.  With integer costs and ε < 1/n the result is optimal;
with float costs it is ε-optimal (primal − dual ≤ n·ε_eff).  Every
arithmetic step and tie rule is the JAX package's, so on the CPU the
port follows the same bids round for round.

Where the JAX loop is a ``lax.while_loop`` on the device, the port runs
``ROUNDS_PER_READ`` rounds between two host reads of "is any row still
bidding": a round run after a problem finished changes nothing (no row
bids), and each problem counts its own rounds against its cap, so the
result is the one the round-by-round loop gives.  Reads per solve: one
per block of rounds in each ε phase, one per phase of the ε schedule and
two more (the cost spread, the final phase's convergence).  On the card
a round is launch-bound (its ~30 eager operations, not the n² bytes it
reads), so rounds, not bytes, set a solve's time.

Counters: ``raft_tpu_lap_solves_total``, ``raft_tpu_lap_phases_total``
(auction phases run), ``raft_tpu_lap_rounds_total`` (rounds run, a
block's no-op rounds included) and ``raft_tpu_lap_reads_total`` (host
reads of a flag).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device

#: auction rounds run between two host reads of the convergence flag
ROUNDS_PER_READ = 16


def _counter(name: str, help: str):
    return telemetry.counter(f"raft_tpu_lap_{name}_total", help)


class LAPResult(NamedTuple):
    """Solution of a batch of assignment problems.  ``converged[b]`` is
    False when the final auction phase hit its round cap and leftover rows
    were assigned by the completion fallback (the permutation is valid,
    but the n·ε_eff bound no longer certifies it); ``residual[b]`` is the
    duality gap primal − dual, ≤ n·ε_eff whenever the bound holds (up to
    rounding)."""

    row_assignment: torch.Tensor   # (batch, n) int32: column of each row
    col_assignment: torch.Tensor   # (batch, n) int32: row of each column
    objective: torch.Tensor        # (batch,) Σ cost[i, σ(i)]
    row_duals: torch.Tensor        # (batch, n) u_i
    col_duals: torch.Tensor        # (batch, n) v_j
    converged: torch.Tensor        # (batch,) bool
    residual: torch.Tensor         # (batch,) primal − dual


def _auction_phase(benefit, prices, eps, live, max_rounds: int):
    """One ε phase of the forward auction (Jacobi bidding) on a batch of
    (n, n) benefit matrices from *prices*; problems where *live* is False
    place no bid.  Returns (row_to_col, col_to_row, prices).  A round is a
    fixed sequence of about 30 tensor operations on whole (batch, n, n)
    and (batch, n) tensors; row and column n of the buffers are the sink
    of the rows that do not bid."""
    bsz, n, _ = benefit.shape
    dev = benefit.device
    r2c = torch.full((bsz, n + 1), -1, dtype=torch.int64, device=dev)
    c2r = torch.full((bsz, n), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros(bsz, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev).expand(bsz, n)
    best_bid = torch.empty((bsz, n + 1), dtype=benefit.dtype, device=dev)
    winner = torch.empty((bsz, n + 1), dtype=torch.int64, device=dev)
    eps = eps[:, None]
    _counter("phases", "LAP auction phases").inc()
    rounds_c = _counter("rounds", "LAP auction rounds, no-op rounds of a "
                        "block included")
    reads_c = _counter("reads", "LAP host reads of a flag")
    while True:
        for _ in range(ROUNDS_PER_READ):
            unassigned = r2c[:, :n] < 0
            active = live & unassigned.any(1) & (rounds < max_rounds)
            bidder = unassigned & active[:, None]
            value = benefit - prices[:, None, :]
            top1, best_j = value.max(2)
            if n >= 2:
                value.scatter_(2, best_j[:, :, None], -math.inf)
                gap = top1 - value.amax(2)
            else:
                gap = torch.zeros_like(top1)
            bid = torch.gather(prices, 1, best_j) + gap + eps
            # the highest bid for each column among its bidders, and the
            # lowest bidding row that placed it
            target = torch.where(bidder, best_j, n)
            best_bid.fill_(-math.inf).scatter_reduce_(1, target, bid, "amax")
            won = bidder & (bid == torch.gather(best_bid, 1, target))
            winner.fill_(n).scatter_reduce_(1, target,
                                            torch.where(won, rows, n),
                                            "amin")
            got = best_bid[:, :n] > -math.inf
            # evict the previous owners, then seat the winners (winners
            # bid unassigned, owners are assigned: disjoint rows)
            r2c.scatter_(1, torch.where(got & (c2r >= 0), c2r, n), -1)
            r2c.scatter_(1, torch.where(got, winner[:, :n], n), rows)
            c2r = torch.where(got, winner[:, :n], c2r)
            prices = torch.where(got, best_bid[:, :n], prices)
            rounds += active
        rounds_c.inc(ROUNDS_PER_READ)
        reads_c.inc()
        if not bool((live & (r2c[:, :n] < 0).any(1)
                     & (rounds < max_rounds)).any()):
            return r2c[:, :n], c2r, prices


def _solve(cost, final_eps: float, scaling_factor: float,
           max_rounds: int):
    """ε-scaled auction for a batch of (n, n) cost matrices."""
    bsz, n, _ = cost.shape
    dt = cost.dtype
    benefit = -cost
    flat = cost.reshape(bsz, -1)
    spread = torch.clamp_min(flat.amax(1) - flat.amin(1), 1.0)
    # ε is floored at a multiple of the price scale's ULP: below it,
    # price + ε == price, an evicted duplicate re-bids the same forever and
    # the phase stalls at its cap; the bound becomes n·ε_eff
    eps_eff = torch.maximum(spread * 8 * torch.finfo(dt).eps,
                            torch.tensor(final_eps, dtype=dt,
                                         device=cost.device))
    max_ratio = 1.0 / (16 * torch.finfo(dt).eps)
    n_phases = 1 + max(1, int(math.ceil(math.log(max_ratio)
                                        / math.log(scaling_factor))))
    prices = torch.zeros((bsz, n), dtype=dt, device=cost.device)
    eps = spread / 2
    done = torch.zeros(bsz, dtype=torch.bool, device=cost.device)
    reads = _counter("reads", "LAP host reads of a flag")
    for _ in range(n_phases):
        reads.inc()
        if bool(done.all()):
            break
        _, _, new_prices = _auction_phase(benefit, prices, eps, ~done,
                                          max_rounds)
        prices = torch.where(done[:, None], prices, new_prices)
        next_eps = torch.maximum(eps / scaling_factor, eps_eff)
        done = done | (eps <= eps_eff)
        eps = next_eps
    live = torch.ones(bsz, dtype=torch.bool, device=cost.device)
    r2c, c2r, prices = _auction_phase(benefit, prices, eps_eff, live,
                                      max_rounds)
    converged = (r2c >= 0).all(1)
    reads.inc()
    if not bool(converged.all()):
        # completion: each leftover row, in row order, takes its best free
        # column (the JAX package's fallback; among sub-ε ties it loses
        # nothing and keeps the result a permutation)
        for b in torch.nonzero(~converged).flatten().tolist():
            free = c2r[b] < 0
            for i in torch.nonzero(r2c[b] < 0).flatten().tolist():
                v = torch.where(free, benefit[b, i] - prices[b],
                                torch.tensor(-math.inf, dtype=dt,
                                             device=cost.device))
                j = int(torch.argmax(v))
                r2c[b, i], c2r[b, j], free[j] = j, i, False
    objective = torch.gather(cost, 2, r2c[:, :, None])[:, :, 0].sum(1)
    u = (benefit - prices[:, None, :]).amax(2)
    residual = objective - ((-u).sum(1) + (-prices).sum(1))
    return (r2c.to(torch.int32), c2r.to(torch.int32), objective, -u,
            -prices, converged, residual)


def solve_lap(costs, epsilon: float = 1e-6, scaling_factor: float = 8.0,
              max_rounds_per_phase: int = 0, *, device=None) -> LAPResult:
    """Solve a batch of n × n min-cost assignment problems: *costs* is
    (batch, n, n) or (n, n).  The assignment's objective is within
    n·ε_eff of optimal, ε_eff = max(*epsilon*, spread · 8 · ε_machine):
    the floor keeps bids above the ULP of the price scale.  With integer
    costs pass *epsilon* < 1/n for the exact optimum; when the float32
    floor would exceed *epsilon*, integer costs are solved in float64
    (which the card always has), other costs keep the floor and a warning
    is logged.  A round cap of *max_rounds_per_phase* (0: 16n + 256) ends
    a phase that stalls.  Arrays go to *device* (``None``: the card);
    tensors stay where they are."""
    from raft_tpu_torch.core.logger import log_warn

    if not isinstance(costs, torch.Tensor):
        costs = torch.as_tensor(np.asarray(costs),
                                device=resolve_device(device))
    squeeze = costs.ndim == 2
    if squeeze:
        costs = costs[None]
    expects(costs.ndim == 3 and costs.shape[1] == costs.shape[2],
            "solve_lap: costs must be (batch, n, n) square")
    n = costs.shape[1]
    if max_rounds_per_phase <= 0:
        max_rounds_per_phase = 16 * n + 256
    dt = torch.promote_types(costs.dtype, torch.float32)
    if costs.numel():
        _counter("reads", "LAP host reads of a flag").inc()
        spread = max(float(costs.max() - costs.min()), 1.0)
        floor = spread * 8 * torch.finfo(dt).eps
        if floor > float(epsilon):
            integer = not (costs.dtype.is_floating_point
                           or costs.dtype.is_complex
                           or costs.dtype == torch.bool)
            # exempt(dtype-drift): integer costs solve in float64 (exact to 2^53)
            if integer and dt != torch.float64:
                # exempt(dtype-drift): integer costs solve in float64 (exact to 2^53)
                dt = torch.float64
            else:
                log_warn("solve_lap: requested epsilon=%g is below the f%d "
                         "ULP floor %g at cost spread %g — the optimality "
                         "bound degrades to n*%g", float(epsilon),
                         torch.finfo(dt).bits, floor, spread, floor)
    _counter("solves", "LAP solves").inc()
    res = LAPResult(*_solve(costs.to(dt), float(epsilon),
                            float(scaling_factor), int(max_rounds_per_phase)))
    if squeeze:
        res = LAPResult(*(a[0] for a in res))
    return res


class LinearAssignmentProblem:
    """The reference's class surface (solver/linear_assignment.cuh:53):
    ``solve(cost_matrices)`` stores the assignments, duals and objectives
    behind the reference's getters."""

    def __init__(self, size: int, batchsize: int = 1, epsilon: float = 1e-6,
                 *, device=None):
        self.size = int(size)
        self.batchsize = int(batchsize)
        self.epsilon = float(epsilon)
        self.device = device
        self._result: Optional[LAPResult] = None

    def solve(self, cost_matrices) -> LAPResult:
        costs = (cost_matrices if isinstance(cost_matrices, torch.Tensor)
                 else torch.as_tensor(np.asarray(cost_matrices),
                                      device=resolve_device(self.device)))
        if costs.ndim == 2:
            costs = costs[None]
        expects(tuple(costs.shape) == (self.batchsize, self.size, self.size),
                f"expected ({self.batchsize}, {self.size}, {self.size}) "
                f"costs")
        self._result = solve_lap(costs, self.epsilon)
        return self._result

    def _res(self) -> LAPResult:
        expects(self._result is not None, "call solve() first")
        return self._result

    # the reference's getters (linear_assignment.cuh:118-170)
    def get_row_assignments(self):
        return self._res().row_assignment

    def get_col_assignments(self):
        return self._res().col_assignment

    def get_primal_objective_value(self, batch: int = 0):
        return self._res().objective[batch]

    def get_dual_objective_value(self, batch: int = 0):
        r = self._res()
        return torch.sum(r.row_duals[batch]) + torch.sum(r.col_duals[batch])

    def get_row_dual_vector(self, batch: int = 0):
        return self._res().row_duals[batch]

    def get_col_dual_vector(self, batch: int = 0):
        return self._res().col_duals[batch]
