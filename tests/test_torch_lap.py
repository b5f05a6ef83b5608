"""The port's batched LAP solver (``raft_tpu_torch.solver``) against
raft_tpu and scipy on the CPU, on the same seeded costs.

The port follows the JAX package's bids round for round (the same ε
schedule, tie rules and float arithmetic), so assignments are held
equal: on integer costs with ε < 1/n (both then optimal) and on float
costs too.  Objectives and duals are sums of n terms in another order:
rtol 1e-5.  Against scipy's ``linear_sum_assignment``: integer costs
exactly optimal, float costs within n·ε_eff, ``converged`` equal to the
JAX package's, the duality gap within [−1e-4, n·ε_eff + 1e-4].
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import raft_tpu.solver as jsol
import raft_tpu_torch.solver as tsol
import raft_tpu_torch.solver.linear_assignment as tla
from raft_tpu_torch.core.error import LogicError


def costs_of(kind, n, seed, batch=3):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 100, (batch, n, n)).astype(np.float32)
    if kind == "int64_wide":           # past float32's ULP floor
        return rng.integers(0, 2_000_000, (batch, n, n)).astype(np.int64)
    if kind == "ties":                 # duplicate rows: exact ties
        c = rng.integers(0, 10, (batch, n, n)).astype(np.float32)
        c[:, 1] = c[:, 0]
        return c
    return rng.uniform(0, 100, (batch, n, n)).astype(np.float32)


def scipy_opt(c):
    r, k = linear_sum_assignment(c)
    return float(c[r, k].astype(np.float64).sum())


CASES = [("int", 8, 0), ("int", 24, 1), ("int", 40, 2), ("float", 8, 3),
         ("float", 32, 4), ("float", 48, 5), ("ties", 16, 6),
         ("int64_wide", 16, 7)]


@pytest.mark.parametrize("kind,n,seed", CASES)
def test_solve_lap_parity(kind, n, seed):
    c = costs_of(kind, n, seed)
    exact = kind != "float"
    eps = 1.0 / (2 * n) if exact else 1e-6
    j = jsol.solve_lap(c, epsilon=eps)
    t = tsol.solve_lap(torch.from_numpy(c), epsilon=eps)
    jr = np.asarray(j.row_assignment)
    assert t.row_assignment.dtype == torch.int32
    assert np.array_equal(t.row_assignment.numpy(), jr)
    assert np.array_equal(t.col_assignment.numpy(),
                          np.asarray(j.col_assignment))
    assert np.array_equal(t.converged.numpy(), np.asarray(j.converged))
    for name in ("objective", "row_duals", "col_duals"):
        want = np.asarray(getattr(j, name), np.float64)
        np.testing.assert_allclose(getattr(t, name).double().numpy(), want,
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max())
    spread = max(float(c.max() - c.min()), 1.0)
    dt = t.objective.dtype
    eps_eff = max(eps, spread * 8 * torch.finfo(dt).eps)
    for b in range(c.shape[0]):
        r = t.row_assignment[b].numpy()
        assert np.array_equal(np.sort(r), np.arange(n))
        got = float(c[b][np.arange(n), r].astype(np.float64).sum())
        opt = scipy_opt(c[b])
        if exact:
            assert got == opt
        else:
            assert got <= opt + n * eps_eff + 1e-4
        gap = float(t.residual[b])
        assert -1e-4 * max(1.0, abs(opt)) <= gap \
            <= n * eps_eff + 1e-4 * max(1.0, abs(opt))
    if kind == "int64_wide":
        # integer costs past float32's floor are solved in float64
        assert t.objective.dtype == torch.float64


def test_squeeze_and_single_rows():
    c = costs_of("float", 12, 9)[0]
    t = tsol.solve_lap(torch.from_numpy(c))
    j = jsol.solve_lap(c)
    assert tuple(t.row_assignment.shape) == (12,)
    assert np.array_equal(t.row_assignment.numpy(),
                          np.asarray(j.row_assignment))
    one = tsol.solve_lap(np.array([[3.0]], np.float32), device="cpu")
    assert one.row_assignment.tolist() == [0] and float(one.objective) == 3
    with pytest.raises(LogicError, match="square"):
        tsol.solve_lap(torch.zeros(2, 3, 4))


def test_round_cap_and_completion_fallback():
    """A cap of one round a phase leaves rows unassigned: the completion
    fallback seats them, the result is still a permutation, and
    ``converged`` says so — as in the JAX package."""
    c = costs_of("float", 20, 10)
    j = jsol.solve_lap(c, max_rounds_per_phase=1)
    t = tsol.solve_lap(torch.from_numpy(c), max_rounds_per_phase=1)
    assert not bool(t.converged.any())
    assert np.array_equal(t.converged.numpy(), np.asarray(j.converged))
    assert np.array_equal(t.row_assignment.numpy(),
                          np.asarray(j.row_assignment))
    for b in range(3):
        assert np.array_equal(np.sort(t.row_assignment[b].numpy()),
                              np.arange(20))


@pytest.mark.parametrize("rounds", [1, 3, 16])
def test_rounds_between_reads_do_not_change_the_result(monkeypatch, rounds):
    """Rounds run after a problem finished change nothing, and each
    problem counts its own rounds, so the block of rounds between host
    reads leaves the result the round-by-round loop's."""
    c = torch.from_numpy(costs_of("float", 24, 11, batch=4))
    monkeypatch.setattr(tla, "ROUNDS_PER_READ", 1)
    ref = tsol.solve_lap(c)
    monkeypatch.setattr(tla, "ROUNDS_PER_READ", rounds)
    got = tsol.solve_lap(c)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_class_surface_and_duality():
    n, b = 16, 3
    c = costs_of("float", n, 12, batch=b)
    tlap = tsol.LinearAssignmentProblem(n, b, 1e-6, device="cpu")
    jlap = jsol.LinearAssignmentProblem(n, b, 1e-6)
    tlap.solve(c)
    jlap.solve(c)
    assert np.array_equal(tlap.get_row_assignments().numpy(),
                          np.asarray(jlap.get_row_assignments()))
    assert np.array_equal(tlap.get_col_assignments().numpy(),
                          np.asarray(jlap.get_col_assignments()))
    for i in range(b):
        for name in ("get_primal_objective_value",
                     "get_dual_objective_value"):
            np.testing.assert_allclose(float(getattr(tlap, name)(i)),
                                       float(getattr(jlap, name)(i)),
                                       rtol=1e-5)
        u = tlap.get_row_dual_vector(i).numpy()
        v = tlap.get_col_dual_vector(i).numpy()
        assert np.all(u[:, None] + v[None, :] <= c[i] + 1e-3)
    with pytest.raises(LogicError, match="expected"):
        tlap.solve(c[:2])
    with pytest.raises(LogicError, match="solve"):
        tsol.LinearAssignmentProblem(n, b, device="cpu").get_row_assignments()
