"""The port's linesearch solver (``optimizer/linesearch.py``) against the
JAX package's ``solve_linesearch``, float64 on the CPU: Armijo on the
pendulum and backtracking with the exact-l1 merit on the hopper (equality
constraints), from goldens/torch_linesearch_{pendulum,hopper}.npz
(``scripts/make_torch_goldens.py linesearch``).

Tolerances: 1e-9 on the pendulum; 1e-6 on the hopper, whose unscaled
Hessian (condition ~1e9 and more) and Schur multipliers amplify the
packages' rounding differences.  The statistics keep the JAX package's
conventions: rho, delta and h_norm NaN, dqH_norm equal to dq_norm, ls_iters
counting the evaluation at alpha = 1, the flag LINESEARCH_MAX_ITERS when a
search uses up its iterations.
"""
import os

import numpy as np
import pytest
import torch

from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.optimizer import solver
from idto_tpu_torch.optimizer.problem import LinesearchMethod, SolverMethod
from idto_tpu_torch.optimizer.solver import SolverFlag
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
# example: (linesearch method, iterations)
CASES = {"pendulum": ("armijo", 6), "hopper": ("backtracking", 3)}
RTOL = {"pendulum": 1e-9, "hopper": 1e-6}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _params(params, name, **more):
    method, iters = CASES[name]
    return params.replace(method=SolverMethod.LINESEARCH,
                          linesearch_method=LinesearchMethod(method),
                          max_iterations=iters, **more)


@pytest.mark.parametrize("name", sorted(CASES))
def test_linesearch_matches_jax(name):
    ref = np.load(os.path.join(_GOLDENS, f"torch_linesearch_{name}.npz"))
    model, _, prob, params, q_guess = load_example(name, device="cpu")
    sol, stats, warm = solver.solve(model, prob, _params(params, name),
                                    q_guess)
    tol = RTOL[name]
    assert int(stats.num_iters) == int(ref["num_iters"])
    assert int(stats.solver_flag) == int(ref["solver_flag"])
    assert np.array_equal(stats.ls_iters.numpy(), ref["ls_iters"])
    assert _rel(sol.q, ref["q"]) < tol
    assert _rel(sol.tau, ref["tau"]) < tol
    for key in ("cost", "alpha", "dq_norm", "grad_norm", "merit"):
        assert _rel(getattr(stats, key), ref[key]) < tol, key
    assert _rel(warm.dq, ref["warm_dq"]) < tol
    assert _rel(warm.dqH, ref["warm_dqH"]) < tol
    assert float(warm.Delta) == float(ref["warm_Delta"]) == params.Delta0
    # The conventions.
    for key in ("rho", "delta", "h_norm"):
        assert np.isnan(getattr(stats, key).numpy()).all(), key
        assert np.isnan(ref[key]).all(), key
    assert torch.equal(stats.dqH_norm, stats.dq_norm)
    assert (stats.ls_iters[: int(stats.num_iters)] >= 0).all()


def test_linesearch_reports_a_search_that_ran_out():
    """One search iteration allowed: Armijo counts the evaluation at
    alpha = 1, so the first search uses it up and the solve stops."""
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    _, stats, _ = solver.solve(model, prob, _params(
        params, "pendulum", max_linesearch_iterations=1), q_guess)
    assert int(stats.num_iters) == 1
    assert int(stats.ls_iters[0]) == 1
    assert int(stats.solver_flag) == int(SolverFlag.LINESEARCH_MAX_ITERS)


@pytest.mark.parametrize("method", ["armijo", "backtracking"])
def test_a_batch_searches_each_scenario_on_its_own(method):
    """A batch of three equals three solves of one: the masks keep each
    scenario's search and iteration count its own."""
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    p = params.replace(method=SolverMethod.LINESEARCH,
                       linesearch_method=LinesearchMethod(method),
                       max_iterations=3)
    rng = np.random.default_rng(2)
    qg = q_guess[None] + torch.as_tensor(
        [[[0.0]], [[0.3]], [[1.0]]]) * torch.as_tensor(
        rng.standard_normal((3,) + tuple(q_guess.shape)))
    qg[:, 0] = prob.q_init
    sol, stats, _ = solve_batch(model, broadcast_problem(prob, 3), p, qg)
    for b in range(3):
        one, st1, _ = solver.solve(model, prob, p, qg[b])
        assert _rel(sol.q[b], one.q) < 1e-12
        assert torch.equal(stats.ls_iters[b], st1.ls_iters)
        assert _rel(stats.alpha[b], st1.alpha) < 1e-12
