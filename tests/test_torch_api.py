"""The port's pyidto-style object API (``idto_tpu_torch/api.py``) against
the JAX package's ``idto_tpu/api.py``, float64 on the CPU: ``Solve`` and
``SolveFromWarmStart`` on the pendulum against
goldens/torch_api_pendulum.npz (``scripts/make_torch_goldens.py api``) at
1e-9, the warm start's fields included, and the accessors.  ``Solve`` of
every registered example under four configurations that together set every
option of ``SolverParameters`` (``Solve`` is a B=1 call of ``solve_batch``,
so this covers the three entry points).
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from idto_tpu_torch.api import TrajectoryOptimizer, WarmStart
from idto_tpu_torch.examples.registry import example_names, load_example
from idto_tpu_torch.optimizer.problem import (
    GradientsMethod,
    LinearSolverType,
    LinesearchMethod,
    SolverMethod,
)

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "torch_api_pendulum.npz")
ITERS = 4
RTOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _optimizer(**more):
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    return TrajectoryOptimizer(
        model, prob, params.replace(max_iterations=ITERS, **more)), q_guess


def test_solve_and_solve_from_warm_start_match_jax():
    ref = np.load(_GOLDEN)
    opt, q_guess = _optimizer()
    sol, stats = opt.Solve(q_guess.numpy())  # host arrays are accepted
    ws = opt.CreateWarmStart(q_guess)
    assert isinstance(ws, WarmStart) and ws.Delta == opt.params.Delta0
    sol_w, stats_w = opt.SolveFromWarmStart(ws)
    # Solve equals SolveFromWarmStart from the same guess.
    assert torch.equal(sol.q, sol_w.q)
    assert torch.equal(stats.cost, stats_w.cost)
    assert _rel(sol.q, ref["q"]) < RTOL
    assert _rel(stats.cost, ref["cost"]) < RTOL
    assert _rel(sol_w.q, ref["warm_solve_q"]) < RTOL
    assert _rel(ws.get_q(), ref["ws_q"]) < RTOL
    assert abs(ws.Delta - float(ref["ws_Delta"])) <= RTOL * float(
        ref["ws_Delta"])
    assert isinstance(ws.dq, np.ndarray) and isinstance(ws.dqH, np.ndarray)
    assert _rel(ws.dq, ref["ws_dq"]) < RTOL
    assert _rel(ws.dqH, ref["ws_dqH"]) < RTOL


def test_a_second_warm_solve_continues_from_the_first():
    opt, q_guess = _optimizer()
    ws = opt.CreateWarmStart(q_guess)
    opt.SolveFromWarmStart(ws)
    q1, Delta1 = ws.get_q(), ws.Delta
    _, stats = opt.SolveFromWarmStart(ws)
    assert float(stats.delta[0]) == Delta1
    assert float(stats.cost[0]) < float(
        opt.Solve(q_guess)[1].cost[0])
    ws.set_q(q1)
    assert np.array_equal(ws.get_q(), q1)


def test_solve_dispatches_the_linesearch():
    opt, q_guess = _optimizer(method=SolverMethod.LINESEARCH)
    _, stats = opt.Solve(q_guess)
    assert np.isfinite(stats.alpha[:ITERS].numpy()).all()
    assert np.isnan(stats.rho.numpy()).all()


def test_accessors_and_problem_updates():
    opt, q_guess = _optimizer()
    assert opt.time_step() == opt.prob.dt == 0.05
    assert opt.num_steps() == opt.prob.num_steps == 40
    assert opt.params.max_iterations == ITERS
    T = opt.num_steps()
    opt.ResetInitialConditions([0.3], np.array([0.1]))
    assert opt.prob.q_init.tolist() == [0.3]
    assert opt.prob.v_init.device == opt.model.mass.device
    q_nom = np.full((T + 1, 1), 2.0)
    opt.UpdateNominalTrajectory(q_nom, np.zeros((T + 1, 1)))
    assert np.array_equal(opt.prob.q_nom.numpy(), q_nom)
    guess = q_guess.clone()
    guess[0] = 0.3
    sol, _ = opt.Solve(guess)
    assert float(sol.q[0, 0]) == 0.3 and float(sol.v[0, 0]) == 0.1


# Four configurations that together set every method, linesearch, gradients
# method, linear solver and diagnostic of SolverParameters.
_EVERY_OPTION = (
    dict(method=SolverMethod.LINESEARCH,
         linesearch_method=LinesearchMethod.ARMIJO,
         gradients_method=GradientsMethod.FORWARD_DIFFERENCES,
         linear_solver=LinearSolverType.DENSE_LDLT),
    dict(method=SolverMethod.LINESEARCH,
         linesearch_method=LinesearchMethod.BACKTRACKING,
         gradients_method=GradientsMethod.CENTRAL_DIFFERENCES,
         record_iteration_times=True),
    dict(gradients_method=GradientsMethod.CENTRAL_DIFFERENCES4,
         linear_solver=LinearSolverType.CYCLIC_REDUCTION, verbose=True,
         debug_compare_against_dense=True, record_iteration_times=True),
    dict(exact_hessian=True, linear_solver=LinearSolverType.PENTA_LU),
)


@pytest.mark.parametrize("name", example_names())
def test_every_example_takes_every_option(name):
    """One iteration of each configuration at T=2: a finite trajectory
    that keeps q_0."""
    model, _, prob, params, q_guess = load_example(name, device="cpu")
    T = 2
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])
    for more in _EVERY_OPTION:
        opt = TrajectoryOptimizer(model, prob,
                                  params.replace(max_iterations=1, **more))
        with contextlib.redirect_stdout(io.StringIO()):
            sol, stats = opt.Solve(q_guess[: T + 1])
        assert sol.q.shape == (T + 1, model.nq)
        assert torch.isfinite(sol.q).all() and torch.isfinite(sol.tau).all()
        assert torch.equal(sol.q[0], q_guess[0])
        assert int(stats.num_iters) == 1
