"""Equality constraints in the port: the constraint Jacobian, the Schur
multiplier solve, the merit and its gradient, the constrained batched
solve, the solver's cyclic-reduction routes and the degraded-solve rescue,
against the JAX package.

  * The tail of one iteration (``_prepare_from_physics``) on spinner and
    hopper at a horizon of 5 steps: the port's physics (held to the JAX
    package's in tests/test_torch_soa.py) is handed to both packages, so
    what is compared is the linear-algebra tail alone, each route of the
    port against the same solver in the JAX package (Thomas; the fused
    Pallas kernel in interpret mode; level-wise cyclic reduction).
    Tolerance 1e-9 relative: the same float64 expressions in another
    summation order.  One exception, measured: the hopper's scaled Hessians
    have condition ~1e9 and h - J~ H~^-1 g~ cancels several digits, so
    cyclic reduction, which does not pivot across blocks, leaves the
    multipliers and the Newton step at ~1e-6..1e-5 of the JAX package's own
    cyclic reduction (merit and merit gradient stay within 1e-9, and Thomas
    holds everything to 1e-9): 1e-4 for those two there.
  * ``solve_batch`` on acrobot, spinner and hopper at their YAML settings
    against goldens/torch_constraints_*.npz, which
    scripts/make_torch_goldens.py writes from ``idto_tpu``
    ``solve_batch(native=True)`` (compiling those solves takes minutes).
    Tolerances are those of tests/test_batched.py: q rtol 1e-7 atol 1e-9,
    tau and the per-iteration statistics rtol 1e-6.  The acrobot runs
    without scaling and its Hessian has condition ~1e10, measured: against
    the golden, Thomas leaves q at 1.6e-6 (absolute), tau at 3.5e-5 and the
    statistics at 2.3e-6, and the cyclic-reduction routes, which do not
    pivot across blocks, q at 1.6e-3, tau at 0.12 (of 50) and the statistics
    at 2e-3.  It is held to (1e-5, 2e-4, 1e-5) through Thomas, its YAML
    solver, and to (5e-3, 0.5, 5e-3) through cyclic reduction.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idto_tpu.examples.registry import load_example as jax_load_example
from idto_tpu.optimizer import solver as jsolver
from idto_tpu.optimizer.partials import IdPartials as JIdPartials
from idto_tpu.optimizer.problem import LinearSolverType as JLinearSolverType
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.ops import cr_kernel, cyclic_reduction, penta
from idto_tpu_torch.optimizer import batched, solver
from idto_tpu_torch.optimizer.problem import LinearSolverType
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch
from idto_tpu_torch.soa import partials as soa_partials
from idto_tpu_torch.soa import rollout

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

RTOL = 1e-9
# Multipliers and Newton step through cyclic reduction on the hopper.
HOPPER_CR_RTOL = 1e-4
_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")

CR = LinearSolverType.CYCLIC_REDUCTION
# (linear_solver, cr_use_pallas): Thomas, the fused reduction, level-wise.
ROUTES = [(LinearSolverType.PENTA_LU, None), (CR, None), (CR, False)]
ROUTE_IDS = ["thomas", "cr_fused", "cr_levels"]


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _short(prob, T):
    """The problem cut to a horizon of T steps."""
    return prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])


def _physics(name, T, B, seed):
    """The port's example cut to T steps, B seeded trajectories around its
    guess, and the physics of one iteration."""
    model, _, prob, params, q_guess = load_example(name, device="cpu")
    prob = _short(prob, T)
    rng = np.random.default_rng(seed)
    qs = q_guess[: T + 1].numpy()[None] + 0.05 * rng.standard_normal(
        (B, T + 1, model.nq))
    qs[:, 0] = prob.q_init.numpy()
    qs = torch.as_tensor(qs)
    probs = broadcast_problem(prob, B)
    tau, v = rollout.generalized_forces(model, probs, params.contact, qs)
    cost = rollout.cost(model, probs, params.contact, qs, tau=tau, v=v)
    parts = soa_partials.id_partials_batched(model, probs, params.contact, qs)
    nplus = soa_partials.nplus_stack_batched(model, qs)
    D_prev = torch.as_tensor(rng.uniform(0.5, 1.0, tuple(qs.shape)))
    return model, probs, params, qs, D_prev, cost, v, tau, parts, nplus


def _jax_tail(name, T, physics, b, route):
    """idto_tpu's ``_prepare_from_physics`` on scenario b of the port's
    physics, with its own model, problem and YAML solver settings, and the
    same linear solver: Thomas, the fused Pallas kernel (interpret mode) for
    the port's fused route, or its level-wise cyclic reduction."""
    _, _, _, qs, D_prev, cost, v, tau, parts, nplus = physics
    jm, _, jprob, jparams, _ = jax_load_example(name)
    jprob = _short(jprob, T)
    jparams = jparams.replace(
        linear_solver=JLinearSolverType(route[0].value),
        cr_use_pallas={None: True, False: False}[route[1]])

    def j(x):
        return jnp.asarray(x[b].numpy())

    jparts = JIdPartials(*(j(p) for p in parts))
    prep = jsolver._prepare_from_physics(
        jm, jprob, jparams, j(qs), j(D_prev), j(cost), j(v), j(tau), jparts,
        j(nplus))
    J = jsolver._constraint_jacobian_dense(
        jm, jprob, jparts, jm.unactuated_vdofs, jnp.float64)
    return prep, J


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("name", ["spinner", "hopper"])
def test_constraint_tail_matches_jax(name, route):
    T, B = 5, 2
    physics = _physics(name, T, B, seed=3)
    model, probs, params = physics[:3]
    assert params.equality_constraints and model.unactuated_vdofs
    params = params.replace(linear_solver=route[0], cr_use_pallas=route[1])
    prep = solver._prepare_from_physics(model, probs, params, *physics[3:])
    n_h = T * len(model.unactuated_vdofs)
    assert prep.lam.shape == (B, n_h) and prep.h.shape == (B, n_h)
    J = solver._constraint_jacobian_dense(
        model, probs, physics[8], model.unactuated_vdofs)
    assert not J[:, :, 0].any()  # q_0 is not a decision variable
    loose = name == "hopper" and route[0] == CR
    solve_rtol = HOPPER_CR_RTOL if loose else RTOL
    for b in range(B):
        jprep, jJ = _jax_tail(name, T, physics, b, route)
        assert _rel(J[b], jJ) < RTOL
        assert _rel(prep.h[b], jprep.h) < RTOL
        assert _rel(prep.lam[b], jprep.lam) < solve_rtol
        assert _rel(prep.merit[b], jprep.merit) < RTOL
        assert _rel(prep.g_merit[b], jprep.g_merit) < RTOL
        assert _rel(prep.p_newton[b], jprep.p_newton) < solve_rtol
        assert _rel(prep.p_cauchy[b], jprep.p_cauchy) < RTOL
        assert bool(prep.solve_ok[b]) and bool(jprep.solve_ok)
        assert bool(prep.fact_ok[b]) and bool(jprep.fact_ok)


def _golden_solve(name, route):
    ref = np.load(os.path.join(_GOLDENS, f"torch_constraints_{name}.npz"))
    model, _, prob, params, _ = load_example(name, device="cpu")
    params = params.replace(
        max_iterations=int(ref["max_iterations"]), linear_solver=route[0],
        cr_use_pallas=route[1])
    qg = torch.as_tensor(ref["q_guess"])
    return ref, solve_batch(model, broadcast_problem(prob, qg.shape[0]),
                            params, qg)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("name", ["acrobot", "spinner", "hopper"])
def test_constrained_solve_matches_jax_golden(name, route):
    """The example's own YAML settings but for the linear solver's route:
    every route solves the same systems."""
    ref, (sol, stats, _) = _golden_solve(name, route)
    q_atol, tau_atol, s_rtol = 1e-9, 1e-8, 1e-6
    if name == "acrobot":
        q_atol, tau_atol, s_rtol = ((5e-3, 0.5, 5e-3) if route[0] == CR
                                    else (1e-5, 2e-4, 1e-5))
    np.testing.assert_allclose(sol.q.numpy(), ref["q"], rtol=1e-7,
                               atol=q_atol)
    np.testing.assert_allclose(sol.tau.numpy(), ref["tau"], rtol=1e-6,
                               atol=tau_atol)
    np.testing.assert_array_equal(stats.num_iters.numpy(), ref["num_iters"])
    np.testing.assert_array_equal(stats.solver_flag.numpy(),
                                  ref["solver_flag"])
    for key in ("cost", "rho", "h_norm", "merit", "delta"):
        np.testing.assert_allclose(getattr(stats, key).numpy(), ref[key],
                                   rtol=s_rtol, atol=1e-9, err_msg=key)
    assert float(stats.h_norm.min()) > 0.0  # the constraints are active


@pytest.mark.parametrize("name", ["pendulum", "acrobot", "spinner", "hopper",
                                  "airhockey", "mini_cheetah"])
def test_every_registered_example_solves_at_its_yaml_settings(name):
    model, _, prob, params, q_guess = load_example(name, device="cpu")
    params = params.replace(max_iterations=1)
    sol, stats, _ = solve_batch(model, broadcast_problem(prob, 1), params,
                                q_guess[None])
    assert bool(torch.isfinite(sol.q).all())
    assert bool(torch.isfinite(stats.cost).all())
    n_h = prob.num_steps * len(model.unactuated_vdofs)
    if params.equality_constraints and n_h:
        assert bool(torch.isfinite(stats.h_norm).all())
    else:
        assert not stats.h_norm.any()


@pytest.mark.parametrize("use,n_rows,tail", [
    (None, 21, 0), (None, 641, 0), (False, 21, 1), (False, 641, 1),
    (True, 21, 0), (True, 128, 0), (True, 129, 64), (True, 641, 64),
])
def test_cr_use_pallas_picks_the_route(use, n_rows, tail):
    """None: the fused kernel whatever the size; False: level-wise
    throughout; True: fused up to 64 packed super-rows, beyond that
    level-wise down to 64 rows and the kernel on the tail."""
    params = load_example("pendulum", device="cpu")[3].replace(
        linear_solver=CR, cr_use_pallas=use)
    assert solver._hybrid_tail_rows(params, n_rows) == tail


def test_hybrid_route_is_reached_from_solve_batch():
    """A horizon of 130 steps packs into 66 super-rows: with
    ``cr_use_pallas=True`` the solve goes level-wise to 33 rows and leaves
    them to the fused reduction.  Same solution as Thomas to 1e-8 (three
    float64 iterations; the systems' condition amplifies eps)."""
    T = 130
    model, _, prob, params, _ = load_example("pendulum", device="cpu")
    q_nom = prob.q_nom[-1].expand(T + 1, model.nq)
    prob = prob.replace(num_steps=T, q_nom=q_nom,
                        v_nom=torch.zeros((T + 1, model.nv),
                                          dtype=q_nom.dtype))
    rng = np.random.default_rng(0)
    qg = 0.1 * rng.standard_normal((2, T + 1, model.nq))
    qg[:, 0] = prob.q_init.numpy()
    qg = torch.as_tensor(qg)
    probs = broadcast_problem(prob, 2)
    params = params.replace(max_iterations=3)
    hybrid = params.replace(linear_solver=CR, cr_use_pallas=True)
    calls = []
    real = cr_kernel.solve_tridiag

    def spy(L, C, U, b, rows=None):
        calls.append(tuple(C.shape))
        return real(L, C, U, b, rows)

    cr_kernel.solve_tridiag = spy
    try:
        sol_h, stats_h, _ = solve_batch(model, probs, hybrid, qg)
    finally:
        cr_kernel.solve_tridiag = real
    assert calls and set(calls) == {(2, 33, 2, 2)}
    sol_t, stats_t, _ = solve_batch(model, probs, params, qg)
    assert _rel(sol_h.q, sol_t.q) < 1e-8
    assert _rel(stats_h.cost, stats_t.cost) < 1e-8
    assert torch.equal(stats_h.solver_flag, stats_t.solver_flag)


def test_rescue_resolves_the_multipliers_with_the_step(monkeypatch):
    """A cyclic-reduction solve that comes back wrong for one scenario fails
    the residual acceptance there; the rescue then takes multipliers, merit,
    merit gradient and Newton step of that scenario from a Thomas factor
    and restores solve_ok, and leaves the healthy scenario as it was."""
    T, B = 5, 2
    physics = _physics("hopper", T, B, seed=4)
    model, probs, params = physics[:3]
    cr = params.replace(linear_solver=CR)
    thomas = solver._prepare_from_physics(
        model, probs, params.replace(linear_solver=LinearSolverType.PENTA_LU),
        *physics[3:])
    healthy = solver._prepare_from_physics(model, probs, cr, *physics[3:])
    assert healthy.solve_ok.all()
    assert batched._rescue_degraded_solves(cr, healthy) is healthy

    real = cr_kernel.solve_many

    def degraded(H, rhs):
        x = real(H, rhs)
        x[0] = 1.5 * x[0] + 0.1  # scenario 0 only
        return x

    monkeypatch.setattr(cr_kernel, "solve_many", degraded)
    prep = solver._prepare_from_physics(model, probs, cr, *physics[3:])
    assert prep.solve_ok.tolist() == [False, True]
    assert _rel(prep.lam[0], thomas.lam[0]) > 1e-3  # from the bad solve
    fixed = batched._rescue_degraded_solves(cr, prep)
    assert fixed.solve_ok.tolist() == [True, True]
    for key in ("lam", "merit", "g_merit", "p_newton", "p_cauchy"):
        assert _rel(getattr(fixed, key)[0], getattr(thomas, key)[0]) < RTOL
        assert torch.equal(getattr(fixed, key)[1], getattr(healthy, key)[1])
    # The step is the Newton step of the merit it is judged by.
    res = penta.matvec(fixed.H, fixed.p_newton) + fixed.g_merit
    assert float(res.abs().max()) < 1e-6 * float(fixed.g_merit.abs().max())


def test_lin_solve_many_agrees_across_factors():
    """One stack of right-hand sides through each factor type."""
    physics = _physics("spinner", 6, 2, seed=5)
    model, probs, params = physics[:3]
    prep = solver._prepare_from_physics(model, probs, params, *physics[3:])
    rhs = torch.cat([prep.gs[:, None], prep.Js], dim=1)
    x_t = solver._lin_solve_many(penta.factorize(prep.H), rhs)
    x_f = solver._lin_solve_many(prep.H, rhs)
    x_l = solver._lin_solve_many(cyclic_reduction.factorize(prep.H), rhs)
    x_h = solver._lin_solve_many(
        cyclic_reduction.factorize(prep.H, tail_rows=2), rhs)
    for x in (x_f, x_l, x_h):
        assert _rel(x, x_t) < RTOL
