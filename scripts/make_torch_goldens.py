"""Generate the goldens that hold the PyTorch port (``idto_tpu_torch``) to
the JAX package where a live JAX solve would take minutes to compile inside
a test:

  * goldens/torch_slice_cheetah.npz (tests/test_torch_slice.py), below;
  * goldens/torch_constraints_{acrobot,spinner,hopper}.npz
    (tests/test_torch_constraints.py): ``solve_batch(native=True)`` at the
    example's own YAML settings (equality constraints on, scan-Thomas), B=2
    scenarios, float64, three trust-region iterations;
  * goldens/torch_mpc_cheetah.npz (tests/test_torch_mpc.py):
    ``mpc_initialize`` with one iteration, then two replans (``mpc_step``)
    at t = 0 and 0.016 s from a perturbed state estimate;
  * goldens/torch_fleet_{kuka,jaco,jaco_ball,dual_jaco,allegro_hand,punyo}.npz
    (tests/test_torch_fleet.py): ``solve_batch`` at the example's own YAML
    settings (scan-Thomas), B=2 scenarios, float64, two trust-region
    iterations; the batch-native SoA solve where the JAX package has one,
    the vmapped AoS solve for punyo (its SoA layer has no capsule pairs);
  * goldens/torch_closed_loop_{hopper,spinner,jaco}.npz
    (tests/test_torch_closed_loop.py): ``run_mpc`` with the simulation
    plant of ``load_sim_plant``, the initial solve cut to three iterations
    and ``sim_time`` to three replans.  Jaco (two iterations, two replans
    of ten substeps each, the stiffer simulation contact): under the
    explicit simulator its YAML gains are unstable, h Kd / M = 250 on the
    wrist, so the file also keeps ``first_nonfinite``, the index of the
    first substep whose logged state is not finite;
  * goldens/torch_partials_punyo.npz (tests/test_torch_soa.py): ``jacfwd``
    of the AoS ``step_tau`` with respect to q at punyo's YAML smoothing, on
    six seeded states along the initial guess;
  * goldens/torch_dynamics_jaco.npz (same test file): mass matrix, bias
    forces, forward dynamics and one simulator step of jaco at four seeded
    states.

The cheetah slice: ``solve_batch(native=True)`` on mini_cheetah (T=20), B=2
scenarios, float64, two trust-region iterations, block cyclic reduction
through the fused Pallas kernel (``cr_use_pallas=True``, interpret mode
on the CPU).  The q guesses are the example's guess plus 0.01 * N(0, 1)
noise from ``np.random.default_rng(0)``, with q_0 pinned to q_init; they
are stored in the file, so the test reads nothing else of the JAX side.

Run from the repo root:  python scripts/make_torch_goldens.py [which ...]
with ``which`` among slice, constraints, mpc, fleet, closed_loop, dynamics,
partials (default: all; a few minutes each on a CPU: the Pallas interpreter and the
cheetah solve compile slowly), or ``fleet:NAME`` / ``closed_loop:NAME`` for
one example.
"""
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from chip_smoke import FLEET
from idto_tpu.examples.registry import load_example
from idto_tpu.optimizer.problem import LinearSolverType
from idto_tpu.parallel.batching import broadcast_problem, solve_batch

GOLDEN = os.path.join(_REPO, "goldens", "torch_slice_cheetah.npz")
B = 2
MAX_ITERATIONS = 2


def _noisy_guesses(prob, q_guess, batch):
    rng = np.random.default_rng(0)
    qg = np.asarray(q_guess)[None] + 0.01 * rng.standard_normal(
        (batch,) + np.shape(q_guess)
    )
    qg[:, 0] = np.asarray(prob.q_init)
    return qg


def constraints(name):
    """The example at its YAML settings, B scenarios, three iterations."""
    iters = 3
    model, _, prob, params, q_guess = load_example(name)
    assert params.equality_constraints and model.unactuated_vdofs
    params = params.replace(max_iterations=iters)
    qg = _noisy_guesses(prob, q_guess, B)
    sol, stats, _ = jax.jit(
        lambda p, q: solve_batch(model, p, params, q, native=True)
    )(broadcast_problem(prob, B), jnp.asarray(qg))
    path = os.path.join(_REPO, "goldens", f"torch_constraints_{name}.npz")
    np.savez(
        path, q_guess=qg, max_iterations=iters, q=np.asarray(sol.q),
        tau=np.asarray(sol.tau),
        **{k: np.asarray(getattr(stats, k)) for k in (
            "cost", "rho", "h_norm", "merit", "delta", "solver_flag",
            "num_iters")},
    )
    print(f"wrote {path}  (cost {np.asarray(stats.cost).tolist()}, h_norm "
          f"{np.asarray(stats.h_norm).tolist()})")


def mpc_cheetah():
    """mini_cheetah: initialize with one iteration, then two replans from a
    state estimate that differs from q_init (base moved in x and y, joints
    and velocities perturbed)."""
    from idto_tpu.mpc.controller import (
        make_mpc_params,
        mpc_initialize,
        mpc_step,
    )

    model, cfg, prob, params, q_guess = load_example("mini_cheetah")
    params = params.replace(max_iterations=1, check_convergence=False)
    mpc_params = make_mpc_params(params, 1)
    rel = np.asarray(cfg.q_nom_relative_to_q_init)
    rng = np.random.default_rng(1)
    q0 = np.asarray(prob.q_init).copy()
    q0[4:6] += [0.01, -0.02]
    q0[7:] += 0.01 * rng.standard_normal(q0[7:].shape)
    x0 = np.concatenate([q0, 0.01 * rng.standard_normal(model.nv)])
    carry, sol0 = jax.jit(mpc_initialize)(model, prob, params, q_guess)
    replan = jax.jit(
        lambda c, x, t: mpc_step(model, prob, mpc_params, rel, c, x, t)
    )
    times = (0.0, 0.016)
    out = {"x0": x0, "times": np.asarray(times), "q_init": np.asarray(sol0.q),
           "Delta_init": np.asarray(carry.Delta)}
    for i, t in enumerate(times):
        carry, sol = replan(carry, jnp.asarray(x0), jnp.asarray(t, x0.dtype))
        out[f"q_{i}"] = np.asarray(sol.q)
        out[f"tau_{i}"] = np.asarray(sol.tau)
        out[f"Delta_{i}"] = np.asarray(carry.Delta)
        out[f"q_nom_{i}"] = np.asarray(carry.q_nom)
    path = os.path.join(_REPO, "goldens", "torch_mpc_cheetah.npz")
    np.savez(path, **out)
    print(f"wrote {path}  (Delta {out['Delta_0']}, {out['Delta_1']})")


def slice_cheetah():
    model, _, prob, params, q_guess = load_example("mini_cheetah")
    params = params.replace(
        max_iterations=MAX_ITERATIONS,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION,
        cr_use_pallas=True,
    )
    qg = _noisy_guesses(prob, q_guess, B)
    sol, stats, _ = jax.jit(
        lambda p, q: solve_batch(model, p, params, q, native=True)
    )(broadcast_problem(prob, B), jnp.asarray(qg))
    np.savez(
        GOLDEN,
        q_guess=qg,
        max_iterations=MAX_ITERATIONS,
        q=np.asarray(sol.q),
        cost=np.asarray(stats.cost),
        rho=np.asarray(stats.rho),
        solver_flag=np.asarray(stats.solver_flag),
        num_iters=np.asarray(stats.num_iters),
    )
    print(f"wrote {GOLDEN}  (cost {np.asarray(stats.cost).tolist()}, "
          f"flags {np.asarray(stats.solver_flag).tolist()})")


def fleet(name):
    """The example at its YAML settings, B scenarios, two iterations."""
    iters = 2
    model, _, prob, params, q_guess = load_example(name)
    params = params.replace(max_iterations=iters)
    qg = _noisy_guesses(prob, q_guess, B)
    sol, stats, _ = jax.jit(
        lambda p, q: solve_batch(model, p, params, q)
    )(broadcast_problem(prob, B), jnp.asarray(qg))
    path = os.path.join(_REPO, "goldens", f"torch_fleet_{name}.npz")
    np.savez(
        path, q_guess=qg, max_iterations=iters, q=np.asarray(sol.q),
        tau=np.asarray(sol.tau),
        **{k: np.asarray(getattr(stats, k)) for k in (
            "cost", "rho", "h_norm", "merit", "delta", "solver_flag",
            "num_iters")},
    )
    print(f"wrote {path}  (cost {np.asarray(stats.cost).tolist()}, h_norm "
          f"{np.asarray(stats.h_norm).tolist()})")


# init iterations, replans
CLOSED_LOOP = {"hopper": (3, 3), "spinner": (3, 3), "jaco": (2, 2)}


def closed_loop(name):
    """``run_mpc`` on the example's simulation plant, the initial solve cut
    to a few iterations and ``sim_time`` to a few replans."""
    import dataclasses

    from idto_tpu.examples.registry import load_sim_plant
    from idto_tpu.mpc.runner import run_mpc

    init_iters, replans = CLOSED_LOOP[name]
    model, cfg, prob, params, q_guess = load_example(name)
    params = params.replace(max_iterations=init_iters)
    cfg = dataclasses.replace(
        cfg, sim_time=(replans + 0.5) / cfg.controller_frequency)
    sim_model, sim_contact = load_sim_plant(name, params)
    plans = []
    res = run_mpc(model, cfg, prob, params, q_guess, sim_model=sim_model,
                  sim_contact=sim_contact,
                  on_replan=lambda t, q: plans.append(np.asarray(q)))
    assert res.num_solves == replans
    finite = np.isfinite(res.q_log).all(axis=1) & np.isfinite(
        res.v_log).all(axis=1)
    first_nonfinite = int(np.argmin(finite)) if not finite.all() else -1
    path = os.path.join(_REPO, "goldens", f"torch_closed_loop_{name}.npz")
    np.savez(path, init_iters=init_iters, replans=replans, times=res.times,
             q_log=res.q_log, v_log=res.v_log, u_log=res.u_log,
             plans=np.stack(plans), first_nonfinite=first_nonfinite)
    print(f"wrote {path}  (q_log {res.q_log.shape}, final q {res.q_log[-1]}, "
          f"first non-finite substep {first_nonfinite})")


def dynamics_jaco():
    """Four states around jaco's q_init (unit quaternion, from
    ``np.random.default_rng(5)``): M, h with contact, forward dynamics and
    one simulator step of 2e-3 s."""
    from idto_tpu.contact.force import contact_wrenches
    from idto_tpu.models import dynamics as dyn
    from idto_tpu.mpc.simulator import sim_step

    n, h = 4, 2e-3
    model, _, prob, params, _ = load_example("jaco")
    rng = np.random.default_rng(5)
    q = np.asarray(prob.q_init)[None] + 0.05 * rng.standard_normal(
        (n, model.nq))
    s = model.q_starts[-1]  # the box's floating joint comes last
    q[:, s:s + 4] /= np.linalg.norm(q[:, s:s + 4], axis=1, keepdims=True)
    v = 0.3 * rng.standard_normal((n, model.nv))
    u = 0.5 * rng.standard_normal((n, model.nu))

    def one(qq, vv, uu):
        wrenches = contact_wrenches(model, qq, vv, params.contact)
        return (dyn.mass_matrix(model, qq),
                dyn.bias_forces(model, qq, vv, wrenches),
                dyn.forward_dynamics(model, qq, vv, model.B @ uu, wrenches),
                sim_step(model, params.contact, h, qq, vv, uu))

    M, bias, a, (q_new, v_new) = jax.jit(jax.vmap(one))(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(u))
    path = os.path.join(_REPO, "goldens", "torch_dynamics_jaco.npz")
    np.savez(path, h=h, q=q, v=v, u=u, M=np.asarray(M), bias=np.asarray(bias),
             a=np.asarray(a), q_new=np.asarray(q_new),
             v_new=np.asarray(v_new))
    print(f"wrote {path}  (|a| max {np.abs(np.asarray(a)).max():.4g})")


def partials_punyo():
    """Six states along punyo's initial guess (``np.random.default_rng(3)``,
    as tests/test_torch_soa.py draws them): dtau/dq of the AoS ``step_tau``
    by ``jacfwd``, at the YAML contact parameters."""
    from idto_tpu.optimizer.trajectory import step_tau

    n = 6
    model, _, prob, params, q_guess = load_example("punyo")
    rng = np.random.default_rng(3)
    knots = np.asarray(q_guess)[rng.integers(0, prob.num_steps + 1, n)]
    q = knots + 0.05 * rng.standard_normal(knots.shape)
    v = 0.3 * rng.standard_normal((model.nv, n)).T
    a = 0.2 * rng.standard_normal((model.nv, n)).T
    dtau_dq = jax.jit(jax.vmap(jax.jacfwd(
        lambda qq, vv, aa: step_tau(model, params.contact, qq, vv, aa))))(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(a))
    path = os.path.join(_REPO, "goldens", "torch_partials_punyo.npz")
    np.savez(path, q=q, v=v, a=a, dtau_dq=np.asarray(dtau_dq))
    print(f"wrote {path}  (dtau_dq {dtau_dq.shape}, max "
          f"{np.abs(np.asarray(dtau_dq)).max():.4g})")


def main(argv):
    which = argv or ["slice", "constraints", "mpc", "fleet", "closed_loop",
                     "dynamics", "partials"]
    for name in FLEET:
        if "fleet" in which or f"fleet:{name}" in which:
            fleet(name)
    for name in CLOSED_LOOP:
        if "closed_loop" in which or f"closed_loop:{name}" in which:
            closed_loop(name)
    if "dynamics" in which:
        dynamics_jaco()
    if "partials" in which:
        partials_punyo()
    if "slice" in which:
        slice_cheetah()
    if "constraints" in which:
        for name in ("acrobot", "spinner", "hopper"):
            constraints(name)
    if "mpc" in which:
        mpc_cheetah()


if __name__ == "__main__":
    main(sys.argv[1:])
