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

The parallel layer (tests/test_torch_parallel.py), on the JAX package's
eight virtual CPU devices: ``horizon`` writes
goldens/torch_horizon_systems.npz (``solve_sharded`` of the random SPD
systems of tests/test_penta.py at (n, k) = (33, 4), (64, 2), (100, 5),
(161, 3), seeded n + k as tests/test_horizon.py seeds them, on meshes of 1,
2 and 4 devices) and goldens/torch_horizon_pendulum.npz
(``solve_trust_region_horizon_sharded`` on tests/test_horizon.py's
pendulum at T=31, cyclic reduction, 10 iterations, on the same meshes);
``sharded`` writes goldens/torch_sharded_pendulum.npz
(``solve_batch_sharded`` of tests/test_parallel.py's ``_setup(8)`` batch on
eight devices) and goldens/torch_sharded_spinner.npz
(``multihost.solve_batch_global`` on the spinner in test mode at B=8, q_init
and the guesses moved by 0.01 N(0, 1) from ``np.random.default_rng(0)``).

The measurement entry points (tests/test_torch_bench.py): ``bench``
writes goldens/torch_bench_cheetah.npz (``bench.py``'s step on
``bench_torch.py``'s seeded inputs, B=2, two chained calls) and
``f32_accept`` writes goldens/torch_f32_accept.npz (the scaled systems of
``scripts/bench_f32_accept.py`` at its six iterates, with the level-wise
cyclic reduction's error against a dense solve).

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

# Eight virtual CPU devices for the parallel layer's meshes (as
# tests/conftest.py gives the JAX package's tests); read when JAX starts.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

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


# -- goldens that stand in for live JAX calls the port's tests made before:
# the same inputs, built by the tests' own helpers ----------------------------


def _save(name, **arrays):
    path = os.path.join(_REPO, "goldens", f"torch_{name}.npz")
    np.savez(path, **arrays)
    print(f"wrote {path}")


def soa_case(name):
    """tests/test_torch_soa.py's ``case``: kinematics, inverse dynamics,
    contact wrenches and step_tau of the SoA layer at its random states, and
    the rollout, cost and exact partials of its trajectories."""
    from idto_tpu.soa import contact as jcon
    from idto_tpu.soa import dynamics as jdyn
    from idto_tpu.soa import kinematics as jkin
    from idto_tpu.soa import partials as jpart
    from idto_tpu.soa import rollout as jroll
    from tests import test_torch_soa as ts

    c = ts._setup(name)
    jm, jprob, jc = c["jm"], c["jprob"], c["jc"]
    q, v, a, qn, qs = (jnp.asarray(c[k]) for k in ("q", "v", "a", "qn", "qs"))
    tq, f = jax.jit(lambda x, y: jcon.contact_wrenches(jm, x, y, jc))(qn, v)
    parts = jax.jit(
        lambda x: jpart.id_partials_batched(jm, jprob, jc, x))(qs)
    kin = {}
    for tag, outs in (("fk", jkin.forward_kinematics(jm, q)),
                      ("bv", jkin.body_velocities(jm, q, v))):
        kin.update({f"{tag}_{i}": np.asarray(x) for i, x in enumerate(outs)})
    qdot = jkin.v_to_qdot(jm, q, v)
    roll_tau, roll_v = jax.jit(
        lambda x: jroll.generalized_forces(jm, jprob, jc, x))(qs)
    _save(f"soa_{name}", **{k: c[k] for k in ("q", "v", "a", "qn", "qs")},
          **kin, qdot=np.asarray(qdot),
          v_back=np.asarray(jkin.qdot_to_v(jm, q, qdot)),
          nplus=np.asarray(jkin.nplus_matrix(jm, q)),
          roll_tau=np.asarray(roll_tau), roll_v=np.asarray(roll_v),
          cost=np.asarray(jax.jit(
              lambda x: jroll.cost(jm, jprob, jc, x))(qs)),
          tau=np.asarray(jax.jit(
              lambda x, y, z: jdyn.inverse_dynamics(jm, x, y, z))(q, v, a)),
          torques=np.asarray(tq), forces=np.asarray(f),
          step_tau=np.asarray(jax.jit(
              lambda x, y, z: jcon.step_tau(jm, jc, x, y, z))(qn, v, a)),
          dtau_dqm=np.asarray(parts[0]), dtau_dqt=np.asarray(parts[1]),
          dtau_dqp=np.asarray(parts[2]))


def aos_punyo():
    """tests/test_torch_soa.py's ``punyo`` states: the AoS contact wrenches
    and step_tau."""
    from idto_tpu.contact.force import contact_wrenches
    from idto_tpu.optimizer.trajectory import step_tau
    from tests import test_torch_soa as ts

    c = ts._punyo_inputs()
    jm, jc = c["jm"], c["jc"]
    q, v, a = (jnp.asarray(c[k].T) for k in ("q", "v", "a"))
    tq, f = jax.jit(jax.vmap(lambda x, y: contact_wrenches(jm, x, y, jc)))(
        q, v)
    tau = jax.jit(jax.vmap(lambda x, y, z: step_tau(jm, jc, x, y, z)))(
        q, v, a)
    _save("aos_punyo", q=c["q"], v=c["v"], a=c["a"], torques=np.asarray(tq),
          forces=np.asarray(f), tau=np.asarray(tau))


def dynamics(name):
    """tests/test_torch_closed_loop.py's ``dyn_case`` states: M, h with
    contact, forward dynamics and one simulator step."""
    from idto_tpu.contact.force import contact_wrenches
    from idto_tpu.models import dynamics as dyn
    from idto_tpu.mpc.simulator import sim_step
    from tests import test_torch_closed_loop as tc

    model, _, prob, params, _ = load_example(name)
    q, v, u = tc._states(model, prob, np.random.default_rng(5), tc.N_STATES)
    h = tc.SIM_H

    def one(qq, vv, uu):
        wrenches = contact_wrenches(model, qq, vv, params.contact)
        return (dyn.mass_matrix(model, qq),
                dyn.bias_forces(model, qq, vv, wrenches),
                dyn.forward_dynamics(model, qq, vv, model.B @ uu, wrenches),
                sim_step(model, params.contact, h, qq, vv, uu))

    M, bias, a, (q_new, v_new) = jax.jit(jax.vmap(one))(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(u))
    _save(f"dynamics_{name}", h=h, q=q, v=v, u=u, M=np.asarray(M),
          bias=np.asarray(bias), a=np.asarray(a), q_new=np.asarray(q_new),
          v_new=np.asarray(v_new))


def segment(name):
    """tests/test_torch_closed_loop.py's simulated segment: six substeps
    from a stored random solution, at seeded gains and state."""
    from idto_tpu.mpc.simulator import simulate_segment
    from idto_tpu.mpc.trajectory_store import StoredTrajectory
    from idto_tpu.optimizer.solver import Solution
    from tests import test_torch_closed_loop as tc

    model, _, prob, params, _ = load_example(name)
    inputs = tc._segment_inputs(model, prob)
    stored = StoredTrajectory.from_solution(
        model, Solution(q=jnp.asarray(inputs["q"]),
                        v=jnp.asarray(inputs["v"]),
                        tau=jnp.asarray(inputs["tau"])),
        tc.SEGMENT["t_store"], prob.dt)
    q, v, log = jax.jit(lambda s, a, b: simulate_segment(
        model, params.contact, tc.SIM_H, tc.SEGMENT["substeps"], s,
        jnp.asarray(inputs["Kp"]), jnp.asarray(inputs["Kd"]), a, b,
        jnp.asarray(tc.SEGMENT["t_start"])))(
        stored, jnp.asarray(inputs["q0"][0]), jnp.asarray(inputs["v0"][0]))
    _save(f"segment_{name}", **inputs, q_end=np.asarray(q),
          v_end=np.asarray(v), log_q=np.asarray(log[0]),
          log_v=np.asarray(log[1]), log_u=np.asarray(log[2]))


def closed_loop_pendulum():
    """tests/test_torch_closed_loop.py's pendulum loop: three replans, the
    initial solve cut to three iterations, gains put in."""
    from idto_tpu.mpc.runner import run_mpc
    from tests import test_torch_closed_loop as tc

    replans, init_iters = 3, 3
    model, cfg, prob, params, q_guess = load_example("pendulum")
    res = run_mpc(model, tc._short(cfg, replans, **tc.PENDULUM_GAINS), prob,
                  params.replace(max_iterations=init_iters), q_guess)
    _save("closed_loop_pendulum", init_iters=init_iters, replans=replans,
          num_solves=res.num_solves, times=res.times, q_log=res.q_log,
          v_log=res.v_log, u_log=res.u_log)


def mpc_step_from_carry(name):
    """tests/test_torch_mpc.py's replan from a seeded carry: the carry, the
    state estimate, and what ``mpc_step`` makes of them."""
    from idto_tpu.mpc import controller as jmpc
    from tests import test_torch_mpc as tm

    model, cfg, prob, params, _ = load_example(name)
    rel = tm._relative_mask(cfg, model)
    rng = np.random.default_rng(7)
    carry = tm._jax_carry(model, prob, rng)
    x0 = tm._state_estimate(model, prob, rng)
    new, sol = jax.jit(lambda c, x, t: jmpc.mpc_step(
        model, prob, jmpc.make_mpc_params(params, 1), rel, c, x, t))(
        carry, jnp.asarray(x0), jnp.asarray(tm.T_NOW))
    out = {"x0": x0, "q": sol.q, "v": sol.v, "tau": sol.tau,
           "Delta": new.Delta, "q_nom": new.q_nom}
    for tag, c in (("in", carry), ("out", new)):
        out[f"{tag}_start_time"] = c.stored.start_time
        out[f"{tag}_Delta"] = c.Delta
        out[f"{tag}_q_nom"] = c.q_nom
        for part in ("q", "v", "u"):
            spline = getattr(c.stored, part)
            out[f"{tag}_{part}_dt"] = spline.dt
            out[f"{tag}_{part}_y"] = spline.y
            out[f"{tag}_{part}_M"] = spline.M
    _save(f"mpc_step_{name}", **{k: np.asarray(x) for k, x in out.items()})


def slice_pendulum():
    """tests/test_torch_slice.py's pendulum batch: ``solve_batch`` with the
    fused Pallas kernel forced on (interpret mode on the CPU)."""
    from tests import test_torch_slice as tsl

    model, _, prob, params, q_guess = load_example("pendulum")
    params = params.replace(
        max_iterations=tsl.PENDULUM_ITERS, verbose=False,
        record_iteration_times=False,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION, cr_use_pallas=True)
    qg = tsl._pendulum_guesses(prob, q_guess)
    sol, stats, _ = jax.jit(
        lambda p, q: solve_batch(model, p, params, q, native=True)
    )(broadcast_problem(prob, qg.shape[0]), jnp.asarray(qg))
    _save("slice_pendulum", q_guess=qg, q=np.asarray(sol.q),
          tau=np.asarray(sol.tau),
          **{k: np.asarray(getattr(stats, k)) for k in (
              "num_iters", "solver_flag", "cost", "rho")})


# -- goldens of the solver options, the object API and the velocity
# command (tests/test_torch_{options,linesearch,api,velocity_command}.py) ---

_STATS = ("num_iters", "solver_flag", "cost", "rho", "delta", "q_norm",
          "dq_norm", "dqH_norm", "grad_norm", "dL_dq", "h_norm", "merit",
          "alpha", "ls_iters")


def _solved(prefix, sol, stats, warm):
    """Arrays of a single-problem (Solution, Stats, WarmStart)."""
    out = {f"{prefix}q": sol.q, f"{prefix}tau": sol.tau,
           f"{prefix}warm_q": warm.q, f"{prefix}warm_Delta": warm.Delta,
           f"{prefix}warm_dq": warm.dq, f"{prefix}warm_dqH": warm.dqH}
    out.update({f"{prefix}{k}": getattr(stats, k) for k in _STATS})
    return {k: np.asarray(v) for k, v in out.items()}


def fd_partials():
    """``id_partials_fd`` of orders 1, 2 and 4 on the spinner at T=4 (the
    test's seeded trajectory)."""
    from idto_tpu.optimizer.partials import id_partials_fd
    from tests import test_torch_options as to

    model, _, prob, params, q_guess = load_example("spinner")
    prob, q = to._short_spinner(prob, q_guess)
    out = {"q": q}
    for order in (1, 2, 4):
        parts = jax.jit(lambda x: id_partials_fd(
            model, prob, params.contact, x, order=order))(jnp.asarray(q))
        for name, x in zip(("dqm", "dqt", "dqp"), parts):
            out[f"order{order}_{name}"] = np.asarray(x)
    _save("fd_spinner", **out)


def dense_pendulum():
    """The pendulum's trust-region solve through the dense LU, with the
    Gauss-Newton and with the exact Hessian."""
    from idto_tpu.optimizer.problem import LinearSolverType as L
    from idto_tpu.optimizer.solver import solve_trust_region
    from tests import test_torch_options as to

    model, _, prob, params, q_guess = load_example("pendulum")
    out = {}
    for tag, more in (("dense_", dict(linear_solver=L.DENSE_LDLT)),
                      ("exact_", dict(exact_hessian=True))):
        p = params.replace(max_iterations=to.DENSE_ITERS, **more)
        out.update(_solved(tag, *jax.jit(
            lambda q: solve_trust_region(model, prob, p, q))(q_guess)))
    _save("dense_pendulum", **out)


def linesearch(name):
    """``solve_linesearch``: Armijo on the pendulum, backtracking with the
    exact-l1 merit on the hopper (equality constraints)."""
    from idto_tpu.optimizer.linesearch import solve_linesearch
    from idto_tpu.optimizer.problem import LinesearchMethod, SolverMethod
    from tests import test_torch_linesearch as tl

    model, _, prob, params, q_guess = load_example(name)
    method, iters = tl.CASES[name]
    p = params.replace(method=SolverMethod.LINESEARCH,
                       linesearch_method=LinesearchMethod(method),
                       max_iterations=iters)
    _save(f"linesearch_{name}", **_solved("", *jax.jit(
        lambda q: solve_linesearch(model, prob, p, q))(q_guess)))


def api_pendulum():
    """``TrajectoryOptimizer.Solve`` and ``SolveFromWarmStart`` from the
    same guess, and the warm start after it."""
    from idto_tpu.api import TrajectoryOptimizer
    from tests import test_torch_api as ta

    model, _, prob, params, q_guess = load_example("pendulum")
    opt = TrajectoryOptimizer(model, prob,
                              params.replace(max_iterations=ta.ITERS))
    sol, stats = opt.Solve(q_guess)
    ws = opt.CreateWarmStart(q_guess)
    sol_w, stats_w = opt.SolveFromWarmStart(ws)
    _save("api_pendulum", q=np.asarray(sol.q), cost=np.asarray(stats.cost),
          warm_solve_q=np.asarray(sol_w.q),
          warm_solve_cost=np.asarray(stats_w.cost), ws_q=np.asarray(ws.q),
          ws_Delta=np.asarray(ws.Delta), ws_dq=np.asarray(ws.dq),
          ws_dqH=np.asarray(ws.dqH))


def velocity_cheetah():
    """mini_cheetah: ``mpc_initialize`` with one iteration, then two
    velocity-command replans whose command changes between them."""
    from idto_tpu.mpc.controller import (
        make_mpc_params,
        mpc_initialize,
        mpc_step_velocity_command,
    )
    from tests import test_torch_velocity_command as tv

    model, _, prob, params, q_guess = load_example("mini_cheetah")
    params = params.replace(max_iterations=1, check_convergence=False)
    mpc_params = make_mpc_params(params, 1)
    x0 = tv._state_estimate(prob, model)
    carry, sol0 = jax.jit(mpc_initialize)(model, prob, params, q_guess)
    step = jax.jit(lambda c, x, t, u: mpc_step_velocity_command(
        model, prob, mpc_params, c, x, t, u))
    out = {"x0": x0, "q_init": np.asarray(sol0.q)}
    for i, (t, cmd) in enumerate(tv.CHAIN):
        carry, sol = step(carry, jnp.asarray(x0), jnp.asarray(t, x0.dtype),
                          jnp.asarray(cmd, x0.dtype))
        out[f"q_{i}"] = np.asarray(sol.q)
        out[f"tau_{i}"] = np.asarray(sol.tau)
        out[f"Delta_{i}"] = np.asarray(carry.Delta)
        out[f"q_nom_{i}"] = np.asarray(carry.q_nom)
    _save("velocity_cheetah", **out)


# -- goldens of the geometry and the batched diagnostics
# (tests/test_torch_{convex,geometry,options,playback}.py) -------------------


def convex_pairs():
    """``jit(vmap(signed_distance))`` once per ordered type pair over the
    poses of tests/test_torch_convex.py, and ``jax.jvp`` along their pose
    tangents at the separated poses of the hull and generic pairs."""
    from idto_tpu.geometry.distance import signed_distance
    from tests import test_torch_convex as tc

    names = ("prm_a", "R_a", "p_a", "prm_b", "R_b", "p_b")
    out = {}
    for ta, tb in tc.PAIRS:
        k = tc._key(ta, tb)
        case = tc.pair_cases(ta, tb)
        ja, jb = int(ta), int(tb)

        def sd(prm_a, R_a, p_a, prm_b, R_b, p_b):
            return signed_distance(ja, prm_a, R_a, p_a, jb, prm_b, R_b, p_b)

        # Each pose, then the same pose with p_a moved by +-PROBE along each
        # axis: the reference's own change there says how far its answer is
        # decided by rounding.
        n = len(case["p_a"])
        shifts = np.concatenate([np.zeros((1, 3)), tc.PROBE * np.concatenate(
            [np.eye(3), -np.eye(3)])])
        args = {x: np.concatenate([case[x]] * len(shifts)) for x in names}
        args["p_a"] = args["p_a"] + np.repeat(shifts, n, axis=0)
        ref = jax.jit(jax.vmap(sd))(*(jnp.asarray(args[x]) for x in names))
        for name, x in zip(("phi", "n", "wa", "wb"), ref):
            x = np.asarray(x).reshape((len(shifts), n) + np.shape(x)[1:])
            out[f"{k}_{name}"] = x[0]
            out[f"{k}_{name}_spread"] = np.abs(x[1:] - x[0]).reshape(
                len(shifts) - 1, n, -1).max(axis=(0, 2))
        ref = [out[f"{k}_{name}"] for name in ("phi", "n", "wa", "wb")]
        for name in names:
            out[f"{k}_{name}"] = case[name]
        if (ta, tb) not in tc.CONVEX_PAIRS:
            continue
        sep = np.asarray(ref[0]) > tc.SEPARATED
        out[f"{k}_separated"] = sep
        sub = {key: v[sep] for key, v in case.items()}
        RK_a = sub["R_a"] @ tc._skew(sub["w_a"])
        RK_b = sub["R_b"] @ tc._skew(sub["w_b"])

        def moved(prm_a, R_a, RK_a, p_a, dp_a, prm_b, R_b, RK_b, p_b, dp_b):
            return jax.jvp(lambda s: sd(prm_a, R_a + s * RK_a, p_a + s * dp_a,
                                        prm_b, R_b + s * RK_b,
                                        p_b + s * dp_b),
                           (jnp.zeros(()),), (jnp.ones(()),))[1]

        tans = jax.jit(jax.vmap(moved))(*(jnp.asarray(x) for x in (
            sub["prm_a"], sub["R_a"], RK_a, sub["p_a"], sub["dp_a"],
            sub["prm_b"], sub["R_b"], RK_b, sub["p_b"], sub["dp_b"])))
        for name, x in zip(("phi", "n", "wa", "wb"), tans):
            out[f"{k}_jvp_{name}"] = np.asarray(x)
        print(f"  {k}: {sep.sum()} separated of {sep.size}")
    _save("convex_pairs", **out)


def hills_cheetah():
    """mini_cheetah with three cylinder hills at the YAML's settings cut to
    T=8: ``solve_batch`` (``vmap(solve_trust_region)`` on the AoS physics,
    the scan-Thomas), B=2, two iterations."""
    import dataclasses

    from idto_tpu.examples import registry as jreg
    from idto_tpu.examples.config import (
        ExampleConfig,
        build_initial_guess,
        build_problem,
        build_solver_params,
    )
    from tests import test_torch_geometry as tg

    cfg = tg.hills_cfg(ExampleConfig.load(os.path.join(
        _REPO, "idto_tpu", "examples", "configs", "mini_cheetah.yaml")))
    model = jreg._mini_cheetah(hills=tg.HILLS).finalize()
    prob = build_problem(cfg, model)
    params = build_solver_params(cfg).replace(max_iterations=tg.HILLS_ITERS)
    assert params.linear_solver == LinearSolverType.PENTA_LU
    qg = tg.hills_guesses(np.asarray(build_initial_guess(cfg, prob)))
    sol, stats, _ = jax.jit(
        lambda p, q: solve_batch(model, p, params, q)
    )(broadcast_problem(prob, tg.HILLS_B), jnp.asarray(qg))
    _save("hills_cheetah", q_guess=qg, q=np.asarray(sol.q),
          tau=np.asarray(sol.tau), cost=np.asarray(stats.cost),
          num_iters=np.asarray(stats.num_iters))


def verbose_pendulum():
    """The verbose table of the pendulum's ``solve_batch`` at B=2 (the
    vmapped trust region: the table is printed by ordered callbacks)."""
    import contextlib
    import io

    from tests import test_torch_options as to

    model, _, prob, params, q_guess = load_example("pendulum")
    p = params.replace(max_iterations=to.VERBOSE_ITERS, verbose=True)
    qg = to.batch_guesses(np.asarray(q_guess))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sol, stats, _ = jax.jit(
            lambda pr, q: solve_batch(model, pr, p, q)
        )(broadcast_problem(prob, to.VERBOSE_B), jnp.asarray(qg))
        jax.block_until_ready(sol.q)
        jax.effects_barrier()
    print(buf.getvalue())
    _save("verbose_pendulum", q_guess=qg, text=np.array(buf.getvalue()),
          cost=np.asarray(stats.cost))


def geometry_wrenches():
    """The AoS ``contact_wrenches`` of the cheetah with hills and of the
    hull pad (over a halfspace, over the cheetah's ground box, with the
    forward derivative along a q tangent) at tests/test_torch_geometry.py's
    states."""
    from idto_tpu.contact.force import ContactParams, contact_wrenches
    from idto_tpu.examples import registry as jreg
    from tests import test_torch_geometry as tg

    def soa(x):  # (N, nl, 3) -> (3, nl, N)
        return np.asarray(x).transpose(2, 1, 0)

    model = jreg._mini_cheetah(hills=tg.HILLS).finalize()
    _, _, _, params, q_guess = load_example("mini_cheetah")
    q, v = tg.hills_wrench_states(np.asarray(q_guess), model.nv)
    tq, f = jax.jit(jax.vmap(lambda x, y: contact_wrenches(
        model, x, y, params.contact)))(jnp.asarray(q.T), jnp.asarray(v.T))
    out = dict(hills_q=q, hills_v=v, hills_torques=soa(tq),
               hills_forces=soa(f))
    q, v, dq = tg.pad_wrench_states()
    for shape in ("hull", "hull_box_ground"):
        model = tg.jax_pad_model(shape)

        def one(x, y, dx):
            return jax.jvp(lambda z: contact_wrenches(
                model, z, y, ContactParams()), (x,), (dx,))

        (tq, f), (dtq, df) = jax.jit(jax.vmap(one))(
            *(jnp.asarray(a.T) for a in (q, v, dq)))
        out.update({f"{shape}_q": q, f"{shape}_torques": soa(tq),
                    f"{shape}_forces": soa(f),
                    f"{shape}_jvp_torques": soa(dtq),
                    f"{shape}_jvp_forces": soa(df)})
    _save("geometry_wrenches", **out)


def scene_convex():
    """``trajectory_scene_data`` of the model with a convex hull of
    tests/test_torch_playback.py at its seeded knots."""
    import json

    from idto_tpu.models.model import GeomType, JointType, ModelBuilder
    from idto_tpu.utils.playback import trajectory_scene_data
    from tests import test_torch_playback as tp

    model = tp.convex_scene_builder(ModelBuilder, JointType,
                                    GeomType).finalize()
    qs = tp.convex_scene_knots()
    scene = trajectory_scene_data(model, qs, 0.05)
    _save("scene_convex", qs=qs, scene=np.array(json.dumps(scene)))


# -- goldens of the parallel layer (tests/test_torch_parallel.py) --------

HORIZON_SYSTEMS = ((33, 4), (64, 2), (100, 5), (161, 3))
HORIZON_MESHES = (1, 2, 4)
HORIZON_T = 31
HORIZON_ITERS = 10


def horizon():
    """``solve_sharded`` on random SPD systems and the horizon-sharded
    trust-region solve of the pendulum, on meshes of 1, 2 and 4 devices."""
    from idto_tpu.optimizer.problem import (
        SolverParameters,
        linear_interp_nominal,
    )
    from idto_tpu.parallel.batching import make_mesh
    from idto_tpu.parallel.horizon import (
        solve_sharded,
        solve_trust_region_horizon_sharded,
    )
    from tests.test_optimizer import pendulum_problem
    from tests.test_penta import random_spd_penta

    out = {}
    for n, k in HORIZON_SYSTEMS:
        rng = np.random.default_rng(n + k)
        H, _ = random_spd_penta(n, k, rng)
        b = rng.standard_normal((n, k))
        tag = f"n{n}_k{k}_"
        out.update({tag + f: np.asarray(getattr(H, f)) for f in "ABCDE"})
        out[tag + "b"] = b
        for nP in HORIZON_MESHES:
            out[tag + f"x_P{nP}"] = np.asarray(solve_sharded(
                H, jnp.asarray(b), make_mesh(nP, axis="horizon")))
    _save("horizon_systems", **out)

    model, prob = pendulum_problem(T=HORIZON_T)
    params = SolverParameters(
        max_iterations=HORIZON_ITERS, scaling=True,
        equality_constraints=False,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION,
    )
    q_guess = jnp.asarray(linear_interp_nominal([0.1], [0.1], HORIZON_T))
    out = {"q_guess": np.asarray(q_guess)}
    for nP in HORIZON_MESHES:
        mesh = make_mesh(nP, axis="horizon")
        sol, stats, _ = jax.jit(
            lambda qg: solve_trust_region_horizon_sharded(
                model, prob, params, qg, mesh))(q_guess)
        out.update({f"P{nP}_q": np.asarray(sol.q),
                    f"P{nP}_tau": np.asarray(sol.tau),
                    f"P{nP}_cost": np.asarray(stats.cost),
                    f"P{nP}_num_iters": np.asarray(stats.num_iters)})
    _save("horizon_pendulum", **out)


def sharded():
    """``solve_batch_sharded`` of the pendulum batch and
    ``solve_batch_global`` of the spinner batch, on eight devices."""
    from idto_tpu.parallel import multihost
    from idto_tpu.parallel.batching import make_mesh, solve_batch_sharded
    from tests.test_parallel import _setup

    model, prob, params, probs, qg, targets = _setup(8)
    sol, stats, _, mean_cost = jax.jit(
        lambda p, q: solve_batch_sharded(model, p, params, q, make_mesh(8))
    )(probs, qg)
    _save("sharded_pendulum", q_nom=np.asarray(probs.q_nom),
          q_guess=np.asarray(qg), q=np.asarray(sol.q),
          cost=np.asarray(stats.cost), num_iters=np.asarray(stats.num_iters),
          mean_cost=np.asarray(mean_cost))

    model, _, prob, params, q_guess = load_example("spinner", test_mode=True)
    batch = 8
    dq = 0.01 * np.random.default_rng(0).standard_normal((batch, model.nq))
    probs = broadcast_problem(prob, batch)
    probs = probs.replace(q_init=probs.q_init + dq)
    qgs = np.asarray(q_guess)[None] + dq[:, None, :]
    sol, stats, _, mean_cost = multihost.solve_batch_global(
        model, probs, params, jnp.asarray(qgs),
        multihost.make_global_mesh(sp=1))
    _save("sharded_spinner", dq=dq, q=np.asarray(sol.q),
          cost=np.asarray(stats.cost), num_iters=np.asarray(stats.num_iters),
          mean_cost=np.asarray(mean_cost))


def bench_cheetah():
    """``bench.py``'s step on ``bench_torch.py``'s inputs: mini_cheetah at
    its YAML settings (scan-Thomas) cut to one iteration without the
    convergence test, B=2 scenarios whose q_init and guess (at every knot)
    move by 0.01 N(0, 1) from ``np.random.default_rng(0)``; two chained
    calls of ``solve_batch`` (the second from the first's q), with q, the
    iteration's cost and its trust ratio of each."""
    batch = 2
    model, _, prob, params, q_guess = load_example("mini_cheetah")
    params = params.replace(max_iterations=1, check_convergence=False)
    dq = 0.01 * np.random.default_rng(0).standard_normal((batch, model.nq))
    probs = broadcast_problem(prob, batch)
    probs = probs.replace(q_init=probs.q_init + dq)
    qg = np.asarray(q_guess)[None] + dq[:, None]

    @jax.jit
    def step(p, q):
        sol, stats, _ = solve_batch(model, p, params, q)
        return sol.q, stats.cost[:, 0], stats.rho[:, 0]

    q1, cost1, rho1 = step(probs, jnp.asarray(qg))
    q2, cost2, rho2 = step(probs, q1)
    _save("bench_cheetah", dq=dq, q_guess=qg, q1=np.asarray(q1),
          cost1=np.asarray(cost1), rho1=np.asarray(rho1), q2=np.asarray(q2),
          cost2=np.asarray(cost2), rho2=np.asarray(rho2))


def _refined_dense_solve(Hd, b, refinements=3):
    """A float64 dense solve refined with residuals in numpy's extended
    precision: good to about float64 rounding at condition ~1e10."""
    x = np.linalg.solve(Hd, b)
    H_ext, b_ext = Hd.astype(np.longdouble), b.astype(np.longdouble)
    for _ in range(refinements):
        r = b_ext - H_ext @ x.astype(np.longdouble)
        x = x + np.linalg.solve(Hd, r.astype(np.float64))
    return x


def f32_accept():
    """``scripts/bench_f32_accept.py``'s systems in float64: the scaled
    (H~, g~) the solver factors at three iterates each of mini_cheetah and
    spinner (the guess, the guess plus 0.01 N(0, 1) from one
    ``np.random.default_rng(0)`` drawn for the cheetah first, and a
    4-iteration ``solve_trust_region``), and at each the level-wise cyclic
    reduction's relative 2-norm error on H~ x = -g~ against a refined dense
    solve, on the system and on eight copies of it within its rounding
    (``perturbed_bands`` of scripts/bench_torch_f32_accept.py, seeded by
    the example's and the iterate's index)."""
    from idto_tpu.ops import cyclic_reduction, penta
    from idto_tpu.optimizer import trajectory
    from idto_tpu.optimizer.hessian import (
        gauss_newton_hessian,
        gradient_from_partials,
    )
    from idto_tpu.optimizer.partials import id_partials_for, nplus_stack
    from idto_tpu.optimizer.solver import (
        _scale_factors_from_diag,
        solve_trust_region,
    )

    def scaled_system(model, prob, params, q):
        contact = params.contact
        v = trajectory.velocities(model, prob, q)
        a = trajectory.accelerations(prob, v)
        tau = jax.vmap(
            lambda qn, vn, an: trajectory.step_tau(model, contact, qn, vn, an)
        )(q[1:], v[1:], a)
        parts = id_partials_for(model, prob, params, q)
        npl = nplus_stack(model, q)
        g = gradient_from_partials(model, prob, parts, npl, q, v, tau)
        H = gauss_newton_hessian(model, prob, parts, npl)
        D = _scale_factors_from_diag(
            penta.extract_diagonal(H), params.scaling_method,
            jnp.ones_like(q))
        return penta.scale_by_diagonal(H, D), D * g

    sys.path.insert(0, os.path.join(_REPO, "scripts"))
    from bench_torch_f32_accept import PERTURBED_COPIES, perturbed_bands

    rng = np.random.default_rng(0)
    out = {}
    for e, name in enumerate(("mini_cheetah", "spinner")):
        model, _, prob, params, q_guess = load_example(name)
        params = params.replace(max_iterations=4, check_convergence=False)
        sol, _, _ = jax.jit(
            lambda qg: solve_trust_region(model, prob, params, qg))(q_guess)
        q0 = np.asarray(q_guess)
        iterates = [q0, q0 + 0.01 * rng.standard_normal(q0.shape),
                    np.asarray(sol.q)]
        sys_fn = jax.jit(lambda q: scaled_system(model, prob, params, q))
        cr = jax.jit(cyclic_reduction.solve)
        for i, q in enumerate(iterates):
            Hs, gs = sys_fn(jnp.asarray(q))
            key = f"{name}_{i}"
            out[f"{key}_q"] = q
            bands = {b: np.asarray(getattr(Hs, b)) for b in "ABCDE"}
            for band in "ABCDE":
                out[f"{key}_{band}"] = bands[band]
            out[f"{key}_g"] = np.asarray(gs)
            # The system and its rounding-level copies, seeded by (e, i).
            copies = np.random.default_rng([e, i])
            errs = []
            for c in range(1 + PERTURBED_COPIES):
                bc = bands if c == 0 else perturbed_bands(bands, copies)
                Hc = penta.PentaBands(**{b: jnp.asarray(x)
                                         for b, x in bc.items()})
                x_dense = _refined_dense_solve(
                    np.asarray(penta.to_dense(Hc)),
                    -np.asarray(gs).reshape(-1))
                x_cr = np.asarray(cr(Hc, -gs)).reshape(-1)
                errs.append(np.linalg.norm(x_cr - x_dense)
                            / np.linalg.norm(x_dense))
            out[f"{key}_cr_errs"] = np.asarray(errs)
            print(f"{key}: CR error against dense {errs[0]:.3e}, median "
                  f"over the copies {np.median(errs):.3e}")
    _save("f32_accept", **out)


# -- goldens of the per-problem (AoS) pipeline and its solve
# (tests/test_torch_aos.py, tests/test_torch_reference_solve.py) -----------


def aos(name):
    """tests/test_torch_aos.py's ``case``: every AoS function of the JAX
    package (kinematics, dynamics, contact wrenches with their pair info,
    step_tau) at the seeded states, and the trajectory quantities and the
    exact partials (``id_partials``) of the seeded T-step trajectory."""
    from idto_tpu.contact.force import contact_wrenches
    from idto_tpu.models import dynamics as jdyn
    from idto_tpu.models import kinematics as jkin
    from idto_tpu.optimizer import trajectory as jtraj
    from idto_tpu.optimizer.partials import id_partials
    from tests import test_torch_aos as ta

    model, _, prob, params, q_guess = load_example(name)
    x = ta.states(name, np.asarray(q_guess), model.nv, ta.CASES.index(name))
    prob = ta.short(prob)
    jc = params.contact

    def per_state(q, v, a):
        R, p = jkin.forward_kinematics(model, q)
        _, _, w, pd = jkin.body_velocities(model, q, v)
        qdot = jkin.v_to_qdot(model, q, v)
        (tq, f), info = contact_wrenches(model, q, v, jc, return_info=True)
        return dict(
            fk_R=R, fk_p=p, bv_w=w, bv_pd=pd, qdot=qdot,
            v_back=jkin.qdot_to_v(model, q, qdot),
            nplus=jkin.nplus_matrix(model, q),
            tau=jdyn.inverse_dynamics(model, q, v, a),
            M=jdyn.mass_matrix(model, q),
            h=jdyn.bias_forces(model, q, v, (tq, f)),
            qdd=jdyn.forward_dynamics(model, q, v, a, (tq, f)),
            torques=tq, forces=f, info_phi=info.phi, info_normal=info.normal,
            info_p_contact=info.p_contact, info_force=info.force,
            step_tau=jtraj.step_tau(model, jc, q, v, a))

    def traj_fn(q):
        v = jtraj.velocities(model, prob, q)
        return dict(traj_v=v, traj_a=jtraj.accelerations(prob, v),
                    traj_tau=jtraj.generalized_forces(model, prob, jc, q),
                    traj_cost=jtraj.cost(model, prob, jc, q))

    out = jax.jit(jax.vmap(per_state))(
        *(jnp.asarray(x[k]) for k in ("q", "v", "a")))
    traj = jnp.asarray(x["traj"])
    out.update(jax.jit(traj_fn)(traj))
    parts = jax.jit(lambda q: id_partials(model, prob, jc, q))(traj)
    out.update(dqm=parts[0], dqt=parts[1], dqp=parts[2])
    _save(f"aos_{name}", **x, **{k: np.asarray(v) for k, v in out.items()})


def reference(name):
    """The JAX per-problem ``solve_trust_region`` on
    tests/test_torch_reference_solve.py's problem (the example at its YAML
    settings, cut as ``cut`` says), then one more iteration from its warm
    start (``Delta0`` = the radius it ended with)."""
    from idto_tpu.optimizer.solver import solve_trust_region
    from tests import test_torch_reference_solve as tr

    model, _, prob, params, q_guess = load_example(name)
    prob, params, q_guess = tr.cut(name, prob, params, q_guess)
    sol, stats, warm = jax.jit(
        lambda q: solve_trust_region(model, prob, params, q))(q_guess)
    one = params.replace(max_iterations=1)
    again = jax.jit(lambda q, d: solve_trust_region(
        model, prob, one, q, Delta0=d))(warm.q, warm.Delta)
    _save(f"reference_{name}", q_guess=np.asarray(q_guess),
          **_solved("", sol, stats, warm), **_solved("again_", *again))


def main(argv):
    which = argv or ["slice", "constraints", "mpc", "fleet", "closed_loop",
                     "dynamics", "partials"]
    for name in FLEET:
        if "fleet" in which or f"fleet:{name}" in which:
            fleet(name)
    for name in CLOSED_LOOP:
        if "closed_loop" in which or f"closed_loop:{name}" in which:
            closed_loop(name)
    if "dynamics" in which or "dynamics:jaco" in which:
        dynamics_jaco()
    if "partials" in which:
        partials_punyo()
    if "slice" in which or "slice:cheetah" in which:
        slice_cheetah()
    if "constraints" in which:
        for name in ("acrobot", "spinner", "hopper"):
            constraints(name)
    if "mpc" in which:
        mpc_cheetah()
    for name in ("spinner", "mini_cheetah"):
        if "soa" in which or f"soa:{name}" in which:
            soa_case(name)
    if "aos_punyo" in which:
        aos_punyo()
    for name in ("pendulum", "hopper"):
        if "dynamics" in which or f"dynamics:{name}" in which:
            dynamics(name)
    if "closed_loop" in which or "closed_loop:pendulum" in which:
        closed_loop_pendulum()
    for name in ("pendulum", "spinner"):
        if "segment" in which or f"segment:{name}" in which:
            segment(name)
    for name in ("pendulum", "spinner"):
        if "mpc_step" in which or f"mpc_step:{name}" in which:
            mpc_step_from_carry(name)
    if "slice" in which or "slice:pendulum" in which:
        slice_pendulum()
    if "fd" in which:
        fd_partials()
    if "dense" in which:
        dense_pendulum()
    for name in ("pendulum", "hopper"):
        if "linesearch" in which or f"linesearch:{name}" in which:
            linesearch(name)
    if "api" in which:
        api_pendulum()
    if "velocity" in which:
        velocity_cheetah()
    if "convex" in which:
        convex_pairs()
    if "hills" in which:
        hills_cheetah()
    if "verbose" in which:
        verbose_pendulum()
    if "scene" in which:
        scene_convex()
    if "wrenches" in which:
        geometry_wrenches()
    if "horizon" in which:
        horizon()
    if "sharded" in which:
        sharded()
    if "bench" in which:
        bench_cheetah()
    if "f32_accept" in which:
        f32_accept()
    for name in ("pendulum", "acrobot", "spinner", "mini_cheetah"):
        if "aos" in which or f"aos:{name}" in which:
            aos(name)
    for name in ("pendulum", "spinner", "mini_cheetah"):
        if "reference" in which or f"reference:{name}" in which:
            reference(name)


if __name__ == "__main__":
    main(sys.argv[1:])
