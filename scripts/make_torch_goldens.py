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
    at t = 0 and 0.016 s from a perturbed state estimate.

The cheetah slice: ``solve_batch(native=True)`` on mini_cheetah (T=20), B=2
scenarios, float64, two trust-region iterations, block cyclic reduction
through the fused Pallas kernel (``cr_use_pallas=True``, interpret mode
on the CPU).  The q guesses are the example's guess plus 0.01 * N(0, 1)
noise from ``np.random.default_rng(0)``, with q_0 pinned to q_init; they
are stored in the file, so the test reads nothing else of the JAX side.

Run from the repo root:  python scripts/make_torch_goldens.py [which ...]
with ``which`` among slice, constraints, mpc (default: all; a few minutes
each on a CPU: the Pallas interpreter and the cheetah solve compile slowly).
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


def main(argv):
    which = argv or ["slice", "constraints", "mpc"]
    if "slice" in which:
        slice_cheetah()
    if "constraints" in which:
        for name in ("acrobot", "spinner", "hopper"):
            constraints(name)
    if "mpc" in which:
        mpc_cheetah()


if __name__ == "__main__":
    main(sys.argv[1:])
