"""Generate goldens/torch_slice_cheetah.npz, the JAX package's batched
mini-cheetah solve that tests/test_torch_slice.py holds the PyTorch port
(``idto_tpu_torch``) to.

The solve: ``solve_batch(native=True)`` on mini_cheetah (T=20), B=2
scenarios, float64, two trust-region iterations, block cyclic reduction
through the fused Pallas kernel (``cr_use_pallas=True``, interpret mode
on the CPU).  The q guesses are the example's guess plus 0.01 * N(0, 1)
noise from ``np.random.default_rng(0)``, with q_0 pinned to q_init; they
are stored in the file, so the test reads nothing else of the JAX side.

Run from the repo root:  python scripts/make_torch_goldens.py
(a few minutes on a CPU: the Pallas interpreter compiles slowly).
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


def main():
    model, _, prob, params, q_guess = load_example("mini_cheetah")
    params = params.replace(
        max_iterations=MAX_ITERATIONS,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION,
        cr_use_pallas=True,
    )
    rng = np.random.default_rng(0)
    qg = np.asarray(q_guess)[None] + 0.01 * rng.standard_normal(
        (B,) + np.shape(q_guess)
    )
    qg[:, 0] = np.asarray(prob.q_init)
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


if __name__ == "__main__":
    main()
