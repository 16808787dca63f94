"""The port's main path as a whole: the batched Gauss-Newton trust-region
solve (``solve_batch``) with block cyclic reduction, against the JAX
package's batch-native solve with the fused Pallas kernel forced on
(``cr_use_pallas=True``, interpret mode on the CPU).

  * pendulum and mini_cheetah, from goldens/torch_slice_{pendulum,
    cheetah}.npz, which scripts/make_torch_goldens.py writes from the JAX
    package (its solves take from half a minute to minutes to compile on a
    CPU).

Tolerance 1e-8 on q, cost and rho per iteration: both sides run the same
float64 algorithm, differing only in summation order (~1e-15), and a few
trust-region iterations amplify that by at most the Hessians' condition
number.  Iteration counts and solver flags must be equal.
"""
import os

import numpy as np
import torch

from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.ops import cr_kernel
from idto_tpu_torch.optimizer.problem import LinearSolverType
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

RTOL = 1e-8
_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
_GOLDEN = os.path.join(_GOLDENS, "torch_slice_cheetah.npz")
PENDULUM_B, PENDULUM_ITERS = 3, 8


def _pendulum_guesses(prob, q_guess):
    """The example's guess plus 0.01 N(0, 1) from seed 0, q_0 pinned."""
    rng = np.random.default_rng(0)
    qg = np.asarray(q_guess)[None] + 0.01 * rng.standard_normal(
        (PENDULUM_B,) + np.shape(q_guess))
    qg[:, 0] = np.asarray(prob.q_init)
    return qg


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _assert_stats_match(stats, ref):
    """stats: port Stats; ref: dict of numpy arrays from the JAX side."""
    np.testing.assert_array_equal(stats.num_iters.numpy(), ref["num_iters"])
    np.testing.assert_array_equal(stats.solver_flag.numpy(),
                                  ref["solver_flag"])
    for name in ("cost", "rho"):
        got, want = getattr(stats, name).numpy(), ref[name]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        mask = ~np.isnan(want)
        if name == "cost":
            assert _rel(got[mask], want[mask]) < RTOL, name
        else:  # trust ratios are O(1): absolute
            assert np.abs(got[mask] - want[mask]).max() < RTOL, name


def _port_solve(name, q_guess, max_iterations):
    model, _, prob, params, _ = load_example(name, device="cpu")
    params = params.replace(
        max_iterations=max_iterations, verbose=False,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION,
    )
    B = q_guess.shape[0]
    return solve_batch(model, broadcast_problem(prob, B), params,
                       torch.as_tensor(q_guess))


def test_pendulum_matches_jax_live():
    """The seeded batch against the JAX solve of it
    (goldens/torch_slice_pendulum.npz)."""
    ref = np.load(os.path.join(_GOLDENS, "torch_slice_pendulum.npz"))
    _, _, prob, _, q_guess = load_example("pendulum", device="cpu")
    qg = _pendulum_guesses(prob, q_guess)
    assert np.array_equal(ref["q_guess"], qg)
    before = cr_kernel.launches
    sol, stats, warm = _port_solve("pendulum", qg, PENDULUM_ITERS)
    assert cr_kernel.launches == before  # CPU tensors: the plain version
    assert _rel(sol.q, ref["q"]) < RTOL
    assert _rel(sol.tau, ref["tau"]) < RTOL
    _assert_stats_match(stats, ref)
    assert warm.q.shape == (PENDULUM_B,) + tuple(q_guess.shape)


def test_mini_cheetah_matches_jax_golden():
    ref = np.load(_GOLDEN)
    sol, stats, _ = _port_solve("mini_cheetah", ref["q_guess"],
                                int(ref["max_iterations"]))
    assert sol.q.dtype == torch.float64
    assert _rel(sol.q, ref["q"]) < RTOL
    _assert_stats_match(stats, ref)

