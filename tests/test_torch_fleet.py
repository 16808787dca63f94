"""Two trust-region iterations of the six manipulation examples (kuka, jaco,
jaco_ball, dual_jaco, allegro_hand, punyo) in the port against the JAX
package, at each example's YAML settings, B=2 scenarios, float64, CPU.

The goldens ``goldens/torch_fleet_*.npz`` come from ``python
scripts/make_torch_goldens.py fleet`` (``idto_tpu``'s ``solve_batch``: the
batch-native SoA solve, and for punyo, whose capsule pairs the JAX SoA layer
lacks, the vmapped AoS solve), with the q guesses stored in the file.

Tolerances.  Through scan-Thomas, the YAML solver: 1e-7 on q, 1e-6 on cost,
merit and h_norm: two chained iterations of the same algorithm on Hessians
of condition up to ~1e10 (scaled), and punyo's capsule search ends 1e-8
apart on the axis between the packages (tests/test_torch_soa.py).

Through CYCLIC_REDUCTION, the route the card's kernel serves (here its plain
version), the same goldens are held loosely.  Cyclic reduction without
pivoting loses the digits the Hessian's condition number takes, the Schur
multipliers of the equality constraints cancel several more, and an accepted
step then moves q by up to 1e-3 relative: the constrained examples are held
to 2e-2 on q and cost with the same iteration counts; dual_jaco, without
constraints, to 1e-6.
"""
import os

import numpy as np
import pytest
import torch

from chip_smoke import FLEET
from idto_tpu.examples.registry import example_names as jax_example_names
from idto_tpu_torch.examples.registry import example_names, load_example
from idto_tpu_torch.optimizer.problem import LinearSolverType
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch
from idto_tpu_torch.soa.contact import supports_soa

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
# (nq, nv, nu, T, pairs, unactuated dofs, equality constraints)
_SHAPES = {
    "kuka": (14, 13, 7, 40, 27, 6, True),
    "jaco": (14, 13, 7, 40, 30, 6, True),
    "jaco_ball": (14, 13, 7, 10, 30, 6, True),
    "dual_jaco": (21, 20, 14, 20, 108, 6, False),
    "allegro_hand": (23, 22, 16, 40, 45, 6, True),
    "punyo": (21, 20, 14, 40, 36, 6, True),
}
RTOL_Q, RTOL_COST = 1e-7, 1e-6
RTOL_CR = {True: 2e-2, False: 1e-6}  # by equality constraints


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_registry_has_the_reference_examples_all_soa_covered():
    assert example_names() == jax_example_names()
    assert len(example_names()) == 12
    for name in example_names():
        assert supports_soa(load_example(name, device="cpu")[0]), name


@pytest.fixture(scope="module", params=FLEET)
def case(request):
    name = request.param
    ref = np.load(os.path.join(_GOLDENS, f"torch_fleet_{name}.npz"))
    model, cfg, prob, params, _ = load_example(name, device="cpu")
    params = params.replace(max_iterations=int(ref["max_iterations"]))
    qg = torch.as_tensor(ref["q_guess"])
    probs = broadcast_problem(prob, qg.shape[0])
    return dict(name=name, ref=ref, model=model, prob=prob, probs=probs,
                params=params, qg=qg)


def test_example_has_its_yaml_shape(case):
    model, prob, params = case["model"], case["prob"], case["params"]
    assert (model.nq, model.nv, model.nu, prob.num_steps,
            len(model.geoms.pairs), len(model.unactuated_vdofs),
            params.equality_constraints) == _SHAPES[case["name"]]
    assert params.linear_solver == LinearSolverType.PENTA_LU


def test_two_iterations_match_the_jax_golden(case):
    ref = case["ref"]
    sol, stats, _ = solve_batch(case["model"], case["probs"], case["params"],
                                case["qg"])
    assert np.array_equal(stats.num_iters.numpy(), ref["num_iters"])
    assert np.array_equal(stats.solver_flag.numpy(), ref["solver_flag"])
    assert _rel(sol.q, ref["q"]) < RTOL_Q
    assert _rel(sol.tau, ref["tau"]) < 1e2 * RTOL_Q
    for key in ("cost", "merit", "h_norm", "delta"):
        assert _rel(getattr(stats, key), ref[key]) < RTOL_COST, key
    assert np.abs(stats.rho.numpy() - ref["rho"]).max() < 1e-5
    assert bool((stats.cost[:, -1] <= stats.cost[:, 0]).all())


def test_cyclic_reduction_route_stays_near_the_thomas_golden(case):
    ref = case["ref"]
    params = case["params"].replace(
        linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    sol, stats, _ = solve_batch(case["model"], case["probs"], params,
                                case["qg"])
    tol = RTOL_CR[params.equality_constraints]
    assert bool(torch.isfinite(sol.q).all())
    assert np.array_equal(stats.num_iters.numpy(), ref["num_iters"])
    assert _rel(sol.q, ref["q"]) < tol
    assert _rel(stats.cost, ref["cost"]) < tol
    assert _rel(stats.h_norm, ref["h_norm"]) < tol or not \
        params.equality_constraints
    assert bool((stats.cost[:, -1] <= stats.cost[:, 0]).all())
