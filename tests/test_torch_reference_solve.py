"""The port's per-problem reference solve (``optimizer/solver.py::
solve_trust_region`` on the AoS physics) and ``solve_batch(native=...)``,
float64 on the CPU.

  * ``solve_trust_region`` on the pendulum, the spinner and the cheetah cut
    to six steps against goldens of the JAX ``solve_trust_region`` at the
    same settings, then one iteration more from its warm start (``python
    scripts/make_torch_goldens.py reference``: goldens/torch_reference_
    {pendulum,spinner,mini_cheetah}.npz).  Tolerances are those of
    tests/test_batched.py, which holds the JAX package's batch-native
    solve against its per-problem one: q rtol 1e-7 atol 1e-9, tau 1e-6 /
    1e-8, the per-iteration statistics 1e-6 / 1e-9, the final radius 1e-7,
    the last step 1e-5 / 1e-8.  The YAML solver of each is Thomas.
  * The same runs against the port's batch-native ``solve`` (B=1), and
    ``solve_batch(native=False)`` against ``native=True`` at B=3, at the
    same tolerances; ``native=False`` runs the trust region whatever
    ``params.method`` says, as in the JAX package.
  * The constrained acrobot through ``solve_batch(native=False)`` against
    goldens/torch_constraints_acrobot.npz (the JAX batch-native solve,
    itself held to the per-problem one), at the bounds
    tests/test_torch_constraints.py measured for that ill-conditioned,
    unscaled problem through Thomas.
  * The dense and exact-Hessian routes against goldens/torch_dense_
    pendulum.npz, which are runs of the JAX ``solve_trust_region``.
"""
import os

import numpy as np
import pytest
import torch

from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.ops import cr_kernel
from idto_tpu_torch.optimizer import batched, solver
from idto_tpu_torch.optimizer.problem import (
    GradientsMethod,
    LinearSolverType,
    SolverMethod,
)
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
# Each example at its YAML settings with max_iterations and, where given,
# the horizon cut.
REFERENCE = {"pendulum": (5, None), "spinner": (3, None),
             "mini_cheetah": (3, 6)}
TOL = {"q": (1e-7, 1e-9), "tau": (1e-6, 1e-8), "stats": (1e-6, 1e-9),
       "Delta": (1e-7, 0.0), "dq": (1e-5, 1e-8)}
_STATS = ("cost", "delta", "rho", "dq_norm", "grad_norm", "merit", "h_norm")


def cut(name, prob, params, q_guess):
    """The problem, parameters and guess of the reference runs (either
    package's objects)."""
    iters, T = REFERENCE[name]
    params = params.replace(max_iterations=iters)
    if T is not None:
        prob = prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                            v_nom=prob.v_nom[: T + 1])
        q_guess = q_guess[: T + 1]
    return prob, params, q_guess


def _close(a, b, key, msg=""):
    rtol, atol = TOL[key]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


def _check(run, ref, prefix=""):
    """A (Solution, Stats, WarmStart) of one problem against arrays of
    another: a golden (keys with ``prefix``) or a second run."""
    sol, stats, warm = run

    def get(key):
        if isinstance(ref, dict):
            return ref[prefix + key]
        obj = {"q": ref[0], "tau": ref[0]}.get(key, ref[1])
        if key.startswith("warm_"):
            return getattr(ref[2], key[5:])
        return getattr(obj, key)

    assert int(stats.num_iters) == int(get("num_iters"))
    assert int(stats.solver_flag) == int(get("solver_flag"))
    _close(sol.q, get("q"), "q", "q")
    _close(sol.tau, get("tau"), "tau", "tau")
    for field in _STATS:
        a, b = np.asarray(getattr(stats, field)), np.asarray(get(field))
        assert np.array_equal(np.isnan(a), np.isnan(b)), field
        _close(a[~np.isnan(b)], b[~np.isnan(b)], "stats", field)
    _close(warm.Delta, get("warm_Delta"), "Delta")
    _close(warm.dq, get("warm_dq"), "dq")


@pytest.fixture(scope="module", params=sorted(REFERENCE))
def reference(request):
    name = request.param
    model, _, prob, params, q_guess = load_example(name, device="cpu")
    prob, params, q_guess = cut(name, prob, params, q_guess)
    ref = dict(np.load(os.path.join(_GOLDENS, f"torch_reference_{name}.npz")))
    assert np.array_equal(ref["q_guess"], q_guess.numpy())
    assert params.linear_solver == LinearSolverType.PENTA_LU
    run = solver.solve_trust_region(model, prob, params, q_guess)
    return dict(name=name, model=model, prob=prob, params=params,
                q_guess=q_guess, ref=ref, run=run)


def test_solve_trust_region_matches_jax(reference):
    _check(reference["run"], reference["ref"])


def test_warm_started_iteration_matches_jax(reference):
    c = reference
    warm = c["run"][2]
    again = solver.solve_trust_region(
        c["model"], c["prob"], c["params"].replace(max_iterations=1),
        warm.q, Delta0=warm.Delta)
    _check(again, c["ref"], "again_")


def test_solve_trust_region_matches_the_batch_native_solve(reference):
    c = reference
    native = solver.solve(c["model"], c["prob"], c["params"], c["q_guess"])
    _check(c["run"], native)
    for field in ("dqH", "q"):
        _close(getattr(c["run"][2], field), getattr(native[2], field), "dq")


def test_solution_and_stats_shapes(reference):
    sol, stats, warm = reference["run"]
    model, prob = reference["model"], reference["prob"]
    K = reference["params"].max_iterations
    assert sol.q.shape == (prob.num_steps + 1, model.nq)
    assert sol.v.shape == (prob.num_steps + 1, model.nv)
    assert sol.tau.shape == (prob.num_steps, model.nv)
    assert stats.cost.shape == stats.time.shape == (K,)
    assert stats.num_iters.dtype == torch.int32 and stats.num_iters.ndim == 0
    assert warm.Delta.ndim == 0 and warm.dq.shape == sol.q.shape
    assert torch.isnan(stats.alpha).all() and not stats.ls_iters.any()


def _batch(name, B, seed=0, **more):
    model, _, prob, params, q_guess = load_example(name, device="cpu")
    params = params.replace(max_iterations=3, check_convergence=True, **more)
    rng = np.random.default_rng(seed)
    qg = q_guess[None] + 0.01 * torch.tensor(
        rng.standard_normal((B,) + tuple(q_guess.shape)))
    qg[:, 0] = prob.q_init
    return model, broadcast_problem(prob, B), params, qg


def _row(x, i):
    """Scenario i of a batched Solution, Stats or WarmStart."""
    return x.replace(**{k: v[i] for k, v in vars(x).items()
                        if isinstance(v, torch.Tensor)})


def _check_batched(a, b):
    for i in range(a[0].q.shape[0]):
        _check(tuple(_row(x, i) for x in a), tuple(_row(x, i) for x in b))


def test_solve_batch_per_problem_matches_native():
    """The spinner (contact) at B=3; the pendulum is held so below."""
    model, probs, params, qg = _batch("spinner", 3)
    assert batched.can_solve_batched_native(model, params)
    per_problem = solve_batch(model, probs, params, qg, native=False)
    native = solve_batch(model, probs, params, qg, native=True)
    _check_batched(per_problem, native)
    # native=None picks the batch-native loop.
    assert torch.equal(solve_batch(model, probs, params, qg)[0].q,
                       native[0].q)


def test_per_problem_batch_runs_the_trust_region_for_linesearch():
    model, probs, params, qg = _batch("pendulum", 3)
    ls = params.replace(method=SolverMethod.LINESEARCH)
    a = solve_batch(model, probs, ls, qg, native=False)
    b = solve_batch(model, probs, params, qg, native=False)
    for x, y in zip(a, b):
        for f in ("q", "cost", "Delta"):
            if hasattr(x, f):
                assert torch.equal(getattr(x, f), getattr(y, f)), f
    assert torch.isnan(a[1].alpha).all()
    _check_batched(a, solve_batch(model, probs, params, qg, native=True))


def test_constrained_acrobot_per_problem_matches_jax():
    """Equality constraints on the per-problem route (the Schur multiplier
    solve with a leading axis of one), against the JAX solve."""
    ref = np.load(os.path.join(_GOLDENS, "torch_constraints_acrobot.npz"))
    model, _, prob, params, _ = load_example("acrobot", device="cpu")
    params = params.replace(max_iterations=int(ref["max_iterations"]))
    qg = torch.tensor(ref["q_guess"])
    probs = broadcast_problem(prob, qg.shape[0])
    sol, stats, _ = solve_batch(model, probs, params, qg, native=False)
    # tests/test_torch_constraints.py's measured bounds for the acrobot
    # through Thomas (q absolute, tau, statistics).
    assert np.abs(sol.q.numpy() - ref["q"]).max() < 1e-5
    assert np.abs(sol.tau.numpy() - ref["tau"]).max() < 2e-4
    for key in ("cost", "h_norm", "merit"):
        a, b = stats.__getattribute__(key).numpy(), ref[key]
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-5, key
    assert np.array_equal(stats.num_iters.numpy(), ref["num_iters"])


@pytest.mark.parametrize("tag", ["dense", "exact"])
def test_dense_routes_match_jax_solve_trust_region(tag):
    from tests.test_torch_options import DENSE_ITERS, RTOL_DENSE

    ref = np.load(os.path.join(_GOLDENS, "torch_dense_pendulum.npz"))
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    more = (dict(linear_solver=LinearSolverType.DENSE_LDLT) if tag == "dense"
            else dict(exact_hessian=True))
    sol, stats, warm = solver.solve_trust_region(
        model, prob, params.replace(max_iterations=DENSE_ITERS, **more),
        q_guess)
    assert int(stats.num_iters) == int(ref[f"{tag}_num_iters"])
    for got, key in ((sol.q, "q"), (stats.cost, "cost"),
                     (warm.dqH, "warm_dqH")):
        a, b = got.numpy(), ref[f"{tag}_{key}"]
        assert np.abs(a - b).max() / np.abs(b).max() < RTOL_DENSE, key


def test_finite_difference_route_matches_native():
    model, probs, params, qg = _batch(
        "pendulum", 2, gradients_method=GradientsMethod.CENTRAL_DIFFERENCES)
    _check_batched(solve_batch(model, probs, params, qg, native=False),
                   solve_batch(model, probs, params, qg, native=True))


def test_cyclic_reduction_route_runs_the_plain_twin_here():
    """CYCLIC_REDUCTION on the per-problem route: on CPU tensors the
    kernel's wrapper takes its plain version (no launch counted), and the
    solve agrees with the batch-native one through the same solver."""
    model, probs, params, qg = _batch(
        "pendulum", 1, linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    launches = cr_kernel.launches
    per_problem = solve_batch(model, probs, params, qg, native=False)
    assert cr_kernel.launches == launches
    _check_batched(per_problem, solve_batch(model, probs, params, qg,
                                            native=True))


def test_verbose_table_and_iteration_times(capsys):
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    params = params.replace(max_iterations=4, verbose=True,
                            record_iteration_times=True)
    _, stats, _ = solver.solve_trust_region(model, prob, params, q_guess)
    per_problem = capsys.readouterr().out.splitlines()
    solver.solve(model, prob, params, q_guess)
    native = capsys.readouterr().out.splitlines()
    n = int(stats.num_iters)
    assert len(per_problem) == len(native) == n + 2  # header, rule, rows
    assert per_problem[:2] == native[:2]
    assert [r.split("|")[0] for r in per_problem[2:]] == [
        f"{k:>5} " for k in range(n)]
    assert torch.isfinite(stats.time[:n]).all() and (stats.time[:n] > 0).all()
    assert torch.isnan(stats.time[n:]).all()


def test_can_solve_batched_native_everywhere_but_halfspace_pairs():
    from idto_tpu_torch.examples.registry import example_names, get_example
    from idto_tpu_torch.models.model import GeomType, JointType, ModelBuilder

    for name in example_names():
        model = get_example(name).build().finalize(device="cpu")
        assert batched.can_solve_batched_native(model, None), name
    b = ModelBuilder()
    b.add_link("slab", "world", JointType.PRISMATIC, mass=1.0,
               inertia=np.eye(3))
    b.add_geometry("world", GeomType.HALFSPACE, [])
    b.add_geometry("slab", GeomType.HALFSPACE, [])
    model = b.finalize(device="cpu")
    assert not batched.can_solve_batched_native(model, None)


def test_find_resource_and_measure_rtt():
    from idto_tpu_torch.utils.find_resource import find_resource
    from idto_tpu_torch.utils.timing import measure_rtt

    path = find_resource("idto_tpu/assets/pendulum.urdf")
    assert os.path.isfile(path)
    assert find_resource("assets/pendulum.urdf") == path
    with pytest.raises(FileNotFoundError):
        find_resource("idto_tpu/assets/no_such_model.urdf")
    rtt = measure_rtt(reps=5, device="cpu")
    assert 0.0 < rtt < 1.0
