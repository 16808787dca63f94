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

The captured route (``utils/graphs.py``) runs on the CPU through the
stand-in of its graphs: Armijo on the cheetah, backtracking on the
constrained hopper and a search that runs out, each bitwise against the
direct route, with no host read inside a region and one flag read between
regions a search chunk and an iteration (none after the last of either).
"""
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.optimizer import linesearch, solver
from idto_tpu_torch.optimizer.problem import LinesearchMethod, SolverMethod
from idto_tpu_torch.optimizer.solver import SolverFlag
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch
from idto_tpu_torch.utils import graphs
from tests.test_torch_graphs import _HOST_READS, _assert_same, _strict_rerun

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


# -- the captured route (``utils/graphs.py``) through the CPU stand-in -------

# case: (example, linesearch method, T, iterations, more parameters)
_CAPTURED = {
    "armijo_cheetah": ("mini_cheetah", "armijo", 8, 2, {}),
    "backtracking_hopper": ("hopper", "backtracking", 5, 2, {}),
    # The first search needs more steps than it may take: the solve stops
    # with LINESEARCH_MAX_ITERS after one iteration, two chunks into it.
    "search_runs_out": ("hopper", "backtracking", 5, 3,
                        {"max_linesearch_iterations": 6}),
}
_LS_REGIONS = {"ls.start", "ls.prepare", "ls.search", "ls.advance",
               "ls.finish"}


@pytest.fixture
def stand_in():
    graphs.reset()
    with graphs.stand_in():
        yield
    graphs.reset()


class _CountHostReads(TorchDispatchMode):
    """Appends "read" to ``log`` at each op that reads a device value on
    the host."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _HOST_READS:
            self.log.append("read")
        return func(*args, **(kwargs or {}))


def _captured_case(case):
    """(run, iterations, chunks) of a case: the example at T steps, two
    scenarios, the second's start moved by 0.01 N(0, 1)."""
    name, method, T, iters, more = _CAPTURED[case]
    model, _, prob, params, q_guess = load_example(name, device="cpu")
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])
    dq = torch.as_tensor(np.stack([np.zeros(model.nq), 0.01 * np.random.
                                   default_rng(0).standard_normal(model.nq)]))
    probs = broadcast_problem(prob, 2)
    probs = probs.replace(q_init=probs.q_init + dq)
    p = params.replace(method=SolverMethod.LINESEARCH,
                       linesearch_method=LinesearchMethod(method),
                       max_iterations=iters, **more)
    qg = q_guess[None, : T + 1] + dq[:, None]
    chunks = -(-p.max_linesearch_iterations // linesearch.SEARCH_CHUNK)
    return (lambda: solve_batch(model, probs, p, qg)), iters, chunks


def _reads_after_each_region(run, monkeypatch):
    """``run()`` with the host reads made between regions logged: (its
    result, a list of (region name, host reads before the next region))."""
    log = []
    inner = graphs.run

    def logged(name, *args, **kwargs):
        log.append(name)
        return inner(name, *args, **kwargs)

    monkeypatch.setattr(graphs, "run", logged)
    try:
        with _CountHostReads(log):
            out = run()
    finally:
        monkeypatch.setattr(graphs, "run", inner)
    seq = []
    for item in log:
        if item == "read":
            seq[-1][1] += 1
        else:
            seq.append([item, 0])
    return out, seq


@pytest.mark.parametrize("case", sorted(_CAPTURED))
def test_captured_linesearch_is_the_direct_solve(stand_in, case,
                                                 monkeypatch):
    """The linesearch through the stand-in of its graphs equals the direct
    solve bitwise; its regions read nothing on the host (``_strict_rerun``);
    between them the host reads one flag after each search chunk but the
    last a search may take, and one after each iteration but the last."""
    run, iters, chunks = _captured_case(case)
    ran, (got, seq) = _strict_rerun(
        lambda: _reads_after_each_region(run, monkeypatch))
    assert ran == _LS_REGIONS
    with graphs.eager():
        want = run()
    _assert_same(got, want)
    stats = got[1]
    if case == "search_runs_out":
        assert stats.num_iters.tolist() == [1, 1]
        assert stats.solver_flag.tolist() == [
            int(SolverFlag.LINESEARCH_MAX_ITERS)] * 2
    else:
        assert stats.num_iters.tolist() == [iters, iters]

    # The reads the second run made between regions (each region ran under
    # the strict mode, which fails on a read).
    assert [name for name, _ in seq[:2]] == ["ls.start", "ls.prepare"]
    assert seq[-1] == ["ls.finish", 0]
    advances, run_of_chunks = 0, 0
    for name, reads in seq:
        if name == "ls.search":
            run_of_chunks += 1
            assert reads == (0 if run_of_chunks == chunks else 1)
        else:
            run_of_chunks = 0
        if name == "ls.advance":
            advances += 1
            assert reads == (0 if advances == iters else 1)
        if name not in ("ls.search", "ls.advance"):
            assert reads == 0, name
    assert advances == int(stats.num_iters.max())
    # Some search took two chunks or more.
    assert sum(name == "ls.search" for name, _ in seq) > advances
