"""The port's solver options against the JAX package, float64 on the CPU:
finite-difference partials, the dense and exact-Hessian solves, the dense
cross-check, the verbose table, the iteration timer, the statistics and
debug CSV files, the gradient check, checkpoints and the timing helpers.

The JAX solves come from goldens (``scripts/make_torch_goldens.py fd
dense``: goldens/torch_fd_spinner.npz, goldens/torch_dense_pendulum.npz);
live JAX calls are pure-Python pieces only (the verbose row, the CSV
writer).  Tolerances:

  * FD partials against JAX ``id_partials_fd`` of the same order, relative
    to the largest entry: 1e-6 at order 1, 1e-9 at order 2, 1e-11 at order
    4 -- the packages' ~1e-16 rounding differences divided by the steps
    eps^(1/2), eps^(1/3), eps^(1/5);
  * FD partials against the port's exact ones: the JAX suite's tiers
    (``tests/test_gradient_check.py``: atol 1e-6 / 1e-9 / 1e-11, rtol ten
    times that);
  * dense and exact-Hessian solves against JAX: 1e-9;
  * the dense cross-check: < 1e-8 on every line.
"""
import dataclasses
import itertools
import os
import re

import numpy as np
import pytest
import torch

from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.optimizer import (
    debug_dump,
    gradient_check,
    itimer,
    solver,
    stats_io,
    trajectory,
)
from idto_tpu_torch.optimizer.partials import (
    id_partials_fd,
    id_partials_for,
)
from idto_tpu_torch.optimizer.problem import (
    GradientsMethod,
    LinearSolverType,
    SolverMethod,
    linear_interp_nominal,
)
from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch
from idto_tpu_torch.soa import partials as soa_partials

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
FD_T = 4
DENSE_ITERS = 4
FD_RTOL_JAX = {1: 1e-6, 2: 1e-9, 4: 1e-11}
FD_TOL_EXACT = {1: 1e-6, 2: 1e-9, 4: 1e-11}
RTOL_DENSE = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _short_spinner(prob, q_guess):
    """The spinner cut to T=FD_T, and a trajectory near its guess (seed
    0); works on either package's problem."""
    T = FD_T
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])
    rng = np.random.default_rng(0)
    q = np.asarray(q_guess)[: T + 1] + 0.02 * rng.standard_normal(
        (T + 1, np.shape(q_guess)[1]))
    return prob, q


# -- finite-difference partials ----------------------------------------------


@pytest.mark.parametrize("order", [1, 2, 4])
def test_fd_partials_match_jax(order):
    ref = np.load(os.path.join(_GOLDENS, "torch_fd_spinner.npz"))
    model, _, prob, params, q_guess = load_example("spinner", device="cpu")
    prob, q = _short_spinner(prob, q_guess)
    assert np.array_equal(ref["q"], q)
    parts = id_partials_fd(model, prob, params.contact,
                           torch.as_tensor(q)[None], order=order)
    for name, x in zip(("dqm", "dqt", "dqp"), parts):
        want = ref[f"order{order}_{name}"]
        assert x.shape == (1,) + want.shape
        assert _rel(x[0], want) < FD_RTOL_JAX[order], name
    assert float(parts.dtau_dqm[:, 0].abs().max()) == 0.0


@pytest.mark.parametrize("order", [1, 2, 4])
def test_fd_partials_match_the_exact_ones(order):
    """The JAX suite's pendulum check (T=8, q from 0.1 to 2.0), on a batch
    of two, through ``id_partials_for``."""
    model, _, prob, params, _ = load_example("pendulum", device="cpu")
    T = 8
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])
    q = torch.as_tensor(linear_interp_nominal([0.1], [2.0], T))
    qs = torch.stack([q, 0.5 * q])
    method = {1: GradientsMethod.FORWARD_DIFFERENCES,
              2: GradientsMethod.CENTRAL_DIFFERENCES,
              4: GradientsMethod.CENTRAL_DIFFERENCES4}[order]
    fd = id_partials_for(model, prob, params.replace(gradients_method=method),
                         qs)
    exact = soa_partials.id_partials_batched(model, prob, params.contact, qs)
    tol = FD_TOL_EXACT[order]
    for a, b in zip(exact, fd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol,
                                   rtol=10 * tol)


# -- dense and exact Hessian ---------------------------------------------------


@pytest.mark.parametrize("tag", ["dense", "exact"])
def test_dense_solves_match_jax(tag):
    ref = np.load(os.path.join(_GOLDENS, "torch_dense_pendulum.npz"))
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    more = (dict(linear_solver=LinearSolverType.DENSE_LDLT) if tag == "dense"
            else dict(exact_hessian=True))
    sol, stats, warm = solver.solve(
        model, prob, params.replace(max_iterations=DENSE_ITERS, **more),
        q_guess)
    assert int(stats.num_iters) == int(ref[f"{tag}_num_iters"])
    assert _rel(sol.q, ref[f"{tag}_q"]) < RTOL_DENSE
    assert _rel(stats.cost, ref[f"{tag}_cost"]) < RTOL_DENSE
    assert np.abs(stats.rho.numpy() - ref[f"{tag}_rho"]).max() < RTOL_DENSE
    assert _rel(warm.dqH, ref[f"{tag}_warm_dqH"]) < RTOL_DENSE


def test_exact_hessian_composes_through_the_contact_model():
    """Four levels of torch.func (forward over reverse over step_tau's own
    jvp and vjp) on the spinner: the exact Hessian is symmetric, pinned at
    q_0, and equals central differences of the exact gradient."""
    model, _, prob, params, q_guess = load_example("spinner", device="cpu")
    prob, q = _short_spinner(prob, q_guess)
    q = torch.as_tensor(q)
    H = solver._exact_hessian_dense(model, prob, params, q[None])[0]
    nq, n = model.nq, q.numel()
    assert H.shape == (n, n)
    assert torch.equal(H[:nq, :nq], torch.eye(nq, dtype=q.dtype))
    assert float(H[:nq, nq:].abs().max()) == 0.0
    assert float((H - H.T).abs().max()) < 1e-9 * float(H.abs().max())
    eps = 1e-6
    cols = []
    for j in range(nq, n):
        e = torch.zeros(n, dtype=q.dtype)
        e[j] = eps
        gp = trajectory.gradient(model, prob, params.contact,
                                 q + e.reshape(q.shape))
        gm = trajectory.gradient(model, prob, params.contact,
                                 q - e.reshape(q.shape))
        cols.append(((gp - gm) / (2 * eps)).reshape(-1))
    fd = torch.stack(cols, dim=1)[nq:]
    assert float((H[nq:, nq:] - fd).abs().max()) < 1e-5 * float(
        fd.abs().max())


# -- dense cross-check, verbose table, iteration timer -----------------------


def test_debug_compare_against_dense(capsys):
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    iters = 3
    solver.solve(model, prob, params.replace(
        max_iterations=iters, debug_compare_against_dense=True), q_guess)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[debug] sparse vs. dense solve relative error:")]
    assert len(lines) == iters
    errs = [float(ln.split(":")[1]) for ln in lines]
    assert max(errs) < 1e-8


def test_verbose_row_is_the_jax_text(capsys):
    from idto_tpu.optimizer.solver import _print_iter_row as jax_row

    rows = [(0, 98.6902225, 98.6902225, 0.1, 1.0000018, 0.0113695,
             7.19518, 0.0), (7, 1.23456789e3, 1.3e3, 2e-5, -0.25, 3e-9,
                             12.5, 4.4e-7), (50, 3.0, 3.1, 1e5, 0.5, 1.0,
                                             2.0, 1e-12)]
    for r in rows:
        jax_row(*r)
    want = capsys.readouterr().out
    for r in rows:
        solver._print_iter_row(*r)
    assert capsys.readouterr().out == want
    assert want.count(" iter |") == 2  # rows 0 and 50


def test_verbose_solve_prints_a_row_an_iteration(capsys):
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    _, stats, _ = solver.solve(model, prob, params.replace(
        max_iterations=3, verbose=True), q_guess)
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if re.match(r"^\s+\d+ \| ", ln)]
    assert len(rows) == int(stats.num_iters) == 3
    assert float(rows[0].split("|")[1]) == pytest.approx(
        float(stats.cost[0]), rel=1e-5)


def test_record_iteration_times_fills_stats_time():
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    for method in SolverMethod:
        _, stats, _ = solver.solve(model, prob, params.replace(
            method=method, max_iterations=3, record_iteration_times=True),
            q_guess)
        t = stats.time.numpy()
        assert (t[:3] > 0).all() and np.isnan(t[3:]).all()
    _, stats, _ = solver.solve(model, prob, params.replace(max_iterations=2),
                               q_guess)
    assert np.isnan(stats.time.numpy()).all()


VERBOSE_B = 2
VERBOSE_ITERS = 3


def batch_guesses(q_guess):
    """The pendulum's guess and the guess lifted by 0.01 rad after q_0: both
    scenarios run every iteration (no convergence test fires in 3)."""
    qg = np.stack([np.asarray(q_guess)] * VERBOSE_B)
    qg[1, 1:] += 0.01
    return qg


def _rows(text):
    return [ln for ln in text.splitlines() if re.match(r"^\s+\d+ \| ", ln)]


@pytest.mark.parametrize("option", ["verbose", "record_iteration_times"])
def test_single_scenario_options_refuse_a_batch(option, capsys):
    """These two options were refused at B > 1 (the test keeps its name);
    now, at B=2, they match the JAX package, which runs
    ``vmap(solve_trust_region)``: its ordered callbacks print one row a scenario an iteration, in scenario
    order (goldens/torch_verbose_pendulum.npz, its text).  The port prints
    the same rows; the vmapped callbacks also print the header once for each
    scenario at iteration 0, the port once.  The timer: each scenario's
    ``stats.time`` row holds the batch iterations it ran (the JAX package's
    ``attach_iteration_times`` writes along the scenario axis instead).  The
    linesearch (which prints no table in either package) takes both."""
    ref = np.load(os.path.join(_GOLDENS, "torch_verbose_pendulum.npz"))
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    qg = batch_guesses(q_guess)
    assert np.array_equal(ref["q_guess"], qg)
    want = str(ref["text"])
    for method in SolverMethod:
        capsys.readouterr()
        sol, stats, _ = solve_batch(
            model, broadcast_problem(prob, VERBOSE_B), params.replace(
                method=method, max_iterations=VERBOSE_ITERS,
                **{option: True}), torch.as_tensor(qg))
        out = capsys.readouterr().out
        assert stats.num_iters.tolist() == [VERBOSE_ITERS] * VERBOSE_B
        t = stats.time.numpy()
        if option == "verbose":
            assert np.isnan(t).all()
            if method == SolverMethod.TRUST_REGION:
                assert _rows(out) == _rows(want)
                assert len(_rows(out)) == VERBOSE_B * VERBOSE_ITERS
                assert out.count(" iter |") == 1
                assert want.count(" iter |") == VERBOSE_B
                assert _rel(stats.cost, ref["cost"]) < 1e-10
            else:
                assert _rows(out) == []
        else:
            assert out == ""
            assert (t > 0).all() and (t[0] == t[1]).all()
    if option == "record_iteration_times":
        # Scenarios that stop early keep NaN past their last iteration.
        itimer.reset()
        for _ in range(3):
            itimer.mark()
        st = stats.replace(num_iters=torch.tensor([3, 1], dtype=torch.int32),
                           time=torch.full((2, 5), float("nan"),
                                           dtype=torch.float64))
        t = itimer.attach(st).time.numpy()
        assert np.isfinite(t[0, :3]).all() and np.isnan(t[0, 3:]).all()
        assert t[1, 0] == t[0, 0] and np.isnan(t[1, 1:]).all()


def test_itimer_on_the_cpu():
    itimer.reset()
    for _ in range(3):
        itimer.mark()
    times = itimer.collect()
    assert len(times) == 3 and all(t >= 0 for t in times)
    itimer.reset()
    assert itimer.collect() == []


# -- every configuration -------------------------------------------------------


@pytest.mark.parametrize("method,gradients,linear", list(itertools.product(
    SolverMethod, GradientsMethod, LinearSolverType)),
    ids=lambda x: x.value)
def test_solve_batch_takes_every_configuration(method, gradients, linear):
    model, _, prob, params, q_guess = load_example("pendulum", device="cpu")
    B = 2
    qg = q_guess[None] + 0.01 * torch.as_tensor(
        np.random.default_rng(1).standard_normal((B,) + tuple(q_guess.shape)))
    qg[:, 0] = prob.q_init
    p = params.replace(method=method, gradients_method=gradients,
                       linear_solver=linear, max_iterations=2)
    sol, stats, warm = solve_batch(model, broadcast_problem(prob, B), p, qg)
    assert sol.q.shape == qg.shape and torch.isfinite(sol.q).all()
    assert (stats.num_iters == 2).all()
    assert (stats.cost[:, 1] < stats.cost[:, 0]).all()


# -- CSV files, gradient check -------------------------------------------------


def test_save_stats_csv_is_byte_identical_to_jax(tmp_path):
    from idto_tpu.optimizer.solver import Stats as JStats
    from idto_tpu.optimizer.stats_io import save_stats_csv as jax_save

    rng = np.random.default_rng(4)
    K = 6
    arrays = {f.name: rng.standard_normal(K)
              for f in dataclasses.fields(solver.Stats)}
    arrays["ls_iters"] = rng.integers(0, 9, K).astype(np.int32)
    arrays["rho"][4:] = np.nan
    arrays.update(num_iters=np.asarray(4, np.int32),
                  solver_flag=np.asarray(0, np.int32),
                  convergence_reason=np.asarray(0, np.int32))
    jax_save(JStats(**arrays), str(tmp_path / "jax.csv"))
    stats_io.save_stats_csv(
        solver.Stats(**{k: torch.as_tensor(v) for k, v in arrays.items()}),
        str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (
        tmp_path / "jax.csv").read_bytes()


def test_cost_sweeps_and_debug_dumps(tmp_path):
    model, _, prob, params, q_guess = load_example("acrobot", device="cpu")
    sol, stats, warm = solver.solve(
        model, prob, params.replace(max_iterations=2), q_guess)
    stats_io.save_contour_csv(model, prob, params, sol.q,
                              str(tmp_path / "c.csv"), n=4)
    c = np.loadtxt(tmp_path / "c.csv", delimiter=",", skiprows=1)
    assert (tmp_path / "c.csv").read_text().splitlines()[0] == "q1,q2,L"
    q = sol.q.clone()
    q[1, 0], q[2, 0] = c[5, 0], c[5, 1]
    assert c.shape == (16, 3) and c[5, 2] == pytest.approx(
        float(trajectory.cost(model, prob, params.contact, q)), rel=1e-12)
    direction = sol.q - q_guess
    stats_io.save_lineplot_csv(model, prob, params, q_guess, direction,
                               str(tmp_path / "l.csv"), n=5)
    lp = np.loadtxt(tmp_path / "l.csv", delimiter=",", skiprows=1)
    assert lp[-1, 1] == pytest.approx(float(trajectory.cost(
        model, prob, params.contact, q_guess + 1.2 * direction)), rel=1e-12)

    debug_dump.save_quadratic_csv(model, prob, params, q_guess,
                                  str(tmp_path / "q.csv"), n_iters=2)
    lines = (tmp_path / "q.csv").read_text().splitlines()
    assert lines[0] == ("iter, q1, q2, dq1, dq2, Delta, cost , g1, g2, H11, "
                        "H12, H21, H22, g_norm, H_norm")
    quad = np.loadtxt(tmp_path / "q.csv", delimiter=",", skiprows=1)
    assert quad.shape == (2, 15)
    assert quad[:, 6] == pytest.approx(stats.cost.numpy(), rel=1e-12)
    assert quad[:, 5] == pytest.approx(stats.delta.numpy(), rel=1e-12)
    debug_dump.save_linesearch_residual_csv(
        model, prob, params, sol.q, warm.dqH, str(tmp_path / "r.csv"))
    res = np.loadtxt(tmp_path / "r.csv", delimiter=",", skiprows=1)
    assert res.shape == (141, 5) and abs(res[20, 1]) < 1e-12  # alpha = 0


def test_trajectory_helpers_agree_with_the_rollout():
    """optimizer/trajectory.py on one spinner trajectory (T=4): step_tau at
    every step from velocities and accelerations equals the rollout's
    generalized forces, and cost and gradient keep the batch convention."""
    model, _, prob, params, q_guess = load_example("spinner", device="cpu")
    prob, q = _short_spinner(prob, q_guess)
    q = torch.as_tensor(q)
    contact = params.contact
    v = trajectory.velocities(model, prob, q)
    a = trajectory.accelerations(prob, v)
    tau = trajectory.generalized_forces(model, prob, contact, q)
    assert v.shape == (FD_T + 1, model.nv) and a.shape == (FD_T, model.nv)
    assert torch.equal(v[0], prob.v_init)
    for t in range(FD_T):
        assert _rel(trajectory.step_tau(model, contact, q[t + 1], v[t + 1],
                                        a[t]), tau[t]) < 1e-12
    qs = torch.stack([q, q + 0.01])
    L = trajectory.cost(model, prob, contact, qs)
    assert L.shape == (2,) and float(L[0]) == float(
        trajectory.cost(model, prob, contact, q))
    g = trajectory.gradient(model, prob, contact, qs)
    assert g.shape == qs.shape and float(g[:, 0].abs().max()) == 0.0
    assert torch.equal(g[0], trajectory.gradient(model, prob, contact, q))


def test_gradient_check_matches_the_analytic_gradient():
    """The JAX suite's tiers: 100 sqrt(eps) for forward, 10 sqrt(eps) for
    central differences (spinner at T=4, contact active)."""
    model, _, prob, params, q_guess = load_example("spinner", device="cpu")
    prob, q = _short_spinner(prob, q_guess)
    q = torch.as_tensor(q)
    g = gradient_check.analytic_gradient(model, prob, params, q)
    assert float(g[0].abs().max()) == 0.0
    # The exact reverse-mode gradient keeps the quaternion term the
    # partials' gradient drops; the spinner has none, so they agree.
    assert _rel(trajectory.gradient(model, prob, params.contact, q),
                g) < 1e-10
    eps = np.finfo(np.float64).eps
    for g_fd, tol in ((gradient_check.fd_gradient(model, prob, params, q),
                       100 * np.sqrt(eps)),
                      (gradient_check.cd_gradient(model, prob, params, q),
                       10 * np.sqrt(eps)),
                      (gradient_check.cd_gradient(model, prob, params, q, 4),
                       10 * np.sqrt(eps))):
        assert _rel(g_fd, g) < tol


# -- checkpoints, timing, profiler ---------------------------------------------


def test_checkpoint_round_trip_and_layout(tmp_path):
    from idto_tpu_torch.utils import checkpoint

    rng = np.random.default_rng(0)
    warm = solver.WarmStart(**{k: torch.as_tensor(rng.standard_normal((2, 3)))
                               for k in ("q", "dq", "dqH")},
                            Delta=torch.tensor([0.1, 0.2], dtype=torch.float64))
    path = checkpoint.save(str(tmp_path / "w"), warm)
    assert path.endswith(".npz")
    data = np.load(path)
    assert sorted(data.files) == [f"leaf_{i:06d}" for i in range(4)]
    assert np.array_equal(data["leaf_000001"], [0.1, 0.2])  # field order
    like = warm.replace(**{k: torch.zeros_like(getattr(warm, k))
                           for k in ("q", "Delta", "dq", "dqH")})
    back = checkpoint.restore(path, like)
    for k in ("q", "Delta", "dq", "dqH"):
        assert torch.equal(getattr(back, k), getattr(warm, k))
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in range(4):
        mgr.save(step, warm.replace(Delta=warm.Delta + step))
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "index.json", "step_2.npz", "step_3.npz"]
    step, got = mgr.restore_latest(like)
    assert step == 3 and torch.equal(got.Delta, warm.Delta + 3)


def test_timing_and_profiler_on_the_cpu():
    from idto_tpu_torch.utils import profiler, timing

    x = torch.ones(64, 64, dtype=torch.float64)
    assert timing.time_fn(lambda a: a @ a, [(x,)], reps=3,
                          device="cpu") > 0.0
    assert timing.time_throughput(lambda a: a @ a, [(x,)], calls=3,
                                  device="cpu") > 0.0
    profiler.reset()
    profiler.set_enabled(True)  # the host-clock table is off by default
    try:
        with profiler.instrument("outer"):
            with profiler.instrument("inner"):
                x @ x
    finally:
        profiler.set_enabled(False)
    table = profiler.table_of_averages()
    assert "outer" in table and "inner" in table
    profiler.reset()
