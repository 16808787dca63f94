"""The port's closed MPC loop against the JAX package: mass matrix, bias
forces and forward dynamics, the PD-plus controller, one simulator step, a
simulated segment, ``run_mpc`` and the command line.

Tolerances, all float64 on the CPU:

  * 1e-10 for the mass matrix, forward dynamics, the controller and one
    simulator step: the same expressions; the port takes M from inverse
    dynamics at unit accelerations (ID is affine in a) where the reference
    takes ``jacfwd``, and jaco's M has condition ~1e4;
  * 1e-9 for a simulated segment of a few substeps from a shared stored
    trajectory;
  * 1e-7 for ``run_mpc`` over three replans on pendulum, spinner and
    hopper (against goldens/torch_closed_loop_*.npz): each
    replan is one trust-region iteration from the last one's carry and the
    simulated state, so differences of 1e-9 a replan compound.

The JAX side is live where it runs eagerly in a second (the PD
controller).  The dynamics of pendulum, hopper and jaco
(goldens/torch_dynamics_*.npz), the segments of pendulum and spinner
(goldens/torch_segment_*.npz) and the loops of pendulum, spinner and hopper
come from ``scripts/make_torch_goldens.py closed_loop dynamics segment``:
their JAX compiles take from ten seconds to minutes.

Jaco's loop is unstable.  The simulator is explicit in the PD terms, and
jaco's YAML gains give h Kd / M = 250 on the wrist joint (inertia 5e-4
kg m^2, Kd = 25, h = 5e-3 s;
``test_pd_gains_of_the_arm_examples_are_unstable_in_the_explicit_simulator``
keeps the number): the state grows 250-fold a substep, then squares, and
``idto_tpu``'s own ``run_mpc`` overflows in the second replan period
(goldens/torch_closed_loop_jaco.npz keeps the substep,
``first_nonfinite``).  The port must turn non-finite at the same substep,
and the first six substeps of its first replan period (the stiffer
simulation contact of ``load_sim_plant``) are held one by one, each relative
to its own largest entry (RTOL_UNSTABLE): both packages amplify the same
rounding differences along with the state itself.  From the seventh substep
on the joint angles pass 1e13 rad, where sin and cos keep no digit in
float64, and two runs differ by factors.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idto_tpu.examples.registry import load_example as jax_load_example
from idto_tpu.examples.registry import load_sim_plant as jax_load_sim_plant
from idto_tpu.models.model import JointType
from idto_tpu.mpc import pd as jpd
from idto_tpu_torch import convert
from idto_tpu_torch.examples import run as cli
from idto_tpu_torch.examples.config import ExampleConfig
from idto_tpu_torch.examples.registry import load_example, load_sim_plant
from idto_tpu_torch.mpc import pd, runner, simulator
from idto_tpu_torch.mpc.trajectory_store import StoredTrajectory
from idto_tpu_torch.optimizer.solver import Solution
from idto_tpu_torch.soa import contact as tcon
from idto_tpu_torch.soa import dynamics as tdyn

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
RTOL = 1e-10
RTOL_SEGMENT = 1e-9
RTOL_LOOP = 1e-7
RTOL_UNSTABLE = 1e-8  # 2.4e-12 at the sixth substep against the JAX run
HELD_UNSTABLE = 6  # substeps
N_STATES = 4
SIM_H = 2e-3
PENDULUM_GAINS = dict(Kp=[2.0], Kd=[0.3])  # its YAML has none


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _states(jm, jprob, rng, n):
    """n states around q_init (unit quaternions), velocities and controls."""
    q = np.asarray(jprob.q_init)[None] + 0.05 * rng.standard_normal(
        (n, jm.nq))
    for j in range(jm.num_joints):
        if JointType(jm.joint_types[j]) == JointType.FLOATING:
            s = jm.q_starts[j]
            q[:, s:s + 4] /= np.linalg.norm(q[:, s:s + 4], axis=1,
                                            keepdims=True)
    v = 0.3 * rng.standard_normal((n, jm.nv))
    u = 0.5 * rng.standard_normal((n, jm.nu))
    return q, v, u


@pytest.fixture(scope="module", params=["pendulum", "hopper", "jaco"])
def dyn_case(request):
    """The JAX package's mass matrix, forward dynamics and simulator step
    at seeded states (goldens/torch_dynamics_*.npz), and the same states
    for the port."""
    name = request.param
    jm, _, jprob, jparams, _ = jax_load_example(name)
    q, v, u = _states(jm, jprob, np.random.default_rng(5), N_STATES)
    g = np.load(os.path.join(_GOLDENS, f"torch_dynamics_{name}.npz"))
    assert float(g["h"]) == SIM_H
    assert all(np.array_equal(g[k], x)
               for k, x in (("q", q), ("v", v), ("u", u)))
    ref = (g["M"], g["bias"], g["a"], (g["q_new"], g["v_new"]))
    return dict(name=name, ref=ref, tm=convert.model(jm, device="cpu"),
                tc=convert.solver_params(jparams).contact,
                q=torch.tensor(q), v=torch.tensor(v), u=torch.tensor(u))


def test_mass_matrix_bias_and_forward_dynamics_match_jax(dyn_case):
    tm, tc = dyn_case["tm"], dyn_case["tc"]
    q, v, u = (dyn_case[k] for k in ("q", "v", "u"))
    M_j, h_j, a_j, _ = dyn_case["ref"]
    M = tdyn.mass_matrix(tm, q.T)  # (nv, nv, N)
    assert _rel(M.permute(2, 0, 1), M_j) < RTOL
    assert float((M - M.transpose(0, 1)).abs().max()) < 1e-12 * float(
        M.abs().max())
    assert float(torch.linalg.eigvalsh(M.permute(2, 0, 1)).min()) > 0.0
    wrenches = tcon.contact_wrenches(tm, q.T, v.T, tc)
    assert _rel(tdyn.bias_forces(tm, q.T, v.T, wrenches).T, h_j) < RTOL
    a = tdyn.forward_dynamics(tm, q.T, v.T, tm.B @ u.T, wrenches)
    assert _rel(a.T, a_j) < RTOL
    # Forward dynamics inverts inverse dynamics.
    tau = tdyn.inverse_dynamics(tm, q.T, v.T, a, wrenches)
    assert _rel(tau, tm.B @ u.T) < 1e-9 or float(
        (tau - tm.B @ u.T).abs().max()) < 1e-9


def test_sim_step_matches_jax(dyn_case):
    q, v, u = (dyn_case[k] for k in ("q", "v", "u"))
    q_new, v_new = simulator.sim_step(dyn_case["tm"], dyn_case["tc"], SIM_H,
                                      q, v, u)
    q_j, v_j = dyn_case["ref"][3]
    assert q_new.shape == q.shape and v_new.shape == v.shape
    assert _rel(q_new, q_j) < RTOL and _rel(v_new, v_j) < RTOL


@pytest.mark.parametrize("feed_forward", [True, False])
def test_pd_plus_control_matches_jax(feed_forward):
    jm, jcfg, jprob, _, _ = jax_load_example("jaco")
    tm = convert.model(jm, device="cpu")
    rng = np.random.default_rng(2)
    q, v, u_nom = _states(jm, jprob, rng, N_STATES)
    q_nom, v_nom, _ = _states(jm, jprob, rng, N_STATES)
    Kp, Kd = np.asarray(jcfg.Kp, float), np.asarray(jcfg.Kd, float)
    assert np.array_equal(pd.actuation_q_matrix(tm),
                          jpd.actuation_q_matrix(jm))
    got = pd.pd_plus_control(
        tm, torch.tensor(Kp), torch.tensor(Kd), torch.tensor(q_nom),
        torch.tensor(v_nom), torch.tensor(u_nom), torch.tensor(q),
        torch.tensor(v), feed_forward)
    assert got.shape == (N_STATES, jm.nu)
    for i in range(N_STATES):
        want = jpd.pd_plus_control(
            jm, Kp, Kd, *(jnp.asarray(x[i]) for x in
                          (q_nom, v_nom, u_nom, q, v)), feed_forward)
        assert _rel(got[i], want) < 1e-12


# -- a simulated segment ----------------------------------------------------


def _random_solution(jm, jprob, rng):
    T = jprob.num_steps
    q = np.asarray(jprob.q_nom) + 0.05 * rng.standard_normal((T + 1, jm.nq))
    v = np.zeros((T + 1, jm.nv))
    v[1:] = (q[1:] - q[:-1]) / jprob.dt
    tau = 0.1 * rng.standard_normal((T, jm.nv))
    return q, v, tau


# The simulated segment: stored at t_store, simulated from t_start.
SEGMENT = dict(t_store=0.02, t_start=0.05, substeps=6)


def _segment_inputs(jm, jprob):
    """A random stored solution, gains and starting state (seed 9)."""
    rng = np.random.default_rng(9)
    q, v, tau = _random_solution(jm, jprob, rng)
    Kp = rng.uniform(1.0, 10.0, jm.nq)
    Kd = rng.uniform(0.1, 1.0, jm.nv)
    q0, v0, _ = _states(jm, jprob, rng, 1)
    return dict(q=q, v=v, tau=tau, Kp=Kp, Kd=Kd, q0=q0, v0=v0)


@pytest.mark.parametrize("name", ["pendulum", "spinner"])
def test_simulate_segment_matches_jax(name):
    """Against the JAX package's segment from the same inputs
    (goldens/torch_segment_NAME.npz)."""
    jm, _, jprob, jparams, _ = jax_load_example(name)
    x = _segment_inputs(jm, jprob)
    ref = np.load(os.path.join(_GOLDENS, f"torch_segment_{name}.npz"))
    for key, val in x.items():
        assert np.array_equal(ref[key], val), key
    substeps = SEGMENT["substeps"]

    tm = convert.model(jm, device="cpu")
    stored = StoredTrajectory.from_solution(
        tm, Solution(q=torch.tensor(x["q"])[None],
                     v=torch.tensor(x["v"])[None],
                     tau=torch.tensor(x["tau"])[None]),
        SEGMENT["t_store"], float(jprob.dt))
    q_t, v_t, log_t = simulator.simulate_segment(
        tm, convert.solver_params(jparams).contact, SIM_H, substeps, stored,
        torch.tensor(x["Kp"]), torch.tensor(x["Kd"]), torch.tensor(x["q0"]),
        torch.tensor(x["v0"]), SEGMENT["t_start"])
    assert _rel(q_t[0], ref["q_end"]) < RTOL_SEGMENT
    assert _rel(v_t[0], ref["v_end"]) < RTOL_SEGMENT
    for x_t, key, width in zip(log_t, ("log_q", "log_v", "log_u"),
                               (jm.nq, jm.nv, jm.nu)):
        assert x_t.shape == (1, substeps, width)
        assert _rel(x_t[0], ref[key]) < RTOL_SEGMENT
    assert torch.equal(log_t[0][:, -1], q_t)


# -- the closed loop --------------------------------------------------------


def _short(cfg, replans, **more):
    return dataclasses.replace(
        cfg, sim_time=(replans + 0.5) / cfg.controller_frequency, **more)


def _check_loop(res, plans, model, cfg, prob, replans):
    substeps = max(1, round(1.0 / (cfg.controller_frequency
                                   * cfg.sim_time_step)))
    assert res.num_solves == replans
    assert res.q_log.shape == (replans * substeps, model.nq)
    assert res.v_log.shape == (replans * substeps, model.nv)
    assert res.u_log.shape == (replans * substeps, model.nu)
    assert res.mean_solve_time > 0.0 and res.mean_sim_time > 0.0
    assert [t for t, _ in plans] == [
        k / cfg.controller_frequency for k in range(replans)]
    assert all(q.shape == (prob.num_steps + 1, model.nq) for _, q in plans)


def test_run_mpc_matches_jax_on_pendulum():
    """Three replans against the JAX run (goldens/torch_closed_loop_
    pendulum.npz), the initial solve cut to three iterations, gains put
    in."""
    ref = np.load(os.path.join(_GOLDENS, "torch_closed_loop_pendulum.npz"))
    replans, init_iters = int(ref["replans"]), int(ref["init_iters"])
    model, cfg, prob, params, q_guess = load_example("pendulum", device="cpu")
    cfg = _short(cfg, replans, **PENDULUM_GAINS)
    plans = []
    res = runner.run_mpc(model, cfg, prob,
                         params.replace(max_iterations=init_iters), q_guess,
                         on_replan=lambda t, q: plans.append((t, q)))
    _check_loop(res, plans, model, cfg, prob, replans)
    assert int(ref["num_solves"]) == replans
    assert np.array_equal(res.times, ref["times"])
    assert np.abs(ref["u_log"]).max() > 0.0
    for key in ("q_log", "v_log", "u_log"):
        assert _rel(getattr(res, key), ref[key]) < RTOL_LOOP, key


@pytest.mark.parametrize("name", ["spinner", "hopper"])
def test_run_mpc_matches_jax_golden(name):
    """Three replans of the spinner and the hopper (equality constraints,
    contact, PD gains and feed-forward from their YAML) against the JAX
    run."""
    ref = np.load(os.path.join(_GOLDENS, f"torch_closed_loop_{name}.npz"))
    replans = int(ref["replans"])
    model, cfg, prob, params, q_guess = load_example(name, device="cpu")
    cfg = _short(cfg, replans)
    sim_model, sim_contact = load_sim_plant(name, params, device="cpu")
    plans = []
    res = runner.run_mpc(
        model, cfg, prob,
        params.replace(max_iterations=int(ref["init_iters"])), q_guess,
        sim_model=sim_model, sim_contact=sim_contact,
        on_replan=lambda t, q: plans.append((t, q)))
    _check_loop(res, plans, model, cfg, prob, replans)
    assert np.allclose(res.times, ref["times"], rtol=0, atol=1e-15)
    assert _rel(np.stack([q for _, q in plans]), ref["plans"]) < RTOL_LOOP
    for key in ("q_log", "v_log", "u_log"):
        assert _rel(getattr(res, key), ref[key]) < RTOL_LOOP, key


def test_run_mpc_on_jaco_turns_non_finite_where_the_jax_run_does():
    ref = np.load(os.path.join(_GOLDENS, "torch_closed_loop_jaco.npz"))
    replans = int(ref["replans"])
    model, cfg, prob, params, q_guess = load_example("jaco", device="cpu")
    cfg = _short(cfg, replans)
    sim_model, sim_contact = load_sim_plant("jaco", params, device="cpu")
    assert sim_contact.stiffness == 10.0 * params.contact.stiffness
    plans = []
    res = runner.run_mpc(
        model, cfg, prob,
        params.replace(max_iterations=int(ref["init_iters"])), q_guess,
        sim_model=sim_model, sim_contact=sim_contact,
        on_replan=lambda t, q: plans.append((t, q)))
    _check_loop(res, plans, model, cfg, prob, replans)
    substeps = res.q_log.shape[0] // replans
    finite = np.isfinite(res.q_log).all(axis=1) & np.isfinite(
        res.v_log).all(axis=1)
    assert substeps <= int(ref["first_nonfinite"]) < replans * substeps
    assert int(np.argmin(finite)) == int(ref["first_nonfinite"])
    assert _rel(plans[0][1], ref["plans"][0]) < RTOL_LOOP
    for key in ("q_log", "v_log", "u_log"):
        assert np.isfinite(getattr(res, key)[:substeps]).all()
        assert np.isfinite(ref[key][:substeps]).all()
        x, y = getattr(res, key)[:HELD_UNSTABLE], ref[key][:HELD_UNSTABLE]
        err = np.abs(x - y).max(axis=1) / np.abs(y).max(axis=1)
        assert err.max() < RTOL_UNSTABLE, (key, err)
    # the state has left every physical range well before it overflows
    assert np.abs(ref["v_log"][substeps - 1]).max() > 1e100


def test_pd_gains_of_the_arm_examples_are_unstable_in_the_explicit_simulator():
    """v' = v + h M^-1 (... - Kd v) is stable only for h Kd / M < 2.  The
    hopper and the cheetah are below 1; the arms' wrist joints are at 250
    (jaco at its YAML step), so no finite closed loop of them exists under
    this integrator, in either package."""
    def worst(name):
        model, cfg, prob, _, _ = load_example(name, device="cpu")
        M = tdyn.mass_matrix(model, prob.q_init[:, None])[..., 0]
        actuated = model.B.sum(dim=1) > 0
        ratio = cfg.sim_time_step * torch.tensor(cfg.Kd) / torch.diagonal(M)
        return float(ratio[actuated].max())

    assert worst("hopper") < 1.0 and worst("mini_cheetah") < 1.0
    assert abs(worst("jaco") - 250.0) < 1.0


def test_run_mpc_refuses_a_sim_model_of_another_layout():
    model, cfg, prob, params, q_guess = load_example("pendulum", device="cpu")
    other = load_example("acrobot", device="cpu")[0]
    with pytest.raises(ValueError, match="layout"):
        runner.run_mpc(model, cfg, prob, params, q_guess, sim_model=other)


def test_load_sim_plant_matches_jax():
    for name in ("hopper", "jaco", "punyo"):
        _, _, _, jparams, _ = jax_load_example(name)
        _, jcontact = jax_load_sim_plant(name, jparams)
        params = load_example(name, device="cpu")[3]
        sim_model, contact = load_sim_plant(name, params, device="cpu")
        assert sim_model is None
        if jcontact is None:
            assert contact is None
        else:
            assert contact == convert.solver_params(
                jparams.replace(contact=jcontact)).contact
            assert contact.stiffness == 10.0 * params.contact.stiffness


# -- the command line -------------------------------------------------------


def test_cli_lists_the_twelve_examples(capsys):
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in ("kuka", "jaco", "jaco_ball", "dual_jaco", "allegro_hand",
                 "punyo", "mini_cheetah", "pendulum"):
        assert name in out


def test_cli_test_mode_solves_pendulum_on_the_cpu(capsys):
    assert cli.main(["pendulum", "--test", "--device", "cpu",
                     "--verbose"]) == 0
    out = capsys.readouterr().out
    assert "iterations:     10" in out and "device=cpu" in out
    cost = [float(line.split(":")[1]) for line in out.splitlines()
            if line.startswith(("initial cost", "final cost"))]
    assert cost[1] < cost[0]
    assert " iter " in out  # the verbose table's header


def test_cli_mpc_runs_pendulum_on_the_cpu(capsys, monkeypatch):
    load = ExampleConfig.load.__func__

    def short_load(cls, path):
        return dataclasses.replace(load(cls, path), sim_time=0.011,
                                   max_iters=3)

    monkeypatch.setattr(ExampleConfig, "load", classmethod(short_load))
    assert cli.main(["pendulum", "--mpc", "--device", "cpu"]) == 0
    assert "MPC: 3 solves" in capsys.readouterr().out


def test_cli_defaults_to_the_card_and_has_no_idle_flags():
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            cli.main(["pendulum", "--test"])
    with pytest.raises(SystemExit):
        cli.main(["pendulum", "--platform=cpu"])
    # --live and --playback are served now (tests/test_torch_playback.py).
    for flag in ("--live", "--playback=x.html"):
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                cli.main(["pendulum", "--test", flag])


def test_cli_writes_the_csv_files_and_the_profile(capsys, monkeypatch,
                                                  tmp_path):
    load = ExampleConfig.load.__func__

    def short_load(cls, path):
        return dataclasses.replace(load(cls, path), max_iters=2)

    monkeypatch.setattr(ExampleConfig, "load", classmethod(short_load))
    files = {flag: str(tmp_path / f"{flag.strip('-')}.csv") for flag in (
        "--stats-csv", "--contour-csv", "--lineplot-csv", "--quadratic-csv",
        "--linesearch-csv")}
    argv = ["acrobot", "--device", "cpu", "--print-debug-data", "--profile"]
    for flag, path in files.items():
        argv += [flag, path]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "iterations:     2" in out
    assert out.count("condition_number_scaled = ") == 2
    assert "ms/sample" in out and "first solve" in out
    stats = np.loadtxt(files["--stats-csv"], delimiter=",", skiprows=1)
    assert stats.shape == (2, 14) and (stats[:, 1] > 0).all()
    for path in files.values():
        assert os.path.getsize(path) > 0
