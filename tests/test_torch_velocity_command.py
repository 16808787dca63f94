"""The port's velocity-command MPC against the JAX package, float64 on the
CPU: ``rot_to_quat`` and ``rpy_to_rot``, ``velocity_command_nominal`` on
random cheetah poses (live JAX: small eager pieces), the cheetah's
velocity-command replan chain against goldens/torch_velocity_cheetah.npz
(``scripts/make_torch_goldens.py velocity``), and the command line.

Tolerances: 1e-12 for the rotations and the nominal (the same float64
expressions); 1e-7 on the chain's q (one initial iteration and two
replans, as tests/test_torch_mpc.py holds the fixed-nominal chain).
"""
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idto_tpu.examples.registry import load_example as jax_load_example
from idto_tpu.models import rotations as jrot
from idto_tpu.mpc import controller as jmpc
from idto_tpu_torch.examples import velocity_command as cli
from idto_tpu_torch.examples.config import ExampleConfig
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.models import rotations as rot
from idto_tpu_torch.mpc import controller as mpc
from idto_tpu_torch.parallel.batching import broadcast_problem

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "torch_velocity_cheetah.npz")
# (t_now, command) of the chain's replans: the command changes between them.
CHAIN = ((0.0, (0.3, 0.0, 0.0)), (1.0 / 60.0, (0.2, 0.1, 0.5)))


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _state_estimate(prob, model):
    """The cheetah's q_init with the base moved and turned, the joints and
    velocities perturbed (seed 3); works on either package's problem."""
    rng = np.random.default_rng(3)
    q0 = np.asarray(prob.q_init).copy()
    q0[:4] += 0.05 * rng.standard_normal(4)
    q0[:4] /= np.linalg.norm(q0[:4])
    q0[4:6] += [0.02, -0.01]
    q0[7:] += 0.01 * rng.standard_normal(q0[7:].shape)
    return np.concatenate([q0, 0.01 * rng.standard_normal(model.nv)])


def _random_quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    quats = _random_quats(rng, 64)
    R = jax.vmap(jrot.quat_to_rot)(jnp.asarray(quats))  # (N, 3, 3)
    got = rot.rot_to_quat(torch.as_tensor(np.asarray(R)).permute(1, 2, 0))
    assert _rel(got.T, jax.vmap(jrot.rot_to_quat)(R)) < 1e-12
    assert (got[0] >= 0).all()
    assert _rel(got.T * np.sign(quats[:, :1]), quats) < 1e-12
    rpy = rng.uniform(-3, 3, (64, 3))
    assert _rel(rot.rpy_to_rot(torch.as_tensor(rpy.T)).permute(2, 0, 1),
                jax.vmap(jrot.rpy_to_rot)(jnp.asarray(rpy))) < 1e-12


def test_velocity_command_nominal_matches_jax():
    """Random base poses and commands, a batch of four."""
    jm, _, jprob, _, _ = jax_load_example("mini_cheetah")
    model, _, prob, _, _ = load_example("mini_cheetah", device="cpu")
    rng = np.random.default_rng(1)
    B = 4
    q0 = np.asarray(jprob.q_init)[None] + 0.1 * rng.standard_normal(
        (B, jm.nq))
    q0[:, :4] = _random_quats(rng, B)
    cmd = rng.uniform(-1, 1, (B, 3))
    q_nom, v_nom = mpc.velocity_command_nominal(
        model, broadcast_problem(prob, B), torch.as_tensor(q0),
        torch.as_tensor(cmd))
    for b in range(B):
        jq, jv = jmpc.velocity_command_nominal(jm, jprob, jnp.asarray(q0[b]),
                                               jnp.asarray(cmd[b]))
        assert _rel(q_nom[b], jq) < 1e-12
        assert _rel(v_nom[b], jv) < 1e-12
    # One command for the batch, and the shortest-path sign.
    q1, _ = mpc.velocity_command_nominal(
        model, prob, torch.as_tensor(q0), torch.as_tensor(cmd[0]))
    assert q1.shape == (B, prob.num_steps + 1, model.nq)
    assert (torch.einsum("btq,bq->bt", q1[..., :4],
                         torch.as_tensor(q0[:, :4])) >= 0).all()


def test_velocity_command_chain_matches_jax_golden():
    ref = np.load(_GOLDEN)
    model, _, prob, params, q_guess = load_example("mini_cheetah",
                                                   device="cpu")
    params = params.replace(max_iterations=1, check_convergence=False)
    mpc_params = mpc.make_mpc_params(params, 1)
    x0 = _state_estimate(prob, model)
    assert np.array_equal(ref["x0"], x0)
    probs = broadcast_problem(prob, 1)
    carry, sol0 = mpc.mpc_initialize(model, probs, params, q_guess[None])
    assert _rel(sol0.q[0], ref["q_init"]) < 1e-7
    x = torch.as_tensor(x0)[None]
    for i, (t, cmd) in enumerate(CHAIN):
        carry, sol = mpc.mpc_step_velocity_command(
            model, probs, mpc_params, carry, x, t,
            torch.as_tensor(cmd, dtype=torch.float64))
        assert _rel(sol.q[0], ref[f"q_{i}"]) < 1e-7
        assert _rel(sol.tau[0], ref[f"tau_{i}"]) < 1e-6
        assert _rel(carry.Delta[0], ref[f"Delta_{i}"]) < 1e-12
        assert _rel(carry.q_nom[0], ref[f"q_nom_{i}"]) < 1e-12


def test_schedule():
    sched = cli.parse_schedule(" 2: 0 0 0.5; 0: 0.3, 0, 0 ;")
    assert sched == [(0.0, (0.3, 0.0, 0.0)), (2.0, (0.0, 0.0, 0.5))]
    assert cli.command_at(sched, -1.0) == (0.3, 0.0, 0.0)
    assert cli.command_at(sched, 1.99) == (0.3, 0.0, 0.0)
    assert cli.command_at(sched, 2.0) == (0.0, 0.0, 0.5)
    for bad in ("", "0: 1 2"):
        with pytest.raises(ValueError):
            cli.parse_schedule(bad)


def test_cli_runs_the_cheetah_on_the_cpu(capsys, monkeypatch, tmp_path):
    """Two replans of 17 substeps under a forward command, the initial
    solve cut to one iteration; the JAX script's two lines, and the
    simulated run's playback file."""
    load = ExampleConfig.load.__func__

    def short_load(cls, path):
        return dataclasses.replace(load(cls, path), max_iters=1)

    monkeypatch.setattr(ExampleConfig, "load", classmethod(short_load))
    html = tmp_path / "run.html"
    assert cli.main(["mini_cheetah", "--schedule", "0: 0.3 0 0",
                     "--sim-time", "0.034", "--device", "cpu",
                     "--playback", str(html)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[mini_cheetah] 2 replans, mean solve ")
    assert out[0].endswith(" Hz)")
    assert re.fullmatch(
        r"base displacement: dx=[+-]\d+\.\d{3} m dy=[+-]\d+\.\d{3} m",
        out[1])
    assert out[2] == f"playback written to {html}"
    scene = json.loads(re.search(r"const SCENE = (\{.*?\});\n",
                                 html.read_text(), re.S).group(1))
    # 1 + 2 x 17 logged states at a stride of 20 substeps of 1 ms.
    assert len(scene["frames"]) == 2 and scene["dt"] == pytest.approx(0.02)
    with pytest.raises(SystemExit):
        cli.main(["pendulum", "--platform=cpu"])
