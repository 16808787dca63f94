"""The port's MPC replan (``idto_tpu_torch/mpc``) against the JAX package:
the natural cubic spline store, the nominal shift with its quaternion
composition, one ``mpc_step`` from a converted carry, and the mini-cheetah
replan chain against a golden.

Tolerances: 1e-12 for the spline and the shift (the same float64
expressions; the spline's tridiagonal solve is well conditioned); 1e-8 for
one replan (one trust-region iteration of the same algorithm from the same
carry; summation orders differ and the Hessian's condition amplifies eps).
The cheetah chain (initialize, then two replans, each from the port's own
previous carry) is held to goldens/torch_mpc_cheetah.npz, which
scripts/make_torch_goldens.py writes from ``idto_tpu``'s ``mpc_initialize``
and ``mpc_step`` (single-trajectory AoS solver), at 1e-7: three chained
iterations.  The replan from a seeded carry is held to
goldens/torch_mpc_step_{pendulum,spinner}.npz (``make_torch_goldens.py
mpc_step``): its JAX compile takes up to a minute.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idto_tpu.examples.registry import load_example as jax_load_example
from idto_tpu.mpc import controller as jmpc
from idto_tpu.mpc.trajectory_store import CubicSpline as JCubicSpline
from idto_tpu.mpc.trajectory_store import StoredTrajectory as JStored
from idto_tpu.optimizer.solver import Solution as JSolution
from idto_tpu.optimizer.solver import WarmStart as JWarmStart
from idto_tpu_torch import convert
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.mpc import controller as mpc
from idto_tpu_torch.mpc.trajectory_store import CubicSpline, StoredTrajectory
from idto_tpu_torch.optimizer.solver import Solution
from idto_tpu_torch.parallel.batching import broadcast_problem

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "torch_mpc_cheetah.npz")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- spline -----------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4, 21])
def test_spline_matches_jax_at_knots_between_and_outside(n):
    """Knot values are reproduced; between knots and outside the knot range
    (boundary-segment extrapolation) the values are the JAX spline's."""
    B, d, dt = 2, 3, 0.05
    rng = np.random.default_rng(n)
    y = rng.standard_normal((B, n, d))
    spline = CubicSpline.fit(torch.as_tensor(y), dt)
    knots = np.arange(n) * dt
    t = np.concatenate([knots, rng.uniform(-0.2, (n + 3) * dt, 40),
                        [-0.3, (n - 1) * dt + 0.3]])
    got = spline.value(torch.as_tensor(t)).numpy()
    assert got.shape == (B, t.size, d)
    assert _rel(got[:, :n], y) < 1e-12
    for b in range(B):
        js = JCubicSpline.fit(jnp.asarray(y[b]), dt)
        want = jax.vmap(js.value)(jnp.asarray(t))
        assert _rel(spline.M[b], js.M) < 1e-12
        assert _rel(got[b], want) < 1e-12


def test_spline_reproduces_a_line_and_extrapolates_it():
    dt, n = 0.1, 6
    ts = torch.arange(n, dtype=torch.float64) * dt
    y = torch.stack([2.0 * ts - 1.0, -0.5 * ts], dim=-1)[None]
    spline = CubicSpline.fit(y, dt)
    assert float(spline.M.abs().max()) < 1e-12
    t = torch.tensor([-0.25, 0.03, 0.31, 0.77], dtype=torch.float64)
    want = torch.stack([2.0 * t - 1.0, -0.5 * t], dim=-1)[None]
    assert _rel(spline.value(t), want) < 1e-12


def test_stored_trajectory_matches_jax():
    """u knots are B^T tau with the last step repeated; sampling counts time
    from ``start_time``."""
    jm, _, jprob, _, _ = jax_load_example("spinner")
    model = convert.model(jm, device="cpu")
    T = jprob.num_steps
    rng = np.random.default_rng(0)
    q = rng.standard_normal((T + 1, jm.nq))
    v = rng.standard_normal((T + 1, jm.nv))
    tau = rng.standard_normal((T, jm.nv))
    jst = JStored.from_solution(
        jm, JSolution(q=jnp.asarray(q), v=jnp.asarray(v),
                      tau=jnp.asarray(tau)), 0.3, jprob.dt)
    st = StoredTrajectory.from_solution(
        model, Solution(q=torch.as_tensor(q)[None], v=torch.as_tensor(v)[None],
                        tau=torch.as_tensor(tau)[None]), 0.3, jprob.dt)
    t = np.array([0.25, 0.3, 0.37, 1.1, 2.9])
    qs, vs = st.sample_state(torch.as_tensor(t))
    us = st.sample_control(torch.as_tensor(t))
    for i, ti in enumerate(t):
        jq, jv = jst.sample_state(jnp.asarray(ti))
        assert _rel(qs[0, i], jq) < 1e-12
        assert _rel(vs[0, i], jv) < 1e-12
        assert _rel(us[0, i], jst.sample_control(jnp.asarray(ti))) < 1e-12


# -- nominal shift ----------------------------------------------------------


def _random_quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("mask_quat", [False, True])
def test_shift_nominal_matches_jax_on_the_cheetah(mask_quat):
    """The cheetah's own mask (x, y of the base) shifts additively; a mask
    that selects the base quaternion shifts it by left composition, unit
    and in the unshifted nominal's hemisphere."""
    jm, jcfg, jprob, _, _ = jax_load_example("mini_cheetah")
    model = convert.model(jm, device="cpu")
    mask = np.asarray(jcfg.q_nom_relative_to_q_init, dtype=bool).copy()
    if mask_quat:
        mask[:4] = True
        mask[7] = True
    B, T = 2, jprob.num_steps
    rng = np.random.default_rng(2)
    q_nom = np.asarray(jprob.q_nom)[None] + 0.1 * rng.standard_normal(
        (B, T + 1, jm.nq))
    q_nom[..., :4] = _random_quats(rng, B * (T + 1)).reshape(B, T + 1, 4)
    q0 = np.asarray(jprob.q_init)[None] + 0.1 * rng.standard_normal(
        (B, jm.nq))
    q0[:, :4] = _random_quats(rng, B)
    out = mpc.shift_nominal(model, torch.as_tensor(q_nom),
                            torch.as_tensor(q0), mask).numpy()
    for b in range(B):
        want = jmpc.shift_nominal(jm, jnp.asarray(q_nom[b]),
                                  jnp.asarray(q0[b]), mask)
        assert _rel(out[b], want) < 1e-12
    if mask_quat:
        quat = out[..., :4]
        assert np.abs(np.linalg.norm(quat, axis=-1) - 1.0).max() < 1e-12
        assert (np.sum(quat * q_nom[..., :4], axis=-1) >= 0).all()
        assert _rel(out[:, 0, :4], q0[:, :4] * np.sign(np.sum(
            q0[:, :4] * q_nom[:, 0, :4], axis=-1, keepdims=True))) < 1e-12
    else:
        assert np.array_equal(out[..., :4], q_nom[..., :4])


# -- one replan from a converted carry --------------------------------------


T_NOW = 0.013


def _relative_mask(cfg, model):
    return np.asarray(cfg.q_nom_relative_to_q_init
                      if cfg.q_nom_relative_to_q_init is not None
                      else [False] * model.nq)


def _state_estimate(model, prob, rng):
    return np.concatenate([
        np.asarray(prob.q_init) + 0.02 * rng.standard_normal(model.nq),
        0.02 * rng.standard_normal(model.nv)])


def _carry_from_golden(ref, tag):
    """The JAX package's MpcCarry as attributes over the golden's arrays
    (what ``convert.mpc_carry`` reads)."""
    from types import SimpleNamespace as NS

    def spline(part):
        return NS(**{k: ref[f"{tag}_{part}_{k}"] for k in ("dt", "y", "M")})

    return NS(stored=NS(start_time=ref[f"{tag}_start_time"], q=spline("q"),
                        v=spline("v"), u=spline("u")),
              Delta=ref[f"{tag}_Delta"], q_nom=ref[f"{tag}_q_nom"])


def _jax_carry(jm, jprob, rng):
    """A carry as ``mpc_initialize`` leaves it, from a seeded trajectory
    near the nominal instead of a solve."""
    T = jprob.num_steps
    q = np.asarray(jprob.q_nom) + 0.05 * rng.standard_normal(
        (T + 1, jm.nq))
    q[0] = np.asarray(jprob.q_init)
    v = np.zeros((T + 1, jm.nv))
    v[1:] = (q[1:] - q[:-1]) / jprob.dt
    tau = 0.1 * rng.standard_normal((T, jm.nv))
    stored = JStored.from_solution(
        jm, JSolution(q=jnp.asarray(q), v=jnp.asarray(v),
                      tau=jnp.asarray(tau)), 0.0, jprob.dt)
    return jmpc.MpcCarry(stored=stored, Delta=jnp.asarray(0.05),
                         q_nom=jprob.q_nom)


@pytest.mark.parametrize("name", ["pendulum", "spinner"])
def test_mpc_step_matches_jax_from_a_converted_carry(name):
    """pendulum (no constraints) and spinner (equality constraints, contact,
    a relative nominal DoF): the same carry, state estimate and time go
    through both packages' ``mpc_step`` (the JAX one in
    goldens/torch_mpc_step_NAME.npz)."""
    ref = np.load(os.path.join(os.path.dirname(_GOLDEN),
                               f"torch_mpc_step_{name}.npz"))
    jm, jcfg, jprob, _, _ = jax_load_example(name)
    rel = _relative_mask(jcfg, jm)
    rng = np.random.default_rng(7)
    jcarry = _jax_carry(jm, jprob, rng)
    x0 = _state_estimate(jm, jprob, rng)
    assert np.array_equal(ref["x0"], x0)
    assert np.array_equal(ref["in_q_y"], np.asarray(jcarry.stored.q.y))

    model, cfg, prob, params, _ = load_example(name, device="cpu")
    mpc_params = mpc.make_mpc_params(params, 1)
    assert mpc_params.max_iterations == 1
    assert not mpc_params.check_convergence
    carry = convert.mpc_carry(jcarry, device="cpu")
    new, sol = mpc.mpc_step(model, broadcast_problem(prob, 1), mpc_params,
                            rel, carry, torch.as_tensor(x0)[None], T_NOW)
    assert sol.q.shape == (1, prob.num_steps + 1, model.nq)
    assert torch.equal(sol.q[0, 0], torch.as_tensor(x0[: model.nq]))
    assert _rel(sol.q[0], ref["q"]) < 1e-8
    assert _rel(sol.v[0], ref["v"]) < 1e-8
    assert _rel(sol.tau[0], ref["tau"]) < 1e-8
    assert _rel(new.Delta[0], ref["Delta"]) < 1e-12
    assert _rel(new.q_nom[0], ref["q_nom"]) < 1e-12
    assert float(new.stored.start_time) == T_NOW
    for part in ("q", "v", "u"):
        spline = getattr(new.stored, part)
        assert _rel(spline.y[0], ref[f"out_{part}_y"]) < 1e-8
        assert _rel(spline.M[0], ref[f"out_{part}_M"]) < 1e-8
    # The converted carry round-trips.
    back = convert.mpc_carry(_carry_from_golden(ref, "out"), device="cpu")
    assert _rel(back.stored.q.y, new.stored.q.y) < 1e-8
    assert back.Delta.shape == (1,) and back.q_nom.shape == new.q_nom.shape


def test_warm_start_converts_to_a_batch_of_one():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 3))
    w = convert.warm_start(
        JWarmStart(q=jnp.asarray(q), Delta=jnp.asarray(0.3),
                   dq=jnp.asarray(q * 2), dqH=jnp.asarray(q * 3)),
        device="cpu")
    assert w.q.shape == (1, 5, 3) and w.Delta.shape == (1,)
    assert np.array_equal(w.dqH[0].numpy(), q * 3)
    assert float(w.Delta[0]) == 0.3


# -- the cheetah chain ------------------------------------------------------


def test_cheetah_replan_chain_matches_jax_golden():
    """``mpc_initialize`` with one iteration, then two replans at t = 0 and
    0.016 s from a state estimate off q_init, as the reference's bench
    chains them (Thomas, the cheetah's YAML solver)."""
    ref = np.load(_GOLDEN)
    model, cfg, prob, params, q_guess = load_example("mini_cheetah",
                                                     device="cpu")
    params = params.replace(max_iterations=1, check_convergence=False)
    mpc_params = mpc.make_mpc_params(params, 1)
    rel = np.asarray(cfg.q_nom_relative_to_q_init)
    probs = broadcast_problem(prob, 1)
    carry, sol0 = mpc.mpc_initialize(model, probs, params, q_guess[None])
    assert _rel(sol0.q[0], ref["q_init"]) < 1e-7
    assert _rel(carry.Delta[0], ref["Delta_init"]) < 1e-12
    x0 = torch.as_tensor(ref["x0"])[None]
    for i, t in enumerate(ref["times"]):
        carry, sol = mpc.mpc_step(model, probs, mpc_params, rel, carry, x0,
                                  float(t))
        assert _rel(sol.q[0], ref[f"q_{i}"]) < 1e-7
        assert _rel(sol.tau[0], ref[f"tau_{i}"]) < 1e-6
        assert _rel(carry.Delta[0], ref[f"Delta_{i}"]) < 1e-12
        assert _rel(carry.q_nom[0], ref[f"q_nom_{i}"]) < 1e-12
        quat = sol.q[0, :, :4]
        assert float((quat.norm(dim=-1) - 1).abs().max()) < 1e-2
