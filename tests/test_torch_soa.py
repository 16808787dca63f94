"""The port's SoA physics against ``idto_tpu.soa`` on the same seeded
inputs: FK, velocity maps, N^+, inverse dynamics, contact wrenches,
step_tau, the rollout cost and the exact partials, at B=2, T=4 on spinner
(contact, planar finger) and mini_cheetah (floating base, sphere-box and
box-box pairs).

Both sides evaluate the same float64 expressions in the same order, up to
the summation order of small contractions, so values agree to ~1e-15;
the stated tolerances are 1e-10 relative (1e-9 for the partials, which
pass through three nested forward/reverse derivatives).  The JAX side is
jitted: its eager partials take minutes on the cheetah.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idto_tpu.examples.registry import load_example as jax_load_example
from idto_tpu.models.model import JointType
from idto_tpu.soa import contact as jcon
from idto_tpu.soa import dynamics as jdyn
from idto_tpu.soa import kinematics as jkin
from idto_tpu.soa import partials as jpart
from idto_tpu.soa import rollout as jroll
from idto_tpu_torch import convert
from idto_tpu_torch.soa import contact as tcon
from idto_tpu_torch.soa import dynamics as tdyn
from idto_tpu_torch.soa import kinematics as tkin
from idto_tpu_torch.soa import partials as tpart
from idto_tpu_torch.soa import rollout as troll

B, T = 2, 4
RTOL = 1e-10
RTOL_PARTIALS = 1e-9


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _setup(name):
    jm, _, jprob, jparams, jqg = jax_load_example(name)
    jprob = jprob.replace(num_steps=T, q_nom=jprob.q_nom[: T + 1],
                          v_nom=jprob.v_nom[: T + 1])
    rng = np.random.default_rng(0)
    qs = np.asarray(jqg)[None, : T + 1] + 0.02 * rng.standard_normal(
        (B, T + 1, jm.nq)
    )
    # Random states for the per-instance maps, quaternions kept away from 0.
    n = B * T
    q = rng.standard_normal((jm.nq, n)) * 0.5
    for j in range(jm.num_joints):
        if JointType(jm.joint_types[j]) == JointType.FLOATING:
            q[jm.q_starts[j]] += 1.0
    v = rng.standard_normal((jm.nv, n)) * 0.3
    a = rng.standard_normal((jm.nv, n)) * 0.2
    # States near the trajectory, where the contacts are active.
    qn = qs[:, 1:].reshape(n, jm.nq).T
    return dict(
        jm=jm, jprob=jprob, jc=jparams.contact,
        tm=convert.model(jm, device="cpu"),
        tprob=convert.problem(jprob, device="cpu"),
        tc=convert.solver_params(jparams).contact,
        qs=qs, q=q, v=v, a=a, qn=qn,
    )


@pytest.fixture(scope="module", params=["spinner", "mini_cheetah"])
def case(request):
    return _setup(request.param)


def test_kinematics(case):
    jm, tm = case["jm"], case["tm"]
    q, v = case["q"], case["v"]
    for x_t, x_j in zip(tkin.forward_kinematics(tm, torch.tensor(q)),
                        jkin.forward_kinematics(jm, jnp.asarray(q))):
        assert _rel(x_t, x_j) < RTOL
    for x_t, x_j in zip(
        tkin.body_velocities(tm, torch.tensor(q), torch.tensor(v)),
        jkin.body_velocities(jm, jnp.asarray(q), jnp.asarray(v)),
    ):
        assert _rel(x_t, x_j) < RTOL
    qd_t = tkin.v_to_qdot(tm, torch.tensor(q), torch.tensor(v))
    qd_j = jkin.v_to_qdot(jm, jnp.asarray(q), jnp.asarray(v))
    assert _rel(qd_t, qd_j) < RTOL
    assert _rel(tkin.qdot_to_v(tm, torch.tensor(q), qd_t),
                jkin.qdot_to_v(jm, jnp.asarray(q), qd_j)) < RTOL
    assert _rel(tkin.nplus_matrix(tm, torch.tensor(q)),
                jkin.nplus_matrix(jm, jnp.asarray(q))) < RTOL


def test_dynamics_and_contact(case):
    jm, tm = case["jm"], case["tm"]
    q, v, a, qn = (case[k] for k in ("q", "v", "a", "qn"))
    tau_t = tdyn.inverse_dynamics(tm, *(torch.tensor(x) for x in (q, v, a)))
    tau_j = jdyn.inverse_dynamics(jm, *(jnp.asarray(x) for x in (q, v, a)))
    assert _rel(tau_t, tau_j) < RTOL
    for x_t, x_j in zip(
        tcon.contact_wrenches(tm, torch.tensor(qn), torch.tensor(v),
                              case["tc"]),
        jcon.contact_wrenches(jm, jnp.asarray(qn), jnp.asarray(v),
                              case["jc"]),
    ):
        assert _rel(x_t, x_j) < RTOL
    st_t = tcon.step_tau(tm, case["tc"], torch.tensor(qn), torch.tensor(v),
                         torch.tensor(a))
    st_j = jcon.step_tau(jm, case["jc"], jnp.asarray(qn), jnp.asarray(v),
                         jnp.asarray(a))
    assert _rel(st_t, st_j) < RTOL


def test_rollout_cost(case):
    qs = case["qs"]
    tau_t, v_t = troll.generalized_forces(case["tm"], case["tprob"],
                                          case["tc"], torch.tensor(qs))
    tau_j, v_j = jroll.generalized_forces(case["jm"], case["jprob"],
                                          case["jc"], jnp.asarray(qs))
    assert _rel(v_t, v_j) < RTOL and _rel(tau_t, tau_j) < RTOL
    assert _rel(troll.cost(case["tm"], case["tprob"], case["tc"],
                           torch.tensor(qs)),
                jroll.cost(case["jm"], case["jprob"], case["jc"],
                           jnp.asarray(qs))) < RTOL


def test_partials(case):
    jm, jprob, jc = case["jm"], case["jprob"], case["jc"]
    qs = case["qs"]
    p_j = jax.jit(
        lambda x: jpart.id_partials_batched(jm, jprob, jc, x)
    )(jnp.asarray(qs))
    p_t = tpart.id_partials_batched(case["tm"], case["tprob"], case["tc"],
                                    torch.tensor(qs))
    for x_t, x_j in zip(p_t, p_j):
        assert x_t.shape == (B, T, jm.nv, jm.nq)
        assert _rel(x_t, x_j) < RTOL_PARTIALS
    assert _rel(tpart.nplus_stack_batched(case["tm"], torch.tensor(qs)),
                jpart.nplus_stack_batched(jm, jnp.asarray(qs))) < RTOL
