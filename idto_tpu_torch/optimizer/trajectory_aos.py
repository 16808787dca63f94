"""Trajectory quantities of one problem on the per-problem (AoS) physics:
v(q), a(q), tau(q) and L(q) (counterpart of
``idto_tpu/optimizer/trajectory.py``).

q is the (T+1, nq) trajectory of one problem; the per-step physics is a
``torch.func.vmap`` over the horizon of ``models/`` and
``contact/force.py``.  ``optimizer/trajectory.py`` computes the same
quantities on the batch-native SoA rollout; the per-problem solve
(``solver.solve_trust_region``) uses these.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from idto_tpu_torch.contact.force import ContactParams, contact_wrenches
from idto_tpu_torch.models.dynamics import inverse_dynamics
from idto_tpu_torch.models.kinematics import qdot_to_v
from idto_tpu_torch.models.model import Model
from idto_tpu_torch.optimizer.problem import ProblemDefinition


def velocities(model: Model, prob: ProblemDefinition, q):
    """v_t = N^+(q_t) (q_t - q_{t-1}) / dt, v_0 = v_init: (T+1, nv)."""
    dq = (q[1:] - q[:-1]) / prob.dt
    v_rest = vmap(lambda qq, qd: qdot_to_v(model, qq, qd))(q[1:], dq)
    return torch.cat([prob.v_init.to(q.dtype)[None], v_rest], dim=0)


def accelerations(prob: ProblemDefinition, v):
    """a_t = (v_{t+1} - v_t) / dt, t = 0..T-1."""
    return (v[1:] - v[:-1]) / prob.dt


def step_tau(model: Model, contact: ContactParams, q_next, v_next, a):
    """tau_t = ID(q_{t+1}, v_{t+1}, a_t) - J^T gamma(q_{t+1}, v_{t+1}):
    inverse dynamics with every term, contact included, implicit."""
    wrenches = contact_wrenches(model, q_next, v_next, contact)
    return inverse_dynamics(model, q_next, v_next, a, wrenches)


def generalized_forces(model: Model, prob: ProblemDefinition, contact, q,
                       v=None):
    """tau: (T, nv) for t = 0..T-1; reuses v when given."""
    if v is None:
        v = velocities(model, prob, q)
    a = accelerations(prob, v)
    return vmap(lambda qn, vn, an: step_tau(model, contact, qn, vn, an))(
        q[1:], v[1:], a)


def cost(model: Model, prob: ProblemDefinition, contact, q, tau=None, v=None):
    """Total cost L(q): the running cost over t = 0..T-1 (the fixed t = 0
    term included) plus the terminal cost; diagonal weights."""
    if v is None:
        v = velocities(model, prob, q)
    if tau is None:
        tau = generalized_forces(model, prob, contact, q, v=v)
    dtype = q.dtype
    dq = q[:-1] - prob.q_nom.to(dtype)[:-1]
    dv = v[:-1] - prob.v_nom.to(dtype)[:-1]
    running = (
        torch.sum(dq * dq * prob.Qq.to(dtype))
        + torch.sum(dv * dv * prob.Qv.to(dtype))
        + torch.sum(tau * tau * prob.R.to(dtype))
    ) * prob.dt
    dqT = q[-1] - prob.q_nom.to(dtype)[-1]
    dvT = v[-1] - prob.v_nom.to(dtype)[-1]
    terminal = torch.sum(dqT * dqT * prob.Qf_q.to(dtype)) \
        + torch.sum(dvT * dvT * prob.Qf_v.to(dtype))
    return running + terminal
