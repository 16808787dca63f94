"""Trajectory quantities of one problem: v(q), a(q), tau(q), L(q) and the
exact gradient (counterpart of ``idto_tpu/optimizer/trajectory.py``).

Thin wrappers over the SoA rollout (``soa/rollout.py``): q is (T+1, nq)
for one trajectory, or (B, T+1, nq) for a batch, and the results carry the
same leading axes.  The linesearch, the gradient check, the exact Hessian
and the CSV dumps call these.
"""
from __future__ import annotations

import torch
from torch.func import grad

from idto_tpu_torch.contact.force import ContactParams
from idto_tpu_torch.models.model import Model
from idto_tpu_torch.optimizer.problem import ProblemDefinition
from idto_tpu_torch.soa import contact as soa_contact
from idto_tpu_torch.soa import rollout


def _batched(q):
    """(q as (B, T+1, nq), whether a batch axis was added)."""
    return (q[None], True) if q.ndim == 2 else (q, False)


def velocities(model: Model, prob: ProblemDefinition, q):
    """v_t = N^+(q_t)(q_t - q_{t-1})/dt, v_0 = v_init."""
    qs, single = _batched(q)
    v = rollout.velocities(model, prob, qs)
    return v[0] if single else v


def accelerations(prob: ProblemDefinition, v):
    """a_t = (v_{t+1} - v_t)/dt, t = 0..T-1."""
    return (v[..., 1:, :] - v[..., :-1, :]) / prob.dt


def step_tau(model: Model, contact: ContactParams, q_next, v_next, a):
    """tau_t = ID(q_{t+1}, v_{t+1}, a_t) - J^T gamma for one step: (nq,),
    (nv,), (nv,) -> (nv,)."""
    return soa_contact.step_tau(model, contact, q_next[:, None],
                                v_next[:, None], a[:, None])[:, 0]


def generalized_forces(model: Model, prob: ProblemDefinition, contact, q):
    """tau: (T, nv) for t = 0..T-1 (or (B, T, nv))."""
    qs, single = _batched(q)
    tau, _ = rollout.generalized_forces(model, prob, contact, qs)
    return tau[0] if single else tau


def cost(model: Model, prob: ProblemDefinition, contact, q, tau=None, v=None):
    """Total cost L(q): a scalar for one trajectory, (B,) for a batch."""
    qs, single = _batched(q)
    if single:
        tau = None if tau is None else tau[None]
        v = None if v is None else v[None]
    L = rollout.cost(model, prob, contact, qs, tau=tau, v=v)
    return L[0] if single else L


def gradient(model: Model, prob: ProblemDefinition, contact, q):
    """Exact dL/dq by reverse mode, with the first block zeroed (q_0 is
    fixed).  Unlike the partials' Gauss-Newton gradient this keeps the
    dN^+/dq term of quaternion DoFs."""
    qs, single = _batched(q)
    g = grad(lambda x: torch.sum(rollout.cost(model, prob, contact, x)))(qs)
    g = torch.cat([torch.zeros_like(g[:, :1]), g[:, 1:]], dim=1)
    return g[0] if single else g
