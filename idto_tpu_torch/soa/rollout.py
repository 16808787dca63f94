"""Batch-native trajectory rollouts (counterpart of
``idto_tpu/soa/rollout.py``).

v(q), tau(q), L(q) for a (B, T+1, nq) stack of trajectories in one
flat-instance evaluation.  ``prob`` tensors may be per-scenario (B, ...)
or shared; broadcasting handles both.
"""
from __future__ import annotations

import torch

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.soa import contact as soa_contact
from idto_tpu_torch.soa import kinematics as soa_kin


def velocities(model: Model, prob, qs, halo=False):
    """v_t = N^+(q_t)(q_t - q_{t-1})/dt, v_0 = v_init: (B, T+1, nv).

    With ``halo``, qs holds the knots q_{lo-1}..q_hi of a slice of the
    horizon (lo > 0) and the result is v_lo..v_hi: (B, hi - lo + 1, nv)."""
    B, Tp1, nq = qs.shape
    T = Tp1 - 1
    dt = prob.dt
    q_prev = qs[:, :T].reshape(B * T, nq).T
    q_next = qs[:, 1:].reshape(B * T, nq).T
    v_rest = soa_kin.qdot_to_v(model, q_next, (q_next - q_prev) / dt)
    v_rest = v_rest.reshape(model.nv, B, T).permute(1, 2, 0)
    if halo:
        return v_rest
    v0 = prob.v_init.to(qs.dtype).reshape(-1, model.nv)[:, None].expand(
        B, 1, model.nv
    )
    return torch.cat([v0, v_rest], dim=1)


def generalized_forces(model: Model, prob, contact_params, qs, v=None,
                       halo=False):
    """(tau (B, T, nv), v (B, T+1, nv)); reuses v when given.  With
    ``halo`` (see ``velocities``) the steps lo..hi-1 of a slice of the
    horizon: tau (B, hi - lo, nv), v (B, hi - lo + 1, nv)."""
    B = qs.shape[0]
    nq, nv = model.nq, model.nv
    dt = prob.dt
    if v is None:
        v = velocities(model, prob, qs, halo=halo)
    T = v.shape[1] - 1
    a = (v[:, 1:] - v[:, :-1]) / dt
    q_next = qs[:, qs.shape[1] - T:].reshape(B * T, nq).T
    v_next = v[:, 1:].reshape(B * T, nv).T
    a_flat = a.reshape(B * T, nv).T
    tau = soa_contact.step_tau(model, contact_params, q_next, v_next, a_flat)
    # Contiguous (B, T, nv): a trajectory's cost then sums its terms in the
    # same order whatever the batch size.
    return tau.reshape(nv, B, T).permute(1, 2, 0).contiguous(), v


def cost(model: Model, prob, contact_params, qs, tau=None, v=None):
    """L(q): (B,).  Running cost over t = 0..T-1 (including the fixed t = 0
    term) plus the terminal cost."""
    dtype = qs.dtype
    dt = prob.dt
    if tau is None or v is None:
        tau, v = generalized_forces(model, prob, contact_params, qs, v=v)

    q_nom = prob.q_nom.to(dtype)
    v_nom = prob.v_nom.to(dtype)
    dq = qs[:, :-1] - q_nom.expand(qs.shape)[:, :-1]
    dv = v[:, :-1] - v_nom.expand(v.shape)[:, :-1]

    def w(x):
        """Weight vector -> (B_or_1, 1, d) for the running terms."""
        x = x.to(dtype)
        return x[:, None, :] if x.ndim == 2 else x[None, None, :]

    running = (
        torch.sum(dq * dq * w(prob.Qq), dim=(1, 2))
        + torch.sum(dv * dv * w(prob.Qv), dim=(1, 2))
        + torch.sum(tau * tau * w(prob.R), dim=(1, 2))
    ) * dt

    def wT(x):
        x = x.to(dtype)
        return x if x.ndim == 2 else x[None]

    dqT = qs[:, -1] - q_nom[..., -1, :]
    dvT = v[:, -1] - v_nom[..., -1, :]
    terminal = torch.sum(dqT * dqT * wT(prob.Qf_q), dim=-1) + torch.sum(
        dvT * dvT * wT(prob.Qf_v), dim=-1
    )
    return running + terminal
