"""Batch-native exact inverse-dynamics partials (counterpart of
``idto_tpu/soa/partials.py``).

Same chain-rule structure as the JAX package, for all scenarios and steps
in one flat instance axis n = B*T:

  * the only differentiation through FK is the nq-tangent forward-mode
    derivative of step_tau in q_{t+1}; tangents are applied with
    ``vmap(lambda e: jvp(f, (x,), (e,))[1])`` over the basis, so the
    tangent axis leads and the primal is evaluated once (unbatched);
  * v/a tangents ride a second forward derivative at fixed q (FK-free);
  * the q_t / q_{t-1} blocks assemble from M = dID/da, Cv = dID/dv and the
    velocity-map partials, with the t = 0 boundary handled by masks.

step_tau itself contains a jvp (body accelerations) and a vjp (J^T), so
the q-tangent pass is a jvp over a jvp and a vjp, vmapped over 19
tangents for mini_cheetah.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.optimizer.partials import IdPartials
from idto_tpu_torch.soa import contact as soa_contact
from idto_tpu_torch.soa import kinematics as soa_kin
from idto_tpu_torch.utils.consts import const


def _jac_rows(f, x, dim):
    """Forward derivative of f at x applied to every basis direction of
    R^dim (broadcast over the instance axis): (dim, out..., n)."""
    n = x.shape[-1]
    eye = torch.eye(dim, dtype=x.dtype, device=x.device)

    def one(e):
        return jvp(f, (x,), (e[:, None].expand(dim, n),))[1]

    return vmap(one)(eye)


def id_partials_batched(model: Model, prob, contact_params, qs) -> IdPartials:
    """Exact partials for a batch of trajectories qs (B, T+1, nq).  Returns
    IdPartials of (B, T, nv, nq) tensors.  Only dt / v_init are read from
    ``prob``, whose tensors may be batched (B, ...) or shared."""
    B, Tp1, nq = qs.shape
    T = Tp1 - 1
    nv = model.nv
    n = B * T
    dtype, device = qs.dtype, qs.device
    dt = prob.dt

    # Flat instance axis (b, t) -> b*T + t.  The triplet for step t is
    # (q_{t-1}, q_t, q_{t+1}); q_{t-1} at t = 0 is a dummy copy of q_0
    # whose contributions are masked out below.
    qm = torch.cat([qs[:, :1], qs[:, 0 : T - 1]], dim=1).reshape(n, nq).T
    qt = qs[:, 0:T].reshape(n, nq).T
    qp = qs[:, 1 : T + 1].reshape(n, nq).T

    is_t0 = const(np.tile(np.arange(T), B) == 0, device)

    v_init = prob.v_init.to(dtype).reshape(-1, nv)[:, None, :].expand(
        B, T, nv
    ).reshape(n, nv).T

    v_t_raw = soa_kin.qdot_to_v(model, qt, (qt - qm) / dt)
    v_t = torch.where(is_t0[None, :], v_init, v_t_raw)
    v_p = soa_kin.qdot_to_v(model, qp, (qp - qt) / dt)
    a = (v_p - v_t) / dt

    # ---- Gq: the one differentiation through FK (nq tangents) ----
    Gq = _jac_rows(
        lambda qq: soa_contact.step_tau(model, contact_params, qq, v_p, a),
        qp, nq,
    ).transpose(0, 1)  # (nv, nq, n)

    # ---- Cv, M: FK-free tangents at fixed q ----
    Cv = _jac_rows(
        lambda vv: soa_contact.step_tau(model, contact_params, qp, vv, a),
        v_p, nv,
    ).transpose(0, 1)
    M = _jac_rows(
        lambda aa: soa_contact.step_tau(model, contact_params, qp, v_p, aa),
        a, nv,
    ).transpose(0, 1)

    # ---- velocity-map partials ----
    Vp_p = _jac_rows(
        lambda qq: soa_kin.qdot_to_v(model, qq, (qq - qt) / dt), qp, nq
    ).transpose(0, 1)
    Vt_t = _jac_rows(
        lambda qq: soa_kin.qdot_to_v(model, qq, (qq - qm) / dt), qt, nq
    ).transpose(0, 1)
    zero = torch.zeros((), dtype=dtype, device=device)
    Vt_t = torch.where(is_t0[None, None, :], zero, Vt_t)  # v_0 = v_init

    Npp = soa_kin.nplus_matrix(model, qp)
    Npt = soa_kin.nplus_matrix(model, qt)

    def mm(A, Bm):
        """(i, v, n) @ (v, q, n) -> (i, q, n)."""
        return torch.einsum("ivn,vqn->iqn", A, Bm)

    CvM = Cv + M / dt
    dqp = Gq + mm(CvM, Vp_p)
    dqt = mm(CvM, -Npp / dt) - mm(M / dt, Vt_t)
    dqm = torch.where(is_t0[None, None, :], zero, mm(M / dt, Npt / dt))

    def unflat(x):
        # (nv, nq, n) -> (B, T, nv, nq)
        return x.reshape(nv, nq, B, T).permute(2, 3, 0, 1)

    return IdPartials(unflat(dqm), unflat(dqt), unflat(dqp))


def nplus_stack_batched(model: Model, qs):
    """N^+ at every knot: qs (B, T+1, nq) -> (B, T+1, nv, nq)."""
    B, Tp1, nq = qs.shape
    Np = soa_kin.nplus_matrix(model, qs.reshape(B * Tp1, nq).T)
    return Np.reshape(model.nv, nq, B, Tp1).permute(2, 3, 0, 1)
