"""Inverse dynamics of one state by differentiation through the kinematics
(counterpart of ``idto_tpu/models/dynamics.py``), for the per-problem
(AoS) pipeline:

    tau = ID(q, v, a, W_ext) = M(q) a + C(q,v) v + g(q) + D v - J(q)^T f_ext

Body accelerations are a second jvp through ``body_velocities``; the
J^T action on the net body wrenches is the vjp of the (linear in v)
body-velocity map.  q is ``(nq,)``, v and a ``(nv,)``; batch with
``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.func import jacfwd, jvp, vjp

from idto_tpu_torch.models import mat3
from idto_tpu_torch.models.kinematics import body_velocities, v_to_qdot
from idto_tpu_torch.models.model import Model
from idto_tpu_torch.utils import linalg


def body_accelerations(model: Model, q, v, a):
    """World-frame kinematics up to accelerations: (R, p, w, pd, wd, pdd),
    poses, angular / linear velocities and angular / linear accelerations
    of each link frame origin."""
    qdot = v_to_qdot(model, q, v)
    (R, p, w, pd), (_, _, wd, pdd) = jvp(
        lambda qq, vv: body_velocities(model, qq, vv), (q, v), (qdot, a)
    )
    return R, p, w, pd, wd, pdd


def _inertial_minus_applied_wrenches(model: Model, q, v, a, external_wrenches):
    """Net wrench about each body origin, in world, that the joints must
    supply: rate of change of momentum less gravity and external forces."""
    R, p, w, pd, wd, pdd = body_accelerations(model, q, v, a)
    dtype = q.dtype

    r = mat3.mv(R, model.com.to(dtype))  # com offset in world, (nl, 3)
    a_com = pdd + mat3.cross(wd, r) + mat3.cross(w, mat3.cross(w, r))
    m = model.mass.to(dtype)[:, None]
    F = m * a_com
    # The per-link scale turns gravity off for some links (the arms).
    F_grav = m * model.grav_scale.to(dtype)[:, None] \
        * model.gravity.to(dtype)[None, :]

    # Rotational inertia about the com in world: R I_B R^T.
    I_w = mat3.mul_t(mat3.mul(R, model.inertia.to(dtype)), R)
    torque_com = mat3.mv(I_w, wd) + mat3.cross(w, mat3.mv(I_w, w))

    torque = torque_com + mat3.cross(r, F - F_grav)
    force = F - F_grav
    if external_wrenches is not None:
        ext_torque, ext_force = external_wrenches
        torque = torque - ext_torque
        force = force - ext_force
    return torque, force


def inverse_dynamics(
    model: Model, q, v, a, external_wrenches: Optional[tuple] = None,
):
    """Generalized forces tau (nv,) that give acceleration ``a``.
    ``external_wrenches`` is an optional (torques, forces) pair of (nl, 3)
    tensors about each body's origin, in world (``contact_wrenches``)."""
    torque, force = _inertial_minus_applied_wrenches(
        model, q, v, a, external_wrenches
    )

    def vel_of_v(vv):
        _, _, w_, pd_ = body_velocities(model, q, vv)
        return w_, pd_

    _, vjp_fn = vjp(vel_of_v, v)
    (tau,) = vjp_fn((torque, force))
    # Viscous joint damping is the applied force -D v: +D v here.
    return tau + model.damping.to(q.dtype) * v


def mass_matrix(model: Model, q):
    """M(q) = d(ID)/da at a = 0: (nv, nv), symmetric positive definite."""
    z = torch.zeros(model.nv, dtype=q.dtype, device=q.device)
    return jacfwd(lambda aa: inverse_dynamics(model, q, z, aa))(z)


def bias_forces(model: Model, q, v, external_wrenches: Optional[tuple] = None):
    """h(q, v) = ID(q, v, 0): Coriolis, gravity and damping less the
    external wrenches' generalized force."""
    z = torch.zeros(model.nv, dtype=q.dtype, device=q.device)
    return inverse_dynamics(model, q, v, z, external_wrenches)


def forward_dynamics(
    model: Model, q, v, tau_applied, external_wrenches: Optional[tuple] = None,
):
    """a = M(q)^{-1} (tau_applied - h(q, v)).  The solve reports nothing
    to the host: a singular M gives inf / nan."""
    M = mass_matrix(model, q)
    h = bias_forces(model, q, v, external_wrenches)
    return linalg.solve(M, tau_applied - h)
