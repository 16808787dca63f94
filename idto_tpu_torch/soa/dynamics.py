"""SoA inverse dynamics (counterpart of ``idto_tpu/soa/dynamics.py``).

tau = M(q) a + C(q,v) v + g(q) + D v - J(q)^T f_ext: body accelerations
come from a second jvp through the kinematics, and the J^T action is the
vjp of the (linear in v) body-velocity map -- the same AD structure as the
JAX package, with ``torch.func`` in place of ``jax``.
"""
from __future__ import annotations

from typing import Optional

from torch.func import jvp, vjp

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.soa import mat3
from idto_tpu_torch.soa.kinematics import body_velocities, v_to_qdot


def body_accelerations(model: Model, q, v, a):
    """(R, p, w, pd, wd, pdd) with q (nq, N), v/a (nv, N)."""
    qdot = v_to_qdot(model, q, v)
    (R, p, w, pd), (_, _, wd, pdd) = jvp(
        lambda qq, vv: body_velocities(model, qq, vv), (q, v), (qdot, a)
    )
    return R, p, w, pd, wd, pdd


def _inertial_minus_applied_wrenches(model: Model, q, v, a, external_wrenches):
    """Net wrench about each body origin in world: (torque, force), each
    (3, nl, N)."""
    R, p, w, pd, wd, pdd = body_accelerations(model, q, v, a)
    dtype = q.dtype

    com = mat3.from_aos_vec(model.com.to(dtype))[..., None]
    r = mat3.mv(R, com)
    a_com = pdd + mat3.cross(wd, r) + mat3.cross(w, mat3.cross(w, r))

    m = model.mass.to(dtype)[None, :, None]
    F = m * a_com
    grav = model.gravity.to(dtype)[:, None, None]
    gscale = model.grav_scale.to(dtype)[None, :, None]
    F_grav = m * gscale * grav

    I_b = mat3.from_aos_mat(model.inertia.to(dtype))[..., None]
    I_w = mat3.mul_t(mat3.mul(R, I_b), R)
    torque_com = mat3.mv(I_w, wd) + mat3.cross(w, mat3.mv(I_w, w))

    torque = torque_com + mat3.cross(r, F - F_grav)
    force = F - F_grav
    if external_wrenches is not None:
        ext_torque, ext_force = external_wrenches
        torque = torque - ext_torque
        force = force - ext_force
    return torque, force


def inverse_dynamics(
    model: Model, q, v, a, external_wrenches: Optional[tuple] = None
):
    """Generalized forces tau (nv, N); ``external_wrenches`` is an optional
    (torques, forces) pair of (3, nl, N) tensors about body origins."""
    torque, force = _inertial_minus_applied_wrenches(
        model, q, v, a, external_wrenches
    )

    def vel_of_v(vv):
        _, _, w_, pd_ = body_velocities(model, q, vv)
        return w_, pd_

    _, vjp_fn = vjp(vel_of_v, v)
    (tau,) = vjp_fn((torque, force))
    return tau + model.damping.to(q.dtype)[:, None] * v
