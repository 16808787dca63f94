"""SoA inverse dynamics, and the mass matrix, bias forces and forward
dynamics built on it (counterpart of ``idto_tpu/soa/dynamics.py`` and of
``mass_matrix`` / ``bias_forces`` / ``forward_dynamics`` in
``idto_tpu/models/dynamics.py``).

tau = M(q) a + C(q,v) v + g(q) + D v - J(q)^T f_ext: body accelerations
come from a second jvp through the kinematics, and the J^T action is the
vjp of the (linear in v) body-velocity map -- the same AD structure as the
JAX package, with ``torch.func`` in place of ``jax``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.func import jvp, vjp

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.soa import mat3
from idto_tpu_torch.soa.kinematics import body_velocities, v_to_qdot
from idto_tpu_torch.utils import linalg


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


def _mass_and_bias(model: Model, q, v, external_wrenches):
    """(M (nv, nv, N), h (nv, N)) from one inverse-dynamics call.  ID is
    affine in a, so column i of M is ID(q, 0, e_i) - ID(q, 0, 0); those
    nv + 1 evaluations and h = ID(q, v, 0, wrenches) ride the instance axis
    as nv + 2 blocks of N."""
    nv, N = model.nv, q.shape[-1]
    dtype, device = q.dtype, q.device
    blocks = nv + 2
    q_all = q[:, None, :].expand(model.nq, blocks, N).reshape(
        model.nq, -1).contiguous()  # no stride-0 primal under jvp
    zero_v = torch.zeros((nv, nv + 1, N), dtype=dtype, device=device)
    v_all = torch.cat([zero_v, v[:, None, :]], dim=1).reshape(nv, -1)
    eye = torch.eye(nv, dtype=dtype, device=device)[:, :, None].expand(
        nv, nv, N)
    a_all = torch.cat(
        [eye, torch.zeros((nv, 2, N), dtype=dtype, device=device)], dim=1
    ).reshape(nv, -1)
    if external_wrenches is None:
        wrenches = None
    else:
        wrenches = tuple(
            torch.cat([w.new_zeros((3, w.shape[1], (nv + 1) * N)), w], dim=-1)
            for w in external_wrenches
        )
    tau = inverse_dynamics(model, q_all, v_all, a_all, wrenches).reshape(
        nv, blocks, N)
    return tau[:, :nv] - tau[:, nv : nv + 1], tau[:, nv + 1]


def mass_matrix(model: Model, q):
    """M(q) = d(ID)/da, (nv, nv, N), symmetric positive definite."""
    zero = torch.zeros((model.nv, q.shape[-1]), dtype=q.dtype, device=q.device)
    return _mass_and_bias(model, q, zero, None)[0]


def bias_forces(model: Model, q, v, external_wrenches: Optional[tuple] = None):
    """h(q, v) = ID(q, v, 0): Coriolis, gravity and damping less the
    external wrenches' generalized force; (nv, N)."""
    return inverse_dynamics(model, q, v, torch.zeros_like(v),
                            external_wrenches)


def forward_dynamics(
    model: Model, q, v, tau_applied,
    external_wrenches: Optional[tuple] = None,
):
    """a = M(q)^{-1} (tau_applied - h(q, v)), (nv, N): what the simulator
    integrates.  The solve reports nothing to the host (a singular M gives
    inf/nan)."""
    M, h = _mass_and_bias(model, q, v, external_wrenches)
    rhs = (tau_applied - h).T[..., None]  # (N, nv, 1)
    return linalg.solve(M.permute(2, 0, 1), rhs)[..., 0].T
