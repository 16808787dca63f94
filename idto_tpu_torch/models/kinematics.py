"""Forward kinematics and velocity maps of one state (counterpart of
``idto_tpu/models/kinematics.py``), for the per-problem (AoS) pipeline.

q is ``(nq,)``, v ``(nv,)``; link rotations come out ``(nl, 3, 3)`` and
positions ``(nl, 3)``.  Batch with ``torch.func.vmap``.  As in the JAX
package, joint-local transforms are evaluated one batched call per joint
type and world poses propagate level by level through the tree (one
gather and compose per depth).  Everything is out of place, so the
``torch.func`` transforms compose through it.

Velocities are the jvp of forward kinematics along qdot = N(q) v
(``body_velocities``); the dynamics push a second jvp through that.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp

from idto_tpu_torch.models import mat3
from idto_tpu_torch.models.model import JointType, Model
from idto_tpu_torch.models.rotations import (
    quat_rate_matrix,
    quat_rate_pinv,
    quat_to_rot,
)
from idto_tpu_torch.utils.consts import const, index


def _batched_axis_angle(axes, angles):
    """(n, 3) axes, (n,) angles -> (n, 3, 3) rotations (Rodrigues)."""
    c = torch.cos(angles)[:, None, None]
    s = torch.sin(angles)[:, None, None]
    zeros = torch.zeros_like(axes[:, 0])
    K = torch.stack(
        [
            torch.stack([zeros, -axes[:, 2], axes[:, 1]], dim=-1),
            torch.stack([axes[:, 2], zeros, -axes[:, 0]], dim=-1),
            torch.stack([-axes[:, 1], axes[:, 0], zeros], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=axes.dtype, device=axes.device)[None]
    return eye + s * K + (1.0 - c) * mat3.mul(K, K)


def _inverse_permutation(order, device):
    inv = np.empty(len(order), dtype=np.int64)
    inv[np.asarray(order)] = np.arange(len(order))
    return index(inv, device)


def _local_transforms(model: Model, q):
    """Child-frame pose in the parent link frame for every joint:
    X_PC(q_j) = X_PJ X_J(q_j).  Returns ((nj, 3, 3), (nj, 3))."""
    dtype, device = q.dtype, q.device
    eye = torch.eye(3, dtype=dtype, device=device)
    order, R_parts, p_parts = [], [], []
    for jtype, js in model.type_groups:
        jt = JointType(jtype)
        g = len(js)
        order.extend(js)
        qi = index([model.q_starts[j] for j in js], device)
        zero_p = torch.zeros((g, 3), dtype=dtype, device=device)
        if jt == JointType.FIXED:
            R_g, p_g = eye.expand(g, 3, 3), zero_p
        elif jt == JointType.REVOLUTE:
            R_g = _batched_axis_angle(
                model.axis.to(dtype)[index(js, device)], q[qi])
            p_g = zero_p
        elif jt == JointType.PRISMATIC:
            R_g = eye.expand(g, 3, 3)
            p_g = model.axis.to(dtype)[index(js, device)] * q[qi][:, None]
        elif jt == JointType.PLANAR:
            # q = [x, y, theta] in the aligned joint frame (z == axis).
            zaxis = const(np.array([0.0, 0.0, 1.0]), device, dtype)
            R_g = _batched_axis_angle(zaxis.expand(g, 3), q[qi + 2])
            p_g = torch.stack(
                [q[qi], q[qi + 1], torch.zeros_like(q[qi])], dim=-1)
        elif jt == JointType.FLOATING:
            # q = [qw, qx, qy, qz, x, y, z]
            quats = torch.stack([q[qi + i] for i in range(4)], dim=0)
            R_g = torch.movedim(quat_to_rot(quats), (0, 1), (-2, -1))
            p_g = torch.stack([q[qi + 4 + i] for i in range(3)], dim=-1)
        else:
            raise ValueError(f"unknown joint type {jt}")
        R_parts.append(R_g)
        p_parts.append(p_g)

    inv = _inverse_permutation(order, device)
    R_j = torch.cat(R_parts, dim=0)[inv]
    p_j = torch.cat(p_parts, dim=0)[inv]
    # Compose with the fixed joint frame:
    # R_pc = R_pj R_j, p_pc = p_pj + R_pj p_j.
    R_pj = model.R_pj.to(dtype)
    return mat3.mul(R_pj, R_j), model.p_pj.to(dtype) + mat3.mv(R_pj, p_j)


def forward_kinematics(model: Model, q):
    """World poses of every link: (R (nl, 3, 3), p (nl, 3))."""
    device = q.device
    R_pc, p_pc = _local_transforms(model, q)
    order = [j for level in model.levels for j in level]
    pos = {j: i for i, j in enumerate(order)}
    R_acc, p_acc = [], []
    for d, level in enumerate(model.levels):
        idx = index(level, device)
        if d == 0:
            # Roots: the parent is the world frame.
            R_lvl, p_lvl = R_pc[idx], p_pc[idx]
        else:
            par = index([pos[model.joint_parents[j]] for j in level], device)
            R_par = torch.cat(R_acc, dim=0)[par]
            p_par = torch.cat(p_acc, dim=0)[par]
            R_lvl = mat3.mul(R_par, R_pc[idx])
            p_lvl = p_par + mat3.mv(R_par, p_pc[idx])
        R_acc.append(R_lvl)
        p_acc.append(p_lvl)
    inv = _inverse_permutation(order, device)
    return torch.cat(R_acc, dim=0)[inv], torch.cat(p_acc, dim=0)[inv]


def _floating_joints(model: Model):
    return [
        j for j in range(model.num_joints)
        if JointType(model.joint_types[j]) == JointType.FLOATING
    ]


def v_to_qdot(model: Model, q, v):
    """qdot = N(q) v.  The identity on every joint's coordinates but the
    quaternion blocks of floating joints."""
    if not _floating_joints(model):
        return v
    segs = []
    for j in range(model.num_joints):
        nvj = model.joint_nv(j)
        qs, vs = model.q_starts[j], model.v_starts[j]
        if JointType(model.joint_types[j]) == JointType.FLOATING:
            segs.append(quat_rate_matrix(q[qs : qs + 4]) @ v[vs : vs + 3])
            segs.append(v[vs + 3 : vs + 6])
        elif nvj > 0:
            segs.append(v[vs : vs + nvj])
    return torch.cat(segs)


def qdot_to_v(model: Model, q, qdot):
    """v = N^+(q) qdot: the map from configuration differences to
    velocities, v_t = N^+(q_t) (q_t - q_{t-1}) / dt."""
    if not _floating_joints(model):
        return qdot
    segs = []
    for j in range(model.num_joints):
        nqj = model.joint_nq(j)
        qs = model.q_starts[j]
        if JointType(model.joint_types[j]) == JointType.FLOATING:
            segs.append(quat_rate_pinv(q[qs : qs + 4]) @ qdot[qs : qs + 4])
            segs.append(qdot[qs + 4 : qs + 7])
        elif nqj > 0:
            segs.append(qdot[qs : qs + nqj])
    return torch.cat(segs)


def nplus_matrix(model: Model, q):
    """Materialized N^+(q): (nv, nq).  The identity but the quaternion
    blocks, which are added into zero slots of the constant part."""
    dtype, device = q.dtype, q.device
    floats = _floating_joints(model)
    if not floats:
        return torch.eye(model.nv, model.nq, dtype=dtype, device=device)
    base = np.zeros((model.nv, model.nq))
    for j in range(model.num_joints):
        if JointType(model.joint_types[j]) == JointType.FLOATING:
            for i in range(3):
                base[model.v_starts[j] + 3 + i,
                     model.q_starts[j] + 4 + i] = 1.0
        else:
            for i in range(model.joint_nv(j)):
                base[model.v_starts[j] + i, model.q_starts[j] + i] = 1.0
    Np = const(base, device, dtype)
    for j in floats:
        qs, vs = model.q_starts[j], model.v_starts[j]
        blk = quat_rate_pinv(q[qs : qs + 4])  # (3, 4): no batch axis here
        pad = (qs, model.nq - qs - 4, vs, model.nv - vs - 3)
        Np = Np + torch.nn.functional.pad(blk, pad)
    return Np


def normalize_quaternions(model: Model, q):
    """Renormalize the quaternion block of every floating joint; q is
    (..., nq)."""
    for j in _floating_joints(model):
        qs = model.q_starts[j]
        quat = q[..., qs : qs + 4]
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        q = torch.cat([q[..., :qs], quat, q[..., qs + 4 :]], dim=-1)
    return q


def body_velocities(model: Model, q, v):
    """World-frame spatial velocities of every link: (R, p, w, pd) --
    rotation, origin, angular velocity and origin velocity, in world --
    from qdot = N(q) v pushed through forward kinematics with a jvp."""
    qdot = v_to_qdot(model, q, v)
    (R, p), (Rd, pd) = jvp(
        lambda qq: forward_kinematics(model, qq), (q,), (qdot,)
    )
    # w x R = Rdot  =>  w = vee(Rdot R^T), over the links.
    W = mat3.mul_t(Rd, R)
    w = 0.5 * torch.stack(
        [W[:, 2, 1] - W[:, 1, 2], W[:, 0, 2] - W[:, 2, 0],
         W[:, 1, 0] - W[:, 0, 1]],
        dim=-1,
    )
    return R, p, w, pd
