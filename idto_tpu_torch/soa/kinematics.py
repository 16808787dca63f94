"""SoA forward kinematics and velocity maps (counterpart of
``idto_tpu/soa/kinematics.py``).

Operands are component-leading with one flat trailing instance axis N:
q (nq, N), v (nv, N), link rotations (3, 3, nl, N), positions (3, nl, N).
FK and the body velocities run level by level over the static level
schedule (one batched compose per tree depth) and joints are evaluated
one batched call per joint type.  Everything is out-of-place so
``torch.func`` transforms compose through it.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp

from idto_tpu_torch.models.model import JointType, Model
from idto_tpu_torch.models.rotations import (
    axis_angle_to_rot,
    quat_rate_matrix,
    quat_rate_pinv,
    quat_to_rot,
)
from idto_tpu_torch.soa import mat3
from idto_tpu_torch.utils.consts import const
from idto_tpu_torch.utils.consts import index as _idx


def local_transforms(model: Model, q):
    """Child pose in the parent link frame per joint: q (nq, N) ->
    (R_pc (3, 3, nj, N), p_pc (3, nj, N))."""
    nj = model.num_joints
    dtype, device = q.dtype, q.device
    N = q.shape[-1]
    eye = torch.eye(3, dtype=dtype, device=device)[:, :, None, None]

    order = []
    R_parts, p_parts = [], []
    for jtype, js in model.type_groups:
        jt = JointType(jtype)
        g = len(js)
        order.extend(js)
        qs = [model.q_starts[j] for j in js]
        if jt == JointType.FIXED:
            R_g = eye.expand(3, 3, g, N)
            p_g = torch.zeros((3, g, N), dtype=dtype, device=device)
        elif jt == JointType.REVOLUTE:
            axes = model.axis.to(dtype)[_idx(js, device)].T  # (3, g)
            R_g = axis_angle_to_rot(axes, q[_idx(qs, device)])
            p_g = torch.zeros((3, g, N), dtype=dtype, device=device)
        elif jt == JointType.PRISMATIC:
            ax = model.axis.to(dtype)[_idx(js, device)].T[:, :, None]
            R_g = eye.expand(3, 3, g, N)
            p_g = ax * q[_idx(qs, device)][None]
        elif jt == JointType.PLANAR:
            # q = [x, y, theta] in the aligned joint frame (z == axis).
            qi = _idx(qs, device)
            xy = torch.stack([q[qi], q[qi + 1]], dim=0)  # (2, g, N)
            zaxes = const(np.array([0.0, 0.0, 1.0]), device, dtype)
            R_g = axis_angle_to_rot(zaxes[:, None].expand(3, g), q[qi + 2])
            p_g = torch.cat(
                [xy, torch.zeros((1, g, N), dtype=dtype, device=device)], dim=0
            )
        elif jt == JointType.FLOATING:
            # q = [qw, qx, qy, qz, x, y, z]
            qi = _idx(qs, device)
            R_g = quat_to_rot(torch.stack([q[qi + i] for i in range(4)], dim=0))
            p_g = torch.stack([q[qi + 4 + i] for i in range(3)], dim=0)
        else:
            raise ValueError(f"unknown joint type {jt}")
        R_parts.append(R_g)
        p_parts.append(p_g)

    inv = np.empty(nj, dtype=np.int64)
    inv[np.asarray(order)] = np.arange(nj)
    inv = _idx(inv, device)
    R_j = torch.cat(R_parts, dim=2)[:, :, inv, :]
    p_j = torch.cat(p_parts, dim=1)[:, inv, :]

    R_pj = mat3.from_aos_mat(model.R_pj.to(dtype))[..., None]
    p_pj = mat3.from_aos_vec(model.p_pj.to(dtype))[..., None]
    return mat3.mul(R_pj, R_j), p_pj + mat3.mv(R_pj, p_j)


def _down_the_tree(model: Model, local, compose):
    """World quantities per link from per-joint ones in the parent frame,
    level by level down the tree: ``local`` is a tuple of tensors with the
    joint axis second to last, and ``compose(parent, loc)`` gives a level's
    tuple from its parents' and its own."""
    device = local[0].device
    order = [j for level in model.levels for j in level]
    pos = {j: i for i, j in enumerate(order)}
    acc = []
    for d, level in enumerate(model.levels):
        loc = tuple(x[..., _idx(level, device), :] for x in local)
        if d == 0:
            acc.append(loc)
            continue
        ppos = _idx([pos[model.joint_parents[j]] for j in level], device)
        par = tuple(torch.cat(xs, dim=-2)[..., ppos, :] for xs in zip(*acc))
        acc.append(compose(par, loc))
    inv = np.empty(model.num_links, dtype=np.int64)
    inv[np.asarray(order)] = np.arange(model.num_links)
    inv = _idx(inv, device)
    return tuple(torch.cat(xs, dim=-2)[..., inv, :] for xs in zip(*acc))


def forward_kinematics(model: Model, q):
    """World link poses: q (nq, N) -> (R (3, 3, nl, N), p (3, nl, N))."""

    def compose(par, loc):
        (R_par, p_par), (R_loc, p_loc) = par, loc
        return mat3.mul(R_par, R_loc), p_par + mat3.mv(R_par, p_loc)

    return _down_the_tree(model, local_transforms(model, q), compose)


def _floating_joints(model: Model):
    return [
        j for j in range(model.num_joints)
        if JointType(model.joint_types[j]) == JointType.FLOATING
    ]


def normalize_quaternions(model: Model, q):
    """Renormalize the quaternion block of every floating joint; q is
    (..., nq) with the coordinate axis last."""
    for j in _floating_joints(model):
        qs = model.q_starts[j]
        quat = q[..., qs : qs + 4]
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        q = torch.cat([q[..., :qs], quat, q[..., qs + 4 :]], dim=-1)
    return q


def v_to_qdot(model: Model, q, v):
    """qdot = N(q) v with (nq, N) / (nv, N) operands."""
    if not _floating_joints(model):
        return v
    segs = []
    for j in range(model.num_joints):
        jt = JointType(model.joint_types[j])
        nvj = model.joint_nv(j)
        qs, vs = model.q_starts[j], model.v_starts[j]
        if jt == JointType.FLOATING:
            w = v[vs : vs + 3]
            Nq = quat_rate_matrix(q[qs : qs + 4])  # (4, 3, N)
            segs.append((Nq * w[None]).sum(1))
            segs.append(v[vs + 3 : vs + 6])
        elif nvj > 0:
            segs.append(v[vs : vs + nvj])
    return torch.cat(segs, dim=0)


def qdot_to_v(model: Model, q, qdot):
    """v = N^+(q) qdot with (nq, N) operands."""
    if not _floating_joints(model):
        return qdot
    segs = []
    for j in range(model.num_joints):
        jt = JointType(model.joint_types[j])
        nqj = model.joint_nq(j)
        qs = model.q_starts[j]
        if jt == JointType.FLOATING:
            qd4 = qdot[qs : qs + 4]
            Npi = quat_rate_pinv(q[qs : qs + 4])  # (3, 4, N)
            segs.append((Npi * qd4[None]).sum(1))
            segs.append(qdot[qs + 4 : qs + 7])
        elif nqj > 0:
            segs.append(qdot[qs : qs + nqj])
    return torch.cat(segs, dim=0)


def nplus_matrix(model: Model, q):
    """Materialized N^+(q): (nv, nq, N).  Identity except the quaternion
    blocks, which are added into zero slots of the constant part."""
    dtype, device = q.dtype, q.device
    N = q.shape[-1]
    base = np.zeros((model.nv, model.nq))
    for j in range(model.num_joints):
        if JointType(model.joint_types[j]) == JointType.FLOATING:
            for i in range(3):
                base[model.v_starts[j] + 3 + i, model.q_starts[j] + 4 + i] = 1.0
        else:
            for i in range(model.joint_nv(j)):
                base[model.v_starts[j] + i, model.q_starts[j] + i] = 1.0
    Np = const(base, device, dtype)[:, :, None].expand(
        model.nv, model.nq, N
    )
    for j in _floating_joints(model):
        qs, vs = model.q_starts[j], model.v_starts[j]
        blk = quat_rate_pinv(q[qs : qs + 4])  # (3, 4, N)
        pad = (0, 0, qs, model.nq - qs - 4, vs, model.nv - vs - 3)
        Np = Np + torch.nn.functional.pad(blk, pad)
    return Np


def body_velocities(model: Model, q, v):
    """World spatial velocities per link: (R, p, w, pd) with R (3,3,nl,N)
    and p/w/pd (3,nl,N).  A jvp of each joint's local transform gives its
    velocity in the parent frame -- w_loc = unskew(Rd R^T) as
    sum_k r_k x rd_k / 2 over the columns -- and the tree carries the
    velocities down with the poses: w = w_par + R_par w_loc and
    pd = pd_par + w_par x (R_par p_loc) + R_par pd_loc.  Nothing
    differentiates the world poses, so no 3x3 tangent is composed level by
    level."""
    qdot = v_to_qdot(model, q, v)
    (R_pc, p_pc), (Rd_pc, pd_pc) = jvp(
        lambda qq: local_transforms(model, qq), (q,), (qdot,)
    )
    w_pc = 0.5 * mat3.cross(R_pc, Rd_pc).sum(1)

    def compose(par, loc):
        R_par, p_par, w_par, pd_par = par
        R_loc, p_loc, w_loc, pd_loc = loc
        r = mat3.mv(R_par, p_loc)
        return (mat3.mul(R_par, R_loc), p_par + r,
                w_par + mat3.mv(R_par, w_loc),
                pd_par + mat3.cross(w_par, r) + mat3.mv(R_par, pd_loc))

    return _down_the_tree(model, (R_pc, p_pc, w_pc, pd_pc), compose)
