"""Quaternion / rotation utilities (counterpart of
``idto_tpu/models/rotations.py``, the subset the port uses).

Quaternions are [w, x, y, z], Hamilton product; ``quat_to_rot(q)`` gives R
with ``p_world = R @ p_body``.  Tensor functions are component-leading:
a quaternion is ``(4, ...)`` and a matrix ``(3, 3, ...)`` with any
trailing instance axes.  The ``*_np`` helpers run at model-build time.
"""
from __future__ import annotations

import numpy as np
import torch


def _stack2(rows):
    return torch.stack([torch.stack(r, dim=0) for r in rows], dim=0)


def quat_to_rot(q):
    """Rotation matrix from a (not necessarily normalized) quaternion,
    homogeneous form divided by |q|^2 so the map is smooth in raw q:
    R = I + s w [u]x + s (u u^T - |u|^2 I), u = (x, y, z), s = 2 / |q|^2."""
    w, u = q[0], q[1:4]
    uu = torch.sum(u * u, dim=0)
    s = 2.0 / (w * w + uu)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).reshape(
        (3, 3) + (1,) * (q.ndim - 1)
    )
    outer = torch.einsum("i...,j...->ij...", u, u)
    return eye * (1.0 - s * uu) + s * (w * skew(u) + outer)


def quat_rate_matrix(q):
    """N_quat(q) (4, 3, ...): world angular velocity w -> qdot."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return 0.5 * _stack2([
        [-x, -y, -z],
        [w, z, -y],
        [-z, w, x],
        [y, -x, w],
    ])


def quat_rate_pinv(q):
    """N_quat^+(q) (3, 4, ...): qdot -> world angular velocity, the left
    pseudo-inverse 4 N_quat^T for unit q.  Only the two matrix axes swap,
    so any trailing batch axes are kept."""
    return 4.0 * torch.swapaxes(quat_rate_matrix(q), 0, 1)


def skew(axes):
    """(3, ...) vectors -> (3, 3, ...) skew matrices (skew(a) u = a x u)."""
    levi = torch.zeros((3, 3, 3), dtype=axes.dtype, device=axes.device)
    for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        levi[i, j, k] = -1.0
        levi[j, i, k] = 1.0
    return torch.einsum("ijk,k...->ij...", levi, axes)


def axis_angle_to_rot(axes, angles):
    """Rodrigues: unit axes (3, g) and angles (g, N) -> (3, 3, g, N)."""
    K = skew(axes)[..., None]  # (3, 3, g, 1)
    KK = torch.einsum("ik...,kj...->ij...", K, K)
    c = torch.cos(angles)[None, None]
    s = torch.sin(angles)[None, None]
    eye = torch.eye(3, dtype=angles.dtype, device=angles.device)[
        :, :, None, None
    ]
    return eye + s * K + (1.0 - c) * KK


def rpy_to_rot_np(rpy):
    """URDF roll-pitch-yaw (extrinsic x-y-z): R = Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def make_frame_from_z(u):
    """Deterministic orthonormal frame [v, w, u] with unit z-axis u
    (Drake's RotationMatrix::MakeFromOneUnitVector basis completion)."""
    u = np.asarray(u, dtype=np.float64)
    u = u / np.linalg.norm(u)
    m = int(np.argmin(np.abs(u)))
    e = np.zeros(3)
    e[m] = 1.0
    v = e - (e @ u) * u
    v = v / np.linalg.norm(v)
    w = np.cross(u, v)
    return np.stack([v, w, u], axis=1)
