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

from idto_tpu_torch.utils.consts import const


# -epsilon_ijk with the sign that makes skew(a) u = a x u.
_LEVI = np.zeros((3, 3, 3))
for _i, _j, _k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
    _LEVI[_i, _j, _k] = -1.0
    _LEVI[_j, _i, _k] = 1.0


def _stack2(rows):
    return torch.stack([torch.stack(r, dim=0) for r in rows], dim=0)


def quat_mul(a, b):
    """Hamilton product a*b of (4, ...) quaternions (broadcasting over the
    trailing axes)."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=0)


def quat_conj(q):
    return torch.cat([q[:1], -q[1:4]], dim=0)


def normalize_quat(q):
    return q / torch.linalg.vector_norm(q, dim=0, keepdim=True)


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
    return torch.einsum("ijk,k...->ij...",
                        const(_LEVI, axes.device, axes.dtype), axes)


def unskew(m):
    """Inverse of skew for (3, 3, ...) matrices: the vector of m's skew
    part (the average of each off-diagonal pair)."""
    return 0.5 * torch.stack(
        [m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]], dim=0
    )


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


def rot_to_quat(R):
    """Quaternion (4, ...) with w >= 0 from rotation matrices (3, 3, ...):
    of the four Shepperd constructions, the one with the largest pivot
    (the first on ties), selected per instance without host branching."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]

    def half_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12)) / 2.0

    qw = half_sqrt(1.0 + tr)
    qx = half_sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2])
    qy = half_sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2])
    qz = half_sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2])
    cases = torch.stack([
        torch.stack([qw, (R[2, 1] - R[1, 2]) / (4 * qw),
                     (R[0, 2] - R[2, 0]) / (4 * qw),
                     (R[1, 0] - R[0, 1]) / (4 * qw)]),
        torch.stack([(R[2, 1] - R[1, 2]) / (4 * qx), qx,
                     (R[0, 1] + R[1, 0]) / (4 * qx),
                     (R[0, 2] + R[2, 0]) / (4 * qx)]),
        torch.stack([(R[0, 2] - R[2, 0]) / (4 * qy),
                     (R[0, 1] + R[1, 0]) / (4 * qy), qy,
                     (R[1, 2] + R[2, 1]) / (4 * qy)]),
        torch.stack([(R[1, 0] - R[0, 1]) / (4 * qz),
                     (R[0, 2] + R[2, 0]) / (4 * qz),
                     (R[1, 2] + R[2, 1]) / (4 * qz), qz]),
    ])  # (case, 4, ...)
    best = torch.argmax(torch.stack([qw, qx, qy, qz]), dim=0)
    q = torch.gather(cases, 0, best[None, None].expand((1,) + cases.shape[1:]))[0]
    w = q[0]
    return q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))


def rpy_to_rot(rpy):
    """Roll-pitch-yaw (3, ...) -> rotation matrices (3, 3, ...), URDF
    convention (extrinsic x-y-z): R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr = torch.cos(rpy[0]), torch.sin(rpy[0])
    cp, sp = torch.cos(rpy[1]), torch.sin(rpy[1])
    cy, sy = torch.cos(rpy[2]), torch.sin(rpy[2])
    return _stack2([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


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
