"""Rotation and frame transforms on the trailing axes, batched over any
leading axes.

Counterpart of `srbx/utils/transforms.py`, same conventions (XYZ Euler
angles, quaternions as (w, x, y, z)).
"""

from __future__ import annotations

import torch


def quat_to_xyz(quat):
    """Quaternion (w, x, y, z) -> XYZ-Euler (roll, pitch, yaw)."""
    qw, qx, qy, qz = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    roll = torch.atan2(-2.0 * (qy * qz - qx * qw),
                       qw**2 - qx**2 - qy**2 + qz**2)
    pitch = torch.asin(torch.clamp(2.0 * (qx * qz + qy * qw), -1.0, 1.0))
    yaw = torch.atan2(-2.0 * (qx * qy - qz * qw),
                      qw**2 + qx**2 - qy**2 - qz**2)
    return torch.stack([roll, pitch, yaw], -1)


def quat_to_rot(quat):
    """Quaternion (w, x, y, z) -> rotation matrix (body -> world)."""
    q0, q1, q2, q3 = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    return torch.stack([
        torch.stack([2 * (q0 * q0 + q1 * q1) - 1, 2 * (q1 * q2 - q0 * q3),
                     2 * (q1 * q3 + q0 * q2)], -1),
        torch.stack([2 * (q1 * q2 + q0 * q3), 2 * (q0 * q0 + q2 * q2) - 1,
                     2 * (q2 * q3 - q0 * q1)], -1),
        torch.stack([2 * (q1 * q3 - q0 * q2), 2 * (q2 * q3 + q0 * q1),
                     2 * (q0 * q0 + q3 * q3) - 1], -1),
    ], -2)


def rot_xyz(eul):
    """XYZ-Euler (roll, pitch, yaw) -> rotation matrix R = Rx Ry Rz."""
    roll, pitch, yaw = eul[..., 0], eul[..., 1], eul[..., 2]
    sr, cr = torch.sin(roll), torch.cos(roll)
    sp, cp = torch.sin(pitch), torch.cos(pitch)
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    return torch.stack([
        torch.stack([cp * cy, -cp * sy, sp], -1),
        torch.stack([cr * sy + cy * sp * sr, cr * cy - sp * sr * sy,
                     -cp * sr], -1),
        torch.stack([sr * sy - cr * cy * sp, cy * sr + cr * sp * sy,
                     cp * cr], -1),
    ], -2)


def xyz_to_quat(eul):
    """XYZ-Euler -> quaternion (w, x, y, z)."""
    half = 0.5 * eul
    sr, cr = torch.sin(half[..., 0]), torch.cos(half[..., 0])
    sp, cp = torch.sin(half[..., 1]), torch.cos(half[..., 1])
    sy, cy = torch.sin(half[..., 2]), torch.cos(half[..., 2])
    return torch.stack([
        cr * cp * cy - sr * sp * sy,
        sr * cp * cy + cr * sp * sy,
        -sr * cp * sy + cr * sp * cy,
        cr * cp * sy + sr * sp * cy,
    ], -1)


def to_world(vec, rot):
    """Body-frame vector -> world frame."""
    return torch.einsum("...ij,...j->...i", rot, vec)


def to_body(vec, rot):
    """World-frame vector -> body frame."""
    return torch.einsum("...ji,...j->...i", rot, vec)


def hat(v):
    """Skew-symmetric (hat) map: hat(a) @ b == a x b."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zeros], -1),
    ], -2)


def vee(m):
    """Inverse of `hat`."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def rodrigues(axis_angle):
    """Exponential map so(3) -> SO(3), smooth at zero:
    R = I + a(t^2) hat(x) + b(t^2) hat(x)^2 with the small-angle forms of
    a = sin(t)/t and b = (1 - cos t)/t^2."""
    n2 = (axis_angle * axis_angle).sum(-1)[..., None, None]
    theta = torch.sqrt(n2 + 1e-30)
    small = n2 < 1e-12
    a = torch.where(small, 1.0 - n2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - n2 / 24.0,
                    (1.0 - torch.cos(theta)) / (n2 + 1e-30))
    x_hat = hat(axis_angle)
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return eye + a * x_hat + b * (x_hat @ x_hat)
