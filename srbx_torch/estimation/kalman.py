"""18-state contact-aided Kalman filter for the base state, batched over
lanes.

Counterpart of `srbx/estimation/kalman.py`: state x = [COM position (3),
COM velocity (3), the four foot positions (4 x 3)]; the input is the IMU
acceleration rotated to the world and gravity-compensated; the measurements
are the 12 kinematic base-to-foot positions and the 4 foot heights (ground
at z = 0). Feet out of contact get a large process noise, so that their
states float free: the contact gating.

The measurement update is sequential, one of the 16 rows at a time in row
order, as the JAX package runs it: the joint innovation covariance S has a
condition near 1e11 (swing feet's process noise against the measurement
noise), beyond float32, while the sequential form only ever divides by the
scalar c_i P c_i' + r_i > 0. Each row of C holds a +1 and at most one -1,
so P c_i and c_i x are a column (or a difference of two) of P and x: the
same IEEE result as the JAX package's dot products, whose other terms are
exact zeros. The quadratic form is clamped at 0 and P symmetrised after
the prediction and after the update, in the JAX package's order. Every
field carries a leading lane axis B.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class KfState(NamedTuple):
    x: torch.Tensor    # (B, 18)
    p: torch.Tensor    # (B, 18, 18) covariance


# each measurement row as (column of +1, column of -1 or None): rows 3f+i
# are foot f's base-to-foot axis i, rows 12+f foot f's height
_ROWS = tuple((i, 6 + 3 * f + i) for f in range(4) for i in range(3)) + \
    tuple((8 + 3 * f, None) for f in range(4))


@functools.lru_cache(maxsize=16)
def _matrices(dt: float, dtype, device):
    """The transition A (18, 18) and input B (18, 3) of the constant-
    acceleration COM and static feet."""
    a = np.eye(18)
    a[0, 3] = a[1, 4] = a[2, 5] = dt
    b = np.zeros((18, 3))
    b[0, 0] = b[1, 1] = b[2, 2] = dt * dt / 2.0
    b[3, 0] = b[4, 1] = b[5, 2] = dt
    return (torch.tensor(a, dtype=dtype, device=device),
            torch.tensor(b, dtype=dtype, device=device))


def init(bsz: int, dt: float = 1e-3, com0=(0.0, 0.0, 0.09),
         dtype=torch.float64, device=None) -> KfState:
    """bsz lanes at com0 with covariance 1e4 I. device=None means the CUDA
    card."""
    device = "cuda" if device is None else device
    x = torch.zeros((bsz, 18), dtype=dtype, device=device)
    x[:, 0:3] = torch.tensor(com0, dtype=dtype, device=device)
    p = 1e4 * torch.eye(18, dtype=dtype, device=device).expand(bsz, 18, 18)
    return KfState(x, p.clone())


def update(
    state: KfState,
    contact_ind,
    imu_accel_body,
    rot,
    rel_foot_pos,
    dt: float = 1e-3,
    accel_noise: float = 2000.0,
    meas_noise: float = 1.0,
    g: float = 9.81,
    swing_noise: float = 1e6,
) -> KfState:
    """One predict and update step for every lane. contact_ind (B, 4) 0/1,
    imu_accel_body (B, 3), rot (B, 3, 3) body to world, rel_foot_pos
    (B, 4, 3) the measured base-minus-foot positions in the world frame."""
    x, p = state
    dtype = x.dtype
    a, b = _matrices(dt, dtype, x.device)

    accel = (rot @ imu_accel_body[..., None])[..., 0]
    accel = torch.cat([accel[:, 0:2], accel[:, 2:3] - g], 1)

    # contact-gated process noise, (sd dt)^2 with sd 1 in stance
    foot_var = torch.full(contact_ind.shape, (swing_noise * dt) ** 2,
                          dtype=dtype, device=x.device).masked_fill(
                              contact_ind > 0, dt ** 2)
    q_diag = torch.cat([
        torch.zeros_like(accel),
        torch.full_like(accel, (accel_noise * dt) ** 2),
        foot_var[:, :, None].expand(-1, 4, 3).reshape(-1, 12),
    ], 1)

    # predict
    x = (a @ x[..., None])[..., 0] + (b @ accel[..., None])[..., 0]
    p = a @ p @ a.T + torch.diag_embed(q_diag)
    p = 0.5 * (p + p.transpose(-1, -2))

    # sequential measurement update: the 12 base-to-foot positions, then
    # the 4 foot heights (0)
    z = rel_foot_pos.reshape(-1, 12)
    for r, (i, j) in enumerate(_ROWS):
        if j is None:
            pc, cx, zi = p[:, :, i], x[:, i], 0.0
        else:
            pc, cx, zi = p[:, :, i] - p[:, :, j], x[:, i] - x[:, j], z[:, r]
        cpc = pc[:, i] if j is None else pc[:, i] - pc[:, j]
        si = torch.clamp(cpc, min=0.0) + meas_noise
        k = pc / si[:, None]
        x = x + k * (zi - cx)[:, None]
        p = p - (pc[:, :, None] * pc[:, None, :]) / si[:, None, None]
    return KfState(x, 0.5 * (p + p.transpose(-1, -2)))
