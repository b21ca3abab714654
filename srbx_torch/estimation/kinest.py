"""Stance-anchored kinematic odometry, batched over lanes.

Counterpart of `srbx/estimation/kinest.py`: the base position follows the
negated motion of the stance toes (their positions computed with the base
pinned at the origin), the base height is the mean stance-toe depth, and
the base velocity is -J qd averaged over the weighted contacts. Every field
carries a leading lane axis B.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from srbx_torch.models import a1, rbd


class KinEstState(NamedTuple):
    com: torch.Tensor        # (B, 3) estimated base position
    toe_prev: torch.Tensor   # (B, 4, 3) previous base-pinned toe positions


def _pinned(q_joints, eul=None):
    """(B, 18) configurations with the base at the origin."""
    bsz = q_joints.shape[0]
    eul = q_joints.new_zeros((bsz, 3)) if eul is None else eul
    return torch.cat([q_joints.new_zeros((bsz, 3)), eul, q_joints], 1)


def toes_and_velocities(model: rbd.Model, q, qd):
    """(B, 4, 3) toe positions at q and their velocities under qd, from one
    jvp of the kinematics."""
    return jvp(lambda qq: rbd.site_positions(model, qq)[:, a1.TOE_SITES],
               (q,), (qd,))


def init(model: rbd.Model, q_joints, com0=(0.0, 0.0, 0.0)) -> KinEstState:
    """q_joints (B, 12); com0 the start position of every lane."""
    toes = rbd.site_positions(model, _pinned(q_joints))[:, a1.TOE_SITES]
    com = torch.tensor(com0, dtype=q_joints.dtype, device=q_joints.device)
    return KinEstState(com.expand(q_joints.shape[0], 3).clone(), toes)


def update(
    model: rbd.Model,
    state: KinEstState,
    q_joints,
    qd,
    eul,
    foot_force,
    contact_ind,
    force_thresh: float = 20.0,
    z_toe_offset: float = 0.0,
    fk=None,
):
    """One odometry step. Returns (new_state, com (B, 3), com_vel (B, 3)).

    q_joints (B, 12); qd (B, 18), its base rows ignored (the base is
    pinned); eul (B, 3); foot_force, contact_ind (B, 4). fk: optionally the
    (toes, toe velocities) of `toes_and_velocities` at the pinned
    configuration [0, eul, q_joints] under qd with its base rows zeroed,
    when the caller has them."""
    dtype = q_joints.dtype
    weighted = (foot_force > force_thresh).to(dtype) + contact_ind.to(dtype)
    num = torch.clamp(weighted.sum(-1), min=1e-9)

    if fk is None:
        qd_nobase = torch.cat([torch.zeros_like(qd[:, 0:3]), qd[:, 3:]], 1)
        fk = toes_and_velocities(model, _pinned(q_joints, eul), qd_nobase)
    toes, toe_vel = fk

    delta = -(toes[:, :, 0:2] - state.toe_prev[:, :, 0:2])
    delta_com = (weighted[:, :, None] * delta).sum(1) / num[:, None]
    com_xy = state.com[:, 0:2] + delta_com
    com_z = -(weighted * toes[:, :, 2]).sum(-1) / num + z_toe_offset
    com_vel = -(weighted[:, :, None] * toe_vel).sum(1) / num[:, None]

    com = torch.cat([com_xy, com_z[:, None]], 1)
    return KinEstState(com, toes), com, com_vel
