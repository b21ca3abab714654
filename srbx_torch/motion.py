"""Gait scheduling and per-domain motion planning, batched over lanes.

Counterpart of `srbx/motion.py` for the gaits the whole-body loop runs:
STAND (the 8-point Bezier stand-up) and TROT (alternating diagonal pairs,
Raibert footholds from the MPC's planned velocity). Every field of
PlannerState carries a leading lane axis; per-lane branches are masked
updates (`torch.where`), as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from srbx_torch.config import MotionConfig
from srbx_torch.ops import bezier as bz


class PlannerState(NamedTuple):
    com_des: torch.Tensor      # (B, 12) pos3, vel3, ori3, omega3
    toe_init: torch.Tensor     # (B, 3, 4)
    toe_final: torch.Tensor    # (B, 3, 4)
    step_len: torch.Tensor     # (B, 3)
    dom_ticks: torch.Tensor    # (B,) float
    des_domain: torch.Tensor   # (B, 4) int32 desired contact pattern
    stand_from: torch.Tensor   # (B, 3) com at stand start
    des_vel: torch.Tensor      # (B, 3) ramped velocity command
    cycle_idx: torch.Tensor    # (B,) int32 position in the gait cycle


def init(motion: MotionConfig, com0, toe_pos, dtype=torch.float64
         ) -> PlannerState:
    """com0 (B, 3), toe_pos (B, 4, 3)."""
    bsz, dev = com0.shape[0], com0.device
    zeros3 = torch.zeros((bsz, 3), dtype=dtype, device=dev)
    com_des = torch.cat([com0.to(dtype),
                         torch.zeros((bsz, 9), dtype=dtype, device=dev)], -1)
    toe = toe_pos.transpose(1, 2).to(dtype)
    return PlannerState(
        com_des=com_des,
        toe_init=toe,
        toe_final=toe.clone(),
        step_len=zeros3,
        dom_ticks=torch.full((bsz,), 1.0 * 1000, dtype=dtype, device=dev),
        des_domain=torch.ones((bsz, 4), dtype=torch.int32, device=dev),
        stand_from=com0.to(dtype),
        des_vel=zeros3.clone(),
        cycle_idx=torch.zeros(bsz, dtype=torch.int32, device=dev),
    )


def stand_com(motion: MotionConfig, state: PlannerState, phase):
    """8-point Bezier stand-up from stand_from to the stand height.
    phase (B,); returns com_des (B, 12)."""
    s = torch.clamp(phase, 0.0, 1.0)
    x0, y0, z0 = state.stand_from.unbind(-1)
    zf = motion.stand_height

    def alpha(a0, af):
        return torch.stack([a0, a0, a0, a0 + (af - a0) / 4,
                            a0 + 3 * (af - a0) / 4, af, af, af], -1)

    alphas = torch.stack([alpha(x0, x0), alpha(y0, y0),
                          alpha(z0, torch.full_like(z0, zf))], 1)  # (B, 3, 8)
    pos = bz.bezier(alphas, s[:, None])
    vel = bz.bezier_d(alphas, s[:, None])
    return torch.cat([pos, vel, torch.zeros_like(state.com_des[:, 6:])], -1)


_TROT_A = np.asarray([0, 1, 1, 0], np.int32)
_TROT_B = np.asarray([1, 0, 0, 1], np.int32)


@functools.lru_cache(maxsize=None)
def _trot_patterns(device):
    return (torch.as_tensor(_TROT_A, device=device),
            torch.as_tensor(_TROT_B, device=device))


def next_trot_domain(prev_des):
    """The upcoming trot stance pattern (B, 4): the diagonals swap."""
    a, b = _trot_patterns(prev_des.device)
    return torch.where(prev_des[:, 0:1] == 1, a, b)


def set_com_des(state: PlannerState, com_xy_traj, stand_height=0.28
                ) -> PlannerState:
    """com_xy_traj (B, 4) = (x, y, dx, dy) from the MPC Bezier."""
    com = state.com_des
    zero = torch.zeros_like(com[:, 0:1])
    new = torch.cat([com_xy_traj[:, 0:2], zero + stand_height,
                     com_xy_traj[:, 2:4], zero, com[:, 6:]], -1)
    return state._replace(com_des=new)


def plan_trot(motion: MotionConfig, state: PlannerState, change_domain,
              prev_des, toe_pos, qd_xy, mpc_states) -> PlannerState:
    """TROT domain update where change_domain (B,), else unchanged:
    alternate the diagonal pairs, the domain length in ticks, and the
    Raibert step from the mean of the MPC's planned velocity knots."""
    dtype = state.com_des.dtype
    dom_ticks = torch.full_like(state.dom_ticks, float(motion.trot_dom_ticks))
    new_des = next_trot_domain(prev_des)

    vx = mpc_states[:, :, 1].mean(-1)
    vy = mpc_states[:, :, 3].mean(-1)
    dom_sec = dom_ticks / 1000.0
    kx = float(0.1 * np.sqrt(0.28 / 9.81))
    ky = float(0.05 * np.sqrt(0.28 / 9.81))
    step = torch.stack([
        vx * dom_sec / 2.0 + kx * (qd_xy[:, 0] - vx),
        vy * dom_sec / 2.0 + ky * (qd_xy[:, 1] - vy),
        torch.zeros_like(vx, dtype=dtype),
    ], -1)
    toe = toe_pos.transpose(1, 2)
    ch = change_domain
    return PlannerState(
        com_des=state.com_des,
        toe_init=torch.where(ch[:, None, None], toe, state.toe_init),
        toe_final=torch.where(ch[:, None, None], toe, state.toe_final),
        step_len=torch.where(ch[:, None], step, state.step_len),
        dom_ticks=torch.where(ch, dom_ticks, state.dom_ticks),
        des_domain=torch.where(ch[:, None], new_des, state.des_domain),
        stand_from=state.stand_from,
        des_vel=state.des_vel,
        cycle_idx=torch.where(ch, state.cycle_idx + 1, state.cycle_idx),
    )


def update_toe_final(state: PlannerState, change_domain, ind, ind_prev,
                     toe_pos) -> PlannerState:
    """toeFinal bookkeeping: re-anchor legs whose contact index changed,
    and every leg on a domain change."""
    toe = toe_pos.transpose(1, 2)
    changed = (ind != ind_prev)[:, None, :]
    tf = torch.where(changed, toe, state.toe_final)
    tf = torch.where(change_domain[:, None, None], toe, tf)
    return state._replace(toe_final=tf)
