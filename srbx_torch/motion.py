"""Gait scheduling and per-domain motion planning, batched over lanes.

Counterpart of `srbx/motion.py`: STAND (the 8-point Bezier stand-up),
TROT (alternating diagonal pairs, Raibert footholds from the MPC's planned
velocity), the velocity-commanded WALK and PACE (a ramped velocity command,
Raibert steps from the filtered COM velocity), the in-place INPLACE_TROT,
INPLACE_WALK and TAP (stance tables cycled under a held COM) and POSE's
teach-pendant sinusoids (`pose_com`). Every field of PlannerState carries
a leading lane axis; per-lane branches are masked updates (`torch.where`),
as in the JAX package. Python constants keep the lanes' dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from srbx_torch.config import MotionConfig
from srbx_torch.ops import bezier as bz
from srbx_torch.utils import transforms as tf


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
_PACE_A = np.asarray([0, 1, 0, 1], np.int32)
_PACE_B = np.asarray([1, 0, 1, 0], np.int32)
_WALK = np.asarray(
    [[0, 1, 1, 1], [1, 1, 0, 1], [1, 1, 1, 0], [1, 0, 1, 1]], np.int32)
_INPLACE_WALK = np.asarray(
    [[0, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 0], [1, 1, 0, 1]], np.int32)
_TAP = np.asarray([1, 0, 1, 1], np.int32)
_TABLES = {"trot_a": _TROT_A, "trot_b": _TROT_B, "pace_a": _PACE_A,
           "pace_b": _PACE_B, "walk": _WALK, "inplace_walk": _INPLACE_WALK,
           "tap": _TAP}
# POSE's amplitude by pose_type: x, y (m), z (m), roll, pitch, yaw (rad)
_POSE_MAGS = (0.04, 0.04, 0.05, 0.3491, 0.17453, 0.13963)


@functools.lru_cache(maxsize=None)
def _table(name, device):
    """A stance table of this module as an int32 tensor on `device`."""
    return torch.as_tensor(_TABLES[name], device=device)


def _swap(prev_des, a, b):
    """(B, 4): table a where a lane's first leg was in stance, else b."""
    return torch.where(prev_des[:, 0:1] == 1, _table(a, prev_des.device),
                       _table(b, prev_des.device))


def next_trot_domain(prev_des):
    """The upcoming trot stance pattern (B, 4): the diagonals swap."""
    return _swap(prev_des, "trot_a", "trot_b")


def set_com_des(state: PlannerState, com_xy_traj, stand_height=0.28
                ) -> PlannerState:
    """com_xy_traj (B, 4) = (x, y, dx, dy) from the MPC Bezier."""
    com = state.com_des
    zero = torch.zeros_like(com[:, 0:1])
    new = torch.cat([com_xy_traj[:, 0:2], zero + stand_height,
                     com_xy_traj[:, 2:4], zero, com[:, 6:]], -1)
    return state._replace(com_des=new)


def _on_change(ch, new, old):
    """Per lane: new where the domain changes (ch (B,)), else old."""
    return torch.where(ch.view((-1,) + (1,) * (old.dim() - 1)), new, old)


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
        toe_init=_on_change(ch, toe, state.toe_init),
        toe_final=_on_change(ch, toe, state.toe_final),
        step_len=_on_change(ch, step, state.step_len),
        dom_ticks=_on_change(ch, dom_ticks, state.dom_ticks),
        des_domain=_on_change(ch, new_des, state.des_domain),
        stand_from=state.stand_from,
        des_vel=state.des_vel,
        cycle_idx=_on_change(ch, state.cycle_idx + 1, state.cycle_idx),
    )


def _ramp_vel(des_vel, fwd_speed, lat_speed, rate=0.01):
    """The signed velocity ramp of des_vel (B, 3) toward the command: an
    axis steps by rate toward its target while sign(target) * v <
    sign(target) * target, so an overshoot or a reversed command still
    converges; a zero target (sign 0) leaves the axis as it is."""
    def axis(v, target):
        sgn = float(np.sign(target))
        return torch.where(sgn * v < sgn * target, v + rate * sgn, v)

    return torch.stack([axis(des_vel[:, 0], fwd_speed),
                        axis(des_vel[:, 1], lat_speed), des_vel[:, 2]], -1)


@functools.lru_cache(maxsize=None)
def _gains(kp, dtype, device):
    """The Raibert gains kp (a tuple) as a tensor, made once per device."""
    return torch.tensor(kp, dtype=dtype, device=device)


def _velocity_step(state, change_domain, toe_pos, com_filtered, rot,
                   fwd_speed, lat_speed, dom_sec, kp, new_des):
    """The WALK and PACE domain update where change_domain: the ramped
    command, the Raibert step in the body frame, the domain length and the
    stance pattern new_des (B, 4)."""
    des_vel = _ramp_vel(state.des_vel, fwd_speed, lat_speed)
    kp = _gains(kp, des_vel.dtype, des_vel.device)
    step_body = (kp * (tf.to_body(com_filtered, rot) - des_vel)
                 + dom_sec * tf.to_body(des_vel, rot) / 2.0)
    ch = change_domain
    return state._replace(
        toe_init=_on_change(ch, toe_pos.transpose(1, 2), state.toe_init),
        step_len=_on_change(ch, tf.to_world(step_body, rot),
                            state.step_len),
        dom_ticks=_on_change(ch, torch.full_like(state.dom_ticks,
                                                 dom_sec * 1000.0),
                             state.dom_ticks),
        des_domain=_on_change(ch, new_des, state.des_domain),
        des_vel=_on_change(ch, des_vel, state.des_vel),
        cycle_idx=_on_change(ch, state.cycle_idx + 1, state.cycle_idx),
    )


def plan_walk(motion: MotionConfig, state: PlannerState, change_domain,
              toe_pos, com_filtered, rot, fwd_speed=0.0, lat_speed=0.0
              ) -> PlannerState:
    """WALK domain update where change_domain (B,): one swing leg at a
    time through 0.2 s domains (the table row after cycle_idx), the ramped
    command, Raibert steps from com_filtered (B, 3) in the body frame of
    rot (B, 3, 3)."""
    n = torch.remainder(state.cycle_idx + 1, 4).long()
    return _velocity_step(state, change_domain, toe_pos, com_filtered, rot,
                          fwd_speed, lat_speed, 0.2, (0.04, 0.01, 0.0),
                          _table("walk", n.device)[n])


def plan_pace(motion: MotionConfig, state: PlannerState, change_domain,
              prev_des, toe_pos, com_filtered, rot, fwd_speed=0.0,
              lat_speed=0.0) -> PlannerState:
    """PACE domain update where change_domain: the lateral pairs swap
    through 0.1 s domains, otherwise as plan_walk."""
    return _velocity_step(state, change_domain, toe_pos, com_filtered, rot,
                          fwd_speed, lat_speed, 0.1, (0.04, 0.02, 0.0),
                          _swap(prev_des, "pace_a", "pace_b"))


def _in_place(state, change_domain, toe_init, dom_ticks, new_des):
    """The in-place gaits' domain update where change_domain: the toe
    anchors, the domain length and the stance pattern; the COM held."""
    ch = change_domain
    return state._replace(
        toe_init=_on_change(ch, toe_init, state.toe_init),
        dom_ticks=_on_change(ch, torch.full_like(state.dom_ticks, dom_ticks),
                             state.dom_ticks),
        des_domain=_on_change(ch, new_des, state.des_domain),
        cycle_idx=_on_change(ch, state.cycle_idx + 1, state.cycle_idx))


def plan_inplace_trot(motion: MotionConfig, state: PlannerState,
                      change_domain, prev_des, toe_pos, hip_pos
                      ) -> PlannerState:
    """INPLACE_TROT where change_domain: the diagonals swap through 0.16 s
    domains, the toes re-targeted under the hips (hip_pos (B, 4, 3)) in x
    and y, toe_init's z kept."""
    toe_init = torch.cat([hip_pos.transpose(1, 2)[:, 0:2],
                          state.toe_init[:, 2:3]], 1)
    return _in_place(state, change_domain, toe_init, 160.0,
                     next_trot_domain(prev_des))


def plan_tap(motion: MotionConfig, state: PlannerState, change_domain,
             toe_pos) -> PlannerState:
    """TAP where change_domain: the FL leg held raised ({1, 0, 1, 1})
    through 1.5 s domains, zero step length."""
    out = _in_place(state, change_domain, toe_pos.transpose(1, 2), 1500.0,
                    _table("tap", toe_pos.device))
    return out._replace(step_len=_on_change(
        change_domain, torch.zeros_like(state.step_len), state.step_len))


def plan_inplace_walk(motion: MotionConfig, state: PlannerState,
                      change_domain, toe_pos) -> PlannerState:
    """INPLACE_WALK where change_domain: one swing leg at a time (FR, FL,
    RL, RR) through 0.3 s domains, the toes re-anchored."""
    n = torch.remainder(state.cycle_idx + 1, 4).long()
    return _in_place(state, change_domain, toe_pos.transpose(1, 2), 300.0,
                     _table("inplace_walk", n.device)[n])


def pose_com(motion: MotionConfig, pose_type: int, t, t_init, com_lock):
    """POSE's teach-pendant sinusoid about com_lock (B, 12) at times t
    (B,) from t_init: pose_type (0-5, a Python int) picks the axis (x, y,
    z, roll, pitch, yaw) and its amplitude; its rate row moves with it."""
    if pose_type not in range(len(_POSE_MAGS)):
        raise ValueError(f"pose_type must be 0-5, got {pose_type!r}")
    freq = 0.8 * np.pi
    mag = _POSE_MAGS[pose_type]
    tt = t - t_init
    com = com_lock.clone()
    if pose_type == 2:
        com[:, 2] += mag * torch.cos(freq * tt) - mag
        com[:, 5] += -mag * freq * torch.sin(freq * tt)
    else:
        # x, y: rows 0-1 and their rates 3-4; angles: rows 6-8, rates 9-11
        row = pose_type if pose_type < 2 else pose_type + 3
        com[:, row] += mag * torch.sin(freq * tt)
        com[:, row + 3] += mag * freq * torch.cos(freq * tt)
    return com


def com_des_from_velocity(state: PlannerState, q_xy, rot, stand_height,
                          dt: float = 1e-3) -> PlannerState:
    """The velocity-command COM reference of WALK and PACE: position q_xy
    (B, 2) + rot des_vel dt at the stand height, velocity rot des_vel."""
    vel_w = tf.to_world(state.des_vel, rot)
    com = state.com_des
    new = torch.cat([q_xy + vel_w[:, 0:2] * dt,
                     torch.full_like(com[:, 0:1], stand_height), vel_w,
                     com[:, 6:]], -1)
    return state._replace(com_des=new)


def update_toe_final(state: PlannerState, change_domain, ind, ind_prev,
                     toe_pos) -> PlannerState:
    """toeFinal bookkeeping: re-anchor legs whose contact index changed,
    and every leg on a domain change."""
    toe = toe_pos.transpose(1, 2)
    changed = (ind != ind_prev)[:, None, :]
    tf = torch.where(changed, toe, state.toe_final)
    tf = torch.where(change_domain[:, None, None], toe, tf)
    return state._replace(toe_final=tf)
