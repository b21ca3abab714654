"""Per-agent 1 kHz control tick, batched over lanes.

Counterpart of `srbx/agent.py` for every gait: each tick updates the phase,
detects a domain change (the phase overrun or a forced replan; the contact
trigger too unless it is switched off; STAND and POSE take neither
trigger), runs the gait's planner (TROT evaluates the MPC's COM Bezier with
the stale-solution fallback; WALK and PACE integrate a ramped velocity
command; INPLACE_TROT, INPLACE_WALK and TAP cycle stance tables under the
held COM; POSE oscillates about the locked stand pose), the virtual
constraints, and assembles the LL QP.
`tick_build` stops before the solve and `tick_finish` completes the tick
from its solution, so that the caller solves every lane's QP in one batched
call; `reduced` selects the reduced LL build (n 25, me 12) over the full
one (n 43, me 30) in both. Every field of AgentState carries a leading lane
axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from srbx_torch import lowlevel, motion
from srbx_torch.config import Gait, LowLevelConfig, MotionConfig, QpConfig
from srbx_torch.estimation import contact
from srbx_torch.models import a1, rbd
from srbx_torch.ops import bezier as bz
from srbx_torch.utils import transforms as tf


class AgentState(NamedTuple):
    loco_tick: torch.Tensor      # (B,) float
    gait_domain: torch.Tensor    # (B,) int32
    planner: motion.PlannerState
    con: contact.ConState
    mpc_alpha: torch.Tensor      # (B, 4, 5) COM Bezier control points
    mpc_states: torch.Tensor     # (B, 4, 4) MPC solution knots
    mpc_available: torch.Tensor  # (B,) bool
    prev_ddq: torch.Tensor       # (B, 18)


def init(motion_cfg: MotionConfig, model: rbd.Model, q0,
         dtype=torch.float64) -> AgentState:
    """Lanes starting at q0 (B, 18)."""
    bsz, dev = q0.shape[0], q0.device
    toe = rbd.site_positions(model, q0)[:, a1.TOE_SITES]
    zeros5 = torch.zeros((bsz, 5), dtype=dtype, device=dev)
    alpha0 = torch.stack([zeros5 + q0[:, 0:1], zeros5, zeros5 + q0[:, 1:2],
                          zeros5], 1)
    return AgentState(
        loco_tick=torch.zeros(bsz, dtype=dtype, device=dev),
        gait_domain=torch.zeros(bsz, dtype=torch.int32, device=dev),
        planner=motion.init(motion_cfg, q0[:, 0:3], toe, dtype),
        con=contact.init(bsz, device=dev),
        mpc_alpha=alpha0,
        mpc_states=torch.zeros((bsz, 4, 4), dtype=dtype, device=dev),
        mpc_available=torch.zeros(bsz, dtype=torch.bool, device=dev),
        prev_ddq=torch.zeros((bsz, 18), dtype=dtype, device=dev),
    )


def set_mpc_data(state: AgentState, alpha_com, mpc_states) -> AgentState:
    return state._replace(mpc_alpha=alpha_com, mpc_states=mpc_states,
                          mpc_available=torch.ones_like(state.mpc_available))


def eval_com_traj(state: AgentState, phase, max_phase=1.05):
    """(B, 4) = (x, dx, y, dy) of the COM Bezier: at the phase where fresh
    MPC data is available, else the stale solution at s = max_phase."""
    s = torch.where(state.mpc_available, phase,
                    torch.full_like(phase, max_phase))
    return bz.bezier(state.mpc_alpha, s[:, None])


class TickCtx(NamedTuple):
    """Context carried from tick_build to tick_finish."""

    vc: lowlevel.VcOut
    ll_ctx: lowlevel.LLCtx    # lowlevel.LLCtxR from the reduced build
    state_pre: AgentState     # the new state, prev_ddq not yet updated
    run_mpc: torch.Tensor     # (B,) bool


# the gaits whose domains never end by time or touchdown
_UNTRIGGERED = (Gait.STAND, Gait.POSE)


def tick_build(ll_cfg: LowLevelConfig, motion_cfg: MotionConfig,
               model: rbd.Model, gait: Gait, state: AgentState, q, qd,
               foot_force, force_new_domain=False, force_thresh: float = 15.0,
               f_des=None, allow_contact_trigger: bool = True,
               reduced: bool = False, d_inv=None):
    """Everything in a control tick up to the LL-QP solve, for every lane:
    q, qd (B, 18), foot_force (B, 4). force_new_domain: a bool for all lanes
    or a (B,) mask. d_inv: (B, 18, 18) D(q)^-1 for the LL build. reduced:
    the reduced LL build (`lowlevel.ll_qp_build_reduced`).

    Returns (lowlevel.LLQpData, TickCtx)."""
    dtype = q.dtype
    bsz = q.shape[0]
    dom_ticks_gait = float(motion_cfg.trot_dom_ticks)

    if gait == Gait.TROT:
        phase = state.loco_tick / dom_ticks_gait
    else:
        phase = state.loco_tick / state.planner.dom_ticks

    # domain-change detection
    time_trigger = phase > motion_cfg.max_phase
    if gait in _UNTRIGGERED:
        time_trigger = torch.zeros_like(time_trigger)
    time_trigger = time_trigger | force_new_domain
    con = contact.update(state.con, foot_force, phase, force_thresh)
    contact_trigger = con.change_domain
    if gait in _UNTRIGGERED or not allow_contact_trigger:
        contact_trigger = torch.zeros_like(contact_trigger)
    change = time_trigger | contact_trigger

    run_mpc = change
    mpc_available = state.mpc_available & ~change
    gait_domain = state.gait_domain + change.to(torch.int32)
    loco_tick = torch.where(change, 0.0, state.loco_tick)
    phase = torch.where(change, 0.0, phase)

    # COM trajectory and planning
    sites = rbd.site_positions(model, q)
    toe_pos = sites[:, a1.TOE_SITES]
    hip_pos = sites[:, a1.HIP_SITES]
    planner = state.planner
    if gait == Gait.STAND:
        toe_t = toe_pos.transpose(1, 2)
        planner = planner._replace(
            com_des=motion.stand_com(motion_cfg, planner, phase),
            toe_init=toe_t, toe_final=toe_t)
        con = contact.set_des_domain(con, torch.ones_like(con.des))
    elif gait == Gait.POSE:
        # all-stance oscillation about the stand pose, locked at stand_from
        # and the stand height, at the time of the tick before a reset
        lock = torch.zeros_like(planner.com_des)
        lock[:, 0:2] = planner.stand_from[:, 0:2]
        lock[:, 2] = motion_cfg.stand_height
        planner = planner._replace(
            com_des=motion.pose_com(motion_cfg, motion_cfg.pose_type,
                                    state.loco_tick * 1e-3, 0.0, lock),
            toe_init=torch.where(change[:, None, None],
                                 toe_pos.transpose(1, 2), planner.toe_init))
        con = contact.set_des_domain(con, torch.ones_like(con.des))
    else:
        if gait in (Gait.WALK, Gait.PACE):
            # no MPC: the COM reference integrates the ramped command
            rot = tf.rot_xyz(q[:, 3:6])
            planner = motion.com_des_from_velocity(
                planner, q[:, 0:2], rot, motion_cfg.stand_height)
            args = (toe_pos, qd[:, 0:3], rot, motion_cfg.fwd_speed,
                    motion_cfg.lat_speed)
            planner = (motion.plan_walk(motion_cfg, planner, change, *args)
                       if gait == Gait.WALK else
                       motion.plan_pace(motion_cfg, planner, change,
                                        con.des, *args))
        elif gait == Gait.INPLACE_TROT:
            planner = motion.plan_inplace_trot(motion_cfg, planner, change,
                                               con.des, toe_pos, hip_pos)
        elif gait == Gait.INPLACE_WALK:
            planner = motion.plan_inplace_walk(motion_cfg, planner, change,
                                               toe_pos)
        elif gait == Gait.TAP:
            planner = motion.plan_tap(motion_cfg, planner, change, toe_pos)
        else:
            com_vals = eval_com_traj(
                state._replace(mpc_available=mpc_available), phase,
                motion_cfg.max_phase)
            com_traj = torch.stack([q[:, 0] + 0.001 * com_vals[:, 1],
                                    q[:, 1] + 0.001 * com_vals[:, 3],
                                    com_vals[:, 1], com_vals[:, 3]], -1)
            planner = motion.set_com_des(planner, com_traj,
                                         motion_cfg.stand_height)
            planner = motion.plan_trot(motion_cfg, planner, change, con.des,
                                       toe_pos, qd[:, 0:2], state.mpc_states)
        con = contact.select(
            change, contact.set_des_domain(con, planner.des_domain), con)
        planner = motion.update_toe_final(planner, change, con.ind,
                                          con.ind_prev, toe_pos)

    # virtual constraints and the LL QP
    ci = con.ind.to(dtype)
    sj, jdqd = rbd.site_jacobians_and_jdot_qd(model, q, qd)
    traj = lowlevel.TrajIn(
        com_des=planner.com_des,
        toe_init=planner.toe_init,
        step_len=planner.step_len,
        dom_ticks=(torch.full((bsz,), dom_ticks_gait, dtype=dtype,
                              device=q.device)
                   if gait == Gait.TROT else planner.dom_ticks),
        toe_offset_z=torch.tensor(motion_cfg.toe_offset_z, dtype=dtype),
    )
    vc = lowlevel.virtual_constraints(
        ll_cfg, motion_cfg, q, qd, ci, phase, traj, state.prev_ddq,
        toe_pos, sj[:, a1.TOE_SITES], jdqd[:, a1.TOE_SITES],
        hip_pos, sj[:, a1.HIP_SITES], jdqd[:, a1.HIP_SITES],
    )
    if f_des is None:
        f_des = torch.zeros((bsz, 12), dtype=dtype, device=q.device)
    build = lowlevel.ll_qp_build_reduced if reduced else lowlevel.ll_qp_build
    data, ll_ctx = build(ll_cfg, model, q, qd, ci, vc, f_des, d_inv=d_inv)
    state_pre = AgentState(
        loco_tick=loco_tick + 1.0,
        gait_domain=gait_domain,
        planner=planner,
        con=con,
        mpc_alpha=state.mpc_alpha,
        mpc_states=state.mpc_states,
        mpc_available=mpc_available,
        prev_ddq=state.prev_ddq,
    )
    return data, TickCtx(vc, ll_ctx, state_pre, run_mpc)


def tick_finish(ll_cfg: LowLevelConfig, ctx: TickCtx, q, qd, sol_x,
                converged, reduced: bool = False, delta=None):
    """Complete the tick from the solved LL QP: the torques and the state
    update. delta: (B, 12, 12) inverse of the swing operational-space
    matrix. reduced: ctx is of the reduced build. Returns (ll_out,
    new_state, run_mpc)."""
    finish = (lowlevel.ll_qp_finish_reduced if reduced
              else lowlevel.ll_qp_finish)
    ll_out = finish(ll_cfg, ctx.ll_ctx, q, qd, ctx.vc, sol_x, converged,
                    delta=delta)
    return (ll_out, ctx.state_pre._replace(prev_ddq=ll_out.ddq),
            ctx.run_mpc)


def tick(ll_cfg: LowLevelConfig, motion_cfg: MotionConfig, qp_cfg: QpConfig,
         model: rbd.Model, gait: Gait, state: AgentState, q, qd, foot_force,
         force_new_domain=None, force_thresh: float = 15.0, f_des=None,
         allow_contact_trigger: bool = True):
    """One control tick per agent lane: `tick_build`, the dense per-problem
    IPM (`srbx_torch.ops.qp.solve`) on each lane's LL QP, `tick_finish`.
    force_new_domain: None (no forced change), a bool for all lanes or a
    (B,) mask. D^-1 and the swing operational-space inverse are LU
    inverses, as the JAX package's per-lane build and finish compute them;
    matrix products run in full float32 (no TF32).

    Returns (ll_out, new_state, run_mpc)."""
    from srbx_torch.ops import qp
    from srbx_torch.ops.qp_batch import full_f32_products

    with full_f32_products():
        d_inv = torch.linalg.inv_ex(rbd.mass_matrix(model, q))[0]
        data, ctx = tick_build(
            ll_cfg, motion_cfg, model, gait, state, q, qd, foot_force,
            force_new_domain=(False if force_new_domain is None
                              else force_new_domain),
            force_thresh=force_thresh, f_des=f_des,
            allow_contact_trigger=allow_contact_trigger, d_inv=d_inv)
        sol = qp.solve(data.P, data.c, data.A, data.b, data.G, data.h, qp_cfg)
        delta = torch.linalg.inv_ex(lowlevel.swing_delta_inv(ctx.ll_ctx))[0]
        return tick_finish(ll_cfg, ctx, q, qd, sol.x, sol.converged,
                           delta=delta)
