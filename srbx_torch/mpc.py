"""Per-cycle event-based NMPC: one gait-domain replan per agent.

Counterpart of `srbx/mpc.py`. `run_nmpc` slices the reference window,
picks footholds (nominal before locomotion starts), assembles the LIP
tracking QP (condensed with cfg.condensed), solves it with the dense
per-problem IPM (`srbx_torch.ops.qp.solve`), adds the closest obstacle (and
optionally the neighbour agent) as CBF circles for the SCP stage
(`srbx_torch.sqp.solve`, with cfg.use_sqp), falls back to holding position
on a non-finite solution and fits the domain's Bezier. It takes a leading
lane axis of independent agents, each with the semantics `jax.vmap` of the
JAX function gives it. The batched cycle of the loops, with its kernels,
is `srbx_torch.mpc_batch.run_nmpc_batch`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from srbx_torch import sqp
from srbx_torch.config import MpcConfig, QpConfig
from srbx_torch.ocp import (assemble, condense, default_footholds, expand,
                            expansion, reference_window, unpack)
from srbx_torch.ops import qp
from srbx_torch.ops.bezier import bezier, bezier_d, fit_domain_bezier


class MpcCarry(NamedTuple):
    """State that persists across NMPC cycles."""

    gait_domain: torch.Tensor     # (B,) int32 current domain counter
    alpha_buffer: torch.Tensor    # (B, 4) previous terminal LIP state


class MpcOutput(NamedTuple):
    alpha_com: torch.Tensor       # (B, 4, 5) Bezier control points
    states: torch.Tensor          # (B, N, 4) planned LIP knots
    inputs: torch.Tensor          # (B, N, 2) planned COP knots
    carry: MpcCarry
    qp_converged: torch.Tensor    # (B,) bool, first QP
    # the first QP's iterations: () the max over lanes from run_nmpc_batch,
    # (B,) each lane's own from run_nmpc
    qp_iters: torch.Tensor
    cbf_margin: torch.Tensor      # (B,) min squared-distance margin
    x: Optional[torch.Tensor] = None   # (B, n) full decision vector


def init_carry(agent_initial, dtype=torch.float64) -> MpcCarry:
    """Fresh carry: alpha buffer at the agents' start xy with zero velocity.
    agent_initial (..., 2)."""
    a = agent_initial.to(dtype)
    zero = torch.zeros_like(a[..., 0])
    buf = torch.stack([a[..., 0], zero, a[..., 1], zero], -1)
    dom = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    return MpcCarry(dom, buf)


def hold_position_x(cfg: MpcConfig, x0, contact_ind):
    """Per-lane 'hold position' decision vectors: states pinned at the
    current position with zero velocity, COP at the COM, uniform lambda
    over present legs, zero slack. x0 (B, 4), contact_ind (B, 4) -> (B, n).
    The fallback for a lane whose solve went non-finite."""
    dtype = x0.dtype
    zero = torch.zeros_like(x0[:, 0])
    st = torch.stack([x0[:, 0], zero, x0[:, 2], zero], 1)
    states = st.repeat(1, cfg.horizon)
    cop = torch.stack([x0[:, 0], x0[:, 2]], 1).repeat(1, cfg.horizon)
    ci = contact_ind.to(dtype)
    lam = (ci / ci.sum(-1, keepdim=True).clamp(min=1.0)).repeat(
        1, cfg.ndomain)
    return torch.cat([states, cop, lam, torch.zeros_like(x0[:, :1])], 1)


def closest_obstacle(q_xy, pobs):
    """Position (B, 2) and distance (B,) of the obstacle closest to each
    lane. q_xy (B, 2); pobs (B, 2, n_obs). Ties go to the first obstacle,
    as with jnp.argmin."""
    diff = pobs - q_xy[:, :, None]
    d2 = (diff * diff).sum(1)
    idx = d2.argmin(-1)
    pos = pobs.gather(2, idx[:, None, None].expand(-1, 2, 1))[:, :, 0]
    return pos, torch.sqrt(d2.gather(1, idx[:, None])[:, 0])


def nmpc_qp_inputs(cfg: MpcConfig, carry: MpcCarry, q_xy, dq_xy, toe_xy,
                   contact_ind, pr_agent, prd_agent, agent_initial):
    """The (x0 (B, 4), ref (B, 4, N), foothold_xy (B, 2, 4), ci (B, 4))
    that run_nmpc hands to ocp.assemble: the nominal footholds and all
    legs in stance while gait_domain <= 1 (before locomotion starts)."""
    x0 = torch.stack([q_xy[:, 0], dq_xy[:, 0], q_xy[:, 1], dq_xy[:, 1]], 1)
    ref = reference_window(pr_agent, prd_agent, 0, carry.gait_domain,
                           cfg.horizon)
    nominal = default_footholds(agent_initial.to(q_xy.dtype))
    use_nominal = carry.gait_domain <= 1
    foothold_xy = torch.where(use_nominal[:, None, None], nominal, toe_xy)
    ci = torch.where(use_nominal[:, None], torch.ones_like(contact_ind),
                     contact_ind)
    return x0, ref, foothold_xy, ci


def run_nmpc(cfg: MpcConfig, qp_cfg: QpConfig, carry: MpcCarry, q_xy, dq_xy,
             toe_xy, contact_ind, pr_agent, prd_agent, agent_initial,
             pobs_real, state_other: Optional[torch.Tensor] = None,
             agent_circle_eps: float = 0.0) -> MpcOutput:
    """One NMPC cycle per agent lane.

    carry: MpcCarry (B,), (B, 4); q_xy, dq_xy (B, 2) COM position and
    velocity; toe_xy (B, 2, 4) footholds; contact_ind (B, 4) the upcoming
    domain's stance mask; pr_agent, prd_agent (B, 2, T) the agent's APF
    references; agent_initial (B, 2); pobs_real (B, 2, n_obs) the true
    obstacles; state_other: optional (B, 4) neighbour state (x, y, dx, dy),
    a second CBF circle, active when agent_circle_eps > 0. qp_converged and
    qp_iters are each lane's first QP's; cbf_margin the least
    squared-distance margin over circles and knots."""
    dtype = q_xy.dtype
    x0, ref, foothold_xy, ci = nmpc_qp_inputs(
        cfg, carry, q_xy, dq_xy, toe_xy, contact_ind, pr_agent, prd_agent,
        agent_initial)
    data = assemble(cfg, x0, ref.to(dtype), foothold_xy, ci, dtype=dtype)
    if cfg.condensed:
        e_mat, e0 = expansion(cfg, x0, foothold_xy, ci, dtype=dtype)
        data_s = condense(cfg, data, e_mat, e0)
        qp_sol = qp.solve(*data_s, qp_cfg)
        x = expand(e_mat, e0, qp_sol.x)
    else:
        e_mat = e0 = None
        data_s = data
        qp_sol = qp.solve(*data, qp_cfg)
        x = qp_sol.x

    obs_xy, _ = closest_obstacle(q_xy, pobs_real.to(dtype))
    bsz = q_xy.shape[0]
    if state_other is None:
        circles = obs_xy[:, None, :]
        mask = torch.ones(bsz, 1, dtype=dtype, device=q_xy.device)
    else:
        circles = torch.stack([obs_xy, state_other[:, :2].to(dtype)], 1)
        mask = torch.tensor([1.0, 1.0 if agent_circle_eps > 0 else 0.0],
                            dtype=dtype, device=q_xy.device).expand(bsz, 2)

    if cfg.use_sqp:
        x = sqp.solve(cfg, qp_cfg, data_s, x, circles, mask, full_data=data,
                      e_mat=e_mat, e0=e0, contact_ind=ci).x

    # the per-agent fallback: a non-finite solution holds position
    x = torch.where(torch.isfinite(x).all(-1, keepdim=True), x,
                    hold_position_x(cfg, x0, ci))
    states, inputs, _, _ = unpack(cfg, x)
    knots = torch.cat([carry.alpha_buffer[:, :, None],
                       states.transpose(1, 2)], 2)
    alpha_com = fit_domain_bezier(knots)
    new_carry = MpcCarry(carry.gait_domain + 1, states[:, -1])
    margin = sqp.cbf_margins(cfg, x, circles).amin((1, 2))
    return MpcOutput(alpha_com, states, inputs, new_carry, qp_sol.converged,
                     qp_sol.iters, margin)


def eval_com_traj(alpha_com, s):
    """The fitted domain Bezier alpha_com (B, 4, 5) at phase s (B,):
    (com_xy, dcom_xy, ddcom_xy), each (B, 2). Position rows (0, 2) and
    velocity rows (1, 3) are separate fitted channels; the acceleration is
    the phase derivative of the velocity channel."""
    vals = bezier(alpha_com, s[:, None])                  # (B, 4)
    dvel = bezier_d(alpha_com[:, [1, 3]], s[:, None])
    return vals[:, [0, 2]], vals[:, [1, 3]], dvel
