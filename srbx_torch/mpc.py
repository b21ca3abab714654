"""Carry, output and per-lane helpers of the event-based NMPC cycle.

Counterpart of the types and helpers of `srbx/mpc.py`; the batched cycle
itself is `srbx_torch.mpc_batch.run_nmpc_batch`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from srbx_torch.config import MpcConfig


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
    qp_iters: torch.Tensor        # () int32, first QP's iterations (max)
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
