"""Artificial-potential-field multi-agent reference planner.

Counterpart of `srbx/refplan.py`: a damped double-integrator rollout of
`loop_size` steps under goal attraction, obstacle repulsion and
Lennard-Jones inter-agent forces, downsampled into the per-grid reference
knots (Pr, Prd) that the NMPC cycle slices its window from. One call rolls
one obstacle field or a batch of them (a leading scenario axis, the
campaign's). The rollout is a loop of small tensor operations on static
buffers; on the card one knot's steps are captured in a CUDA graph and
replayed, the analogue of the JAX package's `lax.scan`. It runs once,
before any control cycle.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from srbx_torch.config import RefPlanConfig


class RefTraj(NamedTuple):
    pr: torch.Tensor    # ([S,] 2*n_agents, T) downsampled positions
    prd: torch.Tensor   # ([S,] 2*n_agents, T) downsampled velocities


@functools.lru_cache(maxsize=None)
def discretize(c: float, m: float, ts: float):
    """Exact ZOH of the damped double integrator, per axis:
    Ad = [[1, (1-e)/a], [0, e]], Bd = [[(a ts - 1 + e)/(a^2 m)], [(1-e)/(a m)]]
    with a = c/m, e = exp(-a ts)."""
    a = c / m
    e = np.exp(-a * ts)
    ad = np.array([[1.0, (1.0 - e) / a], [0.0, e]])
    bd = np.array([[(a * ts - 1.0 + e) / (a * a * m)], [(1.0 - e) / (a * m)]])
    return ad, bd


def _ipow(x, k: int):
    """x**k by repeated squaring, in the multiplication order of
    `jax.lax.integer_pow`, so both packages round alike."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _forces(cfg: RefPlanConfig, pos, pobs, goal, not_self):
    """APF force per agent. pos: (..., n_agents, 2); pobs: (..., n_obs, 2)
    with the same leading (scenario) axes; goal (2,) and not_self
    (n_agents, n_agents), 0 on the diagonal, are built once per rollout.

    Goal attraction, obstacle repulsion inside dmin, Lennard-Jones 6-12
    inter-agent interaction, and zero force within 1 mm of the goal.
    """
    to_goal = pos - goal
    d_goal = _norm(to_goal)[..., None]
    f_att = -cfg.alpha * to_goal / d_goal.clamp(min=1e-12)

    diff = pos[..., :, None, :] - pobs[..., None, :, :]  # (..., na, n_obs, 2)
    d = _norm(diff)
    d_safe = d.clamp(min=1e-9)
    rep_mag = torch.where(
        d < cfg.dmin,
        cfg.eta * (1.0 / d_safe - 1.0 / cfg.dmin) / _ipow(d_safe, 2),
        0.0,
    )
    f_rep = (rep_mag[..., None] * diff / d_safe[..., None]).sum(-2)

    # Self-pairs are masked out, but their distance is set to a benign value
    # BEFORE the 7th and 13th powers: at the tiny guard d^13 underflows f32
    # to 0, and the inf that follows would turn into NaN under the 0-mask.
    adiff = pos[..., :, None, :] - pos[..., None, :, :]
    ad = _norm(adiff)
    ad_safe = torch.where(not_self > 0, ad, 1.0).clamp(min=1e-4)
    eps, sig = cfg.lj_epsilon, cfg.lj_sigma
    lj_mag = -4.0 * eps * (
        6.0 * sig**6 / _ipow(ad_safe, 7) - 12.0 * sig**12 / _ipow(ad_safe, 13)
    )
    f_agent = ((lj_mag * not_self)[..., None] * adiff
               / ad_safe[..., None]).sum(-2)

    f = f_att + f_rep + f_agent
    return torch.where(d_goal < 0.001, 0.0, f)


def resolve_matrices(cfg: RefPlanConfig, dtype=torch.float64, device=None):
    """Per-axis discrete (Ad, Bd): the literal reference matrices when
    cfg.ad_ref is set, else the exact ZOH closed form. device=None means
    the CUDA card."""
    device = "cuda" if device is None else device
    if cfg.ad_ref:
        ad = np.array([[1.0, cfg.ad_ref[0]], [0.0, cfg.ad_ref[1]]])
        bd = np.array([[cfg.bd_ref[0]], [cfg.bd_ref[1]]])
    else:
        ad, bd = discretize(cfg.damping_c, cfg.mass_m, cfg.ts)
    return (torch.as_tensor(ad, dtype=dtype, device=device),
            torch.as_tensor(bd, dtype=dtype, device=device))


def _replay(block, n: int, device):
    """Run `block` n times: eagerly off the card; on the card once eagerly
    (which also loads its kernels), then captured in a CUDA graph (the
    capture runs nothing) and replayed n - 1 times. The block's buffers are
    the graph's static memory."""
    if device.type != "cuda" or n <= 1:
        for _ in range(n):
            block()
        return
    block()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        block()
    for _ in range(n - 1):
        graph.replay()


def generate(cfg: RefPlanConfig, p_start, pobs, dtype=torch.float64,
             return_raw: bool = False, device=None) -> RefTraj:
    """Roll the APF planner and downsample.

    p_start: (2*n_agents,) starting xy per agent; pobs: (2, n_obs), or
    (S, 2, n_obs) for S obstacle fields rolled at once (the JAX package's
    `vmap(generate)` over fields; each field's arithmetic is the same, in
    the same order). Returns RefTraj with T = ceil(loop_size / downsample)
    knots, pr and prd (2*n_agents, T), or (S, 2*n_agents, T) for a batch
    of fields (the reference's 2-knot lead-in is reproduced by shifting and
    edge-padding the tail). On the card the rollout is one CUDA graph of
    `downsample` steps, replayed once per knot. device=None means the CUDA
    card.

    return_raw: also return the full rollout, (RefTraj, (pos_hist,
    vel_hist)) with each of the loop_size steps' pre-step state,
    (loop_size, ..., n_agents, 2), as the JAX package returns it.
    """
    device = torch.device("cuda" if device is None else device)
    na = cfg.n_agents
    ad, bd = resolve_matrices(cfg, dtype, device)
    goal = torch.tensor(cfg.goal, dtype=dtype, device=device)
    not_self = 1.0 - torch.eye(na, dtype=dtype, device=device)
    pobs = pobs.to(dtype=dtype, device=device)
    lead = pobs.shape[:-2]                              # () or (S,)
    pobs_t = pobs.transpose(-1, -2).contiguous()        # (..., n_obs, 2)
    # a copy: the rollout writes its state in place
    pos = p_start.reshape(na, 2).to(dtype=dtype, device=device).expand(
        *lead, na, 2).clone(memory_format=torch.contiguous_format)
    vel = torch.zeros_like(pos)

    n_knots = -(-cfg.loop_size // cfg.downsample)
    pos_hist = torch.empty((n_knots,) + pos.shape, dtype=dtype, device=device)
    vel_hist = torch.empty_like(pos_hist)
    pos_hist[0] = pos                      # the pre-step state, every ds-th
    vel_hist[0] = vel
    step_i = torch.zeros((), dtype=dtype, device=device)   # the step index
    knot = torch.ones(1, dtype=torch.int64, device=device)  # the next knot
    n_blocks = n_knots - 1
    if return_raw:
        # every step's pre-step state; one more block covers the steps after
        # the last knot (its knot lands in a spare row)
        n_blocks = n_knots
        pos_hist = torch.cat([pos_hist, pos_hist[:1]], 0)
        vel_hist = torch.cat([vel_hist, vel_hist[:1]], 0)
        raw_pos = torch.empty((n_knots * cfg.downsample,) + pos.shape,
                              dtype=dtype, device=device)
        raw_vel = torch.empty_like(raw_pos)
        raw_i = torch.zeros(1, dtype=torch.int64, device=device)

    def block():
        """`cfg.downsample` steps, then the state recorded as the next
        knot, in place on the buffers above: static shapes and no host
        values, so that on the card it is captured in a CUDA graph."""
        for _ in range(cfg.downsample):
            if return_raw:
                raw_pos.index_copy_(0, raw_i, pos[None])
                raw_vel.index_copy_(0, raw_i, vel[None])
                raw_i.add_(1)
            f = _forces(cfg, pos, pobs_t, goal, not_self)
            if cfg.ramp_up_iters > 0:
                f = f * (step_i / cfg.ramp_up_iters).clamp(max=1.0)
                step_i.add_(1.0)
            pos_n = ad[0, 0] * pos + ad[0, 1] * vel + bd[0, 0] * f
            vel.copy_(ad[1, 1] * vel + bd[1, 0] * f)
            pos.copy_(pos_n)
        pos_hist.index_copy_(0, knot, pos[None])
        vel_hist.index_copy_(0, knot, vel[None])
        knot.add_(1)

    # the steps after the last recorded knot change nothing recorded
    _replay(block, n_blocks, device)
    pos_hist, vel_hist = pos_hist[:n_knots], vel_hist[:n_knots]

    ds = torch.cat([pos_hist[2:], pos_hist[-1:], pos_hist[-1:]], 0)
    dsv = torch.cat([vel_hist[2:], vel_hist[-1:], vel_hist[-1:]], 0)
    # (T, ..., na, 2) -> (..., na, 2, T) -> (..., 2 na, T)
    perm = tuple(range(1, ds.dim())) + (0,)
    pr = ds.permute(perm).reshape(*lead, 2 * na, -1)
    prd = dsv.permute(perm).reshape(*lead, 2 * na, -1)
    if return_raw:
        return RefTraj(pr, prd), (raw_pos[:cfg.loop_size],
                                  raw_vel[:cfg.loop_size])
    return RefTraj(pr, prd)


def two_agent_config(reference_matrices: bool = False, **kw) -> RefPlanConfig:
    """2-agent planner constants; reference_matrices=True uses the literal
    hard-coded Ad/Bd instead of exact ZOH."""
    base = dict(
        n_agents=2, alpha=100.0, eta=200.0, dmin=2.0, lj_epsilon=1.0,
        lj_sigma=0.75, ramp_up_iters=0, damping_c=600.0, mass_m=8.0,
        ts=0.0010630627843875393,
    )
    if reference_matrices:
        base.update(
            ad_ref=(0.001021788129226, 0.923365890308039),
            bd_ref=(0.000000067853117956, 0.000127723516153268),
        )
    base.update(kw)
    return RefPlanConfig(**base)


def four_agent_config(reference_matrices: bool = False, **kw) -> RefPlanConfig:
    """4-agent planner constants (with a 1000-step force ramp-up);
    reference_matrices=True uses the literal hard-coded Ad/Bd."""
    base = dict(
        n_agents=4, alpha=150.0, eta=400.0, dmin=1.0, lj_epsilon=60.0,
        lj_sigma=1.0, ramp_up_iters=1000, damping_c=550.0, mass_m=8.0,
        ts=0.0010629728231878717,
    )
    if reference_matrices:
        base.update(
            ad_ref=(0.001025061239872, 0.929527039758809),
            bd_ref=(0.000000068070472960, 0.000128132654983983),
        )
    base.update(kw)
    return RefPlanConfig(**base)
