"""Batched whole-body physics: the 18-DoF A1 on compliant ground.

Counterpart of `srbx/sim/wholebody.py`: `step`, the per-agent plant, and
`step_batch`, the batched loops'. The plant is the controller's own
rigid-body model with a spring-damper normal contact at the toe sites and
viscous tangential friction clamped to the Coulomb cone, integrated by
semi-implicit Euler in `substeps` steps per 1 ms tick. With a contact
state (`SimState.con`, `init_contact_state`) the tangential force is the
JAX package's stick-slip model instead: an anchor-point spring-damper per
toe that drags its anchor when the friction cone saturates (kinetic slip,
accumulated per toe) and re-anchors at the toe when contact breaks. A
trunk force (`base_force`, the reference's disturbance generator) adds to
the generalised force's first three rows. `step` solves each substep by
the lane's own Cholesky (`rbd.forward_dynamics`) and reuses a given `d0`
in its first substep; `step_batch` has two forms, as in the JAX package:

* backend "xla": the JAX package's `vmap(step)`, each substep solving
  D qdd = rhs by LAPACK's Cholesky (`rbd.forward_dynamics`), D evaluated
  anew in every substep (a given `d0` is ignored);
* backend "fused" or "pallas": each substep's solve through
  `srbx_torch.ops.spd.solve` (kernel K2a on the card), the first
  substep's D optionally handed in (`d0`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import jvp

from srbx_torch.models import a1, rbd


@dataclasses.dataclass(frozen=True)
class SimConfig:
    dt: float = 1e-3            # control tick
    substeps: int = 2           # integration substeps per tick
    kn: float = 4e4             # ground normal stiffness
    dn: float = 400.0           # ground normal damping
    kt: float = 600.0           # tangential viscous coefficient
    mu: float = 0.6             # ground friction
    kt_stick: float = 2e4       # stick-slip anchor stiffness
    dt_stick: float = 150.0     # stick-slip anchor damping


class ContactState(NamedTuple):
    """Stick-slip tangential contact state, per lane and toe."""

    anchor: torch.Tensor    # (B, 4, 2) world xy of each toe's spring anchor
    slip: torch.Tensor      # (B, 4) cumulative slip distance (m)


class SimState(NamedTuple):
    q: torch.Tensor     # (B, 18)
    qd: torch.Tensor    # (B, 18)
    # the stick-slip contact state; None runs the viscous tangential model
    con: Optional[ContactState] = None


def init_contact_state(model: rbd.Model, q) -> ContactState:
    """Anchors at the current toe xy of lanes q (B, 18), zero slip."""
    toe_xy = rbd.site_positions(model, q)[:, a1.TOE_SITES, 0:2]
    return ContactState(toe_xy, torch.zeros(toe_xy.shape[:2], dtype=q.dtype,
                                            device=q.device))


def contact_forces(cfg: SimConfig, model: rbd.Model, q, qd, con=None):
    """(B, 4, 3) world ground-reaction forces at the toe sites.

    con=None: the viscous tangential model (returns the forces only).
    con=ContactState: the anchor-point stick-slip model, returning (forces,
    new ContactState). A sticking toe pulls toward its anchor with a
    spring-damper; where that force leaves the friction cone it is scaled
    onto the cone and the anchor is dragged to where the spring carries
    exactly that force (kinetic slip), the drag adding to the toe's slip; a
    toe out of contact re-anchors at its own xy."""
    pos, vel = jvp(lambda qq: rbd.site_positions(model, qq), (q,), (qd,))
    toe_pos = pos[..., a1.TOE_SITES, :]
    toe_vel = vel[..., a1.TOE_SITES, :]
    pen = -toe_pos[..., 2]
    active = pen > 0.0
    fz = torch.where(active, cfg.kn * pen - cfg.dn * toe_vel[..., 2], 0.0)
    fz = torch.clamp(fz, min=0.0)
    limit = cfg.mu * fz[..., None]
    p_xy = toe_pos[..., 0:2]
    if con is None:
        ft_raw = -cfg.kt * toe_vel[..., 0:2] * active[..., None]
    else:
        ft_raw = (-cfg.kt_stick * (p_xy - con.anchor)
                  - cfg.dt_stick * toe_vel[..., 0:2]) * active[..., None]
    ft_norm = torch.linalg.vector_norm(ft_raw, dim=-1, keepdim=True)
    slipping = ft_norm > limit                               # (B, 4, 1)
    scale = torch.where(slipping, limit / torch.clamp(ft_norm, min=1e-9),
                        1.0)
    ft = ft_raw * scale
    if con is None:
        return torch.cat([ft, fz[..., None]], -1)
    # kinetic slip: the anchor moves so that the spring carries the
    # clamped force
    anchor_slip = p_xy + ft / cfg.kt_stick
    anchor_new = torch.where(active[..., None],
                             torch.where(slipping, anchor_slip, con.anchor),
                             p_xy)
    drag = torch.linalg.vector_norm(anchor_new - con.anchor, dim=-1)
    slip_new = con.slip + torch.where(active & slipping[..., 0], drag, 0.0)
    grf = torch.cat([ft, fz[..., None]], -1)
    return grf, ContactState(anchor_new, slip_new)


def step_batch(cfg: SimConfig, model: rbd.Model, states: SimState,
               tau_joints, backend: str = "xla", base_force=None,
               d0=None) -> SimState:
    """One 1 ms tick for every lane under joint torques tau_joints (B, 12):
    the JAX package's `step_batch` without the TPU-only `tile`.

    base_force: optional (B, 3) world force on each lane's trunk, added to
    rows 0:3 of the generalised force for the whole tick. states.con: the
    stick-slip contact state, threaded through every substep and returned
    in the new state (None keeps the viscous model). d0: optional
    (B, 18, 18) mass matrices at states.q, reused by the first substep on
    the "fused" and "pallas" backends (the controller evaluated them at the
    same q) and ignored on "xla", as there: the goldens integrate about a
    thousand contact-rich ticks, where reassociating the first substep's
    solve would be amplified."""
    if backend == "xla":
        fd, d0 = rbd.forward_dynamics, None
    elif backend in ("fused", "pallas"):
        fd = rbd.forward_dynamics_batch
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return _integrate(cfg, model, states, tau_joints, fd, base_force, d0)


def step(cfg: SimConfig, model: rbd.Model, state: SimState, tau_joints,
         base_force=None, d0=None) -> SimState:
    """One 1 ms tick per lane under joint torques tau_joints (B, 12): the
    JAX package's single-plant `step`, each substep's D qdd = rhs solved by
    the lane's own Cholesky (`rbd.forward_dynamics`). base_force: optional
    (B, 3) world force on each trunk; state.con: the stick-slip contact
    state, threaded through every substep; d0: optional (B, 18, 18) mass
    matrices at state.q, used by the first substep only (the controller
    evaluated them at the same q)."""
    return _integrate(cfg, model, state, tau_joints, rbd.forward_dynamics,
                      base_force, d0)


def _integrate(cfg, model, states, tau_joints, fd, base_force, d0):
    """cfg.substeps semi-implicit Euler steps, the forward dynamics by fd,
    d0 (or None) the first substep's mass matrices."""
    dt = cfg.dt / cfg.substeps
    q, qd, con = states.q, states.qd, states.con
    bsz, dtype = q.shape[0], q.dtype
    base = (torch.zeros((bsz, 6), dtype=dtype, device=q.device)
            if base_force is None else torch.cat(
                [base_force.to(dtype), torch.zeros((bsz, 3), dtype=dtype,
                                                   device=q.device)], -1))
    tau_full = torch.cat([base, tau_joints], -1)
    spare = torch.zeros((bsz, len(model.sites) - 4, 3), dtype=dtype,
                        device=q.device)
    for k in range(cfg.substeps):
        if con is None:
            grf = contact_forces(cfg, model, q, qd)
        else:
            grf, con = contact_forces(cfg, model, q, qd, con)
        f_sites = torch.cat([grf, spare], 1)
        qdd = fd(model, q, qd, tau_full, f_ext_sites=f_sites,
                 d=d0 if k == 0 else None)
        qd = qd + dt * qdd
        q = q + dt * qd
    return SimState(q, qd, con)


def foot_force_measurement(cfg: SimConfig, model: rbd.Model,
                           state: SimState):
    """(B, 4) normal foot forces (N): the foot-force sensor reading."""
    return contact_forces(cfg, model, state.q, state.qd)[..., 2]


def default_crouch(model: rbd.Model, dtype=torch.float64, device=None):
    """(18,) crouched start configuration, toes 1 mm above the ground.
    device=None means the CUDA card."""
    device = "cuda" if device is None else device
    q = torch.zeros(18, dtype=dtype, device=device)
    q[7::3] = 1.1      # thighs
    q[8::3] = -2.3     # calves
    toe_z = rbd.site_positions(model, q)[a1.TOE_SITES, 2].min()
    q[2] = -toe_z + 0.001
    return q
