"""Batched whole-body physics: the 18-DoF A1 on compliant ground.

Counterpart of `srbx/sim/wholebody.py` on the paths the batched closed
loops take (`step_batch`): the plant is the controller's own rigid-body
model with a spring-damper normal contact at the toe sites and viscous
tangential friction clamped to the Coulomb cone, integrated by
semi-implicit Euler in `substeps` steps per 1 ms tick. Two forms, as in the
JAX package:

* backend "xla": the JAX package's `vmap(step)`, each substep solving
  D qdd = rhs by LAPACK's Cholesky (`rbd.forward_dynamics`), D evaluated
  anew in every substep (a given `d0` is ignored);
* backend "fused" or "pallas": each substep's solve through
  `srbx_torch.ops.spd.solve` (kernel K2a on the card), the first
  substep's D optionally handed in (`d0`).

Not ported: the stick-slip tangential model (`SimState.con`, which raises
NotImplementedError) and the trunk force pulses (`base_force`).
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
    kt_stick: float = 2e4       # stick-slip anchor stiffness (not ported)
    dt_stick: float = 150.0     # stick-slip anchor damping (not ported)


class SimState(NamedTuple):
    q: torch.Tensor     # (B, 18)
    qd: torch.Tensor    # (B, 18)
    con: Optional[tuple] = None   # stick-slip contact state (not ported)


def _no_stiction(con):
    if con is not None:
        raise NotImplementedError(
            "srbx_torch does not port the stick-slip contact model "
            "(SimState.con / stiction=True)")


def contact_forces(cfg: SimConfig, model: rbd.Model, q, qd, con=None):
    """(B, 4, 3) world ground-reaction forces at the toe sites."""
    _no_stiction(con)
    pos, vel = jvp(lambda qq: rbd.site_positions(model, qq), (q,), (qd,))
    toe_pos = pos[..., a1.TOE_SITES, :]
    toe_vel = vel[..., a1.TOE_SITES, :]
    pen = -toe_pos[..., 2]
    active = pen > 0.0
    fz = torch.where(active, cfg.kn * pen - cfg.dn * toe_vel[..., 2], 0.0)
    fz = torch.clamp(fz, min=0.0)
    limit = cfg.mu * fz[..., None]
    ft_raw = -cfg.kt * toe_vel[..., 0:2] * active[..., None]
    ft_norm = torch.linalg.vector_norm(ft_raw, dim=-1, keepdim=True)
    scale = torch.where(ft_norm > limit,
                        limit / torch.clamp(ft_norm, min=1e-9), 1.0)
    return torch.cat([ft_raw * scale, fz[..., None]], -1)


def step_batch(cfg: SimConfig, model: rbd.Model, states: SimState,
               tau_joints, backend: str = "xla", d0=None) -> SimState:
    """One 1 ms tick for every lane under joint torques tau_joints (B, 12):
    the JAX package's `step_batch` without the TPU-only `tile`. d0:
    optional (B, 18, 18) mass matrices at states.q, reused by the first
    substep on the "fused" and "pallas" backends (the controller evaluated
    them at the same q) and ignored on "xla", as there: the goldens
    integrate about a thousand contact-rich ticks, where reassociating
    the first substep's solve would be amplified."""
    _no_stiction(states.con)
    if backend == "xla":
        fd, d0 = rbd.forward_dynamics, None
    elif backend in ("fused", "pallas"):
        fd = rbd.forward_dynamics_batch
    else:
        raise ValueError(f"unknown backend {backend!r}")
    dt = cfg.dt / cfg.substeps
    q, qd = states.q, states.qd
    bsz, dtype = q.shape[0], q.dtype
    tau_full = torch.cat(
        [torch.zeros((bsz, 6), dtype=dtype, device=q.device), tau_joints], -1)
    spare = torch.zeros((bsz, len(model.sites) - 4, 3), dtype=dtype,
                        device=q.device)
    for k in range(cfg.substeps):
        grf = contact_forces(cfg, model, q, qd)
        f_sites = torch.cat([grf, spare], 1)
        qdd = fd(model, q, qd, tau_full, f_ext_sites=f_sites,
                 d=d0 if k == 0 else None)
        qd = qd + dt * qdd
        q = q + dt * qd
    return SimState(q, qd)


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
