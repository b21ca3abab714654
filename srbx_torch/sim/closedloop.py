"""Full-fidelity closed loop, batched over lanes: stand-up, then trot
domains under the event-cadence NMPC.

Counterpart of `srbx/sim/closedloop.py::run_batch`. Every 1 ms tick of
every lane builds the 43-variable low-level QP (`agent.tick_build`), solves
all lanes' QPs in one call of the general fused IPM (kernel K1b), inverts
the 18x18 mass matrix and the 12x12 swing operational-space matrix
(kernel K2b) and runs the physics substeps, each solving D qdd = rhs
(kernel K2a). At each gait-domain boundary the batched NMPC cycle runs
(`mpc_batch.run_nmpc_batch`, kernel K1a). The JAX package's `lax.scan`s
are Python loops here.

Matrix products run in full float32 (no TF32), as the JAX package asks with
`default_matmul_precision("highest")` around the tick.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from srbx_torch import agent as agent_mod
from srbx_torch import motion as motion_mod
from srbx_torch import mpc as mpc_mod
from srbx_torch import mpc_batch
from srbx_torch.config import (Gait, LowLevelConfig, MotionConfig, MpcConfig,
                               QpConfig)
from srbx_torch.lowlevel import swing_delta_inv
from srbx_torch.models import a1, rbd
from srbx_torch.ops import qp_batch, spd
from srbx_torch.sim import wholebody as wb


class LoopConfig(NamedTuple):
    stand_ticks: int = 1000
    n_domains: int = 40
    ticks_per_domain: int = 172   # 4 grids x 43 ms
    # ticks until a domain's NMPC solution arrives; until then the LL runs
    # on the stale-Bezier fallback
    mpc_latency_ticks: int = 0


class LoopResult(NamedTuple):
    """Batched closed-loop result; every field has a leading lane axis B."""

    sim: wb.SimState
    agent: agent_mod.AgentState
    com_hist: torch.Tensor      # (B, n_domains, ticks, 3)
    qp_ok: torch.Tensor         # (B,) share of converged LL QPs
    mpc_ok: torch.Tensor        # (B,) share of converged MPC cycles
    tau_hist: torch.Tensor      # (B, n_domains, 2) max |tau|, LL qp_ok
    est_rmse: Optional[torch.Tensor] = None   # estimation in the loop only


def _tick_batch(ll_cfg, motion_cfg, qp_cfg, model, gait, states, qs, qds,
                forces, force_new_domain=False, allow_contact_trigger=True,
                reduced=False, return_d=False):
    """One control tick for every lane: tick_build, ONE fused LL-QP solve
    over all lanes, tick_finish. D^-1 and the swing operational-space
    inverse run through `spd.inverse` (K2b). return_d: also return the
    (B, 18, 18) mass matrices at qs, which the plant reuses for its first
    substep."""
    d_b = rbd.mass_matrix(model, qs)
    data, ctx = agent_mod.tick_build(
        ll_cfg, motion_cfg, model, gait, states, qs, qds, forces,
        force_new_domain=force_new_domain,
        allow_contact_trigger=allow_contact_trigger, reduced=reduced,
        d_inv=spd.inverse(d_b))
    sol = qp_batch.solve(data.P, data.c, data.A, data.b, data.G, data.h,
                         qp_cfg, backend="fused")
    delta_b = spd.inverse(swing_delta_inv(ctx.ll_ctx))
    out = agent_mod.tick_finish(ll_cfg, ctx, qs, qds, sol.x, sol.converged,
                                reduced=reduced, delta=delta_b)
    return out + (d_b,) if return_d else out


def _resolve_ll_qp_cfg(qp_cfg, ll_qp_cfg):
    """The LL solver config: the caller's, else qp_cfg. The full LL QP runs
    raw in every dtype; only the reduced build (not ported) adds Ruiz
    sweeps in float32 in the JAX package."""
    return qp_cfg if ll_qp_cfg is None else ll_qp_cfg


def _init_lanes(motion_cfg, loop, model, a0_l, dtype, stiction=False):
    """Per-lane crouch start: sim state, agent state with the stand
    planner armed, MPC carry."""
    if stiction:
        raise NotImplementedError(
            "srbx_torch does not port the stick-slip contact model")
    bsz = a0_l.shape[0]
    q0 = wb.default_crouch(model, dtype, a0_l.device).repeat(bsz, 1)
    q0 = torch.cat([q0[:, 0:2] + a0_l.to(dtype), q0[:, 2:]], 1)
    sim = wb.SimState(q0, torch.zeros_like(q0))
    ast = agent_mod.init(motion_cfg, model, q0, dtype)
    ast = ast._replace(planner=ast.planner._replace(
        stand_from=q0[:, 0:3],
        dom_ticks=torch.full((bsz,), float(loop.stand_ticks), dtype=dtype,
                             device=q0.device)))
    return sim, ast, mpc_mod.init_carry(a0_l, dtype)


def _ctrl_inputs(sim_cfg, model, sims):
    """The controller's view of the state for one tick: ground truth (the
    estimation pipeline is not ported) and the measured foot forces."""
    return sims.q, sims.qd, wb.foot_force_measurement(sim_cfg, model, sims)


def _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop, model, sims,
                 asts):
    """The batched stand-up ticks."""
    for _ in range(loop.stand_ticks):
        qs, qds, forces = _ctrl_inputs(sim_cfg, model, sims)
        ll_outs, asts, _, d_b = _tick_batch(
            ll_cfg, motion_cfg, ll_qp_cfg, model, Gait.STAND, asts, qs, qds,
            forces, return_d=True)
        sims = wb.step_batch(sim_cfg, model, sims, ll_outs.tau, d0=d_b)
    return sims, asts


def run_batch(
    mpc_cfg: MpcConfig,
    ll_cfg: LowLevelConfig,
    motion_cfg: MotionConfig,
    qp_cfg: QpConfig,
    sim_cfg: wb.SimConfig,
    loop: LoopConfig,
    model: rbd.Model,
    pr_agent,        # (B, 2, T)
    prd_agent,       # (B, 2, T)
    agent_initial,   # (B, 2)
    pobs_real,       # (B, 2, n_obs)
    dtype=torch.float64,
    backend: str = "fused",
    tile: int = 256,
    ll_reduced: bool = False,
    ll_qp_cfg: QpConfig | None = None,
    est_cfg=None,
    est_key=None,
    stiction: bool = False,
    push=None,
    device=None,
) -> LoopResult:
    """Batched full-fidelity loop; the JAX package's `run_batch` with the
    lane axis inside, plus `device` (None means the CUDA card; the inputs
    are moved there). `tile` is the TPU kernels' lane tile and is not read.

    Ported: backend="fused", ll_reduced=False, est_cfg=None,
    stiction=False, push=None, and the NMPC's condensed lanes-last branch
    (mpc_cfg.condensed, elide_simplex and use_sqp). Anything else raises
    NotImplementedError.
    """
    unported = {"backend": backend != "fused", "ll_reduced": ll_reduced,
                "est_cfg": est_cfg is not None, "stiction": stiction,
                "push": push is not None}
    if any(unported.values()):
        raise NotImplementedError(
            "srbx_torch ports run_batch with backend='fused', "
            "ll_reduced=False, est_cfg=None, stiction=False, push=None; "
            f"not {[k for k, v in unported.items() if v]} (ROADMAP M7, M8)")
    if not (mpc_cfg.condensed and mpc_cfg.elide_simplex and mpc_cfg.use_sqp):
        raise NotImplementedError(
            "srbx_torch's NMPC inside run_batch is the condensed lanes-last "
            "branch: MpcConfig(condensed=True, elide_simplex=True, "
            "use_sqp=True); the generic branch needs K1b instantiations "
            "for the NMPC's shapes (ROADMAP Next 2)")
    device = torch.device("cuda" if device is None else device)

    def on_dev(t):
        return torch.as_tensor(t).to(device=device, dtype=dtype)

    pr_agent, prd_agent, agent_initial, pobs_real = map(
        on_dev, (pr_agent, prd_agent, agent_initial, pobs_real))
    ll_qp_cfg = _resolve_ll_qp_cfg(qp_cfg, ll_qp_cfg)
    with qp_batch.full_f32_products():
        return _run(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg, sim_cfg,
                    loop, model, pr_agent, prd_agent, agent_initial,
                    pobs_real, dtype, backend, device)


def _run(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg, sim_cfg, loop, model,
         pr_agent, prd_agent, agent_initial, pobs_real, dtype, backend,
         device):
    """run_batch's stand phase and trot domains, on checked inputs."""
    sims, asts, mcarries = _init_lanes(motion_cfg, loop, model, agent_initial,
                                       dtype)
    sims, asts = _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop,
                              model, sims, asts)

    ok_cnt = torch.zeros(agent_initial.shape[0], dtype=torch.int32,
                         device=device)
    com_hist, stats = [], []
    for _ in range(loop.n_domains):
        # HL replan at the domain boundary, for the upcoming stance pair
        toe_xy = rbd.site_positions(model, sims.q)[:, a1.TOE_SITES, 0:2]
        contact_ind = motion_mod.next_trot_domain(asts.con.des).to(dtype)
        out = mpc_batch.run_nmpc_batch(
            mpc_cfg, qp_cfg, mcarries, sims.q[:, 0:2], sims.qd[:, 0:2],
            toe_xy.transpose(1, 2), contact_ind, pr_agent, prd_agent,
            agent_initial, pobs_real, backend=backend)
        asts = agent_mod.set_mpc_data(asts, out.alpha_com, out.states)

        com, llok, taumax = [], [], []
        for k in range(loop.ticks_per_domain):
            qs, qds, forces = _ctrl_inputs(sim_cfg, model, sims)
            ll_outs, asts, _, d_b = _tick_batch(
                ll_cfg, motion_cfg, ll_qp_cfg, model, Gait.TROT, asts, qs,
                qds, forces, force_new_domain=(k == 0),
                allow_contact_trigger=False, return_d=True)
            asts = asts._replace(mpc_available=asts.mpc_available
                                 | (k >= loop.mpc_latency_ticks))
            sims = wb.step_batch(sim_cfg, model, sims, ll_outs.tau, d0=d_b)
            com.append(sims.q[:, 0:3])
            llok.append(ll_outs.qp_converged)
            taumax.append(ll_outs.tau.abs().amax(-1))
        mcarries = out.carry
        ok_cnt = ok_cnt + out.qp_converged.to(torch.int32)
        com_hist.append(torch.stack(com, 1))
        stats.append(torch.stack([torch.stack(taumax, 0).amax(0),
                                  torch.stack(llok, 0).to(dtype).mean(0)],
                                 -1))
    stats = torch.stack(stats, 1)                  # (B, n_domains, 2)
    return LoopResult(
        sim=sims,
        agent=asts,
        com_hist=torch.stack(com_hist, 1),
        qp_ok=stats[:, :, 1].mean(1),
        mpc_ok=ok_cnt.to(dtype) / loop.n_domains,
        tau_hist=stats,
    )
