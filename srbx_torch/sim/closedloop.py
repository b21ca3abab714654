"""Full-fidelity closed loops, batched over lanes: stand-up, then trot
domains under the event-cadence NMPC.

Counterpart of `srbx/sim/closedloop.py::run_batch` and `run_team_batch`.
Every 1 ms tick of every lane builds the low-level QP (`agent.tick_build`:
the full build, n 43 / me 30, or with `ll_reduced` the reduced one, n 25 /
me 12), solves all lanes' QPs in one call of `qp_batch.solve`, finishes the
tick and runs the physics substeps. At each gait-domain boundary the batched
NMPC cycle runs (`mpc_batch.run_nmpc_batch`); in the team loop every agent's
NMPC takes its neighbour's broadcast state as a CBF circle. The JAX
package's `lax.scan`s are Python loops here. The backend picks the tick's
form, as in the JAX package:

* "fused": the LL QP through the general fused IPM (kernel K1b), D^-1 and
  the swing operational-space inverse through `spd.inverse` (K2b), the
  physics solves through `spd.solve` (K2a) with the controller's D reused
  by the first substep; the NMPC through a fused IPM too: on its condensed
  lanes-last branch kernel K1a, uncondensed K1b at (n, me) = (41, 28),
  condensed with the simplex rows kept K1b at (17, 4);
* "pallas": the same inverses and physics, the LL QP and the NMPC through
  the step-fused IPM with the Cholesky kernels K3a and K3b;
* "xla": the JAX package's per-lane form: LU inverses
  (`torch.linalg.inv_ex`), the physics by `wholebody.step_batch(backend=
  "xla")`, the step-fused IPM on torch.linalg.

Matrix products run in full float32 (no TF32), as the JAX package asks with
`default_matmul_precision("highest")` around the tick.
"""

from __future__ import annotations

import dataclasses
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

BACKENDS = ("fused", "pallas", "xla")


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
                forces, backend="fused", force_new_domain=False,
                allow_contact_trigger=True, reduced=False, return_d=False):
    """One control tick for every lane: tick_build, ONE batched LL-QP solve
    over all lanes on `backend`, tick_finish. On "fused" and "pallas" D^-1
    and the swing operational-space inverse run through `spd.inverse`
    (K2b); on "xla" they are per-lane LU inverses, as the JAX package's
    build and finish take them there. return_d: also return the
    (B, 18, 18) mass matrices at qs, which the plant reuses for its first
    substep (None on "xla", where the plant evaluates its own)."""
    if backend == "xla":
        d_b = None
        d_inv = torch.linalg.inv_ex(rbd.mass_matrix(model, qs))[0]
    else:
        d_b = rbd.mass_matrix(model, qs)
        d_inv = spd.inverse(d_b)
    data, ctx = agent_mod.tick_build(
        ll_cfg, motion_cfg, model, gait, states, qs, qds, forces,
        force_new_domain=force_new_domain,
        allow_contact_trigger=allow_contact_trigger, reduced=reduced,
        d_inv=d_inv)
    sol = qp_batch.solve(data.P, data.c, data.A, data.b, data.G, data.h,
                         qp_cfg, backend=backend)
    delta_inv = swing_delta_inv(ctx.ll_ctx.base if reduced else ctx.ll_ctx)
    delta_b = (torch.linalg.inv_ex(delta_inv)[0] if backend == "xla"
               else spd.inverse(delta_inv))
    out = agent_mod.tick_finish(ll_cfg, ctx, qs, qds, sol.x, sol.converged,
                                reduced=reduced, delta=delta_b)
    return out + (d_b,) if return_d else out


def _resolve_ll_qp_cfg(qp_cfg, ll_reduced, ll_qp_cfg, dtype=None):
    """The LL solver configuration of the batched loops: the caller's, else
    by dtype. The reduced LL QP's Hessian carries aux_pen A'^T A' (condition
    about aux_pen / df_pen = 1e10): the JAX package measured it converging
    on no lane in float32 without equilibration and on every lane with 5
    Ruiz sweeps, while in float64 equilibration lost accuracy. So float64
    runs qp_cfg raw, float32 (or an unstated dtype) the reduced build with
    at least 5 Ruiz sweeps; the full build runs qp_cfg raw."""
    if ll_qp_cfg is not None:
        return ll_qp_cfg
    if dtype == torch.float64:
        return qp_cfg
    return (dataclasses.replace(qp_cfg, ruiz_iters=max(qp_cfg.ruiz_iters, 5))
            if ll_reduced else qp_cfg)


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


def _sim_backend(backend):
    return "xla" if backend == "xla" else "fused"


def _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop, model, sims,
                 asts, backend, ll_reduced):
    """The batched stand-up ticks."""
    for _ in range(loop.stand_ticks):
        qs, qds, forces = _ctrl_inputs(sim_cfg, model, sims)
        ll_outs, asts, _, d_b = _tick_batch(
            ll_cfg, motion_cfg, ll_qp_cfg, model, Gait.STAND, asts, qs, qds,
            forces, backend, reduced=ll_reduced, return_d=True)
        sims = wb.step_batch(sim_cfg, model, sims, ll_outs.tau,
                             backend=_sim_backend(backend), d0=d_b)
    return sims, asts


def _trot_domain(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop, model, sims,
                 asts, backend, ll_reduced):
    """One trot domain's LL ticks after its NMPC. Returns (sims, asts,
    com (B, ticks, 3), LL qp_converged (B, ticks), max |tau| (B, ticks))."""
    com, llok, taumax = [], [], []
    for k in range(loop.ticks_per_domain):
        qs, qds, forces = _ctrl_inputs(sim_cfg, model, sims)
        ll_outs, asts, _, d_b = _tick_batch(
            ll_cfg, motion_cfg, ll_qp_cfg, model, Gait.TROT, asts, qs, qds,
            forces, backend, force_new_domain=(k == 0),
            allow_contact_trigger=False, reduced=ll_reduced, return_d=True)
        asts = asts._replace(mpc_available=asts.mpc_available
                             | (k >= loop.mpc_latency_ticks))
        sims = wb.step_batch(sim_cfg, model, sims, ll_outs.tau,
                             backend=_sim_backend(backend), d0=d_b)
        com.append(sims.q[:, 0:3])
        llok.append(ll_outs.qp_converged)
        taumax.append(ll_outs.tau.abs().amax(-1))
    return (sims, asts, torch.stack(com, 1), torch.stack(llok, 1),
            torch.stack(taumax, 1))


def _replan(mpc_cfg, qp_cfg, model, mcarries, sims, asts, pr, prd, a0, pobs,
            backend, state_other=None, agent_circle_eps=0.0):
    """The HL replan at a domain boundary, for the upcoming stance pair:
    the NMPC output, with the agents' MPC data set from it."""
    dtype = sims.q.dtype
    toe_xy = rbd.site_positions(model, sims.q)[:, a1.TOE_SITES, 0:2]
    contact_ind = motion_mod.next_trot_domain(asts.con.des).to(dtype)
    out = mpc_batch.run_nmpc_batch(
        mpc_cfg, qp_cfg, mcarries, sims.q[:, 0:2], sims.qd[:, 0:2],
        toe_xy.transpose(1, 2), contact_ind, pr, prd, a0, pobs,
        backend=backend, state_other=state_other,
        agent_circle_eps=agent_circle_eps)
    return out, agent_mod.set_mpc_data(asts, out.alpha_com, out.states)


def _check_options(mpc_cfg, backend, est_cfg, stiction=False, push=None):
    """Raise on what the port does not run."""
    unported = {"est_cfg": est_cfg is not None, "stiction": stiction,
                "push": push is not None}
    if any(unported.values()):
        raise NotImplementedError(
            "srbx_torch's batched loops run without estimation in the loop, "
            "stiction and pushes; not "
            f"{[k for k, v in unported.items() if v]} (ROADMAP M7, M8)")
    if backend == "lanes":
        raise NotImplementedError(
            "the pure-JAX 'lanes' backend is left out of srbx_torch "
            "(ROADMAP.md); use 'fused', 'pallas' or 'xla'")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "fused":
        mpc_batch.check_fused(mpc_cfg, mpc_cfg.condensed)


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

    Ported: backends "fused", "pallas" and "xla" (module docstring), the
    full and the reduced LL build (`ll_reduced`, with the LL solver
    configuration `_resolve_ll_qp_cfg` picks), any MpcConfig on "pallas"
    and "xla", and on "fused" any MpcConfig whose NMPC QPs the fused
    kernels are built for (`mpc_batch.check_fused`: every MpcConfig at the
    default horizon and ndomain). est_cfg, stiction and push raise
    NotImplementedError.
    """
    _check_options(mpc_cfg, backend, est_cfg, stiction, push)
    device = torch.device("cuda" if device is None else device)

    def on_dev(t):
        return torch.as_tensor(t).to(device=device, dtype=dtype)

    pr_agent, prd_agent, agent_initial, pobs_real = map(
        on_dev, (pr_agent, prd_agent, agent_initial, pobs_real))
    ll_qp_cfg = _resolve_ll_qp_cfg(qp_cfg, ll_reduced, ll_qp_cfg, dtype)
    with qp_batch.full_f32_products():
        return _run(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg, sim_cfg,
                    loop, model, pr_agent, prd_agent, agent_initial,
                    pobs_real, dtype, backend, ll_reduced)


def _run(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg, sim_cfg, loop, model,
         pr_agent, prd_agent, agent_initial, pobs_real, dtype, backend,
         ll_reduced):
    """run_batch's stand phase and trot domains, on checked inputs."""
    sims, asts, mcarries = _init_lanes(motion_cfg, loop, model, agent_initial,
                                       dtype)
    sims, asts = _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop,
                              model, sims, asts, backend, ll_reduced)

    ok_cnt = torch.zeros(agent_initial.shape[0], dtype=torch.int32,
                         device=agent_initial.device)
    com_hist, stats = [], []
    for _ in range(loop.n_domains):
        out, asts = _replan(mpc_cfg, qp_cfg, model, mcarries, sims, asts,
                            pr_agent, prd_agent, agent_initial, pobs_real,
                            backend)
        sims, asts, com, llok, taumax = _trot_domain(
            ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop, model, sims, asts,
            backend, ll_reduced)
        mcarries = out.carry
        ok_cnt = ok_cnt + out.qp_converged.to(torch.int32)
        com_hist.append(com)
        stats.append(torch.stack([taumax.amax(1), llok.to(dtype).mean(1)],
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


def run_team_batch(
    mpc_cfg: MpcConfig,
    ll_cfg: LowLevelConfig,
    motion_cfg: MotionConfig,
    qp_cfg: QpConfig,
    sim_cfg: wb.SimConfig,
    loop: LoopConfig,
    model: rbd.Model,
    pr,              # (S, A, 2, T)
    prd,             # (S, A, 2, T)
    agent_initials,  # (S, A, 2)
    pobs_real,       # (S, 2, n_obs)
    dtype=torch.float64,
    backend: str = "fused",
    ll_reduced: bool = False,
    ll_qp_cfg: QpConfig | None = None,
    est_cfg=None,
    est_key=None,
    device=None,
):
    """Scenario-batched multi-agent team loop: S scenarios of A whole-body
    robots as S * A lanes (scenario-major), the JAX package's
    `run_team_batch` without the TPU-only `tile` and with `device` (None
    means the CUDA card; the inputs are moved there). Every scenario's
    obstacle field is repeated for its agents. At each domain boundary each
    agent's NMPC takes the next agent's broadcast 4-state (x, y, dx, dy) of
    its own scenario (a roll by -1 on the agent axis) as a CBF circle with
    agent_circle_eps = mpc_cfg.cbf_eps; every LL QP and every NMPC of all
    scenarios and agents is one batched solve. Backends, builds and
    solver configurations as in `run_batch`; est_cfg raises
    NotImplementedError (ROADMAP M8).

    Returns (sims, com_ends (D, S, A, 3), margins (D, S, A), llok (D, S)):
    the lanes' final sim state, each domain's last COM, each agent's CBF
    margin of each domain's NMPC, and each scenario's share of converged LL
    QPs in each domain.
    """
    _check_options(mpc_cfg, backend, est_cfg)
    device = torch.device("cuda" if device is None else device)

    def on_dev(t):
        return torch.as_tensor(t).to(device=device, dtype=dtype)

    pr, prd, agent_initials, pobs_real = map(
        on_dev, (pr, prd, agent_initials, pobs_real))
    n_scen, n_agents = agent_initials.shape[0:2]
    n_lanes = n_scen * n_agents
    a0_l = agent_initials.reshape(n_lanes, 2)
    pr_l = pr.reshape(n_lanes, 2, -1)
    prd_l = prd.reshape(n_lanes, 2, -1)
    pobs_l = pobs_real.repeat_interleave(n_agents, 0)
    ll_qp_cfg = _resolve_ll_qp_cfg(qp_cfg, ll_reduced, ll_qp_cfg, dtype)

    with qp_batch.full_f32_products():
        sims, asts, mcarries = _init_lanes(motion_cfg, loop, model, a0_l,
                                           dtype)
        sims, asts = _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg,
                                  loop, model, sims, asts, backend,
                                  ll_reduced)
        com_ends, margins, lloks = [], [], []
        for _ in range(loop.n_domains):
            # the neighbour broadcast: each agent sees the next one's state
            states4 = torch.cat([sims.q[:, 0:2], sims.qd[:, 0:2]], 1)
            others = torch.roll(states4.reshape(n_scen, n_agents, 4), -1,
                                1).reshape(n_lanes, 4)
            out, asts = _replan(mpc_cfg, qp_cfg, model, mcarries, sims, asts,
                                pr_l, prd_l, a0_l, pobs_l, backend,
                                state_other=others,
                                agent_circle_eps=mpc_cfg.cbf_eps)
            sims, asts, _, llok, _ = _trot_domain(
                ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop, model, sims,
                asts, backend, ll_reduced)
            mcarries = out.carry
            com_ends.append(sims.q[:, 0:3].reshape(n_scen, n_agents, 3))
            margins.append(out.cbf_margin.reshape(n_scen, n_agents))
            lloks.append(llok.to(dtype).mean(1).reshape(n_scen, n_agents)
                         .mean(1))
    return (sims, torch.stack(com_ends), torch.stack(margins),
            torch.stack(lloks))
