"""Full-fidelity closed loops, batched over lanes: stand-up, then trot
domains under the event-cadence NMPC, event-driven trot ticks, or the
MPC-less velocity-commanded and in-place gaits.

Counterpart of `srbx/sim/closedloop.py::run`, `run_batch`, `run_team`,
`run_team_batch`, `run_batch_event` and `run_velocity_gait`.
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

`run` (one agent) and `run_team` (one team) are the per-agent path, the
JAX package's own architecture, which its batched loops are held to: every
tick is `agent.tick` (each lane's LL QP by the dense per-problem IPM
`ops.qp.solve`, LU inverses), the plant `wholebody.step`, and each agent's
replan `mpc.run_nmpc` (each lane's QPs by `ops.qp.solve`). It runs no
kernel: the JAX functions reach no Pallas kernel either. Inside they run
the batched loops' code with `PER_AGENT` in place of a backend.

`run_batch` also runs the plant with stick-slip contact (`stiction`) and
under per-lane trunk force pulses (`push`), as the JAX package's does.

With `est_cfg` every loop runs estimation in the loop
(`srbx_torch.estimation.pipeline`): the controller sees the sensor model's
readings through kinematic odometry or the KF, never the truth, and the
physics evaluates its own mass matrix (the controller's is at q_hat).

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
from srbx_torch.estimation import pipeline
from srbx_torch.lowlevel import swing_delta_inv
from srbx_torch.models import a1, rbd
from srbx_torch.ops import qp_batch, spd
from srbx_torch.sim import wholebody as wb
from srbx_torch.utils import prng

BACKENDS = ("fused", "pallas", "xla")
# the per-agent path of run and run_team, in place of a backend
PER_AGENT = "per_agent"


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
    substep (None on "xla", where the plant evaluates its own).
    PER_AGENT: `agent.tick`, each lane's QP by the dense IPM."""
    if backend == PER_AGENT:
        out = agent_mod.tick(
            ll_cfg, motion_cfg, qp_cfg, model, gait, states, qs, qds, forces,
            force_new_domain=force_new_domain,
            allow_contact_trigger=allow_contact_trigger)
        return out + (None,) if return_d else out
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


def _init_lanes(motion_cfg, loop, model, a0_l, dtype, stiction=False,
                q0=None):
    """Per-lane start, the crouch at a0_l unless q0 (B, 18) is given: sim
    state (with stiction its contact state, anchored at the toes), agent
    state with the stand planner armed, MPC carry."""
    bsz = a0_l.shape[0]
    if q0 is None:
        q0 = wb.default_crouch(model, dtype, a0_l.device).repeat(bsz, 1)
        q0 = torch.cat([q0[:, 0:2] + a0_l.to(dtype), q0[:, 2:]], 1)
    sim = wb.SimState(q0, torch.zeros_like(q0),
                      wb.init_contact_state(model, q0) if stiction else None)
    ast = agent_mod.init(motion_cfg, model, q0, dtype)
    ast = ast._replace(planner=ast.planner._replace(
        stand_from=q0[:, 0:3],
        dom_ticks=torch.full((bsz,), float(loop.stand_ticks), dtype=dtype,
                             device=q0.device)))
    return sim, ast, mpc_mod.init_carry(a0_l, dtype)


def _init_ests(est_cfg, model, sims, est_key):
    """The lanes' estimators: one key per lane from split(est_key, B), as
    the JAX package draws them; est_key None means key(0). est_key is the
    port's key tensor (2,) or the JAX package's raw key (a uint32 array)."""
    dev = sims.q.device
    est_key = prng.key(0, dev) if est_key is None else prng.as_key(est_key,
                                                                    dev)
    keys = prng.split(est_key, sims.q.shape[0])
    return pipeline.init(est_cfg, model, sims, keys)


def _ctrl_inputs(est_cfg, sim_cfg, model, ests, sims, asts, dom_ticks):
    """The controller's view of the state for one tick: (ests, q, qd,
    foot forces). Ground truth and the plant's foot forces without est_cfg;
    with it the estimation pipeline's (q_hat, qd_hat) and measured forces,
    truth confined to the plant and the sensors. dom_ticks divides the
    lanes' tick counts into the gait phase that the pipeline's contact
    filter reads."""
    if est_cfg is None:
        return (ests, sims.q, sims.qd,
                wb.foot_force_measurement(sim_cfg, model, sims))
    ests, out = pipeline.update(est_cfg, sim_cfg, model, ests, sims,
                                asts.loco_tick / dom_ticks)
    return ests, out.q_hat, out.qd_hat, out.foot_force


def _errsq(qs, qds, sims):
    """(B, 2) squared errors of the base position and velocity estimates."""
    return torch.stack([((qs[:, 0:3] - sims.q[:, 0:3]) ** 2).sum(-1),
                        ((qds[:, 0:3] - sims.qd[:, 0:3]) ** 2).sum(-1)], -1)


def _sim_backend(backend):
    return "xla" if backend == "xla" else "fused"


def _physics(sim_cfg, model, sims, tau, backend, d_b, est_cfg,
             base_force=None):
    """The plant's tick, under base_force (B, 3) when given. Without
    estimation the controller's D (at the true q) is the first substep's;
    with it the controller's D was evaluated at q_hat, so the plant
    evaluates its own. PER_AGENT: `wholebody.step`, as the JAX package's
    per-agent loops call it (no d0)."""
    if backend == PER_AGENT:
        return wb.step(sim_cfg, model, sims, tau, base_force=base_force)
    return wb.step_batch(sim_cfg, model, sims, tau,
                         backend=_sim_backend(backend), base_force=base_force,
                         d0=d_b if est_cfg is None else None)


def _push_force(push, t, dtype):
    """The trunk forces (B, 3) of push = (force, start, duration) at trot
    tick t: each lane's force while start <= t < start + duration, else
    zero; None without push."""
    if push is None:
        return None
    force, start, dur = push
    on = (t >= start) & (t < start + dur)
    return force * on[:, None].to(dtype)


def _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop, model, sims,
                 asts, backend, ll_reduced, est_cfg=None, ests=None):
    """The batched stand-up ticks; with estimation in the loop the
    estimators run (and settle) during the stand-up."""
    for _ in range(loop.stand_ticks):
        ests, qs, qds, forces = _ctrl_inputs(
            est_cfg, sim_cfg, model, ests, sims, asts,
            torch.clamp(asts.planner.dom_ticks, min=1.0))
        ll_outs, asts, _, d_b = _tick_batch(
            ll_cfg, motion_cfg, ll_qp_cfg, model, Gait.STAND, asts, qs, qds,
            forces, backend, reduced=ll_reduced, return_d=True)
        if est_cfg is not None:
            ests = pipeline.set_contact_ind(ests, asts.con.ind)
        sims = _physics(sim_cfg, model, sims, ll_outs.tau, backend, d_b,
                        est_cfg)
    return sims, asts, ests


class DomainOut(NamedTuple):
    """One trot domain's per-tick records (B, ticks, ...) and, with
    estimation, its mean squared estimate errors (B, 2)."""

    com: torch.Tensor
    llok: torch.Tensor
    taumax: torch.Tensor
    errsq: Optional[torch.Tensor] = None


def _trot_domain(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop, model, sims,
                 asts, backend, ll_reduced, est_cfg=None, ests=None,
                 push=None, dom_idx=0):
    """One trot domain's LL ticks after its NMPC; push pulses count trot
    ticks from the first domain's start (domain dom_idx's tick k is
    dom_idx * ticks_per_domain + k). Returns (sims, asts, ests,
    DomainOut)."""
    com, llok, taumax, errsq = [], [], [], []
    trot_dom_ticks = float(motion_cfg.trot_dom_ticks)
    for k in range(loop.ticks_per_domain):
        ests, qs, qds, forces = _ctrl_inputs(est_cfg, sim_cfg, model, ests,
                                             sims, asts, trot_dom_ticks)
        if est_cfg is not None:
            errsq.append(_errsq(qs, qds, sims))
        ll_outs, asts, _, d_b = _tick_batch(
            ll_cfg, motion_cfg, ll_qp_cfg, model, Gait.TROT, asts, qs, qds,
            forces, backend, force_new_domain=(k == 0),
            allow_contact_trigger=False, reduced=ll_reduced, return_d=True)
        if est_cfg is not None:
            ests = pipeline.set_contact_ind(ests, asts.con.ind)
        asts = asts._replace(mpc_available=asts.mpc_available
                             | (k >= loop.mpc_latency_ticks))
        sims = _physics(sim_cfg, model, sims, ll_outs.tau, backend, d_b,
                        est_cfg, _push_force(
                            push, dom_idx * loop.ticks_per_domain + k,
                            qs.dtype))
        com.append(sims.q[:, 0:3])
        llok.append(ll_outs.qp_converged)
        taumax.append(ll_outs.tau.abs().amax(-1))
    return sims, asts, ests, DomainOut(
        torch.stack(com, 1), torch.stack(llok, 1), torch.stack(taumax, 1),
        torch.stack(errsq, 1).mean(1) if errsq else None)


def _state_view(est_cfg, sims, ests):
    """The HL's (q, qd): the latest estimate with estimation in the loop,
    else the truth."""
    return (sims.q, sims.qd) if est_cfg is None else (ests.q_hat,
                                                       ests.qd_hat)


def _replan(mpc_cfg, qp_cfg, model, mcarries, qs, qds, asts, pr, prd, a0,
            pobs, backend, state_other=None, agent_circle_eps=0.0):
    """The HL replan at a domain boundary from the state view (qs, qds),
    for the upcoming stance pair: the NMPC output, with the agents' MPC
    data set from it."""
    out = _nmpc(mpc_cfg, qp_cfg, model, mcarries, qs, qds,
                motion_mod.next_trot_domain(asts.con.des).to(qs.dtype), pr,
                prd, a0, pobs, backend, state_other, agent_circle_eps)
    return out, agent_mod.set_mpc_data(asts, out.alpha_com, out.states)


def _nmpc(mpc_cfg, qp_cfg, model, mcarries, qs, qds, contact_ind, pr, prd,
          a0, pobs, backend, state_other=None, agent_circle_eps=0.0):
    """One batched NMPC cycle from (qs, qds) for the stance pattern
    contact_ind; PER_AGENT: `mpc.run_nmpc`, each lane's QPs by the dense
    IPM."""
    toe_xy = rbd.site_positions(model, qs)[:, a1.TOE_SITES, 0:2]
    if backend == PER_AGENT:
        return mpc_mod.run_nmpc(
            mpc_cfg, qp_cfg, mcarries, qs[:, 0:2], qds[:, 0:2],
            toe_xy.transpose(1, 2), contact_ind, pr, prd, a0, pobs,
            state_other=state_other, agent_circle_eps=agent_circle_eps)
    return mpc_batch.run_nmpc_batch(
        mpc_cfg, qp_cfg, mcarries, qs[:, 0:2], qds[:, 0:2],
        toe_xy.transpose(1, 2), contact_ind, pr, prd, a0, pobs,
        backend=backend, state_other=state_other,
        agent_circle_eps=agent_circle_eps)


def _check_backend(backend):
    """Raise on a backend the port does not run."""
    if backend == "lanes":
        raise NotImplementedError(
            "the pure-JAX 'lanes' backend is left out of srbx_torch "
            "(ROADMAP.md); use 'fused', 'pallas' or 'xla'")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def _check_options(mpc_cfg, backend):
    """Raise on what the port does not run."""
    _check_backend(backend)
    if backend == "fused":
        mpc_batch.check_fused(mpc_cfg, mpc_cfg.condensed)


def _on_device(device, dtype, *arrays):
    """device None means the CUDA card; the arrays moved there in dtype."""
    device = torch.device("cuda" if device is None else device)
    return device, [torch.as_tensor(t).to(device=device, dtype=dtype)
                    for t in arrays]


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
    default horizon and ndomain).

    est_cfg (a `srbx_torch.estimation.pipeline.EstConfig`): estimation in
    the loop. The LL ticks and the replans consume the sensor-driven
    estimates, ground truth stays in the plant and the sensor model, and
    the result carries `est_rmse` (B, 2): the RMSE of the base position
    (m) and velocity (m/s) estimates over the trot ticks. est_key: the
    noise key (`srbx_torch.utils.prng.key`, or the JAX package's raw key);
    None means key 0.

    stiction=True runs the plant with the stick-slip contact model, every
    toe anchored where it starts; the result's `sim.con.slip` (B, 4) is
    each toe's cumulative slip. push: optional (force (B, 3), start_tick
    (B,), duration_ticks (B,)), per-lane trunk force pulses (the
    reference's disturbance generator, `src/A1_Sim.cpp:84-107`): a lane's
    force acts on its trunk during the trot ticks t with start <= t <
    start + duration, t counting trot ticks from the first domain's start
    (the stand phase is not counted).
    """
    _check_options(mpc_cfg, backend)
    device, (pr_agent, prd_agent, agent_initial, pobs_real) = _on_device(
        device, dtype, pr_agent, prd_agent, agent_initial, pobs_real)
    if push is not None:
        force, start, dur = push
        push = (torch.as_tensor(force).to(device=device, dtype=dtype),
                torch.as_tensor(start).to(device=device, dtype=torch.int64),
                torch.as_tensor(dur).to(device=device, dtype=torch.int64))
    ll_qp_cfg = _resolve_ll_qp_cfg(qp_cfg, ll_reduced, ll_qp_cfg, dtype)
    with qp_batch.full_f32_products():
        return _run(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg, sim_cfg,
                    loop, model, pr_agent, prd_agent, agent_initial,
                    pobs_real, dtype, backend, ll_reduced, est_cfg, est_key,
                    stiction, push)


def _run(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg, sim_cfg, loop, model,
         pr_agent, prd_agent, agent_initial, pobs_real, dtype, backend,
         ll_reduced, est_cfg, est_key, stiction=False, push=None, q0=None):
    """run_batch's and run's stand phase and trot domains, on checked
    inputs."""
    sims, asts, mcarries = _init_lanes(motion_cfg, loop, model, agent_initial,
                                       dtype, stiction, q0)
    ests = (_init_ests(est_cfg, model, sims, est_key)
            if est_cfg is not None else None)
    sims, asts, ests = _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg,
                                    loop, model, sims, asts, backend,
                                    ll_reduced, est_cfg, ests)

    ok_cnt = torch.zeros(agent_initial.shape[0], dtype=torch.int32,
                         device=agent_initial.device)
    com_hist, stats, errsq = [], [], []
    for dom_idx in range(loop.n_domains):
        qs, qds = _state_view(est_cfg, sims, ests)
        out, asts = _replan(mpc_cfg, qp_cfg, model, mcarries, qs, qds, asts,
                            pr_agent, prd_agent, agent_initial, pobs_real,
                            backend)
        sims, asts, ests, dom = _trot_domain(
            ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop, model, sims, asts,
            backend, ll_reduced, est_cfg, ests, push, dom_idx)
        mcarries = out.carry
        ok_cnt = ok_cnt + out.qp_converged.to(torch.int32)
        com_hist.append(dom.com)
        stats.append(torch.stack([dom.taumax.amax(1),
                                  dom.llok.to(dtype).mean(1)], -1))
        errsq.append(dom.errsq)
    stats = torch.stack(stats, 1)                  # (B, n_domains, 2)
    return LoopResult(
        sim=sims,
        agent=asts,
        com_hist=torch.stack(com_hist, 1),
        qp_ok=stats[:, :, 1].mean(1),
        mpc_ok=ok_cnt.to(dtype) / loop.n_domains,
        tau_hist=stats,
        est_rmse=(torch.sqrt(torch.stack(errsq, 1).mean(1))
                  if est_cfg is not None else None),
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
    solver configurations as in `run_batch`.

    est_cfg: estimation in the loop per robot, as in `run_batch` (one key
    per lane from split(est_key, S * A)); the replans and the neighbour
    4-state each agent broadcasts are its estimate, never the truth.

    Returns (sims, com_ends (D, S, A, 3), margins (D, S, A), llok (D, S)):
    the lanes' final sim state, each domain's last COM, each agent's CBF
    margin of each domain's NMPC, and each scenario's share of converged LL
    QPs in each domain; with est_cfg a 5th element, est_rmse (S, A, 2).
    """
    _check_options(mpc_cfg, backend)
    device, (pr, prd, agent_initials, pobs_real) = _on_device(
        device, dtype, pr, prd, agent_initials, pobs_real)
    ll_qp_cfg = _resolve_ll_qp_cfg(qp_cfg, ll_reduced, ll_qp_cfg, dtype)
    with qp_batch.full_f32_products():
        return _team(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg, sim_cfg,
                     loop, model, pr, prd, agent_initials, pobs_real, dtype,
                     backend, ll_reduced, est_cfg, est_key)


def _team(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg, sim_cfg, loop, model,
          pr, prd, agent_initials, pobs_real, dtype, backend, ll_reduced,
          est_cfg, est_key):
    """run_team_batch's and run_team's stand phase and trot domains, on
    checked inputs."""
    n_scen, n_agents = agent_initials.shape[0:2]
    n_lanes = n_scen * n_agents
    a0_l = agent_initials.reshape(n_lanes, 2)
    pr_l = pr.reshape(n_lanes, 2, -1)
    prd_l = prd.reshape(n_lanes, 2, -1)
    pobs_l = pobs_real.repeat_interleave(n_agents, 0)
    sims, asts, mcarries = _init_lanes(motion_cfg, loop, model, a0_l, dtype)
    ests = (_init_ests(est_cfg, model, sims, est_key)
            if est_cfg is not None else None)
    sims, asts, ests = _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg,
                                    loop, model, sims, asts, backend,
                                    ll_reduced, est_cfg, ests)
    com_ends, margins, lloks, errsq = [], [], [], []
    for _ in range(loop.n_domains):
        # the neighbour broadcast: each agent sees the next one's state
        qs, qds = _state_view(est_cfg, sims, ests)
        states4 = torch.cat([qs[:, 0:2], qds[:, 0:2]], 1)
        others = torch.roll(states4.reshape(n_scen, n_agents, 4), -1,
                            1).reshape(n_lanes, 4)
        out, asts = _replan(mpc_cfg, qp_cfg, model, mcarries, qs, qds, asts,
                            pr_l, prd_l, a0_l, pobs_l, backend,
                            state_other=others,
                            agent_circle_eps=mpc_cfg.cbf_eps)
        sims, asts, ests, dom = _trot_domain(
            ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, loop, model, sims, asts,
            backend, ll_reduced, est_cfg, ests)
        mcarries = out.carry
        com_ends.append(sims.q[:, 0:3].reshape(n_scen, n_agents, 3))
        margins.append(out.cbf_margin.reshape(n_scen, n_agents))
        lloks.append(dom.llok.to(dtype).mean(1).reshape(n_scen, n_agents)
                     .mean(1))
        errsq.append(dom.errsq)
    res = (sims, torch.stack(com_ends), torch.stack(margins),
           torch.stack(lloks))
    if est_cfg is None:
        return res
    est_rmse = torch.sqrt(torch.stack(errsq, 1).mean(1))
    return res + (est_rmse.reshape(n_scen, n_agents, 2),)


def _first_lane(tree):
    """Lane 0 of every tensor of a tree of NamedTuples."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_first_lane(t) for t in tree))
    return tree[0]


def run(
    mpc_cfg: MpcConfig,
    ll_cfg: LowLevelConfig,
    motion_cfg: MotionConfig,
    qp_cfg: QpConfig,
    sim_cfg: wb.SimConfig,
    loop: LoopConfig,
    model: rbd.Model,
    pr_agent,        # (2, T)
    prd_agent,       # (2, T)
    agent_initial,   # (2,)
    pobs_real,       # (2, n_obs)
    q0=None,         # optional (18,)
    dtype=torch.float64,
    stiction: bool = False,
    device=None,
) -> LoopResult:
    """Single-agent full-fidelity run: the JAX package's `run`, plus
    `device` (None means the CUDA card; the inputs are moved there). The
    stand-up from q0 (the crouch at agent_initial by default), the stand
    Bezier spanning loop.stand_ticks, then loop.n_domains trot domains,
    each replanned by `mpc.run_nmpc` for the upcoming stance pair and
    ticked by `agent.tick` (the domain's first tick forces its change, the
    contact trigger is off, the MPC data arrive after
    loop.mpc_latency_ticks) and `wholebody.step`. stiction=True runs the
    plant with the stick-slip contact model; `sim.con.slip` (4,) is each
    toe's cumulative slip.

    Returns the JAX package's single-lane LoopResult: sim.q (18,),
    com_hist (n_domains, ticks, 3), qp_ok and mpc_ok (), tau_hist
    (n_domains, 2) (max |tau|, LL qp_ok share per domain)."""
    device, (pr_agent, prd_agent, agent_initial, pobs_real) = _on_device(
        device, dtype, pr_agent, prd_agent, agent_initial, pobs_real)
    if q0 is not None:
        q0 = torch.as_tensor(q0).to(device=device, dtype=dtype)[None]
    with qp_batch.full_f32_products():
        res = _run(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, qp_cfg, sim_cfg,
                   loop, model, pr_agent[None], prd_agent[None],
                   agent_initial[None], pobs_real[None], dtype, PER_AGENT,
                   False, None, None, stiction, None, q0)
    return _first_lane(res)


def run_team(
    mpc_cfg: MpcConfig,
    ll_cfg: LowLevelConfig,
    motion_cfg: MotionConfig,
    qp_cfg: QpConfig,
    sim_cfg: wb.SimConfig,
    loop: LoopConfig,
    model: rbd.Model,
    pr,              # (A, 2, T)
    prd,             # (A, 2, T)
    agent_initials,  # (A, 2)
    pobs_real,       # (2, n_obs)
    dtype=torch.float64,
    device=None,
):
    """Multi-agent full-fidelity loop: the JAX package's `run_team`, plus
    `device` (None means the CUDA card; the inputs are moved there). The
    agents are lanes; at each domain boundary every agent's `mpc.run_nmpc`
    takes the next agent's broadcast 4-state (x, y, dx, dy), a roll by -1
    over the agents, as a CBF circle with agent_circle_eps =
    mpc_cfg.cbf_eps; every tick is `agent.tick` and `wholebody.step` per
    agent, without stick-slip contact.

    Returns (sims (A, ...), com_ends (D, A, 3), margins (D, A), llok (D,)):
    the agents' final sim state, each domain's last COM, each agent's CBF
    margin of each domain's NMPC, and each domain's share of converged LL
    QPs over its ticks and agents."""
    device, (pr, prd, agent_initials, pobs_real) = _on_device(
        device, dtype, pr, prd, agent_initials, pobs_real)
    with qp_batch.full_f32_products():
        sims, com_ends, margins, llok = _team(
            mpc_cfg, ll_cfg, motion_cfg, qp_cfg, qp_cfg, sim_cfg, loop,
            model, pr[None], prd[None], agent_initials[None], pobs_real[None],
            dtype, PER_AGENT, False, None, None)
    return sims, com_ends[:, 0], margins[:, 0], llok[:, 0]


class EventBatchResult(NamedTuple):
    """run_batch_event's result; every field has a leading lane axis B."""

    sim: wb.SimState
    agent: agent_mod.AgentState
    com_hist: torch.Tensor      # (B, n_ticks, 3)
    qp_ok: torch.Tensor         # (B,) share of converged LL QPs
    domains: torch.Tensor       # (B,) int32 gait domains completed
    mpc_solves: torch.Tensor    # (B,) int32 NMPC replans applied
    trigger_hist: torch.Tensor  # (B, n_ticks) bool, replan requested
    est_rmse: Optional[torch.Tensor] = None   # estimation in the loop only


def run_batch_event(
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
    n_ticks: int,
    dtype=torch.float64,
    backend: str = "fused",
    tile: int = 256,
    ll_reduced: bool = False,
    ll_qp_cfg: QpConfig | None = None,
    mpc_period_ticks: int = 1,
    est_cfg=None,
    est_key=None,
    device=None,
) -> EventBatchResult:
    """Batched event-driven loop: the JAX package's `run_batch_event`, plus
    `device` (None means the CUDA card); `tile` is not read. After the
    stand-up, n_ticks trot ticks with per-lane domain triggers (a lane's
    contact trigger or phase overrun, as `agent.tick_build` computes it)
    instead of run_batch's fixed cadence:

    * every tick, a lane's trigger (`run_mpc`) latches its replan request;
    * every `mpc_period_ticks` ticks (the HL thread's cadence), if any lane
      has a request, one batched NMPC runs for all lanes from the state
      view and is applied only to the requesting lanes: their MPC carry,
      their pending solution, a countdown of `loop.mpc_latency_ticks` and
      their solve count; the requests clear. This is the JAX package's
      `lax.cond`, decided by one host read of the requests on poll ticks;
    * a lane whose countdown reaches 0 gets its pending solution; until
      then its LL runs on the stale-Bezier fallback. The countdown is -1
      when idle.

    est_cfg: the contact debouncer, and with it every trigger, runs on the
    measured foot force, and the LL and the NMPC on the estimates, as in
    `run_batch`; the result carries est_rmse over the n_ticks trot ticks.
    Backends, builds and solver configurations as in `run_batch`.
    """
    _check_options(mpc_cfg, backend)
    device, (pr_agent, prd_agent, agent_initial, pobs_real) = _on_device(
        device, dtype, pr_agent, prd_agent, agent_initial, pobs_real)
    ll_qp_cfg = _resolve_ll_qp_cfg(qp_cfg, ll_reduced, ll_qp_cfg, dtype)
    with qp_batch.full_f32_products():
        return _run_event(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg,
                          sim_cfg, loop, model, pr_agent, prd_agent,
                          agent_initial, pobs_real, n_ticks, dtype, backend,
                          ll_reduced, mpc_period_ticks, est_cfg, est_key)


def _where_lanes(mask, new, old):
    return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def _run_event(mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg, sim_cfg, loop,
               model, pr_agent, prd_agent, agent_initial, pobs_real, n_ticks,
               dtype, backend, ll_reduced, mpc_period_ticks, est_cfg,
               est_key):
    """run_batch_event's stand phase and event-driven ticks."""
    bsz, dev = agent_initial.shape[0], agent_initial.device
    sims, asts, mcarries = _init_lanes(motion_cfg, loop, model, agent_initial,
                                       dtype)
    ests = (_init_ests(est_cfg, model, sims, est_key)
            if est_cfg is not None else None)
    sims, asts, ests = _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg,
                                    loop, model, sims, asts, backend,
                                    ll_reduced, est_cfg, ests)

    trot_dom_ticks = float(motion_cfg.trot_dom_ticks)
    pend_alpha = torch.zeros((bsz, 4, 5), dtype=dtype, device=dev)
    pend_states = torch.zeros((bsz, 4, 4), dtype=dtype, device=dev)
    countdown = torch.full((bsz,), -1, dtype=torch.int32, device=dev)
    n_solves = torch.zeros(bsz, dtype=torch.int32, device=dev)
    req = torch.zeros(bsz, dtype=torch.bool, device=dev)
    com, llok, trig, errsq = [], [], [], []
    for k in range(n_ticks):
        ests, qs, qds, forces = _ctrl_inputs(est_cfg, sim_cfg, model, ests,
                                             sims, asts, trot_dom_ticks)
        if est_cfg is not None:
            errsq.append(_errsq(qs, qds, sims))
        ll_outs, asts, run_mpc, d_b = _tick_batch(
            ll_cfg, motion_cfg, ll_qp_cfg, model, Gait.TROT, asts, qs, qds,
            forces, backend, force_new_domain=(k == 0),
            allow_contact_trigger=True, reduced=ll_reduced, return_d=True)
        if est_cfg is not None:
            ests = pipeline.set_contact_ind(ests, asts.con.ind)
        req = req | run_mpc

        if k % mpc_period_ticks == 0 and bool(req.any()):
            # the triggering tick already moved con.des to the new domain
            out = _nmpc(mpc_cfg, qp_cfg, model, mcarries, qs, qds,
                        asts.con.des.to(dtype), pr_agent, prd_agent,
                        agent_initial, pobs_real, backend)
            mcarries = type(mcarries)(*(_where_lanes(req, n, o) for n, o in
                                        zip(out.carry, mcarries)))
            pend_alpha = _where_lanes(req, out.alpha_com, pend_alpha)
            pend_states = _where_lanes(req, out.states, pend_states)
            countdown = torch.where(req, loop.mpc_latency_ticks, countdown)
            n_solves = n_solves + req.to(torch.int32)
            req = torch.zeros_like(req)

        # delivery: a lane whose countdown reaches 0 gets its solution
        deliver = countdown == 0
        asts = asts._replace(
            mpc_alpha=_where_lanes(deliver, pend_alpha, asts.mpc_alpha),
            mpc_states=_where_lanes(deliver, pend_states, asts.mpc_states),
            mpc_available=asts.mpc_available | deliver)
        countdown = torch.where(countdown >= 0, countdown - 1, countdown)

        sims = _physics(sim_cfg, model, sims, ll_outs.tau, backend, d_b,
                        est_cfg)
        com.append(sims.q[:, 0:3])
        llok.append(ll_outs.qp_converged)
        trig.append(run_mpc)
    return EventBatchResult(
        sim=sims,
        agent=asts,
        com_hist=torch.stack(com, 1),
        qp_ok=torch.stack(llok, 1).to(dtype).mean(1),
        domains=asts.gait_domain,
        mpc_solves=n_solves,
        trigger_hist=torch.stack(trig, 1),
        est_rmse=(torch.sqrt(torch.stack(errsq, 1).mean(1))
                  if est_cfg is not None else None),
    )


class VelocityGaitResult(NamedTuple):
    """run_velocity_gait's result; every field has a leading lane axis B."""

    sim: wb.SimState
    agent: agent_mod.AgentState
    com_hist: torch.Tensor      # (B, n_ticks, 3)
    qp_ok: torch.Tensor         # (B,) share of converged LL QPs
    domains: torch.Tensor       # (B,) int32 gait domains completed


VELOCITY_GAITS = (Gait.WALK, Gait.PACE, Gait.INPLACE_TROT, Gait.INPLACE_WALK,
                  Gait.TAP, Gait.POSE)


def run_velocity_gait(
    gait: Gait,
    ll_cfg: LowLevelConfig,
    motion_cfg: MotionConfig,
    qp_cfg: QpConfig,
    sim_cfg: wb.SimConfig,
    loop: LoopConfig,
    model: rbd.Model,
    agent_initial,   # (B, 2)
    n_ticks: int,
    dtype=torch.float64,
    backend: str = "fused",
    ll_reduced: bool = False,
    ll_qp_cfg: QpConfig | None = None,
    device=None,
) -> VelocityGaitResult:
    """Batched MPC-less gait: the JAX package's `run_velocity_gait` without
    the TPU kernels' lane tile (`tile` is not taken) and with `device`
    (None means the CUDA card; agent_initial is moved there). The stand-up,
    then n_ticks ticks of `gait` with per-lane domains (tick 0 forces one;
    after it a lane's phase overrun or touchdown ends its domain; POSE's
    never end): WALK and PACE step under the ramped `motion_cfg.fwd_speed`
    / `lat_speed` command with their own Raibert steps; INPLACE_TROT,
    INPLACE_WALK and TAP hold the COM at the stand target while cycling
    their stance tables; POSE oscillates `motion_cfg.pose_type`'s axis
    about the locked stand pose. Backends, builds and solver configurations
    as in `run_batch`; no NMPC runs, so K1a never does."""
    if gait not in VELOCITY_GAITS:
        raise ValueError(f"run_velocity_gait drives {VELOCITY_GAITS}, got "
                         f"{gait!r}")
    _check_backend(backend)
    device, (agent_initial,) = _on_device(device, dtype, agent_initial)
    ll_qp_cfg = _resolve_ll_qp_cfg(qp_cfg, ll_reduced, ll_qp_cfg, dtype)
    with qp_batch.full_f32_products():
        sims, asts, _ = _init_lanes(motion_cfg, loop, model, agent_initial,
                                    dtype)
        sims, asts, _ = _stand_phase(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg,
                                     loop, model, sims, asts, backend,
                                     ll_reduced)
        sims, asts, com, llok = _gait_ticks(
            ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, model, gait, sims, asts,
            range(n_ticks), backend, ll_reduced)
    return VelocityGaitResult(
        sim=sims,
        agent=asts,
        com_hist=com,
        qp_ok=llok.to(dtype).mean(1),
        domains=asts.gait_domain,
    )


def _gait_ticks(ll_cfg, motion_cfg, ll_qp_cfg, sim_cfg, model, gait, sims,
                asts, ticks, backend, ll_reduced):
    """The gait ticks `ticks` (a range; tick 0 forces a domain change) of
    run_velocity_gait. Returns (sims, asts, com (B, n, 3), llok (B, n))."""
    com, llok = [], []
    for k in ticks:
        forces = wb.foot_force_measurement(sim_cfg, model, sims)
        ll_outs, asts, _, d_b = _tick_batch(
            ll_cfg, motion_cfg, ll_qp_cfg, model, gait, asts, sims.q, sims.qd,
            forces, backend, force_new_domain=(k == 0),
            allow_contact_trigger=True, reduced=ll_reduced, return_d=True)
        sims = _physics(sim_cfg, model, sims, ll_outs.tau, backend, d_b, None)
        com.append(sims.q[:, 0:3])
        llok.append(ll_outs.qp_converged)
    return sims, asts, torch.stack(com, 1), torch.stack(llok, 1)
