"""Batched success-rate campaigns: the template A/B campaign.

Counterpart of `srbx/eval/campaign.py::run_campaign_batch`, the batch form
of the paper's QP-only against CBF-SQP comparison over randomized obstacle
fields (`src/A1_Sim.cpp:811-1274`), with failure = any agent within
`fail_radius` of a real obstacle (`src/MPC_dist.cpp:21-40`):

  * scenarios x agents are one lane axis; the APF planner rolls every
    scenario's field at once (`refplan.generate` with a scenario axis);
  * each gait domain runs ONE NMPC cycle for all lanes
    (`mpc_batch.run_nmpc_batch`): with the campaign's condensed,
    simplex-eliminated configuration and backend "fused" its lanes-last
    branch, kernel K1a;
  * the closed loop runs at template level: the plant is the LIP landing on
    the planned terminal knot, plus an optional per-domain velocity kick;
  * the neighbour exchange is a roll on the agent sub-axis of the lane axis.

The JAX package's `lax.scan` over domains is a Python loop here. Random
numbers come from JAX keys through `srbx_torch.utils.prng` (a key is the
port's int64 key tensor, `prng.key(seed)`, or the JAX package's raw key),
so that a key gives the JAX package's obstacle fields and, with
`disturbance > 0`, its per-domain kicks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from srbx_torch import gait as gaitmod
from srbx_torch import mpc, mpc_batch, refplan
from srbx_torch.config import Gait, MpcConfig, QpConfig
from srbx_torch.ocp import default_footholds
from srbx_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    n_agents: int = 2
    n_domains: int = 120          # ~ 60 s / 172 ms-per-domain + stand
    n_obstacles: int = 20
    disturbance: float = 0.0      # per-domain velocity kick (m/s, std)
    fail_radius: float = 0.5
    obstacle_uncertainty: float = 0.6
    inter_agent_cbf: bool = False


class CampaignResult(NamedTuple):
    success: torch.Tensor        # (S, n_agents) bool, never within fail radius
    fail_distance: torch.Tensor  # (S, n_agents) ||q|| at first failure (0 if none)
    min_clearance: torch.Tensor  # (S, n_agents) min obstacle distance over run
    final_xy: torch.Tensor       # (S, n_agents, 2)
    qp_ok_frac: torch.Tensor     # (S,) fraction of converged cycles
    traj: torch.Tensor           # (S, n_domains, n_agents, 2) COM track


def sample_obstacles(key, n_scenarios: int, n_obstacles: int,
                     uncertainty: float = 0.6, dtype=torch.float64,
                     device=None):
    """Randomized obstacle fields (reference `src/A1_Sim.cpp:940-981`):
    nominal positions U([0,9] x [-2,2]); real positions = nominal +
    U(+-uncertainty) clamped to [1,9] x [-3,3]. Returns (pobs, real), each
    (S, 2, n_obs).

    The JAX package's draws: `split(key, 3)`, then one uniform on each
    subkey, in `dtype` (the JAX package draws in its x64 flag's float type),
    on `device` (None means the CUDA card).
    """
    key = prng.as_key(key, device)
    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    shape = (n_scenarios, n_obstacles)
    xs = prng.uniform(k1, shape, dtype, 0.0, 9.0)
    ys = prng.uniform(k2, shape, dtype, -2.0, 2.0)
    pobs = torch.stack([xs, ys], 1)                       # (S, 2, n_obs)
    noise = prng.uniform(k3, (n_scenarios, 2, n_obstacles), dtype,
                         -uncertainty, uncertainty)
    real = pobs + noise
    real = torch.stack([real[:, 0].clamp(1.0, 9.0),
                        real[:, 1].clamp(-3.0, 3.0)], 1)
    return pobs, real


def _contact_table(n_domains: int, dtype, device):
    """(n_domains, 4) trot stance table starting after the stand domain."""
    m = max(n_domains + 2, 12)
    m += (-(m - 2)) % 4  # round up to a valid schedule length
    sched = gaitmod.contact_schedule(Gait.TROT, m)
    return torch.as_tensor(sched[:n_domains], dtype=dtype, device=device)


def run_campaign_batch(
    cfg: MpcConfig,
    qp_cfg: QpConfig,
    camp: CampaignConfig,
    ref_cfg: refplan.RefPlanConfig,
    p_start,
    key,
    n_scenarios: int,
    backend: str = "fused",
    warm_start_qp: bool = False,
    dtype=torch.float64,
    device=None,
) -> CampaignResult:
    """Full batched campaign: sample obstacle fields, plan APF references,
    and run every scenario's closed loop, all (scenario x agent) lanes of a
    domain in one NMPC cycle.

    The JAX signature without the TPU-only `tile`: `split(key)` gives the
    fields' key and the run's (the kicks'), as there; `dtype` is the run's
    floating type (the JAX package takes it from its x64 flag);
    `device=None` means the CUDA card.
    """
    k_obs, k_run = prng.split(prng.as_key(key, device)).unbind(-2)
    pobs, pobs_real = sample_obstacles(
        k_obs, n_scenarios, camp.n_obstacles, camp.obstacle_uncertainty,
        dtype, device)
    return _run_campaign_batch_core(
        cfg, qp_cfg, camp, ref_cfg, p_start, pobs, pobs_real, k_run,
        backend, warm_start_qp=warm_start_qp)


def _run_campaign_batch_core(
    cfg: MpcConfig,
    qp_cfg: QpConfig,
    camp: CampaignConfig,
    ref_cfg: refplan.RefPlanConfig,
    p_start,
    pobs,          # (S, 2, n_obs) nominal fields (APF input)
    pobs_real,     # (S, 2, n_obs) true fields (CBF + failure detection)
    k_run,         # the kicks' key; None without disturbance
    backend: str,
    warm_start_qp: bool = False,
) -> CampaignResult:
    """The campaign on given fields: `plan_lanes`, then `run_domains`. The
    run's dtype and device are `pobs_real`'s."""
    pr_l, prd_l = plan_lanes(ref_cfg, p_start, pobs, camp.n_agents,
                             pobs_real.dtype, pobs_real.device)
    return run_domains(cfg, qp_cfg, camp, p_start, pr_l, prd_l, pobs_real,
                       k_run, backend, warm_start_qp)


def run_campaign_chunked(
    cfg: MpcConfig,
    qp_cfg: QpConfig,
    camp: CampaignConfig,
    ref_cfg: refplan.RefPlanConfig,
    p_start,
    key,
    n_scenarios: int,
    max_chunk: int = 512,
    batch_backend: str | None = None,
    dtype=torch.float64,
    device=None,
) -> CampaignResult:
    """The campaign in chunks of at most `max_chunk` scenarios, each through
    `run_campaign_batch` on `batch_backend`: one chunk on `key` when
    n_scenarios <= max_chunk, else one on each key of `split(key,
    n_chunks)`, the results concatenated along the scenario axis, as the
    JAX package's `run_campaign_chunked`. n_scenarios must divide into
    chunks of max_chunk. dtype and device as in `run_campaign_batch`.

    batch_backend=None, the JAX package's per-agent vmapped path
    (`run_campaign` over `run_scenario`), is not ported yet (ROADMAP M10's
    rest) and raises NotImplementedError.
    """
    if batch_backend is None:
        raise NotImplementedError(
            "srbx_torch runs run_campaign_chunked through run_campaign_batch "
            "only (pass batch_backend); the per-agent path, run_scenario and "
            "run_campaign over mpc.run_nmpc, is ROADMAP M10's rest")

    def runner(k, n):
        return run_campaign_batch(cfg, qp_cfg, camp, ref_cfg, p_start, k, n,
                                  backend=batch_backend, dtype=dtype,
                                  device=device)

    key = prng.as_key(key, device)
    if n_scenarios <= max_chunk:
        return runner(key, n_scenarios)
    n_chunks, rem = divmod(n_scenarios, max_chunk)
    if rem:
        raise ValueError(f"n_scenarios={n_scenarios} not divisible by "
                         f"{max_chunk}")
    outs = [runner(k, max_chunk) for k in prng.split(key, n_chunks)]
    return CampaignResult(*(torch.cat(xs, 0) for xs in zip(*outs)))


def plan_lanes(ref_cfg: refplan.RefPlanConfig, p_start, pobs, n_agents: int,
               dtype, device):
    """Every scenario's APF reference in one rollout, per lane (scenario-
    major, agent-minor): (pr, prd), each (S * n_agents, 2, T)."""
    p_start = torch.as_tensor(p_start).to(dtype=dtype, device=device)
    ref = refplan.generate(ref_cfg, p_start, pobs, dtype=dtype,
                           device=device)                 # (S, 2 na, T)
    n_lanes = pobs.shape[0] * n_agents
    return (ref.pr.reshape(n_lanes, 2, -1), ref.prd.reshape(n_lanes, 2, -1))


def run_domains(cfg: MpcConfig, qp_cfg: QpConfig, camp: CampaignConfig,
                p_start, pr_l, prd_l, pobs_real, k_run, backend: str,
                warm_start_qp: bool = False) -> CampaignResult:
    """The closed loop over `camp.n_domains` gait domains, one NMPC cycle
    for all lanes a domain, on the lanes' references (`plan_lanes`). It
    keeps the JAX package's carry: the MPC carries, q, dq, the latched
    failure flag and distance, the minimum clearance, the per-lane converged
    count and, for `warm_start_qp`, the previous domain's decision vector.
    The run's dtype and device are `pobs_real`'s."""
    dtype, device = pobs_real.dtype, pobs_real.device
    n_scenarios = pobs_real.shape[0]
    na = camp.n_agents
    n_lanes = n_scenarios * na
    if camp.disturbance > 0 and k_run is None:
        raise ValueError("camp.disturbance > 0 needs a key (k_run)")
    keys = (prng.split(prng.as_key(k_run, device), camp.n_domains)
            if camp.disturbance > 0 else None)
    agent0 = torch.as_tensor(p_start).to(dtype=dtype, device=device) \
        .reshape(na, 2)
    pobs_l = pobs_real.repeat_interleave(na, 0)           # (L, 2, n_obs)
    agent0_l = agent0.repeat(n_scenarios, 1)              # (L, 2)
    contacts = _contact_table(camp.n_domains, dtype, device)
    eps = cfg.cbf_eps if camp.inter_agent_cbf else 0.0

    carries = mpc.init_carry(agent0_l, dtype)
    q = agent0_l
    dq = torch.zeros((n_lanes, 2), dtype=dtype, device=device)
    failed = torch.zeros((n_lanes,), dtype=torch.bool, device=device)
    fail_dist = torch.zeros((n_lanes,), dtype=dtype, device=device)
    min_clear = torch.full((n_lanes,), float("inf"), dtype=dtype,
                           device=device)
    ok_cnt = torch.zeros((n_lanes,), dtype=torch.int32, device=device)
    zero = torch.zeros_like(agent0_l[:, 0])
    x_prev = mpc.hold_position_x(
        cfg, torch.stack([agent0_l[:, 0], zero, agent0_l[:, 1], zero], 1),
        torch.ones((n_lanes, 4), dtype=dtype, device=device))
    traj = []
    for dom in range(camp.n_domains):
        # neighbour exchange: each agent sees the next agent's (x, y, dx, dy)
        other = torch.cat([q, dq], 1).reshape(n_scenarios, na, 4)
        other = other.roll(-1, 1).reshape(n_lanes, 4)
        # state_other is always passed; the eps gate masks the neighbour
        # circle's rows when the inter-agent CBF is off, as in the JAX
        # package
        out = mpc_batch.run_nmpc_batch(
            cfg, qp_cfg, carries, q, dq, default_footholds(q),
            contacts[dom].expand(n_lanes, 4), pr_l, prd_l, agent0_l, pobs_l,
            backend=backend, state_other=other, agent_circle_eps=eps,
            x0_warm=x_prev if warm_start_qp else None)
        q_n = out.states[:, -1, 0::2]                     # (x, y)
        dq_n = out.states[:, -1, 1::2]                    # (dx, dy)
        if camp.disturbance > 0:
            dq_n = dq_n + camp.disturbance * prng.normal(
                keys[dom], dq_n.shape, dtype)

        # failure detector (`src/MPC_dist.cpp:21-40`), latched per lane
        diff = q_n[:, :, None] - pobs_l
        clear = torch.sqrt((diff * diff).sum(1)).amin(1)  # (L,)
        newly_failed = (clear < camp.fail_radius) & ~failed
        fail_dist = torch.where(newly_failed,
                                torch.sqrt((q_n * q_n).sum(1)), fail_dist)
        failed = failed | newly_failed
        min_clear = torch.minimum(min_clear, clear)
        ok_cnt = ok_cnt + out.qp_converged.to(torch.int32)
        carries, q, dq, x_prev = out.carry, q_n, dq_n, out.x
        traj.append(q_n)

    def unlane(arr):
        return arr.reshape((n_scenarios, na) + arr.shape[1:])

    return CampaignResult(
        success=unlane(~failed),
        fail_distance=unlane(fail_dist),
        min_clearance=unlane(min_clear),
        final_xy=unlane(q),
        qp_ok_frac=unlane(ok_cnt).sum(1).to(dtype) / (camp.n_domains * na),
        traj=torch.stack(traj, 1).reshape(n_scenarios, na, -1, 2)
        .transpose(1, 2),
    )
