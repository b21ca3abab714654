"""Scenario-batched 4-agent whole-body teams on one CUDA card: the
A1_Sim_4_agents workload (`src/A1_Sim_4_agents.cpp`) replicated over S
randomized obstacle fields, S x 4 full-fidelity robots (18-DoF physics, the
1 kHz low-level QP, the NMPC with neighbour CBF circles) as one program.

    python -m srbx_torch.eval.run_team [S] [n_domains] [stand_ticks] [seed]

Counterpart of `scripts/run_team_batch_scale.py` (its mode "batch-r") at the
production operating point of `scripts/run_team4_wholebody.py:38-57`:
float32; `MpcConfig(use_sqp=True, sqp_iters=1, condensed=True,
elide_box_rows=True, elide_simplex=True)`; the relaxed `QpConfig`; backend
"fused"; the reduced LL QP (n 25, me 12), which float32 solves after 5 Ruiz
sweeps. The agents start at `P_START` and follow the APF reference of four
agents (`loop_size` 20,000 steps). Each field has 20 obstacles, x uniform
in [3, 8] and y in [-2, 2], drawn as the JAX script draws them from
`jax.random.key(seed)` (seed 7 there): `split`, then a float32 uniform on
each subkey (`srbx_torch.utils.prng`), so that the fields are the JAX
script's.

A short warm-up run (2 stand ticks, one domain of 2 ticks) comes first;
then the timed run: the batched planner over the S fields (`planner_s`)
and the team loop (`loop_s`), each ended by a synchronize.
robot_ticks_per_s = S x 4 x ticks per robot / (planner_s + loop_s), as the
JAX script counts it (its steady wall includes the planner); the loop's own
rate is `loop_robot_ticks_per_s`. Prints one JSON line with the checks of
the JAX script (the minimum distance between two agents of a scenario at
the end, the minimum CBF margin, the LL-QP converged share, all finite) and
the card's name and power limit.
"""

from __future__ import annotations

import itertools
import json
import sys
import time

import torch

from srbx_torch import refplan
from srbx_torch.config import LowLevelConfig, MotionConfig, MpcConfig, QpConfig
from srbx_torch.eval.run_campaign_ab import card_name
from srbx_torch.models import a1
from srbx_torch.sim import closedloop, wholebody as wb
from srbx_torch.utils import prng

N_AGENTS = 4
N_OBSTACLES = 20
P_START = (0.0, 1.5, 0.0, 0.5, 0.0, -0.5, 0.0, -1.5)
MPC_CFG = MpcConfig(use_sqp=True, sqp_iters=1, condensed=True,
                    elide_box_rows=True, elide_simplex=True)
QP_CFG = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6, reg_dual=1e-6,
                  max_iters=12)
BACKEND = "fused"


def sample_fields(n_scenarios: int, seed: int, dtype, device):
    """(S, 2, 20) obstacle fields, x in [3, 8] and y in [-2, 2]: the JAX
    script's draws from `key(seed)` (float32 uniforms on the two keys of its
    split), in `dtype` on `device`."""
    k1, k2 = prng.split(prng.key(seed, device)).unbind(-2)
    xs = prng.uniform(k1, (n_scenarios, N_OBSTACLES), torch.float32, 3.0, 8.0)
    ys = prng.uniform(k2, (n_scenarios, N_OBSTACLES), torch.float32, -2.0,
                      2.0)
    return torch.stack([xs, ys], 1).to(dtype=dtype, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(pobs, loop: closedloop.LoopConfig, loop_size: int = 20_000,
        dtype=torch.float32):
    """The planner and the team loop on fields pobs (S, 2, 20), on their
    device. Returns (run_team_batch's result, planner_s, loop_s)."""
    device = pobs.device
    n_scen = pobs.shape[0]
    p_start = torch.tensor(P_START, dtype=dtype, device=device)
    _sync(device)
    t0 = time.perf_counter()
    ref = refplan.generate(refplan.four_agent_config(loop_size=loop_size),
                           p_start, pobs, dtype=dtype, device=device)
    _sync(device)
    t1 = time.perf_counter()
    out = closedloop.run_team_batch(
        MPC_CFG, LowLevelConfig(), MotionConfig(), QP_CFG, wb.SimConfig(),
        loop, a1.model(), ref.pr.reshape(n_scen, N_AGENTS, 2, -1),
        ref.prd.reshape(n_scen, N_AGENTS, 2, -1),
        p_start.reshape(1, N_AGENTS, 2).expand(n_scen, -1, -1), pobs,
        dtype=dtype, backend=BACKEND, ll_reduced=True, device=device)
    _sync(device)
    return out, t1 - t0, time.perf_counter() - t1


def summarize(out, loop: closedloop.LoopConfig, planner_s, loop_s):
    """The JAX script's line: rates and checks of one run."""
    sims, com_ends, margins, llok = out
    n_scen = com_ends.shape[1]
    final = com_ends[-1, :, :, 0:2]                        # (S, A, 2)
    dmin = min((final[:, i] - final[:, j]).norm(dim=-1).min().item()
               for i, j in itertools.combinations(range(N_AGENTS), 2))
    ticks = loop.stand_ticks + loop.n_domains * loop.ticks_per_domain
    robot_ticks = n_scen * N_AGENTS * ticks
    return {
        "scenarios": n_scen, "agents": N_AGENTS,
        "robots": n_scen * N_AGENTS, "stand_ticks": loop.stand_ticks,
        "n_domains": loop.n_domains,
        "ticks_per_domain": loop.ticks_per_domain, "ticks_per_robot": ticks,
        "planner_s": planner_s, "loop_s": loop_s,
        "robot_ticks_per_s": robot_ticks / (planner_s + loop_s),
        "loop_robot_ticks_per_s": robot_ticks / loop_s,
        "min_inter_agent_distance": dmin,
        "min_cbf_margin": margins.min().item(),
        "ll_qp_ok": llok.double().mean().item(),
        "finite": all(bool(torch.isfinite(t).all()) for t in (
            sims.q, sims.qd, com_ends, margins, llok)),
    }


def main(n_scenarios: int = 64, n_domains: int = 8, stand_ticks: int = 800,
         seed: int = 7, device=None, loop_size: int = 20_000):
    """Warm up, run once timed and print the summary line; returns
    (summary, run_team_batch's result). device=None means the CUDA card,
    and without one the runner raises; pass device="cpu" to run on the
    CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_team needs a CUDA card; pass device='cpu' "
                           "to run on the CPU")
    dtype = torch.float32
    pobs = sample_fields(n_scenarios, seed, dtype, device)
    run(pobs, closedloop.LoopConfig(2, 1, 2), loop_size, dtype)   # warm-up
    loop = closedloop.LoopConfig(stand_ticks=stand_ticks,
                                 n_domains=n_domains)
    out, planner_s, loop_s = run(pobs, loop, loop_size, dtype)
    summ = summarize(out, loop, planner_s, loop_s)
    summ.update(seed=seed, loop_size=loop_size, dtype="float32",
                backend=BACKEND, ll_reduced=True,
                device=card_name() if device.type == "cuda" else "cpu",
                torch=torch.__version__)
    print(json.dumps(summ), flush=True)
    return summ, out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
