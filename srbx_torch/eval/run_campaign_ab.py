"""The template A/B success-rate campaign on one CUDA card: QP-only
against CBF-SQP, the batch form of the reference's NUMBER_OF_SIMS loop with
its per-scenario solver A/B (`src/A1_Sim.cpp:931,983,1167-1176`).

    python -m srbx_torch.eval.run_campaign_ab [n_scenarios] [n_domains] [seed]

Counterpart of `srbx/eval/run_campaign_ab.py`: 2 agents a scenario, 20
obstacles a field, the APF reference of 40,000 steps, float32, the relaxed
solver configuration, both legs in the formulation
"condensed+simplex+elided+fused" (the lanes-last NMPC cycle through kernel
K1a). The fields are drawn as the JAX runner draws them, from `key(seed)`
(seed 0 by default, the JAX runner's `jax.random.key(0)`) split into the
fields' key and the run's (`campaign.sample_obstacles` on the first, in
float32): at 1024 scenarios they are the JAX package's fields behind
`docs/CAMPAIGN_1024.json` (also committed in
`tests/data/campaign_fields_jax.npz`), so that the success rates compare
with it.

Each leg runs twice, each run ended by one synchronize: the first (with
any kernel build and lazy initialisation) and the steady run, whose planner
and domain loop are timed apart (`planner_s`, `loop_s`, one synchronize
between them). domains_per_s = n_scenarios x n_agents x n_domains / steady
wall, as the JAX runner defines it. Writes docs/CAMPAIGN_TORCH_<n>.json
with the card's name and power limit (nvidia-smi) and prints the summary.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

from srbx_torch import refplan
from srbx_torch.config import MpcConfig, QpConfig
from srbx_torch.eval import analysis, campaign
from srbx_torch.utils import prng

ROOT = Path(__file__).resolve().parents[2]
FORMULATION = "condensed+simplex+elided+fused"
QP_CFG = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6, reg_dual=1e-6,
                  max_iters=12)
P_START = (0.0, 0.5, 0.0, -0.5)
LEGS = {"qp_only": False, "cbf_sqp": True}


def leg_config(use_sqp: bool) -> MpcConfig:
    return MpcConfig(use_sqp=use_sqp, sqp_iters=2, condensed=True,
                     elide_box_rows=True, elide_simplex=True)


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(n_scenarios: int = 1024, n_domains: int = 120, seed: int = 0,
         device=None, loop_size: int = 40_000, legs=tuple(LEGS), out=None):
    """Run the A/B legs; returns (summary, {leg: CampaignResult}).

    device=None means the CUDA card, and without one the runner raises;
    pass device="cpu" to run on the CPU. `out` is the JSON path (default
    docs/CAMPAIGN_TORCH_<n>.json).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_campaign_ab needs a CUDA card; pass "
                           "device='cpu' to run on the CPU")
    dtype = torch.float32
    camp = campaign.CampaignConfig(n_agents=2, n_domains=n_domains)
    ref_cfg = refplan.two_agent_config(loop_size=loop_size)
    k_obs, k_run = prng.split(prng.key(seed, device)).unbind(-2)
    pobs, pobs_real = campaign.sample_obstacles(
        k_obs, n_scenarios, camp.n_obstacles, camp.obstacle_uncertainty,
        dtype, device)
    fields = f"campaign.sample_obstacles on split(jax key {seed})[0]"
    p_start = torch.tensor(P_START, dtype=dtype, device=device)

    out_d = {"n_scenarios": n_scenarios, "n_domains": n_domains,
             "n_agents": camp.n_agents, "loop_size": loop_size,
             "dtype": str(dtype).removeprefix("torch."), "fields": fields,
             "device": card_name() if device.type == "cuda" else "cpu",
             "torch": torch.__version__, "formulation": {}}
    results = {}
    for label in legs:
        cfg = leg_config(LEGS[label])
        out_d["formulation"][label] = FORMULATION
        t0 = time.perf_counter()
        res = campaign._run_campaign_batch_core(
            cfg, QP_CFG, camp, ref_cfg, p_start, pobs, pobs_real, k_run,
            "fused")
        _sync(device)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        pr_l, prd_l = campaign.plan_lanes(ref_cfg, p_start, pobs,
                                          camp.n_agents, dtype, device)
        _sync(device)
        t1 = time.perf_counter()
        res = campaign.run_domains(cfg, QP_CFG, camp, p_start, pr_l, prd_l,
                                   pobs_real, k_run, "fused")
        _sync(device)
        t2 = time.perf_counter()
        summ = analysis.campaign_summary(res)
        summ.update(wall_s_first=first, wall_s_steady=t2 - t0,
                    planner_s=t1 - t0, loop_s=t2 - t1,
                    domains_per_s=n_scenarios * camp.n_agents * n_domains
                    / (t2 - t0))
        out_d[label] = summ
        results[label] = res
        brief = {k: v for k, v in summ.items() if k != "failing_distances"}
        print(label, brief, flush=True)

    path = Path(out) if out else ROOT / "docs" / \
        f"CAMPAIGN_TORCH_{n_scenarios}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    analysis.dump_json(out_d, str(path))
    print("wrote", path, flush=True)
    return out_d, results


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)
