"""Where chip_smoke.py's time goes, part by part, on the card.

The smoke runs the team golden's loop and its float64 kernels-vs-plain
loops (SIDE_JOBS) in side processes (SIDE_GROUPS) beside phases 15 and
16. This script times, each on its own:

1. phase 18's loop (run_velocity_gait, WALK, B 4096, float32, "fused",
   the reduced LL build after 5 Ruiz sweeps; 20 stand and 30 WALK ticks)
   alone, beside one side process and beside the smoke's side processes,
   and how long those processes take to finish after it;
2. the team golden (chip_smoke.team_golden_run: its 644 ticks, on the
   plan of team_golden_plan) alone, held to the golden's bounds;
3. each side job alone, in this process.

With `--only per_agent` it times phase 19's parts alone instead: its two
float64 side jobs (agent_run, agent_team) in this process, then the phase
itself (`per_agent_phase`: the float32 team at the paper's configuration,
its profile, the checks of the side jobs' results).

    python scripts/torch_smoke_parts.py [--device cpu] [--only per_agent]

Prints one JSON object a part, each with the seconds since the start, and
first the card's name and power limit. On the CPU (`--device cpu`, a
check of the script itself) it runs part 1's loop alone at 8 lanes and
part 3's first job at 2.
"""
import argparse
import json
import os
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

T0 = time.perf_counter()


def rec(d):
    d["elapsed_s"] = time.perf_counter() - T0
    print(json.dumps(d, default=str), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--only", choices=("per_agent",))
    args = ap.parse_args()
    cpu = args.device == "cpu"
    dev = torch.device("cpu" if cpu else "cuda")
    B = 8 if cpu else 4096
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from srbx_torch import refplan
    from srbx_torch.config import (LowLevelConfig, MotionConfig, MpcConfig,
                                   QpConfig)
    from srbx_torch.models import a1
    from srbx_torch.ops import _build, qp_batch
    from srbx_torch.sim import wholebody as wb

    smi = "cpu"
    if not cpu:
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    if args.only == "per_agent":
        return per_agent(dev, smi, cpu)
    if not cpu:
        t0 = time.perf_counter()
        _build.build()
        _build.load()
        rec({"what": "build", "s": time.perf_counter() - t0, "smi": smi,
             "cpus": os.cpu_count(),
             "affinity": len(os.sched_getaffinity(0))})
    f32 = torch.float32
    p_start = np.array([0.0, 0.5, 0.0, -0.5])
    a0 = p_start[:2] + np.linspace(0.0, 0.01, B)[:, None] * np.array(
        [1.0, 0.0])
    pobs = np.full((B, 2, 20), 100.0)
    ref = refplan.generate(refplan.two_agent_config(loop_size=4_000),
                           torch.tensor(p_start, dtype=f32, device=dev),
                           torch.tensor(pobs[0], dtype=f32, device=dev),
                           dtype=f32, device=dev)
    pr = ref.pr[0:2].expand(B, -1, -1)
    prd = ref.prd[0:2].expand(B, -1, -1)
    w = types.SimpleNamespace(
        model=a1.model(), ll_cfg=LowLevelConfig(), motion_cfg=MotionConfig(),
        sim_cfg=wb.SimConfig(),
        mpc=MpcConfig(use_sqp=True, sqp_iters=1, condensed=True,
                      elide_box_rows=True, elide_simplex=True),
        relaxed=QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                         reg_dual=1e-6, max_iters=12),
        pr=pr, prd=prd, a0=a0, pobs=pobs, dev=dev,
        lanes=cs.loop_lanes(dev, pr, prd, a0, pobs))
    if cpu:
        cs.WB_CROSS_LANES = 2
    else:
        w.golden = cs.team_golden_plan(dev)

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    def walk(stand, ticks):
        """Seconds of a WALK run of `stand` + `ticks` ticks on B lanes."""
        with qp_batch.full_f32_products():
            t0 = time.perf_counter()
            cs.run_gait(w, "WALK", f32, B, stand, ticks,
                        ll_qp_cfg=cs.dataclasses.replace(cs.vel_qp_cfg(),
                                                         ruiz_iters=5))
            sync()
            return time.perf_counter() - t0

    # (1) a B 4096 WALK run alone (warm-up first), then beside one side
    # process, then beside the smoke's
    walk(2, 2)
    s = walk(20, 30)
    rec({"what": "walk_alone", "ticks": 50, "s": s, "ms_per_tick": s * 20})
    for groups in () if cpu else ((("clf", "est"),), cs.SIDE_GROUPS):
        sides = [cs.start_side(w, g) for g in groups]
        time.sleep(15)   # let the side processes reach the card
        s = walk(20, 30)
        rec({"what": "walk_beside", "groups": groups, "ticks": 50, "s": s,
             "ms_per_tick": s * 20})
        t0 = time.perf_counter()
        out = cs.finish_sides(sides, smi)
        rec({"what": "sides_finished_after_walk",
             "waited_s": time.perf_counter() - t0,
             "job_s": {k: v["seconds"] for k, v in out.items()}})
    # (2) the team golden alone
    if not cpu:
        t0 = time.perf_counter()
        cs.team_golden_check(cs.team_golden_run(w), w.golden["planner_s"],
                             smi)
        rec({"what": "golden_alone", "s": time.perf_counter() - t0})
    # (3) each side job alone in this process
    for job, fn in cs.SIDE_JOBS.items():
        if job == "golden":
            continue
        t0 = time.perf_counter()
        with qp_batch.full_f32_products():
            fn(w)
        sync()
        rec({"what": "job_alone", "job": job, "s": time.perf_counter() - t0})
        if cpu:
            break


def per_agent(dev, smi, cpu):
    """Phase 19's side jobs alone, then the phase."""
    from srbx_torch.config import LowLevelConfig, MotionConfig
    from srbx_torch.models import a1
    from srbx_torch.ops import qp_batch
    from srbx_torch.sim import wholebody as wb

    rec({"what": "per_agent", "smi": smi, "cpus": os.cpu_count()})
    w = types.SimpleNamespace(model=a1.model(), ll_cfg=LowLevelConfig(),
                              motion_cfg=MotionConfig(),
                              sim_cfg=wb.SimConfig(), dev=dev)
    out = {}
    for job in ("agent_run", "agent_team"):
        t0 = time.perf_counter()
        with qp_batch.full_f32_products():
            out[job] = cs.SIDE_JOBS[job](w)
        out[job].update(ok=True, seconds=time.perf_counter() - t0)
        rec({"what": "job_alone", "job": job, "s": out[job]["seconds"],
             "run_s": out[job]["run_s"], "batch_s": out[job]["batch_s"]})
    t0 = time.perf_counter()
    cs.per_agent_phase(dev, smi, w, out["agent_run"], out["agent_team"])
    rec({"what": "per_agent_phase", "s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
