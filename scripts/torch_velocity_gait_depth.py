"""The WALK claim of the JAX package's tests/test_wholebody.py:199-226
(test_velocity_gait_walk_and_pace) through srbx_torch at its depth and at
the smoke's width.

The JAX test runs `run_velocity_gait(Gait.WALK, ...)` on 2 lanes in
float64: `MotionConfig(fwd_speed=0.15)`, `LoopConfig(stand_ticks=400)`,
the relaxed LL solver (abstol 2e-3, reltol 1e-4, reg 1e-6, 12
iterations), the reduced LL build, 2000 WALK ticks, and claims: every lane
cycles at least 8 domains, its LL QPs converge on more than 95 % of the
ticks, its COM stays above 0.25 m, and its base ends more than 0.05 m
ahead of where it started. Here the same run goes through the port at
`--lanes` lanes (4096 by default, the smoke's phase 18 width) in float32
(the smoke's), on backend "fused" on the card ("xla" on the CPU), the
lanes' starts spread over 0-0.01 m in x. Each claim is checked on every
lane.

    python scripts/torch_velocity_gait_depth.py [--lanes N] [--device cpu]

Prints one JSON object: the claims, per-lane minima and quantiles of the
quantities they read, the LL ticks/s of the run (one synchronize at its
end, after a warm-up that builds the kernels), and the card's name and
power limit. Exits 1 when a claim fails on some lane.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from srbx_torch.config import (Gait, LowLevelConfig,  # noqa: E402
                               MotionConfig, QpConfig)
from srbx_torch.models import a1  # noqa: E402
from srbx_torch.sim import closedloop, wholebody as wb  # noqa: E402

STAND, TICKS = 400, 2000
RELAXED = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                   reg_dual=1e-6, max_iters=12)


def run(a0, stand, ticks, device):
    backend = "fused" if device.type == "cuda" else "xla"
    return closedloop.run_velocity_gait(
        Gait.WALK, LowLevelConfig(),
        dataclasses.replace(MotionConfig(), fwd_speed=0.15), RELAXED,
        wb.SimConfig(), closedloop.LoopConfig(stand_ticks=stand), a1.model(),
        a0, ticks, dtype=torch.float32, backend=backend, ll_reduced=True,
        device=device)


def quantiles(x):
    x = x.double().cpu()
    return {"min": x.min().item(), "p50": x.median().item(),
            "max": x.max().item()}


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_velocity_gait_depth: no CUDA card; pass --device cpu",
              file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    a0 = np.zeros((args.lanes, 2))
    a0[:, 0] = np.linspace(0.0, 0.01, args.lanes)
    run(a0[:2], 2, 2, device)                           # builds the kernels
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(a0, STAND, TICKS, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x0 = torch.as_tensor(a0[:, 0], dtype=torch.float64)
    advance = res.sim.q[:, 0].double().cpu() - x0
    z_min = res.com_hist[:, :, 2].amin(1)
    qp_ok = res.qp_ok.double()
    finite = all(bool(torch.isfinite(t).all()) for t in (
        res.sim.q, res.sim.qd, res.com_hist))
    claims = {
        "domains >= 8": bool((res.domains >= 8).all()),
        "qp_ok > 0.95": bool((qp_ok > 0.95).all()),
        "com z > 0.25 m": bool((z_min > 0.25).all()),
        "x advance > 0.05 m": bool((advance > 0.05).all()),
        "finite": finite,
    }
    out = {
        "claims": claims,
        "lanes": args.lanes, "stand_ticks": STAND, "walk_ticks": TICKS,
        "dtype": "float32",
        "backend": "fused" if device.type == "cuda" else "xla",
        "domains": quantiles(res.domains),
        "ll_qp_ok": quantiles(qp_ok),
        "walk_com_z_min": quantiles(z_min),
        "x_advance_m": quantiles(advance),
        "des_vel_x_end": quantiles(res.agent.planner.des_vel[:, 0]),
        "wall_s": wall,
        "ll_ticks_per_s": args.lanes * (STAND + TICKS) / wall,
        "ms_per_tick": wall * 1e3 / (STAND + TICKS),
        "device": card_name() if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
    }
    print(json.dumps(out, indent=1))
    return 0 if all(claims.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
