"""The JAX package's claims of the per-agent loops through srbx_torch at
the JAX tests' depth.

Two runs, each checked against the claims of its JAX test:

1. tests/test_wholebody.py:71-97 (test_full_fidelity_trot_tracks_reference):
   `closedloop.run` of one agent from the origin, `MpcConfig(use_sqp=False)`,
   800 stand ticks and 10 trot domains of 172 ticks, on the two-agent APF
   reference (loop 20,000) among far obstacles. Claims: x > 0.15 m, within
   0.15 m of the reference's x at column 40, |y| < 0.1 m, |z - 0.28| < 0.02
   m, roll, pitch and yaw under 0.1 rad, LL qp_ok > 0.98, mpc_ok 1, max
   |tau| <= 50 Nm.
2. tests/test_team.py:15-48 (test_two_agent_team_trots_without_collision):
   `closedloop.run_team` of two agents started 1.2 m apart,
   `MpcConfig(use_sqp=True, sqp_iters=2)`, 800 stand ticks and 8 domains.
   Claims: finite, both x > 0.1 m, roll, pitch and yaw under 0.15 rad,
   |z - 0.28| < 0.03 m, separation > 0.8 m, every CBF margin >= cbf_eps -
   1e-3, every domain's LL qp_ok > 0.95.

    python scripts/torch_per_agent_depth.py [--device cpu] [--stand N]
        [--domains N N] [--loop N]

Runs in float64 (the JAX tests' dtype), on the card unless told otherwise;
`--stand`, `--domains` and `--loop` (the reference's steps) cut the depth
for a rehearsal on the CPU (the claims are then not expected to hold).
Prints one JSON object: each run's claims, the quantities they read, its
wall seconds and ms per tick (one synchronize at its end, after a two-tick
warm-up), and the card's name and power limit. Exits 1 when a claim fails.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from srbx_torch import refplan  # noqa: E402
from srbx_torch.config import (LowLevelConfig, MotionConfig,  # noqa: E402
                               MpcConfig, QpConfig)
from srbx_torch.models import a1  # noqa: E402
from srbx_torch.sim import closedloop, wholebody as wb  # noqa: E402

LL, MOTION, QP, SIM = LowLevelConfig(), MotionConfig(), QpConfig(), \
    wb.SimConfig()
DTYPE = torch.float64                  # the JAX tests' dtype


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def reference(p_start, device, loop):
    pobs = torch.full((2, 20), 100.0, dtype=DTYPE, device=device)
    traj = refplan.generate(refplan.two_agent_config(loop_size=loop),
                            torch.tensor(p_start, dtype=DTYPE, device=device),
                            pobs, dtype=DTYPE, device=device)
    return traj, pobs


def timed(fn, ticks, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    wall = time.perf_counter() - t0
    return out, {"wall_s": wall, "ticks": ticks,
                 "ms_per_tick": wall * 1e3 / ticks}


def single(device, stand, domains, loop):
    """Run 1: tests/test_wholebody.py:71-97."""
    traj, pobs = reference([0.0, 0.0, 0.0, -1.0], device, loop)
    a0 = torch.zeros(2, dtype=DTYPE, device=device)

    def go(stand, n, ticks=172):
        return closedloop.run(
            MpcConfig(use_sqp=False), LL, MOTION, QP, SIM,
            closedloop.LoopConfig(stand, n, ticks), a1.model(),
            traj.pr[0:2], traj.prd[0:2], a0, pobs, dtype=DTYPE, device=device)

    go(1, 1, 1)                                    # warm-up
    res, rec = timed(lambda: go(stand, domains), stand + 172 * domains,
                     device)
    q = res.sim.q.double().cpu().numpy()
    ref_x = float(traj.pr[0, 40])
    tau_max = float(res.tau_hist[:, 0].max())
    rec.update({
        "test": "tests/test_wholebody.py:71-97", "stand": stand,
        "domains": domains, "q_xyz": q[0:3].tolist(),
        "rpy": q[3:6].tolist(), "ref_x": ref_x,
        "qp_ok": float(res.qp_ok), "mpc_ok": float(res.mpc_ok),
        "tau_max": tau_max,
        "claims": {
            "x > 0.15": bool(q[0] > 0.15),
            "|x - ref_x| < 0.15": bool(abs(q[0] - ref_x) < 0.15),
            "|y| < 0.1": bool(abs(q[1]) < 0.1),
            "|z - 0.28| < 0.02": bool(abs(q[2] - MOTION.stand_height)
                                      < 0.02),
            "|rpy| < 0.1": bool(np.abs(q[3:6]).max() < 0.1),
            "qp_ok > 0.98": float(res.qp_ok) > 0.98,
            "mpc_ok == 1": float(res.mpc_ok) == 1.0,
            "tau_max <= 50": tau_max <= 50.0 + 1e-6,
        }})
    return rec


def team(device, stand, domains, loop):
    """Run 2: tests/test_team.py:15-48."""
    p_start = [0.0, 0.6, 0.0, -0.6]
    traj, pobs = reference(p_start, device, loop)
    a0 = torch.tensor(p_start, dtype=DTYPE, device=device).reshape(2, 2)
    cfg = MpcConfig(use_sqp=True, sqp_iters=2)

    def go(stand, n, ticks=172):
        return closedloop.run_team(
            cfg, LL, MOTION, QP, SIM,
            closedloop.LoopConfig(stand, n, ticks), a1.model(),
            traj.pr.reshape(2, 2, -1), traj.prd.reshape(2, 2, -1), a0, pobs,
            dtype=DTYPE, device=device)

    go(1, 1, 1)
    (sims, _, margins, llok), rec = timed(
        lambda: go(stand, domains), stand + 172 * domains, device)
    q = sims.q.double().cpu().numpy()
    sep = float(np.linalg.norm(q[0, 0:2] - q[1, 0:2]))
    m_min, ok_min = float(margins.min()), float(llok.min())
    rec.update({
        "test": "tests/test_team.py:15-48", "stand": stand,
        "domains": domains, "x": q[:, 0].tolist(), "z": q[:, 2].tolist(),
        "rpy_max": float(np.abs(q[:, 3:6]).max()), "separation": sep,
        "margin_min": m_min, "llok_min": ok_min,
        "claims": {
            "finite": bool(np.isfinite(q).all()),
            "x > 0.1": bool((q[:, 0] > 0.1).all()),
            "|rpy| < 0.15": bool(np.abs(q[:, 3:6]).max() < 0.15),
            "|z - 0.28| < 0.03": bool(np.abs(q[:, 2] - 0.28).max() < 0.03),
            "separation > 0.8": sep > 0.8,
            "margin >= cbf_eps - 1e-3": m_min >= cfg.cbf_eps - 1e-3,
            "llok > 0.95": ok_min > 0.95,
        }})
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stand", type=int, default=800)
    ap.add_argument("--domains", type=int, nargs=2, default=(10, 8),
                    metavar=("SINGLE", "TEAM"))
    ap.add_argument("--loop", type=int, default=20_000,
                    help="the reference planner's steps")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_per_agent_depth: no CUDA card; pass --device cpu",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = [single(device, args.stand, args.domains[0], args.loop),
            team(device, args.stand, args.domains[1], args.loop)]
    out = {"runs": runs, "dtype": str(DTYPE),
           "device": card_name() if device.type == "cuda" else "cpu",
           "torch": torch.__version__}
    print(json.dumps(out, indent=1))
    return 0 if all(all(r["claims"].values()) for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
