#!/usr/bin/env python3
"""How far rounding alone moves the whole-body LL QP's solution.

    python3 scripts/torch_ll_qp_conditioning.py [--lanes 2048] [--ulps 4]

Builds the low-level QPs (n 43, me 30, mi 45) that `agent.tick_build` makes
from the stand and trot states `chip_smoke.py` checks K1b on (the crouched
start with numpy noise of seed 4: joints 0.1 rad, base angles 0.03 rad,
rates 0.2), on the CPU in float64, and solves each twice with the fused
IPM's plain PyTorch version under `QpConfig()`: once as built, once with h
scaled by (1 + ulps * eps). Prints per case the converged share, the lanes
whose converged flag or iteration count differ between the two solves, and
the largest change of x on lanes converged in both. This is the spread that
any other order of the same arithmetic (such as the CUDA kernel's) may show.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=2048)
    ap.add_argument("--ulps", type=float, default=4.0)
    args = ap.parse_args()

    from srbx_torch import agent, motion
    from srbx_torch.config import Gait, LowLevelConfig, MotionConfig, QpConfig
    from srbx_torch.estimation import contact
    from srbx_torch.models import a1, rbd
    from srbx_torch.ops import qp_fused, spd
    from srbx_torch.sim import closedloop, wholebody as wb

    f64, cpu, bsz = torch.float64, torch.device("cpu"), args.lanes
    model = a1.model()
    ll_cfg, motion_cfg, sim_cfg = LowLevelConfig(), MotionConfig(), \
        wb.SimConfig()
    loop = closedloop.LoopConfig(stand_ticks=800, n_domains=2,
                                 ticks_per_domain=172)
    # the states of chip_smoke.py's wb_states, on the CPU
    a0 = np.array([0.0, 0.5]) + np.linspace(0.0, 0.01, bsz)[:, None] * \
        np.array([1.0, 0.0])
    rng = np.random.default_rng(4)
    sims, stand, _ = closedloop._init_lanes(
        motion_cfg, loop, model, torch.tensor(a0, dtype=f64, device=cpu), f64)
    noise = np.zeros((bsz, 18))
    noise[:, 3:6] = rng.normal(size=(bsz, 3)) * 0.03
    noise[:, 6:] = rng.normal(size=(bsz, 12)) * 0.1
    q = sims.q + torch.tensor(noise, dtype=f64)
    qd = torch.tensor(rng.normal(size=(bsz, 18)) * 0.2, dtype=f64)
    lane = torch.arange(bsz)
    des = torch.where((lane % 2 == 0)[:, None],
                      motion.next_trot_domain(stand.con.des),
                      1 - motion.next_trot_domain(stand.con.des))
    hold = torch.stack([q[:, 0], torch.zeros_like(q[:, 0]), q[:, 1],
                        torch.zeros_like(q[:, 0])], 1)
    trot = stand._replace(
        loco_tick=(lane % loop.ticks_per_domain).to(f64),
        gait_domain=torch.full_like(stand.gait_domain, 2),
        con=contact.set_des_domain(stand.con, des),
        planner=stand.planner._replace(
            dom_ticks=torch.full_like(stand.planner.dom_ticks, 172.0),
            des_domain=des.to(torch.int32)),
        mpc_alpha=hold[:, :, None].expand(-1, -1, 5).contiguous(),
        mpc_available=torch.ones_like(stand.mpc_available))
    forces = wb.foot_force_measurement(sim_cfg, model, wb.SimState(q, qd))

    scale = 1.0 + args.ulps * torch.finfo(f64).eps
    for case, gait, st in (("stand", Gait.STAND, stand),
                           ("trot", Gait.TROT, trot)):
        d = rbd.mass_matrix(model, q)
        data, _ = agent.tick_build(
            ll_cfg, motion_cfg, model, gait, st, q, qd, forces,
            allow_contact_trigger=False, d_inv=spd.inverse_plain(d))
        base = qp_fused.solve_plain(*data, QpConfig())
        moved = list(data)
        moved[5] = data[5] * scale
        pert = qp_fused.solve_plain(*moved, QpConfig())
        both = base.converged & pert.converged
        dx = (base.x - pert.x).abs().amax(1)
        print(json.dumps({
            "case": case, "lanes": bsz, "h_scaled_by_ulps": args.ulps,
            "converged": base.converged.double().mean().item(),
            "converged_flag_flips": int((base.converged
                                         != pert.converged).sum()),
            "iteration_count_flips": int((base.lane_iters
                                          != pert.lane_iters).sum()),
            "max_dx_converged_in_both": dx[both].max().item(),
            "lanes_dx_over_1e-9": int((dx[both] > 1e-9).sum()),
            "max_dx_unconverged": (dx[~both].max().item()
                                   if (~both).any() else None),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
