#!/usr/bin/env python3
"""How far the NMPC's own float32 QP solutions are pinned down by the relaxed
stopping test: the fused IPM's plain version (`srbx_torch.ops.qp_fused`) on
the QPs of `chip_smoke.py`'s benchmark lanes, solved as given and with h
moved by one ulp up and down, float32, the relaxed solver configuration.

    python3 scripts/torch_nmpc_qp_f32_spread.py [LANES]    # default 16384

For each of the cycle's QPs (cold, the SCP round's with one CBF circle and
with the neighbour's too) of the condensed, simplex-eliminated cycle with
its box rows kept (K1a at mi 92, 112, 116) and of the uncondensed cycle
(K1b at (41, 28)), it prints the largest change of the planned trajectory
(states and inputs, relative to max(1, |traj|)) that one ulp of h makes,
and the largest primal scale max(|Gx|, |h|) of the relaxed stopping test
(the box rows' h is 1e3, so the test admits primal residuals up to
(abstol + reltol) times that). Runs on the CPU; the numbers say nothing
about a device's speed.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("spread_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(lanes: int = 16384) -> int:
    sys.path.insert(0, str(HERE))
    smoke = _smoke()
    from srbx_torch import mpc_batch
    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch.ops import qp_fused

    smoke.BATCH = lanes
    dev, f32 = torch.device("cpu"), torch.float32
    relaxed = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                       reg_dual=1e-6, max_iters=12, kkt_refine_iters=0)
    strict = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                      reg_dual=1e-6, max_iters=25)
    inputs, p_start, _ = smoke.benchmark_inputs(dev)
    args = smoke.lanes_of(inputs, dev, f32, lanes)
    other = torch.tensor(p_start[2:], dtype=f32).expand(lanes, 2)
    box = MpcConfig(use_sqp=True, sqp_iters=2, condensed=True,
                    elide_simplex=True)
    qp, cases = smoke.cycle_qps(box, strict, args, other,
                                (("scp_mi112", (1.0,)),
                                 ("scp_mi116", (1.0, 1.0))),
                                cold="cold_mi92")
    runs = [("K1a", case, G, h, x0,
             lambda G, h, x0: qp_fused.solve_lanes_last_plain(
                 qp.P, qp.c, G, h, relaxed, x0=x0)[0].T,
             lambda x: mpc_batch.expand_ll(qp, x.T)[:, :24],
             lambda x, G=G: torch.einsum("mnb,bn->bm", G, x))
            for case, G, h, x0 in cases]
    data, traj, gcases = smoke.generic_cycle_qps(
        MpcConfig(use_sqp=True, sqp_iters=2), strict, args, other, False)
    runs += [("K1b (41, 28)", case, G, h, x0,
              lambda G, h, x0: qp_fused.solve_plain(
                  *data[:4], G, h, relaxed, x0=x0).x,
              traj, lambda x, G=G: torch.einsum("bmn,bn->bm", G, x))
             for case, G, h, x0 in gcases]
    for kernel, case, G, h, x0, solve, to_traj, gx in runs:
        t0 = time.perf_counter()
        x = solve(G, h, x0)
        ref = to_traj(x)
        spread = {}
        for name, target in (("up", float("inf")), ("down", -float("inf"))):
            moved = torch.nextafter(h, torch.full_like(h, target))
            t = to_traj(solve(G, moved, x0))
            spread[name] = ((t - ref).abs() / ref.abs().clamp(min=1.0)) \
                .max().item()
        h_lead = h.T if kernel == "K1a" else h
        scale = torch.maximum(gx(x).abs().amax(1), h_lead.abs().amax(1))
        print(json.dumps({
            "kernel": kernel, "case": case, "lanes": lanes, "dtype": "float32",
            "config": "relaxed", "traj_spread_1ulp_h": spread,
            "max_primal_scale": scale.max().item(),
            "seconds": time.perf_counter() - t0, "device": "cpu"}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
