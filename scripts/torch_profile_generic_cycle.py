#!/usr/bin/env python3
"""Where one generic NMPC cycle of srbx_torch spends its time, on one CUDA
card.

    python3 scripts/torch_profile_generic_cycle.py [--lanes 131072]

Runs `mpc_batch.run_nmpc_batch` on its generic branch at the reference
shape (uncondensed `MpcConfig(use_sqp=True, sqp_iters=2)`: QPs of n 41,
me 28, mi 92 and 112, backend "pallas", so kernels K3a and K3b on every IPM
iteration) in float32 on the benchmark's lanes (bench.py: the APF reference
of two agents among 20 random obstacles, lanes spread over 1 cm), under the
relaxed and the strict solver configurations. For each: one warm-up cycle,
then torch.profiler over one cycle: wall ms, device busy ms and share (the
sum of kernel times over the wall time), kernel launches, the device time
of K3a, K3b, the matrix products (cuBLAS and CUTLASS kernels) and the rest,
and the kernels that take the most time. Prints one JSON line per
configuration, and the card's name and power limit. Needs a CUDA card;
without one it exits non-zero.
"""

from __future__ import annotations

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

GROUPS = (("K3a", ("cholesky_kernel",)), ("K3b", ("cho_solve_kernel",)),
          ("matrix products", ("gemm", "gemv", "cutlass", "xmma", "dot")))


def group_of(name):
    for group, keys in GROUPS:
        if any(key in name for key in keys):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=131072)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from srbx_torch import convert, mpc, mpc_batch, refplan
    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch.ocp import default_footholds
    from srbx_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.load()
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    bsz = args.lanes
    p_start = np.array([0.0, 0.5, 0.0, -0.5])
    pobs = np.stack([np.random.default_rng(0).uniform(2.0, 8.0, 20),
                     np.random.default_rng(1).uniform(-2.0, 2.0, 20)])
    ref = refplan.generate(refplan.two_agent_config(loop_size=4_000),
                           torch.tensor(p_start, dtype=f32, device=dev),
                           torch.tensor(pobs, dtype=f32, device=dev),
                           dtype=f32, device=dev)
    agent0 = p_start[:2]
    q = agent0 + np.linspace(0, 0.01, bsz)[:, None]
    zeros = np.zeros(bsz)
    lanes = convert.from_numpy((
        mpc.MpcCarry(np.zeros(bsz, np.int32),
                     np.stack([q[:, 0], zeros, q[:, 1], zeros], 1)),
        q, np.zeros((bsz, 2)),
        np.tile(default_footholds(torch.tensor(agent0)).numpy(), (bsz, 1, 1)),
        np.tile([0.0, 1.0, 1.0, 0.0], (bsz, 1)),
        np.tile(convert.to_numpy(ref.pr[0:2]), (bsz, 1, 1)),
        np.tile(convert.to_numpy(ref.prd[0:2]), (bsz, 1, 1)),
        np.tile(agent0, (bsz, 1)), np.tile(pobs, (bsz, 1, 1))), dev, f32)
    cfg = MpcConfig(use_sqp=True, sqp_iters=2)
    configs = {
        "relaxed": QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                            reg_dual=1e-6, max_iters=12, kkt_refine_iters=0),
        "strict": QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                           reg_dual=1e-6, max_iters=25),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, qp_cfg in configs.items():
        def cycle():
            return mpc_batch.run_nmpc_batch(cfg, qp_cfg, *lanes,
                                            backend="pallas",
                                            condensed=False)

        cycle()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cycle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            cycle()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.device_time_total for e in kernels)
        by_group = {}
        for e in kernels:
            g = group_of(e.key)
            by_group[g] = by_group.get(g, 0.0) + e.device_time_total / 1e3
        top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
        print(json.dumps({
            "what": "generic_cycle", "config": name, "lanes": bsz,
            "dtype": "float32", "qp_iters": int(out.qp_iters),
            "converged": out.qp_converged.double().mean().item(),
            "wall_ms": wall * 1e3, "profiled_wall_ms": prof_wall * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / prof_wall,
            "kernel_launches": sum(e.count for e in kernels),
            "device_ms_by_group": by_group,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "device_ms": e.device_time_total / 1e3}
                            for e in top],
            "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
