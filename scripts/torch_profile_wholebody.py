#!/usr/bin/env python3
"""Where one whole-body tick of srbx_torch spends its time, on one CUDA card.

    python3 scripts/torch_profile_wholebody.py [--lanes 4096] [--ticks 5]

Sets up the closed loop's lanes (`srbx_torch.sim.closedloop`, float32, the
crouched start), runs 20 stand-up ticks to warm up, then measures the tick's
stages as `closedloop._tick_batch` and `wholebody.step_batch` run them:

* each stage alone (synchronised before and after): host ms and device ms
  (CUDA events), averaged over --ticks stand ticks;
* the same ticks back to back with no synchronisation: wall ms per tick;
* torch.profiler over those ticks: device busy share (the sum of kernel
  times over the wall time) and the kernels that take the most time.

Prints one JSON line per measurement, and the card's name and power limit.
Needs a CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from srbx_torch import agent
    from srbx_torch.config import Gait, LowLevelConfig, MotionConfig, QpConfig
    from srbx_torch.lowlevel import swing_delta_inv
    from srbx_torch.models import a1, rbd
    from srbx_torch.ops import _build, qp_batch, spd
    from srbx_torch.sim import closedloop, wholebody as wb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.load()
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    model = a1.model()
    ll, mo, sim_cfg = LowLevelConfig(), MotionConfig(), wb.SimConfig()
    qp_cfg = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                      reg_dual=1e-6, max_iters=12)
    loop = closedloop.LoopConfig(stand_ticks=800, n_domains=2)
    a0 = torch.zeros(args.lanes, 2, dtype=f32, device=dev)
    a0[:, 0] = torch.linspace(0.0, 0.01, args.lanes, device=dev)
    a0[:, 1] = 0.5
    state = dict(zip(("sims", "asts"), closedloop._init_lanes(
        mo, loop, model, a0, f32)[:2]))

    def stages():
        """The stages of one stand tick, in order, as (name, thunk)."""
        ctx = {}

        def forces():
            ctx["forces"] = wb.foot_force_measurement(sim_cfg, model,
                                                      state["sims"])

        def mass():
            ctx["d"] = rbd.mass_matrix(model, state["sims"].q)

        def inv_d():
            ctx["dinv"] = spd.inverse(ctx["d"])

        def build():
            s = state["sims"]
            ctx["data"], ctx["tick"] = agent.tick_build(
                ll, mo, model, Gait.STAND, state["asts"], s.q, s.qd,
                ctx["forces"], d_inv=ctx["dinv"])

        def solve():
            ctx["sol"] = qp_batch.solve(*ctx["data"], qp_cfg,
                                        backend="fused")

        def inv_swing():
            ctx["delta"] = spd.inverse(swing_delta_inv(ctx["tick"].ll_ctx))

        def finish():
            s = state["sims"]
            ctx["out"], state["asts"], _ = agent.tick_finish(
                ll, ctx["tick"], s.q, s.qd, ctx["sol"].x,
                ctx["sol"].converged, delta=ctx["delta"])

        def physics():
            state["sims"] = wb.step_batch(sim_cfg, model, state["sims"],
                                          ctx["out"].tau, backend="fused",
                                          d0=ctx["d"])

        return [("foot_forces", forces), ("mass_matrix", mass),
                ("K2b_inverse_D", inv_d), ("tick_build", build),
                ("K1b_ll_qp", solve), ("K2b_inverse_swing", inv_swing),
                ("tick_finish", finish), ("physics_2_substeps", physics)]

    def tick():
        for _, fn in stages():
            fn()

    for _ in range(20):
        tick()
    torch.cuda.synchronize()

    host = {}
    device = {}
    for _ in range(args.ticks):
        for name, fn in stages():
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            fn()
            e1.record()
            host[name] = host.get(name, 0.0) + time.perf_counter() - t0
            torch.cuda.synchronize()
            device[name] = device.get(name, 0.0) + e0.elapsed_time(e1)
    for name in host:
        print(json.dumps({"stage": name, "lanes": args.lanes,
                          "host_ms": host[name] * 1e3 / args.ticks,
                          "device_span_ms": device[name] / args.ticks,
                          "device": smi}), flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.ticks
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            tick()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # the kernels themselves: operator and autograd events carry their
    # kernels' time again, inclusively
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:15]
    print(json.dumps({
        "what": "tick", "lanes": args.lanes, "ticks": args.ticks,
        "wall_ms_per_tick": wall * 1e3,
        "profiled_wall_ms_per_tick": prof_wall * 1e3 / args.ticks,
        "device_busy_ms_per_tick": busy_us / 1e3 / args.ticks,
        "device_busy_share": busy_us / 1e6 / prof_wall,
        "kernel_launches_per_tick": sum(e.count for e in kernels)
        / args.ticks,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_ms_per_tick": e.device_time_total / 1e3
                         / args.ticks} for e in top],
        "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
