#!/usr/bin/env python3
"""Smoke run of srbx_torch on one CUDA card: build, check and time the main path.

    python3 chip_smoke.py          # from the repository root, one CUDA card

The main path is one batched CBF-NMPC control cycle per agent lane
(`srbx_torch.mpc_batch.run_nmpc_batch` on its lanes-last fused branch) at the
benchmark operating point: B = 131072 lanes, float32, the APF reference of
two agents (`loop_size` 4000) among 20 random obstacles. Phases, each
printing one JSON line:

1. probe  - the card, and its name and power limit as nvidia-smi gives them;
2. build  - compile the CUDA kernel from srbx_torch/csrc with nvcc;
3. kernel - the fused IPM kernel against its plain PyTorch version on the
            card, on the cycle's own QPs (mi 28 cold, 48 and 52 warm), in
            float64 (strict config) and float32 (relaxed and strict);
4. slice  - the reference planner and one cycle at B = 131072 in float32:
            finite outputs, 3 kernel launches, and the first 512 lanes
            against the plain path in float64;
5. times  - cycles/s (pipelined and synced, relaxed and strict) and the
            kernel's time against the plain version's.

Then a {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
Any failed check raises and the script exits non-zero. Without a CUDA card,
or outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BATCH = 131072
CROSS_LANES = 512
REPS = 10


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(rec):
    print(json.dumps(rec), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "srbx_torch").is_dir() or not (ROOT / "srbx").is_dir():
        print(f"chip_smoke: no srbx_torch/ and srbx/ beside {__file__}; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch import convert, mpc, mpc_batch, refplan, sqp
    from srbx_torch.ocp import contract, default_footholds
    from srbx_torch.ops import _build, qp_fused

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ------------------------------ 1. probe ------------------------------ #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "probe", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ------------------------------ 2. build ------------------------------ #
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log = lib.with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.is_file() else [])
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)), "ptxas": ptxas})

    cfg = MpcConfig(use_sqp=True, sqp_iters=2, elide_box_rows=True,
                    elide_simplex=True)
    # the benchmark's two solver configurations (bench.py)
    relaxed = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                       reg_dual=1e-6, max_iters=12, kkt_refine_iters=0)
    strict = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                      reg_dual=1e-6, max_iters=25)

    # the benchmark's reference and lanes (bench.py): the planner runs on
    # the card in float32; the lanes are made with numpy and handed over
    # with convert.from_numpy, as the JAX package's inputs would be
    f32 = torch.float32
    p_start = np.array([0.0, 0.5, 0.0, -0.5])
    pobs = np.stack([np.random.default_rng(0).uniform(2.0, 8.0, 20),
                     np.random.default_rng(1).uniform(-2.0, 2.0, 20)])
    t0 = time.perf_counter()
    ref = convert.to_numpy(refplan.generate(
        refplan.two_agent_config(loop_size=4_000),
        torch.tensor(p_start, dtype=f32, device=dev),
        torch.tensor(pobs, dtype=f32, device=dev), dtype=f32, device=dev))
    refplan_s = time.perf_counter() - t0
    check(bool(np.isfinite(ref.pr).all() and np.isfinite(ref.prd).all()),
          "refplan.generate gave non-finite knots")
    agent0 = p_start[:2]
    q = agent0 + np.linspace(0, 0.01, BATCH)[:, None]
    zeros = np.zeros(BATCH)
    inputs = (
        mpc.MpcCarry(np.zeros(BATCH, np.int32),
                     np.stack([q[:, 0], zeros, q[:, 1], zeros], 1)),
        q, np.zeros((BATCH, 2)),
        np.tile(default_footholds(torch.tensor(agent0)).numpy(), (BATCH, 1, 1)),
        np.tile([0.0, 1.0, 1.0, 0.0], (BATCH, 1)),
        np.tile(ref.pr[0:2], (BATCH, 1, 1)), np.tile(ref.prd[0:2], (BATCH, 1, 1)),
        np.tile(agent0, (BATCH, 1)), np.tile(pobs, (BATCH, 1, 1)),
    )

    def lanes(dtype, count=BATCH):
        """The first `count` benchmark lanes on the card in `dtype`."""
        carry, *rest = inputs
        head = (mpc.MpcCarry(*(a[:count] for a in carry)),
                *(a[:count] for a in rest))
        return convert.from_numpy(head, dev, dtype)

    def cycle(args, qp_cfg, **kw):
        return mpc_batch.run_nmpc_batch(cfg, qp_cfg, *args, condensed=True,
                                        **kw)

    # ------------------------- 3. kernel vs plain ------------------------- #
    def cycle_qps(dtype):
        """The cycle's own QPs: the cold first solve (mi 28), and SCP
        solves warm-started from its solution with one (mi 48) and two
        (mi 52) CBF circles, the second the other agent's start."""
        carry, q, dq, toe, ci, pr, prd, a0, pob = lanes(dtype)
        ci_eff = mpc_batch.effective_contacts(carry, ci)
        qp = mpc_batch.condensed_qp(cfg, carry, q, dq, toe, ci_eff, pr, prd,
                                    a0)
        x_ll = qp_fused.solve_lanes_last_plain(qp.P, qp.c, qp.G, qp.h,
                                               strict)[0]
        x = mpc_batch.expand_ll(qp, x_ll)
        x0 = contract(cfg, x, ci_eff).T.contiguous()
        obs = mpc.closest_obstacle(q, pob)[0]
        other = torch.tensor(p_start[2:], dtype=dtype,
                             device=dev).expand(BATCH, 2)
        vel_g, vel_h = sqp._vel_rows(cfg, dtype, dev)
        cases = [("cold_mi28", qp.G, qp.h, None)]
        for name, circles in (("warm_mi48", obs[:, None]),
                              ("warm_mi52", torch.stack([obs, other], 1))):
            mask = torch.ones(circles.shape[:2], dtype=dtype, device=dev)
            cbf_g, cbf_h = sqp._cbf_rows(cfg, x, circles, mask, dtype)
            g, h = mpc_batch.project_rows(
                qp, torch.cat([vel_g.expand(BATCH, -1, -1), cbf_g], 1),
                torch.cat([vel_h.expand(BATCH, -1), cbf_h], 1))
            cases.append((name, g, h, x0))
        return qp, cases

    # In float32 the kernel and its plain version round differently. Where
    # all four legs stand (every benchmark lane: domain 0) the condensed P
    # is singular, because how the stance legs share the load does not enter
    # the cost, so that share (in x) drifts with rounding while the planned
    # trajectory does not. The float32 check therefore bounds the trajectory
    # x_full[:24] = (states, inputs) = e0 + E x, and reports x unchecked.
    n_traj = (cfg.n_state + cfg.n_input) * cfg.horizon
    f64_max_dx = 0.0
    launches0 = qp_fused.solve_lanes_last.launches
    n_compared = 0
    for dtype, configs in ((torch.float64, (("strict", strict),)),
                           (f32, (("relaxed", relaxed),
                                            ("strict", strict)))):
        qp, cases = cycle_qps(dtype)
        for cfg_name, qp_cfg in configs:
            for case, G, h, x0 in cases:
                xk, zk, sk, stk = qp_fused.solve_lanes_last(
                    qp.P, qp.c, G, h, qp_cfg, x0=x0)
                xp, zp, sp, stp = qp_fused.solve_lanes_last_plain(
                    qp.P, qp.c, G, h, qp_cfg, x0=x0)
                torch.cuda.synchronize()
                n_compared += 1
                conv_k, conv_p = stk[2] > 0.5, stp[2] > 0.5
                traj_k = mpc_batch.expand_ll(qp, xk)[:, :n_traj]
                traj_p = mpc_batch.expand_ll(qp, xp)[:, :n_traj]
                dtraj = (traj_k - traj_p).abs()
                rec = {"phase": "kernel", "case": case, "dtype": str(dtype),
                       "config": cfg_name, "mi": G.shape[0], "lanes": BATCH,
                       "max_abs_dx": (xk - xp).abs().max().item(),
                       "max_abs_dz": (zk - zp).abs().max().item(),
                       "max_abs_ds": (sk - sp).abs().max().item(),
                       "max_abs_dtraj": dtraj.max().item(),
                       "converged_kernel": conv_k.double().mean().item(),
                       "converged_plain": conv_p.double().mean().item(),
                       "max_iters_kernel": stk[3].max().item(),
                       "max_iters_plain": stp[3].max().item()}
                if dtype == torch.float64:
                    # the same arithmetic in another order: rounding only
                    rec["bound"] = ("max|dx| <= 1e-9; same converged lanes; "
                                    "equal max iterations")
                    f64_max_dx = max(f64_max_dx, rec["max_abs_dx"])
                    ok = (rec["max_abs_dx"] <= 1e-9
                          and bool((conv_k == conv_p).all())
                          and rec["max_iters_kernel"] == rec["max_iters_plain"])
                else:
                    both = conv_k & conv_p
                    rel = (dtraj / traj_p.abs().clamp(min=1.0))[both]
                    rec["max_rel_dtraj_converged"] = (rel.max().item()
                                                      if rel.numel() else 0.0)
                    rec["bound"] = ("lanes converged in both: trajectory "
                                    "|d| <= 1e-3 max(1,|traj|); kernel "
                                    "converged share >= plain's - 0.5 "
                                    "points; equal max iterations")
                    ok = (rec["max_rel_dtraj_converged"] <= 1e-3
                          and rec["converged_kernel"]
                          >= rec["converged_plain"] - 0.005
                          and rec["max_iters_kernel"] == rec["max_iters_plain"])
                rec["ok"] = ok
                emit(rec)
                check(ok, f"kernel disagrees with its plain version: {rec}")
    check(qp_fused.solve_lanes_last.launches - launches0 == n_compared,
          "the kernel's launch counter did not advance once per solve")

    # ------------------------------ 4. slice ------------------------------ #
    args = lanes(f32)
    cycle(args, relaxed)                       # warm-up: lazy init, caches
    torch.cuda.synchronize()
    qp_fused.solve_lanes_last.launches = 0
    out = cycle(args, relaxed)
    torch.cuda.synchronize()
    slice_launches = qp_fused.solve_lanes_last.launches
    check(slice_launches == 1 + cfg.sqp_iters,
          f"{slice_launches} fused-IPM launches in one cycle, expected 3")
    for name in ("alpha_com", "states", "inputs", "x", "cbf_margin"):
        t = getattr(out, name)
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(tuple(out.states.shape) == (BATCH, cfg.horizon, 4)
          and tuple(out.alpha_com.shape) == (BATCH, 4, 5),
          "unexpected output shapes")

    # the first lanes against the plain path (the same cycle with the fused
    # IPM's plain PyTorch version) in float64 on the card
    args64 = lanes(torch.float64, CROSS_LANES)

    def plain_solve(P, c, G, h, qp_cfg, x0=None):
        return qp_fused.solve_lanes_last_plain(P, c, G, h, qp_cfg, x0=x0)

    with mock.patch.object(qp_fused, "solve_lanes_last", plain_solve):
        ref64 = cycle(args64, relaxed)
    ker64 = cycle(args64, relaxed)
    torch.cuda.synchronize()

    def maxdiff(a, b):
        a, b = convert.to_numpy((a, b))
        return float(np.abs(a.astype(np.float64) - b).max())

    cross = {
        "phase": "slice", "lanes": BATCH, "dtype": "float32",
        "config": "relaxed", "launches": slice_launches,
        "refplan_seconds": refplan_s,
        "converged": out.qp_converged.double().mean().item(),
        "qp_iters": int(out.qp_iters),
        "f64_kernel_vs_plain_states": maxdiff(ker64.states, ref64.states),
        "f64_kernel_vs_plain_alpha_com": maxdiff(ker64.alpha_com,
                                                 ref64.alpha_com),
        "f32_vs_f64_plain_states": maxdiff(out.states[:CROSS_LANES],
                                           ref64.states),
        "f32_vs_f64_plain_alpha_com": maxdiff(out.alpha_com[:CROSS_LANES],
                                              ref64.alpha_com),
        "f32_vs_f64_plain_qp_converged_equal": bool(
            (out.qp_converged[:CROSS_LANES] == ref64.qp_converged).all()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    # f64 kernel path against f64 plain path: rounding only, so 1e-9.
    # f32 kernel path against f64 plain path: each stops inside the relaxed
    # tolerance at its own point. 1e-3 (1 mm on the planned COM knots and
    # their Bezier coefficients) is far below what the robot tracks and
    # catches a wrong plan, whose knots move by centimetres or more.
    cross["bound"] = "f64 paths 1e-9; f32 vs f64 states and alpha_com 1e-3"
    cross["ok"] = (cross["f64_kernel_vs_plain_states"] <= 1e-9
                   and cross["f64_kernel_vs_plain_alpha_com"] <= 1e-9
                   and cross["f32_vs_f64_plain_states"] <= 1e-3
                   and cross["f32_vs_f64_plain_alpha_com"] <= 1e-3)
    emit(cross)
    check(cross["ok"], f"slice cross-check failed: {cross}")

    # ------------------------------ 5. times ------------------------------ #
    for cfg_name, qp_cfg in (("relaxed", relaxed), ("strict", strict)):
        out = cycle(args, qp_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = cycle(args, qp_cfg)
        torch.cuda.synchronize()
        pipelined = BATCH * REPS / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = cycle(args, qp_cfg)
            torch.cuda.synchronize()
        synced = BATCH * REPS / (time.perf_counter() - t0)
        emit({"phase": "times", "what": "cycle", "config": cfg_name,
              "lanes": BATCH, "dtype": "float32", "reps": REPS,
              "cycles_per_s_pipelined": pipelined,
              "cycles_per_s_synced": synced,
              "converged": out.qp_converged.double().mean().item(),
              "qp_iters": int(out.qp_iters), "device": smi})

    def event_ms(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    qp, cases = cycle_qps(f32)
    k1_ms = {}
    for case, G, h, x0 in cases[:2]:                # mi 28 cold, mi 48 warm
        def kern():
            return qp_fused.solve_lanes_last(qp.P, qp.c, G, h, relaxed,
                                             x0=x0)

        def plain():
            return qp_fused.solve_lanes_last_plain(qp.P, qp.c, G, h, relaxed,
                                                   x0=x0)

        kern()
        plain()
        # in turns on one card: plain, kernel, kernel, plain
        p1 = event_ms(plain, 3)
        k1 = event_ms(kern, REPS)
        k2 = event_ms(kern, REPS)
        p2 = event_ms(plain, 3)
        k1_ms[case] = ((k1 + k2) / 2, (p1 + p2) / 2)
        emit({"phase": "times", "what": "fused_ipm", "case": case,
              "mi": G.shape[0], "lanes": BATCH, "dtype": "float32",
              "config": "relaxed", "kernel_ms": [k1, k2],
              "plain_ms": [p1, p2], "device": smi})

    ms, plain_ms = k1_ms["warm_mi48"]
    emit({"kernels": [{
        "name": "qp_fused_noeq", "route": "cuda",
        "source": "srbx_torch/csrc/qp_fused.cu",
        "replaces": "srbx/ops/qp_fused.py:94",
        "launches": slice_launches, "max_abs_err": f64_max_dx,
        "ms": ms, "plain_ms": plain_ms,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
