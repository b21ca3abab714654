#!/usr/bin/env python3
"""Smoke run of srbx_torch on one CUDA card: build, check and time its paths.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Three paths, each driven through the entry point a user calls:

* the batched CBF-NMPC control cycle (`srbx_torch.mpc_batch.run_nmpc_batch`
  on its lanes-last fused branch, kernel K1a) at the benchmark operating
  point: B = 131072 lanes, float32, the APF reference of two agents
  (`loop_size` 4000) among 20 random obstacles;
* the whole-body 1 kHz closed loop (`srbx_torch.sim.closedloop.run_batch`:
  the LL QP through kernel K1b, the SPD inverses through K2b, the physics
  solves through K2a, the NMPC at each domain boundary through K1a) at
  B = 4096 lanes, float32: 800 stand-up ticks and 2 trot domains of 172;
* the NMPC cycle on its generic branch at the reference shape
  (`run_nmpc_batch(backend="pallas", condensed=False)`: QPs of n 41, me 28,
  mi 92 and 112 through the step-fused batched IPM, with the Cholesky and
  Cholesky-solve kernels K3a and K3b on every iteration) at B = 131072,
  float32.

Phases, each printing JSON lines:

1. probe     - the card, and its name and power limit as nvidia-smi gives;
2. build     - compile every CUDA source in srbx_torch/csrc with nvcc (one
               process per source), report ptxas registers and spills, each
               kernel's resident warps per SM and K3's launch geometry, and
               fail if the float32 builds of K1a, K1b, K3a or K3b spill;
3. kernel    - K1a against its plain PyTorch version on the card, on the
               cycle's own QPs (mi 28 cold, 48 and 52 warm), in float64
               (strict config) and float32 (relaxed and strict); then, as
               phase "mixed", on B - 5 lanes mixing converging, infeasible
               and one NaN lane in every block, in float64;
4. slice     - the reference planner and one cycle at B = 131072 in float32:
               finite outputs, 3 K1a launches, and the first 512 lanes
               against the plain path in float64;
5. times     - cycles/s (pipelined and synced, relaxed and strict) and K1a's
               time at mi 28, 48 and 52 against the plain version's;
6. wb_kernel - K1b on random well-conditioned QPs of the LL QP's shape
               (float64, to 1e-9) and on LL QPs that the port's tick_build
               makes from stand and trot states at B = 4096 (float64 strict,
               float32 relaxed: converged share and a recomputed stopping
               test), K2a and K2b on the loop's mass and swing matrices;
               then K1b on 4093 mixed lanes as in phase 3;
7. wholebody - run_batch at B = 4096 float32: finite, COM height, exact
               launch counts, LL ticks/s; and the first 64 lanes in float64
               through the kernels and through the plain versions;
8. wb_times  - K1b, K2a and K2b at the loop's shapes against their plain
               versions and, for K2, one PyTorch call (library_ms);
9. k3        - K3a and K3b against their plain versions, bitwise on the
               good lanes, on random SPD matrices with one indefinite lane,
               at the generic cycle's (k, r), then on a ragged batch
               (B - 3 lanes) at the path's (k, r) and at the edge shapes
               k 1, 33, 64 with r 1, 3, 32, 64, in float64 and float32;
10. generic_cycle - one generic cycle at B = 131072 float32, relaxed and
               strict: finite, exact K3 launch counts, converged share; and
               the first 512 lanes in float64 through the kernels and
               through the plain versions;
11. times    - generic cycles/s (pipelined and synced) and K3a and K3b,
               at each (k, r) the relaxed cycle launched them with, against
               their plain versions and torch.linalg.cholesky_ex /
               torch.cholesky_solve (library_ms); their kernels-line rows
               weight those shapes by their launches.

Then a {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
Any failed check raises and the script exits non-zero. Without a CUDA card,
or outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import re
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
GEN_REPS = 3             # generic-cycle repetitions per timing
WB_BATCH = 4096          # whole-body lanes
WB_CROSS_LANES = 64      # whole-body lanes run in float64, kernels vs plain
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def ipm_flops(n, me, mi, refine, lane_iters, cold):
    """Floating-point operations (leading terms, a multiply-add counted as
    2) that the fused IPM needs for lanes whose iteration counts are
    `lane_iters` (a tensor of the run's own counts): the start, then per
    iteration the factorization of M = P + G'WG (and of S = A M^-1 A' with
    M^-1 A' when me > 0), two refined KKT solves with their right-hand
    sides and step directions, and the residual test."""
    chol = lambda k: k ** 3 / 3                            # noqa: E731
    factor = mi * n * (n + 1) + chol(n)
    if me:
        factor += 2 * n * n * me + me * (me + 1) * n + chol(me)
    kkt = 2 * n * n + (4 * me * n + 2 * me * me if me else 0)
    refine_step = 4 * mi * n + 2 * n * n + (4 * me * n if me else 0) + kkt
    conv = 4 * mi * n + 2 * n * n + (4 * me * n if me else 0)
    per_iter = (factor + 2 * (kkt + refine * refine_step)
                + 2 * 4 * mi * n + conv)
    start = (factor + kkt + 2 * mi * n) if cold else 0
    lanes = lane_iters.numel()
    return lanes * (start + 2 * mi * n + conv) + per_iter * float(
        lane_iters.double().sum())


def bound(nbytes, flops):
    """The least time the card could take: bytes moved once over the HBM
    rate against float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def k3_work(k, r, bsz, itemsize=4):
    """Bytes that K3a (r = 0) or K3b (r right-hand sides) must move on bsz
    lanes, and the operations it does: the lower triangle of M or L read once
    (k (k + 1) / 2 entries: nothing needs the rest), L (k x k, its zeros
    included) or X written once, the right-hand sides read once; k^3 / 3
    operations for the factorization, 2 k^2 r for the two substitutions."""
    tri = k * (k + 1) // 2
    if r == 0:
        return itemsize * bsz * (tri + k * k), bsz * k ** 3 / 3
    return itemsize * bsz * (tri + 2 * k * r), bsz * 2 * k * k * r


def k1a_work(P, c, G, h, x0, lane_iters, refine, itemsize=4):
    """Bytes that K1a must move (P, c, G, h and x0 read once; x, z, s and
    stat written once) and the operations its lanes' iterations need."""
    n, bsz = c.shape
    mi = G.shape[0]
    read = P.numel() + c.numel() + G.numel() + h.numel() + (
        0 if x0 is None else x0.numel())
    nbytes = itemsize * (read + (n + 2 * mi + 8) * bsz)
    return nbytes, ipm_flops(n, 0, mi, refine, lane_iters, cold=x0 is None)


def k1b_work(data, sol, refine, itemsize=4):
    """Bytes that K1b must move (P, c, A, b, G, h read once; x, y, z, s and
    stat written once) and the operations its lanes' iterations need (the
    regularised KKT start included)."""
    P, c, A, b, G, h = data
    bsz, n = c.shape
    nbytes = itemsize * (sum(t.numel() for t in data) + sum(
        t.numel() for t in (sol.x, sol.y, sol.z, sol.s)) + 8 * bsz)
    return nbytes, ipm_flops(n, A.shape[1], G.shape[1], refine,
                             sol.lane_iters, cold=True)


def make_mixed(G, h, every=16, first=3, nan_lane=7):
    """Mix lanes that stop at different iterations into every block, in
    place, on batch-leading views G (B, mi, n) and h (B, mi): lanes first,
    first + every, ... get the contradictory rows x_0 <= -1 and -x_0 <= -1
    (infeasible: they run to max_iters), and lane nan_lane gets h = NaN in
    its first row (non-finite from its start: the NaN freeze stops it at
    its first iteration). The other lanes converge in a few iterations.
    Returns the infeasible lanes."""
    idx = torch.arange(first, G.shape[0], every, device=G.device)
    G[idx, :2] = 0.0
    G[idx, 0, 0] = 1.0
    G[idx, 1, 0] = -1.0
    h[idx, :2] = -1.0
    h[nan_lane, 0] = float("nan")
    return idx


def mixed_record(kernel, lanes, xk, xp, fin_k, fin_p, conv_k, conv_p,
                 it_k, it_p, infeasible, nan_lane, max_iters):
    """Kernel against plain version on a ragged batch of mixed lanes (x
    batch-leading, per-lane finiteness, converged flags and iterations)."""
    both = conv_k & conv_p
    nonfinite = torch.nonzero(~fin_k).flatten().tolist()
    rec = {"lanes": lanes, "dtype": "float64", "max_iters": max_iters,
           "max_abs_dx_converged": (xk[both] - xp[both]).abs().max().item(),
           "converged_kernel": conv_k.double().mean().item(),
           "converged_equal": bool((conv_k == conv_p).all()),
           "lane_iters_equal": bool((it_k == it_p).all()),
           "finite_equal": bool((fin_k == fin_p).all()),
           "nonfinite_lanes_kernel": nonfinite,
           "iters_min": it_k.min().item(), "iters_max": it_k.max().item(),
           "infeasible_lanes_at_max_iters": bool(
               (it_k[infeasible] == max_iters).all()),
           "bound": ("lanes converged in both: max|dx| <= 1e-9; equal "
                     "converged flags, per-lane iterations and finiteness; "
                     "only the NaN lane non-finite; iterations span 1 to "
                     "max_iters")}
    rec["ok"] = (rec["max_abs_dx_converged"] <= 1e-9
                 and rec["converged_equal"] and rec["lane_iters_equal"]
                 and rec["finite_equal"] and nonfinite == [nan_lane]
                 and rec["iters_min"] == 1 and rec["iters_max"] == max_iters
                 and rec["infeasible_lanes_at_max_iters"])
    emit({"phase": "mixed", "kernel": kernel, **rec})
    check(rec["ok"], f"{kernel} on mixed ragged lanes: {rec}")


def ptxas_summary(log: str, kernel: str):
    """Registers, stack bytes and spill bytes of every instantiation of
    `kernel` in an `nvcc -Xptxas -v` log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or kernel not in name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.append({"entry": name, "stack": int(m.group(1)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["entry"] == name:
            out[-1]["registers"] = int(m.group(1))
    return out


def event_ms(fn, reps):
    """Mean CUDA-event time in ms of `reps` back-to-back calls of fn."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(rec):
    print(json.dumps(rec), flush=True)


def benchmark_inputs(dev):
    """The benchmark's reference and lanes (bench.py): the planner runs on
    the card in float32; the lanes are made with numpy, as the JAX
    package's inputs would be. Returns (inputs, p_start, pobs)."""
    from srbx_torch import convert, mpc, refplan
    from srbx_torch.ocp import default_footholds

    f32 = torch.float32
    p_start = np.array([0.0, 0.5, 0.0, -0.5])
    pobs = np.stack([np.random.default_rng(0).uniform(2.0, 8.0, 20),
                     np.random.default_rng(1).uniform(-2.0, 2.0, 20)])
    ref = convert.to_numpy(refplan.generate(
        refplan.two_agent_config(loop_size=4_000),
        torch.tensor(p_start, dtype=f32, device=dev),
        torch.tensor(pobs, dtype=f32, device=dev), dtype=f32, device=dev))
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
    return inputs, p_start, pobs


def lanes_of(inputs, dev, dtype, count=BATCH):
    """The first `count` benchmark lanes on the card in `dtype`."""
    from srbx_torch import convert, mpc

    carry, *rest = inputs
    head = (mpc.MpcCarry(*(a[:count] for a in carry)),
            *(a[:count] for a in rest))
    return convert.from_numpy(head, dev, dtype)


def nmpc_cycle_qps(cfg, strict, inputs, p_start, pobs, dev, dtype):
    """The cycle's own QPs: the cold first solve (mi 28), and SCP solves
    warm-started from its solution with one (mi 48) and two (mi 52) CBF
    circles, the second the other agent's start. Returns the condensed QP
    and [(case, G, h, x0)]."""
    from srbx_torch import mpc, mpc_batch, sqp
    from srbx_torch.ocp import contract
    from srbx_torch.ops import qp_fused

    carry, q, dq, toe, ci, pr, prd, a0, pob = lanes_of(inputs, dev, dtype)
    ci_eff = mpc_batch.effective_contacts(carry, ci)
    qp = mpc_batch.condensed_qp(cfg, carry, q, dq, toe, ci_eff, pr, prd, a0)
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


def random_ll_qps(bsz, dev, dtype, seed=7, n=43, me=30, mi=45):
    """Random QPs at the LL QP's shape, well conditioned (diagonal P in
    [0.1, 10], a strictly feasible point), made with numpy from a seed:
    [P, c, A, b, G, h] batch-leading."""
    rng = np.random.default_rng(seed)
    p = np.zeros((bsz, n, n))
    p[:, np.arange(n), np.arange(n)] = rng.uniform(0.1, 10.0, (bsz, n))
    a = rng.normal(size=(bsz, me, n))
    g = rng.normal(size=(bsz, mi, n))
    x_feas = rng.normal(size=(bsz, n))
    return [torch.tensor(v, dtype=dtype, device=dev) for v in (
        p, rng.normal(size=(bsz, n)), a, np.einsum("bmn,bn->bm", a, x_feas),
        g, np.einsum("bmn,bn->bm", g, x_feas)
        + rng.uniform(0.1, 1.0, (bsz, mi)))]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "srbx_torch").is_dir():
        print(f"chip_smoke: no srbx_torch/ beside {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch import convert, mpc, mpc_batch, refplan
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
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    # the fused IPMs' and K3's float32 builds must not spill (the "If" in
    # the mangled name is the float instantiation)
    k1_ptxas = {name: ptxas_summary(log.read_text(), name) for name in (
        "qp_fused_noeq_kernel", "qp_general_kernel")}
    k3_ptxas = {name: ptxas_summary(log.read_text(), name) for name in (
        "cholesky_kernel", "cho_solve1_kernel", "cho_solve_kernel")}
    f32_spills = sum(e["spill_stores"] + e["spill_loads"]
                     for es in k1_ptxas.values() for e in es
                     if "kernelIf" in e["entry"])
    k3_f32_spills = sum(e["spill_stores"] + e["spill_loads"]
                        for es in k3_ptxas.values() for e in es
                        if "kernelIf" in e["entry"])
    warps = {f"{k}_{d}_mi{mi}": qp_fused.resident_warps(dt, mi, k == "K1b")
             for k, mis in (("K1a", (28, 48, 52)), ("K1b", (45,)))
             for d, dt in (("f32", torch.float32), ("f64", torch.float64))
             for mi in mis}
    # the other kernels at their paths' shapes, float32
    for name, fn, shapes in (
            ("K2", _build.load().srbx_spd_resident_warps,
             ((18, 1), (18, 18), (12, 12))),
            ("K3", _build.load().srbx_pallas_resident_warps,
             ((41, 0), (28, 0), (41, 28), (41, 1), (28, 1)))):
        for k, r in shapes:
            warps[f"{name}_f32_k{k}_r{r}"] = fn(0, k, r)
    from srbx_torch.ops import pallas_linalg as plin
    k3_geometry = {f"{d}_k{k}_r{r}": plin.launch_geometry(dt, k, r, BATCH)
                   for d, dt in (("f32", torch.float32),
                                 ("f64", torch.float64))
                   for k, r in ((41, 0), (28, 0), (41, 28), (41, 1), (28, 1))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)), "ptxas": ptxas,
          "k1_ptxas": k1_ptxas, "k1_f32_spill_bytes": f32_spills,
          "k3_ptxas": k3_ptxas, "k3_f32_spill_bytes": k3_f32_spills,
          "resident_warps_per_sm": warps, "k3_geometry": k3_geometry})
    check(f32_spills == 0 and all(k1_ptxas.values()),
          f"the fused IPMs' float32 builds spill: {k1_ptxas}")
    check(k3_f32_spills == 0 and all(k3_ptxas.values()),
          f"K3a or K3b's float32 builds spill: {k3_ptxas}")

    cfg = MpcConfig(use_sqp=True, sqp_iters=2, elide_box_rows=True,
                    elide_simplex=True)
    # the benchmark's two solver configurations (bench.py)
    relaxed = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                       reg_dual=1e-6, max_iters=12, kkt_refine_iters=0)
    strict = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                      reg_dual=1e-6, max_iters=25)

    f32 = torch.float32
    t0 = time.perf_counter()
    inputs, p_start, pobs = benchmark_inputs(dev)
    refplan_s = time.perf_counter() - t0

    def lanes(dtype, count=BATCH):
        return lanes_of(inputs, dev, dtype, count)

    def cycle(args, qp_cfg, **kw):
        return mpc_batch.run_nmpc_batch(cfg, qp_cfg, *args, condensed=True,
                                        **kw)

    # ------------------------- 3. kernel vs plain ------------------------- #
    def cycle_qps(dtype):
        return nmpc_cycle_qps(cfg, strict, inputs, p_start, pobs, dev, dtype)

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
        if dtype == torch.float64:
            qp64, cases64 = qp, cases
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

    # A ragged batch (B - 5 lanes: the last block part full) whose blocks
    # mix lanes that converge in a few iterations, infeasible lanes that run
    # to max_iters and one lane that is non-finite from its start. Each
    # lane stops on its own; none may change another's result.
    mixed_cfg = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                         reg_dual=1e-6, max_iters=12)
    cut = BATCH - 5
    _, g_mix, h_mix, x_mix = cases64[1]
    ops = [t[..., :cut].clone(memory_format=torch.contiguous_format)
           for t in (qp64.P, qp64.c, g_mix, h_mix)]
    infeasible = make_mixed(ops[2].permute(2, 0, 1), ops[3].T)
    x_mix = x_mix[:, :cut].contiguous()
    outs = [fn(*ops, mixed_cfg, x0=x_mix) for fn in (
        qp_fused.solve_lanes_last, qp_fused.solve_lanes_last_plain)]
    torch.cuda.synchronize()
    fin = [torch.isfinite(x).all(0) & torch.isfinite(z).all(0)
           & torch.isfinite(sl).all(0) for x, z, sl, _ in outs]
    mixed_record("K1a", cut, outs[0][0].T, outs[1][0].T, *fin,
                 outs[0][3][2] > 0.5, outs[1][3][2] > 0.5, outs[0][3][3],
                 outs[1][3][3], infeasible, 7, mixed_cfg.max_iters)
    del qp64, cases64, ops, outs

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

    qp, cases = cycle_qps(f32)
    k1_ms, k1_stat = {}, {}
    for case, G, h, x0 in cases:                # mi 28 cold, mi 48 / 52 warm
        def kern():
            return qp_fused.solve_lanes_last(qp.P, qp.c, G, h, relaxed,
                                             x0=x0)

        def plain():
            return qp_fused.solve_lanes_last_plain(qp.P, qp.c, G, h, relaxed,
                                                   x0=x0)

        k1_stat[case] = kern()[3]
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

    # the row reports the cycle's warm SCP solve (mi 48), and each case
    k1a_cases = {}
    for case, G, h, x0 in cases:
        k1a_cases[case] = dict(
            mi=G.shape[0], ms=k1_ms[case][0], plain_ms=k1_ms[case][1],
            **bound(*k1a_work(qp.P, qp.c, G, h, x0, k1_stat[case][3],
                              relaxed.kkt_refine_iters)))
    main_case = dict(k1a_cases["warm_mi48"])
    del main_case["mi"]
    kernels = [dict(
        name="qp_fused_noeq", route="cuda",
        source="srbx_torch/csrc/qp_fused.cu",
        replaces="srbx/ops/qp_fused.py:94",
        launches=slice_launches, max_abs_err=f64_max_dx,
        **main_case, library_ms=None,
        launches_by_path={"nmpc_cycle": slice_launches},
        by_case=k1a_cases)]

    # ------------------- 6. whole-body kernels vs plain ------------------- #
    from srbx_torch import agent, motion
    from srbx_torch.config import Gait, LowLevelConfig, MotionConfig
    from srbx_torch.estimation import contact
    from srbx_torch.lowlevel import swing_delta_inv
    from srbx_torch.models import a1, rbd
    from srbx_torch.ops import spd
    from srbx_torch.sim import closedloop, wholebody as wb

    model = a1.model()
    ll_cfg, motion_cfg, sim_cfg = LowLevelConfig(), MotionConfig(), \
        wb.SimConfig()
    wb_mpc = MpcConfig(use_sqp=True, sqp_iters=1, condensed=True,
                       elide_box_rows=True, elide_simplex=True)
    # bench_wholebody's relaxed LL and NMPC solver configuration
    wb_relaxed = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                          reg_dual=1e-6, max_iters=12)
    wb_loop = closedloop.LoopConfig(stand_ticks=800, n_domains=2,
                                    ticks_per_domain=172)
    wb_ticks = wb_loop.stand_ticks + wb_loop.n_domains * \
        wb_loop.ticks_per_domain
    wb_a0 = p_start[:2] + np.linspace(0.0, 0.01, WB_BATCH)[:, None] * \
        np.array([1.0, 0.0])
    wb_pobs = np.full((WB_BATCH, 2, 20), 100.0)
    wb_ref = refplan.generate(
        refplan.two_agent_config(loop_size=4_000),
        torch.tensor(p_start, dtype=f32, device=dev),
        torch.tensor(wb_pobs[0], dtype=f32, device=dev), dtype=f32,
        device=dev)
    wb_pr = wb_ref.pr[0:2].expand(WB_BATCH, -1, -1)
    wb_prd = wb_ref.prd[0:2].expand(WB_BATCH, -1, -1)

    def wb_states(dtype):
        """Stand and trot states of the loop at B = 4096: the crouched start
        with joints, base angles and rates spread by numpy noise; the trot
        lanes in alternating diagonal domains at every phase of a domain,
        their MPC Bezier holding position."""
        rng = np.random.default_rng(4)
        sims, stand, _ = closedloop._init_lanes(
            motion_cfg, wb_loop, model,
            torch.tensor(wb_a0, dtype=dtype, device=dev), dtype)
        noise = np.zeros((WB_BATCH, 18))
        noise[:, 3:6] = rng.normal(size=(WB_BATCH, 3)) * 0.03
        noise[:, 6:] = rng.normal(size=(WB_BATCH, 12)) * 0.1
        q = sims.q + torch.tensor(noise, dtype=dtype, device=dev)
        qd = torch.tensor(rng.normal(size=(WB_BATCH, 18)) * 0.2, dtype=dtype,
                          device=dev)
        lane = torch.arange(WB_BATCH, device=dev)
        des = torch.where((lane % 2 == 0)[:, None],
                          motion.next_trot_domain(stand.con.des),
                          1 - motion.next_trot_domain(stand.con.des))
        hold = torch.stack([q[:, 0], torch.zeros_like(q[:, 0]), q[:, 1],
                            torch.zeros_like(q[:, 0])], 1)
        trot = stand._replace(
            loco_tick=(lane % wb_loop.ticks_per_domain).to(dtype),
            gait_domain=torch.full_like(stand.gait_domain, 2),
            con=contact.set_des_domain(stand.con, des),
            planner=stand.planner._replace(
                dom_ticks=torch.full_like(stand.planner.dom_ticks, 172.0),
                des_domain=des.to(torch.int32)),
            mpc_alpha=hold[:, :, None].expand(-1, -1, 5).contiguous(),
            mpc_available=torch.ones_like(stand.mpc_available))
        forces = wb.foot_force_measurement(sim_cfg, model, wb.SimState(q, qd))
        out = {}
        for name, gait, st in (("stand", Gait.STAND, stand),
                               ("trot", Gait.TROT, trot)):
            d = rbd.mass_matrix(model, q)
            data, ctx = agent.tick_build(
                ll_cfg, motion_cfg, model, gait, st, q, qd, forces,
                allow_contact_trigger=False, d_inv=spd.inverse_plain(d))
            out[name] = (data, d, swing_delta_inv(ctx.ll_ctx),
                         -rbd.bias_forces(model, q, qd))
        return out

    def k1b_record(case, dtype, cfg_name, data, sk, sp):
        dx = (sk.x - sp.x).abs()
        return {"phase": "wb_kernel", "kernel": "K1b qp_general",
                "case": case, "dtype": str(dtype), "config": cfg_name,
                "lanes": WB_BATCH, "n": data[1].shape[1],
                "me": data[2].shape[1], "mi": data[4].shape[1],
                "max_abs_dx": dx.max().item(),
                "max_abs_dy": (sk.y - sp.y).abs().max().item(),
                "converged_kernel": sk.converged.double().mean().item(),
                "converged_plain": sp.converged.double().mean().item(),
                "converged_equal": (sk.converged == sp.converged)
                .double().mean().item(),
                "lane_iters_equal": (sk.lane_iters == sp.lane_iters)
                .double().mean().item(),
                "max_iters_kernel": int(sk.iters),
                "max_iters_plain": int(sp.iters)}

    def stopping_test(data, sol):
        """The IPM's relative residual and gap, recomputed in float64 from a
        returned (x, y, z, s), and the gap test's scale 1 + |objective|."""
        P, c, A, b, G, h = (t.double() for t in data)
        x, y, z, s = (t.double() for t in (sol.x, sol.y, sol.z, sol.s))

        def mv(m, v):
            return torch.einsum("bij,bj->bi", m, v)

        def mtv(m, v):
            return torch.einsum("bij,bi->bj", m, v)

        def amax(*ts):
            return torch.stack([t.abs().amax(1) for t in ts]).amax(0)

        px, gx, ax, gtz, aty = mv(P, x), mv(G, x), mv(A, x), mtv(G, z), \
            mtv(A, y)
        res = torch.maximum(
            amax(px + c + gtz + aty) / amax(px, c, gtz, aty).clamp(min=1.0),
            amax(gx + s - h, ax - b) / amax(gx, h, ax, b).clamp(min=1.0))
        obj = 0.5 * (x * px).sum(1) + (c * x).sum(1)
        return res, (s * z).sum(1), 1.0 + obj.abs()

    # K1b's arithmetic: random QPs at the LL QP's shape (n 43, me 30,
    # mi 45), well conditioned (diagonal P in [0.1, 10], a strictly
    # feasible point), where the kernel and its plain version differ by
    # rounding only: max|dx| <= 1e-9 with equal flags and per-lane
    # iterations, in float64.
    rand_qp = random_ll_qps(WB_BATCH, dev, torch.float64)

    wb_counts = (qp_fused.solve, spd.solve, spd.inverse)
    counts0 = [k.launches for k in wb_counts]
    sk = qp_fused.solve(*rand_qp, QpConfig())
    sp = qp_fused.solve_plain(*rand_qp, QpConfig())
    torch.cuda.synchronize()
    rec = k1b_record("random", torch.float64, "strict", rand_qp, sk, sp)
    rec["bound"] = ("max|dx| <= 1e-9; equal converged flags and per-lane "
                    "iterations")
    rec["ok"] = (rec["max_abs_dx"] <= 1e-9 and rec["converged_equal"] == 1.0
                 and rec["lane_iters_equal"] == 1.0)
    k1b_f64_dx = rec["max_abs_dx"]
    emit(rec)
    check(rec["ok"], f"K1b disagrees with its plain version: {rec}")

    # K1b on the loop's own LL QPs. These are badly conditioned (in the
    # float64 plain version alone, a 4-ulp change of h moves x by up to
    # 9e-5 on converged stand lanes and flips the converged flag of 1 lane
    # in 2048: scripts/torch_ll_qp_conditioning.py), so x is not compared. What holds: the kernel converges on
    # as many lanes as the plain version, and every lane it calls converged
    # meets the stopping test when that is recomputed in float64 from its
    # (x, y, z, s), within the recomputation's rounding (1e-6 of the limit
    # in float64, 1 % in float32).
    k2_f64_rel = {}
    wb_qps = {}
    for dtype, qp_cfg, cfg_name in ((torch.float64, QpConfig(), "strict"),
                                    (f32, wb_relaxed, "relaxed")):
        states = wb_states(dtype)
        wb_qps[dtype] = states
        slack = 1.0 + (1e-6 if dtype == torch.float64 else 1e-2)
        for case, (data, d, dinv12, rhs) in states.items():
            sk = qp_fused.solve(*data, qp_cfg)
            sp = qp_fused.solve_plain(*data, qp_cfg)
            torch.cuda.synchronize()
            rec = k1b_record(case, dtype, cfg_name, data, sk, sp)
            res, gap, gap_scale = stopping_test(data, sk)
            conv = sk.converged
            res_lim = (qp_cfg.abstol + qp_cfg.reltol) * slack
            certified = ((res <= res_lim)
                         & (gap <= qp_cfg.abstol * gap_scale * slack))[conv]
            both = conv & sp.converged
            rel = ((sk.x - sp.x)[:, 0:24].abs().amax(1)
                   / sp.x[:, 0:24].abs().amax(1).clamp(min=1.0))[both]
            rec.update({
                "certified_share_of_converged": (
                    certified.double().mean().item() if conv.any() else 1.0),
                "max_recomputed_res_converged": (
                    res[conv].max().item() if conv.any() else 0.0),
                "res_limit": qp_cfg.abstol + qp_cfg.reltol,
                "rel_dx_force_torque_both_converged": (
                    [rel.median().item(), rel.quantile(0.99).item(),
                     rel.max().item()] if rel.numel() else None),
                "bound": ("kernel converged share >= plain's - 0.5 points; "
                          "every kernel-converged lane meets the stopping "
                          f"test recomputed in float64 (x{slack:.7g})")})
            rec["ok"] = (rec["converged_kernel"]
                         >= rec["converged_plain"] - 0.005
                         and bool(certified.all()))
            emit(rec)
            check(rec["ok"], f"K1b disagrees with its plain version: {rec}")
            for kname, got, want in (
                    ("K2a spd.solve k18", spd.solve(d, rhs),
                     spd.solve_plain(d, rhs)),
                    ("K2b spd.inverse k18", spd.inverse(d),
                     spd.inverse_plain(d)),
                    ("K2b spd.inverse k12", spd.inverse(dinv12),
                     spd.inverse_plain(dinv12))):
                torch.cuda.synchronize()
                rel = ((got - want).abs().max()
                       / want.abs().max()).item()
                bound_rel = 1e-12 if dtype == torch.float64 else 1e-5
                rec = {"phase": "wb_kernel", "kernel": kname, "case": case,
                       "dtype": str(dtype), "lanes": WB_BATCH,
                       "max_abs_err": (got - want).abs().max().item(),
                       "max_rel_err": rel,
                       "bound": f"max|d| / max|value| <= {bound_rel:g}",
                       "ok": rel <= bound_rel}
                if dtype == torch.float64:
                    k2_f64_rel[kname] = max(k2_f64_rel.get(kname, 0.0),
                                            rec["max_abs_err"])
                emit(rec)
                check(rec["ok"], f"SPD kernel disagrees: {rec}")
    check([k.launches - c for k, c in zip(wb_counts, counts0)] == [5, 4, 8],
          "the whole-body kernels' counters did not advance once per call")

    # K1b on a ragged batch (B - 3 = 4093 lanes) of random QPs of the LL
    # QP's shape mixing converging, infeasible and one non-finite lane, as for K1a
    mix_lanes = WB_BATCH - 3
    mix_qp = random_ll_qps(mix_lanes, dev, torch.float64, seed=8)
    infeasible = make_mixed(mix_qp[4], mix_qp[5])
    sols = [fn(*mix_qp, mixed_cfg) for fn in (qp_fused.solve,
                                              qp_fused.solve_plain)]
    torch.cuda.synchronize()
    fin = [torch.isfinite(torch.cat([o.x, o.y, o.z, o.s], 1)).all(1)
           for o in sols]
    mixed_record("K1b", mix_lanes, sols[0].x, sols[1].x, *fin,
                 sols[0].converged, sols[1].converged, sols[0].lane_iters,
                 sols[1].lane_iters, infeasible, 7, mixed_cfg.max_iters)

    # ------------------------- 7. the whole-body loop ----------------------- #
    def run_wb(dtype, lanes, loop):
        return closedloop.run_batch(
            wb_mpc, ll_cfg, motion_cfg, wb_relaxed, sim_cfg, loop, model,
            wb_pr[:lanes].to(dtype), wb_prd[:lanes].to(dtype),
            torch.tensor(wb_a0[:lanes], dtype=dtype, device=dev),
            torch.tensor(wb_pobs[:lanes], dtype=dtype, device=dev),
            dtype=dtype, device=dev)

    run_wb(f32, WB_BATCH, closedloop.LoopConfig(2, 1, 2))   # warm-up
    torch.cuda.synchronize()
    all_counts = (qp_fused.solve_lanes_last,) + wb_counts
    for k in all_counts:
        k.launches = 0
    t0 = time.perf_counter()
    res = run_wb(f32, WB_BATCH, wb_loop)
    torch.cuda.synchronize()
    wb_wall = time.perf_counter() - t0
    wb_launches = dict(zip(("K1a", "K1b", "K2a", "K2b"),
                           (k.launches for k in all_counts)))
    expect = {"K1a": 2 * wb_loop.n_domains, "K1b": wb_ticks,
              "K2a": 2 * wb_ticks, "K2b": 2 * wb_ticks}
    finite = all(bool(torch.isfinite(t).all()) for t in (
        res.sim.q, res.sim.qd, res.com_hist, res.qp_ok, res.mpc_ok,
        res.tau_hist))
    final_z = res.com_hist[:, -1, -1, 2]

    # the first lanes in float64, through the kernels and through the plain
    # versions, over 50 stand and 20 trot ticks
    cross_loop = closedloop.LoopConfig(50, 1, 20)
    ker64 = run_wb(torch.float64, WB_CROSS_LANES, cross_loop)
    with mock.patch.object(qp_fused, "solve", qp_fused.solve_plain), \
            mock.patch.object(qp_fused, "solve_lanes_last", plain_solve), \
            mock.patch.object(spd, "solve", spd.solve_plain), \
            mock.patch.object(spd, "inverse", spd.inverse_plain):
        ref64 = run_wb(torch.float64, WB_CROSS_LANES, cross_loop)
    torch.cuda.synchronize()
    wb_rec = {
        "phase": "wholebody", "lanes": WB_BATCH, "dtype": "float32",
        "ticks_per_lane": wb_ticks, "stand_ticks": wb_loop.stand_ticks,
        "n_domains": wb_loop.n_domains,
        "ticks_per_domain": wb_loop.ticks_per_domain,
        "wall_s": wb_wall, "ll_ticks_per_s": WB_BATCH * wb_ticks / wb_wall,
        "ll_qp_ok": res.qp_ok.double().mean().item(),
        "mpc_ok": res.mpc_ok.double().mean().item(),
        "final_com_z_min": final_z.min().item(),
        "final_com_z_max": final_z.max().item(),
        "launches": wb_launches, "expected_launches": expect,
        "finite": finite,
        "f64_kernel_vs_plain_q": (ker64.sim.q - ref64.sim.q).abs().max()
        .item(),
        "f64_kernel_vs_plain_com": (ker64.com_hist - ref64.com_hist).abs()
        .max().item(),
        "f64_cross_lanes": WB_CROSS_LANES,
        "f64_cross_ticks": [cross_loop.stand_ticks,
                            cross_loop.ticks_per_domain],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": smi,
        "bound": ("finite; final COM z > 0.2 m in every lane; exact launch "
                  "counts; f64 kernels vs plain q and com <= 1e-9"),
    }
    wb_rec["ok"] = (finite and final_z.min().item() > 0.2
                    and wb_launches == expect
                    and wb_rec["f64_kernel_vs_plain_q"] <= 1e-9
                    and wb_rec["f64_kernel_vs_plain_com"] <= 1e-9)
    emit(wb_rec)
    check(wb_rec["ok"], f"whole-body loop check failed: {wb_rec}")

    # --------------------------- 8. whole-body times ------------------------ #
    data32, d32, dinv12_32, rhs32 = wb_qps[f32]["trot"]
    sk = qp_fused.solve(*data32, wb_relaxed)
    wb_ms = {}
    for kname, kern, plain, library in (
            ("K1b", lambda: qp_fused.solve(*data32, wb_relaxed),
             lambda: qp_fused.solve_plain(*data32, wb_relaxed), None),
            ("K2a", lambda: spd.solve(d32, rhs32),
             lambda: spd.solve_plain(d32, rhs32),
             lambda: torch.linalg.solve(d32, rhs32)),
            ("K2b", lambda: spd.inverse(d32), lambda: spd.inverse_plain(d32),
             lambda: torch.linalg.inv(d32)),
            ("K2b_k12", lambda: spd.inverse(dinv12_32),
             lambda: spd.inverse_plain(dinv12_32),
             lambda: torch.linalg.inv(dinv12_32))):
        kern(), plain()
        if library is not None:
            library()
        p1 = event_ms(plain, 3)
        k1 = event_ms(kern, REPS)
        k2 = event_ms(kern, REPS)
        p2 = event_ms(plain, 3)
        lib_ms = event_ms(library, REPS) if library is not None else None
        wb_ms[kname] = ((k1 + k2) / 2, (p1 + p2) / 2, lib_ms)
        emit({"phase": "wb_times", "kernel": kname, "lanes": WB_BATCH,
              "dtype": "float32", "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
              "library_ms": lib_ms, "device": smi})

    def elems(*ts):
        return sum(t.numel() for t in ts)

    bsz = WB_BATCH
    k1b_bytes, k1b_flops = k1b_work(data32, sk, wb_relaxed.kkt_refine_iters)
    k2a_bytes = 4 * (elems(d32) + 2 * elems(rhs32))
    k2b_bytes = 4 * 2 * elems(d32)
    k = 18
    for name, src, replaces, key, err, nbytes, flops in (
            ("qp_general", "srbx_torch/csrc/qp_general.cu",
             "srbx/ops/qp_fused.py:94", "K1b", k1b_f64_dx, k1b_bytes,
             k1b_flops),
            ("spd_solve", "srbx_torch/csrc/spd.cu", "srbx/ops/spd.py:70",
             "K2a", k2_f64_rel["K2a spd.solve k18"], k2a_bytes,
             bsz * (k ** 3 / 3 + 2 * k * k)),
            ("spd_inverse", "srbx_torch/csrc/spd.cu", "srbx/ops/spd.py:78",
             "K2b", max(k2_f64_rel["K2b spd.inverse k18"],
                        k2_f64_rel["K2b spd.inverse k12"]), k2b_bytes,
             bsz * (k ** 3 / 3 + 2 * k ** 3))):
        ms, plain_ms, lib_ms = wb_ms[key]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=wb_launches[key], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms,
            launches_by_path={"wholebody": wb_launches[key]},
            **bound(nbytes, flops)))
    kernels[0]["launches_by_path"]["wholebody"] = wb_launches["K1a"]

    # ------------------------ 9. K3 kernels vs plain ----------------------- #
    from srbx_torch.ops import qp_batch

    gen = torch.Generator(device=dev).manual_seed(11)
    bad_lane = 7

    def spd_batch(k, r, dtype, n_lanes=BATCH):
        """Well-conditioned SPD matrices (n_lanes, k, k) made on the card
        from a seed, lane `bad_lane` indefinite (a diagonal entry -1), and
        right-hand sides (n_lanes, k, r)."""
        a = torch.randn(n_lanes, k, k, generator=gen, device=dev,
                        dtype=dtype)
        m = a @ a.mT / k + torch.eye(k, dtype=dtype, device=dev)
        m[bad_lane, k // 2, k // 2] = -1.0
        rhs = torch.randn(n_lanes, k, r, generator=gen, device=dev,
                          dtype=dtype)
        return m, rhs

    def compare(rec, name, got, want, good, dtype):
        err = (got[good] - want[good]).abs().max().item()
        rec[f"{name}_max_abs_err"] = err
        rec[f"{name}_max_rel_err"] = err / want[good].abs().max().item()
        rec[f"{name}_bitwise_equal"] = bool(torch.equal(got[good],
                                                        want[good]))
        rec[f"{name}_bad_lane_nonfinite"] = not bool(
            torch.isfinite(got[bad_lane]).all())
        rec[f"{name}_other_lanes_finite"] = bool(
            torch.isfinite(got[good]).all())
        if dtype == torch.float64:
            k3_f64_err[name] = max(k3_f64_err[name], err)

    def k3_cases(n_lanes, k, rs, dtype):
        """K3a on n_lanes k x k matrices, then K3b against its factor for
        each r in rs: one record per (k, r)."""
        bound_rel = 1e-12 if dtype == torch.float64 else 1e-5
        m, _ = spd_batch(k, 1, dtype, n_lanes)
        good = torch.ones(n_lanes, dtype=torch.bool, device=dev)
        good[bad_lane] = False
        # the kernels read only the lower triangles: NaN above the
        # diagonal of M and of L changes nothing
        upper = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
        lp = plin.batch_cholesky_plain(m)
        lk = plin.batch_cholesky(m)
        lk_nan = plin.batch_cholesky(m.masked_fill(upper, float("nan")))
        torch.cuda.synchronize()
        n_k3[0] += 2
        base = {"phase": "k3", "dtype": str(dtype), "lanes": n_lanes, "k": k,
                "bad_lane": bad_lane}
        compare(base, "K3a", lk, lp, good, dtype)
        base["K3a_upper_zero"] = bool((lk.triu(1) == 0).all())
        lower_only = torch.equal(lk_nan[good], lk[good])
        del lk, lk_nan, m
        lp_nan = lp.masked_fill(upper, float("nan"))
        for r in rs:
            rhs = torch.randn(n_lanes, k, r, generator=gen, device=dev,
                              dtype=dtype)
            xk = plin.batch_cho_solve(lp, rhs)
            xp = plin.batch_cho_solve_plain(lp, rhs)
            xk_nan = plin.batch_cho_solve(lp_nan, rhs)
            torch.cuda.synchronize()
            n_k3[1] += 2
            rec = dict(base, r=r)
            compare(rec, "K3b", xk, xp, good, dtype)
            rec["upper_triangle_ignored"] = (
                lower_only and torch.equal(xk_nan[good], xk[good]))
            rec["bound"] = (f"bitwise equal on the other lanes (and max|d| "
                            f"/ max|value| <= {bound_rel:g}); the indefinite "
                            "lane non-finite, every other lane finite; "
                            "strict upper triangle of L exactly zero; NaN "
                            "above the diagonal of M and L changes no other "
                            "lane")
            rec["ok"] = (all((rec[f"{n}_max_rel_err"] <= bound_rel
                              and rec[f"{n}_bitwise_equal"]
                              and rec[f"{n}_bad_lane_nonfinite"]
                              and rec[f"{n}_other_lanes_finite"])
                             for n in ("K3a", "K3b"))
                         and rec["K3a_upper_zero"]
                         and rec["upper_triangle_ignored"])
            emit(rec)
            check(rec["ok"], f"K3 kernels disagree with their plain "
                  f"versions: {rec}")
            del rhs, xk, xp, xk_nan

    k3_counts = (plin.batch_cholesky, plin.batch_cho_solve)
    counts0 = [k.launches for k in k3_counts]
    k3_f64_err = {"K3a": 0.0, "K3b": 0.0}
    n_k3 = [0, 0]
    # the generic cycle's (k, r) on B lanes: M^-1 A' (41, 28), M and S
    # solves (41, 1) and (28, 1); the condensed forms' (17, 4) and (13, 1);
    # then on B - 3 lanes (a multiple of no block's lanes) the path's k and
    # the edge shapes k 1, 33, 64 with r 1, 3, 32, 64
    k3_grid = [(BATCH, 41, (28, 1)), (BATCH, 28, (1,)), (BATCH, 17, (4,)),
               (BATCH, 13, (1,)), (BATCH - 3, 41, (28, 1)),
               (BATCH - 3, 28, (1,))] + [
        (BATCH - 3, k, (1, 3, 32, 64)) for k in (1, 33, 64)]
    t0 = time.perf_counter()
    for dtype in (torch.float64, f32):
        for n_lanes, k, rs in k3_grid:
            k3_cases(n_lanes, k, rs, dtype)
    check([k.launches - c for k, c in zip(k3_counts, counts0)] == n_k3,
          "the K3 kernels' counters did not advance once per call")
    emit({"phase": "k3", "seconds": time.perf_counter() - t0,
          "launches": n_k3})

    # ------------------------ 10. the generic cycle ------------------------ #
    # The reference-shape formulation off the TPU: uncondensed (n 41, me 28,
    # mi 92; SCP mi 112), the step-fused batched IPM with backend "pallas".
    gen_cfg = MpcConfig(use_sqp=True, sqp_iters=2)

    def gen_cycle(args, qp_cfg):
        return mpc_batch.run_nmpc_batch(gen_cfg, qp_cfg, *args,
                                        backend="pallas", condensed=False)

    solve_iters = []
    real_solve = qp_batch.solve

    def recording_solve(*a, **kw):
        sol = real_solve(*a, **kw)
        solve_iters.append(int(sol.iters))
        return sol

    def expected_k3(qp_cfg):
        """K3 launches of the solves just recorded: per solve with I
        iterations, K3a 2 + 2 I and K3b 3 + (1 + 4 (1 + R)) I."""
        refine = qp_cfg.kkt_refine_iters
        return (sum(2 + 2 * i for i in solve_iters),
                sum(3 + (1 + 4 * (1 + refine)) * i for i in solve_iters))

    args = lanes(f32)
    gen_cycle(args, relaxed)                   # warm-up
    torch.cuda.synchronize()
    gen_runs = {}
    for cfg_name, qp_cfg in (("relaxed", relaxed), ("strict", strict)):
        solve_iters.clear()
        for k in k3_counts + (qp_fused.solve_lanes_last, qp_fused.solve):
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(qp_batch, "solve", recording_solve):
            out = gen_cycle(args, qp_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K3a": plin.batch_cholesky.launches,
                    "K3b": plin.batch_cho_solve.launches,
                    "K1a": qp_fused.solve_lanes_last.launches,
                    "K1b": qp_fused.solve.launches}
        exp_a, exp_b = expected_k3(qp_cfg)
        expect = {"K3a": exp_a, "K3b": exp_b, "K1a": 0, "K1b": 0}
        finite = all(bool(torch.isfinite(getattr(out, n)).all()) for n in (
            "alpha_com", "states", "inputs", "x", "cbf_margin"))
        rec = {"phase": "generic_cycle", "config": cfg_name, "lanes": BATCH,
               "dtype": "float32", "n": 41, "me": 28,
               "mi": [92, 112, 112], "solve_iters": list(solve_iters),
               "launches": launches, "expected_launches": expect,
               "converged": out.qp_converged.double().mean().item(),
               "qp_iters": int(out.qp_iters), "wall_s": wall,
               "finite": finite,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "shapes_ok": tuple(out.states.shape) == (BATCH, 4, 4),
               "bound": ("finite; exact K3 launch counts, no K1 launch; "
                         "first solve's converged share >= 0.9 relaxed"),
               "device": smi}
        rec["ok"] = (finite and launches == expect and rec["shapes_ok"]
                     and (cfg_name == "strict" or rec["converged"] >= 0.9))
        gen_runs[cfg_name] = rec
        emit(rec)
        check(rec["ok"], f"generic cycle check failed: {rec}")

    # the first lanes in float64, through the kernels and through the plain
    # versions: the K3 kernels are bitwise their plain versions, so rounding
    # elsewhere is the only difference, and there is none
    args64 = lanes(torch.float64, CROSS_LANES)
    with mock.patch.object(plin, "batch_cholesky",
                           plin.batch_cholesky_plain), \
            mock.patch.object(plin, "batch_cho_solve",
                              plin.batch_cho_solve_plain):
        ref64 = gen_cycle(args64, strict)
    ker64 = gen_cycle(args64, strict)
    torch.cuda.synchronize()
    cross = {"phase": "generic_cycle", "what": "f64 kernels vs plain",
             "lanes": CROSS_LANES, "config": "strict",
             "states": maxdiff(ker64.states, ref64.states),
             "alpha_com": maxdiff(ker64.alpha_com, ref64.alpha_com),
             "converged_equal": bool(
                 (ker64.qp_converged == ref64.qp_converged).all()),
             "converged": ker64.qp_converged.double().mean().item(),
             "bound": "states and alpha_com <= 1e-9; equal converged flags"}
    cross["ok"] = (cross["states"] <= 1e-9 and cross["alpha_com"] <= 1e-9
                   and cross["converged_equal"])
    emit(cross)
    check(cross["ok"], f"generic cycle cross-check failed: {cross}")

    # ----------------------- 11. generic-cycle times ---------------------- #
    for cfg_name, qp_cfg in (("relaxed", relaxed), ("strict", strict)):
        out = gen_cycle(args, qp_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GEN_REPS):
            out = gen_cycle(args, qp_cfg)
        torch.cuda.synchronize()
        pipelined = BATCH * GEN_REPS / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(GEN_REPS):
            out = gen_cycle(args, qp_cfg)
            torch.cuda.synchronize()
        synced = BATCH * GEN_REPS / (time.perf_counter() - t0)
        emit({"phase": "times", "what": "generic_cycle", "config": cfg_name,
              "lanes": BATCH, "dtype": "float32", "reps": GEN_REPS,
              "cycles_per_s_pipelined": pipelined,
              "cycles_per_s_synced": synced,
              "converged": out.qp_converged.double().mean().item(),
              "qp_iters": int(out.qp_iters), "device": smi})

    # K3 at each (k, r) the relaxed generic cycle launched it with: the
    # factorizations of M (k 41) and S (k 28) once per solve start and per
    # iteration, M^-1 A' (41, 28) as often, and 2 (1 + R) single solves per
    # iteration against M (41, 1) and S (28, 1); each kernels-line row
    # weights its shapes by those launches
    iters = gen_runs["relaxed"]["solve_iters"]
    n_solves, n_iters = len(iters), sum(iters)
    singles = n_solves + 2 * (1 + relaxed.kkt_refine_iters) * n_iters
    k3_shapes = {("K3a", 41, 0): n_solves + n_iters,
                 ("K3a", 28, 0): n_solves + n_iters,
                 ("K3b", 41, 28): n_solves + n_iters,
                 ("K3b", 41, 1): singles, ("K3b", 28, 1): singles}
    for name in ("K3a", "K3b"):
        check(sum(n for (kn, _, _), n in k3_shapes.items() if kn == name)
              == gen_runs["relaxed"]["launches"][name],
              f"{name}'s launches per shape do not add up to its count")
    k3_ms = {}
    for (name, k, r), n_launch in k3_shapes.items():
        m, rhs = spd_batch(k, max(r, 1), f32)
        m[bad_lane] = torch.eye(k, dtype=f32, device=dev)
        l = plin.batch_cholesky_plain(m)
        if name == "K3a":
            kern = functools.partial(plin.batch_cholesky, m)
            plain = functools.partial(plin.batch_cholesky_plain, m)
            library = functools.partial(torch.linalg.cholesky_ex, m)
        else:
            kern = functools.partial(plin.batch_cho_solve, l, rhs)
            plain = functools.partial(plin.batch_cho_solve_plain, l, rhs)
            library = functools.partial(torch.cholesky_solve, rhs, l)
        kern(), plain(), library()
        p1 = event_ms(plain, 3)
        t1 = event_ms(kern, REPS)
        t2 = event_ms(kern, REPS)
        p2 = event_ms(plain, 3)
        lib_ms = event_ms(library, REPS)
        k3_ms[name, k, r] = {"ms": (t1 + t2) / 2, "plain_ms": (p1 + p2) / 2,
                             "library_ms": lib_ms,
                             **bound(*k3_work(k, r, BATCH))}
        emit({"phase": "times", "what": name, "k": k, "r": r or None,
              "lanes": BATCH, "dtype": "float32", "kernel_ms": [t1, t2],
              "plain_ms": [p1, p2], "library_ms": lib_ms,
              "launches_relaxed_cycle": n_launch,
              **bound(*k3_work(k, r, BATCH)), "device": smi})
    for name, key, replaces, err in (
            ("pallas_cholesky", "K3a", "srbx/ops/pallas_linalg.py:27",
             k3_f64_err["K3a"]),
            ("pallas_cho_solve", "K3b", "srbx/ops/pallas_linalg.py:62",
             k3_f64_err["K3b"])):
        launches = gen_runs["relaxed"]["launches"][key]
        shapes = {s: n for s, n in k3_shapes.items() if s[0] == key}
        mean = {f: sum(n * k3_ms[s][f] for s, n in shapes.items()) / launches
                for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                          "bytes", "flops")}
        bytes_bound = all(k3_ms[s]["bound_by"] == "bytes" for s in shapes)
        kernels.append(dict(
            name=name, route="cuda", source="srbx_torch/csrc/pallas_linalg.cu",
            replaces=replaces, launches=launches, max_abs_err=err, **mean,
            bound_by="bytes" if bytes_bound else "operations",
            weighted_over={f"k{k}" + (f"_r{r}" if r else ""): n
                           for (_, k, r), n in shapes.items()},
            launches_by_path={"generic_cycle": launches}))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
