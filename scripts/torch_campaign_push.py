"""Whole-body push-recovery campaign on one CUDA card: success against push
magnitude through srbx_torch's full 18-DoF closed loop.

The point of `scripts/campaign_push.py` (whose record is
docs/CAMPAIGN_PUSH.json): 16 lanes per magnitude of 0, 10, ..., 90 N
(B = 160), float32, `LoopConfig(stand_ticks=800, n_domains=10)`, an
obstacle-free straight trot (the two-agent APF reference, loop 8000), the
QP-only condensed NMPC on backend "fused" (kernel K1a) with tile 128, the
reduced LL QP (kernel K1b at n 25 / me 12), the physics through K2a and
K2b. Each lane gets one trunk force pulse of 300 ticks in the horizontal
plane: the azimuth uniform in [0, 2 pi) and the onset uniform in
[2, n_domains - 3) domains of trot ticks, drawn from the JAX script's
`jax.random.key(7)` through `srbx_torch.utils.prng`, so that every lane's
pulse is the JAX script's.

Success (the JAX script's rule): upright at the end (base z in [0.18,
0.40] m, |roll| and |pitch| < 0.5 rad), finite, and the LL QP converging
on more than 99.5 % of the final domain's ticks.

    python scripts/torch_campaign_push.py [reps] [n_domains] [dur_ms]
        [--stand N] [--dtype float64] [--device cpu] [--ll-ruiz N]
        [--backend fused|xla]

At the script's point the run is also held lane by lane to the JAX
package's own run of the same point in the same dtype, committed in
tests/data/torch_push_jax.npz (tests/test_torch_disturbance.py::
build_push_fixture, on the CPU, backend "xla"): the lanes whose success or
finiteness differ, and the largest final-state difference on the lanes
where both are finite.

--ll-ruiz N gives the LL QP N Ruiz sweeps in either dtype (by default
the loop picks them by dtype, as the JAX script's does: 5 in float32, none
in float64), so that a float64 run can take the float32 run's LL solver
configuration and differ from it in the dtype alone.

--backend picks the loop's backend (by default "fused" on the card, the
JAX script's choice there, and "xla" on the CPU): "fused" on the CPU runs
the kernels' plain versions, "xla" the port's library path.

Prints the record's fields, the success rule, the per-lane outcomes, the
wall time of the run after a short warm-up (one synchronize at the end)
and the card's name and power limit from nvidia-smi. At the script's
point (the defaults) it also writes them to docs/CAMPAIGN_PUSH_TORCH.json
(float32) or docs/CAMPAIGN_PUSH_TORCH_F64.json (float64), with _LLRUIZ<N>
added for --ll-ruiz, _CPU for a run on the CPU and _<BACKEND> for a backend
other than the device's default (a run on the CPU is a second witness
beside the card's kernels); smaller points (rehearsals) only print.
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

from srbx_torch import refplan  # noqa: E402
from srbx_torch.config import (LowLevelConfig, MotionConfig,  # noqa: E402
                               MpcConfig, QpConfig)
from srbx_torch.models import a1  # noqa: E402
from srbx_torch.sim import closedloop, wholebody as wb  # noqa: E402
from srbx_torch.utils import prng  # noqa: E402

MAGS = [0.0, 10.0, 20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0, 90.0]
QP_CFG = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6, reg_dual=1e-6,
                  max_iters=12)
MPC_CFG = MpcConfig(use_sqp=False, condensed=True, elide_box_rows=True,
                    elide_simplex=True)
P_START = (0.0, 0.0, 0.0, -1.0)
SUCCESS_RULE = ("final base z in [0.18, 0.40] m, |roll| and |pitch| < 0.5 "
                "rad, finite, LL-QP converged share of the final domain > "
                "0.995")


def pushes(reps, n_domains, dur_ticks, ticks_per_domain, dtype, device):
    """The JAX script's pulses: (force (B, 3), start (B,), dur (B,)) with
    B = 10 reps, magnitudes repeated reps times, from key(7), on
    `device`."""
    bsz = len(MAGS) * reps
    k_az, k_start = prng.split(prng.key(7, device)).unbind(-2)
    mags = torch.tensor(MAGS, dtype=torch.float32,
                        device=device).repeat_interleave(reps)
    az = prng.uniform(k_az, (bsz,), torch.float32, 0.0, 2 * np.pi)
    force = torch.stack([mags * torch.cos(az), mags * torch.sin(az),
                         torch.zeros_like(mags)], 1).to(dtype)
    start = prng.randint(k_start, (bsz,), 2 * ticks_per_domain,
                         (n_domains - 3) * ticks_per_domain)
    dur = torch.full((bsz,), dur_ticks, dtype=torch.int32, device=device)
    return force, start, dur


def success(res):
    """Per lane, the JAX script's success rule on a run_batch result."""
    q = res.sim.q.double().cpu().numpy()
    bsz = q.shape[0]
    com = res.com_hist.double().cpu().numpy().reshape(bsz, -1)
    z_ok = (q[:, 2] > 0.18) & (q[:, 2] < 0.40)
    rp_ok = (np.abs(q[:, 3]) < 0.5) & (np.abs(q[:, 4]) < 0.5)
    finite = np.isfinite(com).all(1) & np.isfinite(q).all(1)
    llok_final = res.tau_hist[:, -1, 1].double().cpu().numpy() > 0.995
    return z_ok & rp_ok & finite & llok_final, finite


def against_jax(res, ok, finite, f64):
    """The run lane by lane against the JAX package's run of the same point
    in the same dtype (tests/data/torch_push_jax.npz, float32 under
    "f32.*")."""
    pre = "" if f64 else "f32."
    with np.load(ROOT / "tests" / "data" / "torch_push_jax.npz") as f:
        jx = {k[len(pre):]: v for k, v in f.items() if k.startswith(pre)}
    mags = np.repeat(MAGS, len(ok) // len(MAGS))
    q = res.sim.q.double().cpu().numpy()
    both = finite & jx["finite"]
    differ = np.nonzero((ok != jx["success"]) | (finite != jx["finite"]))[0]
    return {
        "source": "tests/data/torch_push_jax.npz (JAX package, "
                  + ("float64" if f64 else "float32, under f32.")
                  + ", backend xla, CPU)",
        "success_total_jax": float(jx["success"].mean()),
        "success_vs_push_N_jax": {
            str(int(m)): float(jx["success"][mags == m].mean())
            for m in MAGS},
        "finite_lanes_jax": int(jx["finite"].sum()),
        "success_equal_share": float((ok == jx["success"]).mean()),
        "lanes_differing": [{"lane": int(i), "push_N": float(mags[i]),
                             "success": bool(ok[i]),
                             "success_jax": bool(jx["success"][i]),
                             "finite": bool(finite[i]),
                             "finite_jax": bool(jx["finite"][i])}
                            for i in differ],
        "max_abs_dq_final_both_finite": float(
            np.abs(q[both] - jx["q"][both]).max()) if both.any() else None,
        "max_abs_dq_final_by_push_N": {
            str(int(m)): float(np.abs(q[both & (mags == m)]
                                      - jx["q"][both & (mags == m)]).max())
            for m in MAGS if (both & (mags == m)).any()},
    }


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("reps", type=int, nargs="?", default=16)
    ap.add_argument("n_domains", type=int, nargs="?", default=10)
    ap.add_argument("dur_ms", type=int, nargs="?", default=300)
    ap.add_argument("--stand", type=int, default=800)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ll-ruiz", type=int, default=None)
    ap.add_argument("--backend", default=None, choices=("fused", "xla"))
    args = ap.parse_args(argv)
    f64 = args.dtype == "float64"
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_campaign_push: no CUDA card; pass --device cpu",
              file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.float64 if f64 else torch.float32
    reps = args.reps
    bsz = len(MAGS) * reps
    loop = closedloop.LoopConfig(stand_ticks=args.stand,
                                 n_domains=args.n_domains)
    pobs = torch.full((2, 20), 100.0, dtype=dtype, device=device)
    ref = refplan.generate(refplan.two_agent_config(loop_size=8_000),
                           torch.tensor(P_START, dtype=dtype, device=device),
                           pobs, dtype=dtype, device=device)
    pr = ref.pr[0:2].expand(bsz, -1, -1)
    prd = ref.prd[0:2].expand(bsz, -1, -1)
    a0 = torch.tensor(P_START[0:2], dtype=dtype,
                      device=device).expand(bsz, 2)
    pobs_b = pobs.expand(bsz, 2, 20)
    push = pushes(reps, args.n_domains, args.dur_ms, loop.ticks_per_domain,
                  dtype, device)
    default_backend = "fused" if device.type == "cuda" else "xla"
    backend = args.backend or default_backend
    ll_qp_cfg = (None if args.ll_ruiz is None else
                 dataclasses.replace(QP_CFG, ruiz_iters=args.ll_ruiz))

    def run(loop):
        res = closedloop.run_batch(
            MPC_CFG, LowLevelConfig(), MotionConfig(), QP_CFG,
            wb.SimConfig(), loop, a1.model(), pr, prd, a0, pobs_b,
            dtype=dtype, backend=backend, tile=128, ll_reduced=True,
            ll_qp_cfg=ll_qp_cfg, push=push, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return res

    run(closedloop.LoopConfig(2, 1, 2))     # warm-up: any kernel build
    t0 = time.perf_counter()
    res = run(loop)
    wall = time.perf_counter() - t0

    ok, finite = success(res)
    curve = {str(int(m)): float(ok[i * reps:(i + 1) * reps].mean())
             for i, m in enumerate(MAGS)}
    with open(ROOT / "docs" / "CAMPAIGN_PUSH.json") as f:
        record = json.load(f)
    ticks = loop.stand_ticks + loop.n_domains * loop.ticks_per_domain
    out = {
        "reps_per_magnitude": reps,
        "n_domains": args.n_domains,
        "pulse_duration_ms": args.dur_ms,
        "success_vs_push_N": curve,
        "wall_s": wall,
        "notes": ("per-lane trunk force pulse, random azimuth in the "
                  "horizontal plane, onset uniform in [2,n_domains-3] "
                  "domains of trot; reference analogue "
                  "src/A1_Sim.cpp:84-107; pulses from jax.random.key(7) as "
                  "scripts/campaign_push.py draws them"),
        "success_rule": SUCCESS_RULE,
        "success_total": float(ok.mean()),
        "record_success_total": float(np.mean(
            list(record["success_vs_push_N"].values()))),
        "finite_lanes": int(finite.sum()), "lanes": bsz,
        "stand_ticks": loop.stand_ticks, "ticks_per_lane": ticks,
        "ll_ticks_per_s": bsz * ticks / wall,
        "ll_qp_ok": res.qp_ok.double().mean().item(),
        "mpc_ok": res.mpc_ok.double().mean().item(),
        "success_per_lane": [bool(v) for v in ok],
        "finite_per_lane": [bool(v) for v in finite],
        "dtype": args.dtype, "backend": backend, "ll_reduced": True,
        "ll_ruiz_iters": closedloop._resolve_ll_qp_cfg(
            QP_CFG, True, ll_qp_cfg, dtype).ruiz_iters,
        "device": card_name() if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
    }
    full = (args.reps, args.n_domains, args.dur_ms, args.stand) == (
        16, 10, 300, 800)
    if full:
        out["jax_" + args.dtype] = against_jax(res, ok, finite, f64)
    print(json.dumps(out, indent=1))
    if full:
        name = "CAMPAIGN_PUSH_TORCH" + ("_F64" if f64 else "") + (
            "" if args.ll_ruiz is None else f"_LLRUIZ{args.ll_ruiz}") + (
            "" if device.type == "cuda" else "_CPU") + (
            "" if backend == default_backend else f"_{backend.upper()}")
        path = ROOT / "docs" / f"{name}.json"
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
