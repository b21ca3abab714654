#!/usr/bin/env python3
"""Times of the fused IPM kernels K1a and K1b (`srbx_torch/ops/qp_fused.py`)
on one CUDA card, built from a given tree, so that two designs can be timed
in turns in one call.

    python3 scripts/torch_time_k1.py [--root TREE] [--label NAME] [--check]

`--root` is the repository tree whose `srbx_torch/` is built and timed (by
default this script's own); the QPs and the bounds come from this script's
`chip_smoke.py`, so every tree is timed on the same inputs. To compare two
designs, copy the other tree's `srbx_torch/` under the git-ignored `_chip/`
and run old, new, new, old in one command:

    mkdir -p _chip/old && git archive <commit> srbx_torch | tar -x -C _chip/old
    for t in _chip/old . . _chip/old; do
        python3 scripts/torch_time_k1.py --root $t --label $t; done

K1a runs on the NMPC cycle's own QPs (B = 131072, float32, relaxed: cold
mi 28, warm mi 48 and warm mi 52; and, where the tree takes mi > 64, the
same cycle with its box rows kept: cold mi 92, warm mi 112 and 116), K1b
on random well-conditioned QPs of each shape the tree has: the whole-body
LL QP's (mi 45, the full n 43 / me 30 and the reduced n 25 / me 12) and
the NMPC's (n 41 / me 28 at mi 92, 112, 116 and n 17 / me 4 at mi 28, 48,
52, 92, 112, 116), B = 4096, float32, bench_wholebody's relaxed
configuration. Each line gives the CUDA-event ms per launch (the mean of
10 launches, twice), the bound as `chip_smoke.py` counts it, the lanes'
iterations, and the build's ptxas registers, stack and spills for that
kernel. `--check` first holds each kernel against its plain version in
float64 on a ragged batch (B - 5 and 4093 lanes). Needs a CUDA card;
without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
REPS = 10


def _smoke():
    """This tree's chip_smoke.py as a module (its helpers import srbx_torch
    lazily, so they use the tree on sys.path)."""
    spec = importlib.util.spec_from_file_location("k1_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    smoke = _smoke()
    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch.ops import _build, qp_fused

    label = args.label or str(root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib = _build.build()
    _build.load()
    log = lib.with_suffix(".log").read_text()
    warps = {}
    # each tree's K1b shapes and their inequality rows: the LL QP's at mi
    # 45, the NMPC's (where the tree has them) at the cycle's mi
    built = getattr(qp_fused, "GENERAL_SHAPES", ((43, 30),))
    k1b_mis = {(43, 30): (45,), (25, 12): (45,), (41, 28): (92, 112, 116),
               (17, 4): (28, 48, 52, 92, 112, 116)}
    k1b_cases = [(n, me, mi) for (n, me), mis in k1b_mis.items()
                 if (n, me) in built for mi in mis]
    k1a_mis = (28, 48, 52) + ((92, 112, 116) if qp_fused.MAX_MI >= 116
                              else ())
    if hasattr(qp_fused, "resident_warps"):        # not in the first designs
        general = hasattr(_build.load(), "srbx_qp_general_resident_warps")
        for dtype in (torch.float32, torch.float64):
            for mi in k1a_mis:
                warps[f"K1a_{dtype}_mi{mi}"] = qp_fused.resident_warps(
                    dtype, mi)
            for n, me, mi in k1b_cases if general else ():
                warps[f"K1b_{n}_{me}_{dtype}_mi{mi}"] = \
                    qp_fused.resident_warps(dtype, mi, general=True,
                                            shape=(n, me))
    print(json.dumps({"label": label, "root": str(root), "device": smi,
                      "resident_warps_per_sm": warps,
                      "ptxas_k1a": smoke.ptxas_summary(
                          log, "qp_fused_noeq_kernel"),
                      "ptxas_k1b": smoke.ptxas_summary(
                          log, "qp_general_kernel")}),
          flush=True)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MpcConfig(use_sqp=True, sqp_iters=2, elide_box_rows=True,
                    elide_simplex=True)
    relaxed = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                       reg_dual=1e-6, max_iters=12, kkt_refine_iters=0)
    strict = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                      reg_dual=1e-6, max_iters=25)
    wb_relaxed = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                          reg_dual=1e-6, max_iters=12)
    box_cfg = MpcConfig(use_sqp=True, sqp_iters=2, elide_simplex=True,
                        condensed=True)
    inputs, p_start, pobs = smoke.benchmark_inputs(dev)

    def qps(dtype):
        """The cycle's K1a QPs (mi 28, 48, 52), then those of the cycle with
        its box rows kept (mi 92, 112, 116) where the tree takes them."""
        out = []
        for c in (cfg, box_cfg) if len(k1a_mis) > 3 else (cfg,):
            qp, cases = smoke.nmpc_cycle_qps(c, strict, inputs, p_start,
                                             pobs, dev, dtype)
            out += [(qp, case) for case in cases]
        return out

    if args.check:
        for qp, (case, G, h, x0) in qps(torch.float64):
            cut = smoke.BATCH - 5
            ops = [t[..., :cut].contiguous() for t in (qp.P, qp.c, G, h)]
            x0c = None if x0 is None else x0[:, :cut].contiguous()
            xk, _, _, stk = qp_fused.solve_lanes_last(*ops, strict, x0=x0c)
            xp, _, _, stp = qp_fused.solve_lanes_last_plain(*ops, strict,
                                                            x0=x0c)
            print(json.dumps({
                "label": label, "check": "K1a", "case": case,
                "mi": G.shape[0], "lanes": cut,
                "dtype": "float64", "max_abs_dx": (xk - xp).abs().max().item(),
                "converged_equal": bool((stk[2] == stp[2]).all()),
                "lane_iters_equal": (stk[3] == stp[3]).double().mean().item(),
                "max_iters": [stk[3].max().item(), stp[3].max().item()]}),
                flush=True)
        for n, me, mi in k1b_cases:
            data = smoke.random_ll_qps(4093, dev, torch.float64, n=n, me=me,
                                       mi=mi)
            sk = qp_fused.solve(*data, QpConfig())
            sp = qp_fused.solve_plain(*data, QpConfig())
            print(json.dumps({
                "label": label, "check": "K1b", "n": n, "me": me, "mi": mi,
                "lanes": 4093, "dtype": "float64",
                "max_abs_dx": (sk.x - sp.x).abs().max().item(),
                "converged_equal": bool((sk.converged == sp.converged).all()),
                "lane_iters_equal": (sk.lane_iters == sp.lane_iters).double()
                .mean().item()}), flush=True)
        del data

    for qp, (case, G, h, x0) in qps(torch.float32):
        def kern():
            return qp_fused.solve_lanes_last(qp.P, qp.c, G, h, relaxed, x0=x0)

        stat = kern()[3]
        ms = [smoke.event_ms(kern, REPS), smoke.event_ms(kern, REPS)]
        work = smoke.k1a_work(qp.P, qp.c, G, h, x0, stat[3],
                              relaxed.kkt_refine_iters)
        print(json.dumps({"label": label, "kernel": "K1a", "case": case,
                          "mi": G.shape[0], "lanes": smoke.BATCH,
                          "dtype": "float32", "ms": ms,
                          "converged": (stat[2] > 0.5).double().mean().item(),
                          "max_iters": stat[3].max().item(),
                          **smoke.bound(*work), "device": smi}), flush=True)

    for n, me, mi in k1b_cases:
        data = smoke.random_ll_qps(smoke.WB_BATCH, dev, torch.float32, n=n,
                                   me=me, mi=mi)

        def kern_b():
            return qp_fused.solve(*data, wb_relaxed)

        sol = kern_b()
        ms = [smoke.event_ms(kern_b, REPS), smoke.event_ms(kern_b, REPS)]
        work = smoke.k1b_work(data, sol, wb_relaxed.kkt_refine_iters)
        print(json.dumps({"label": label, "kernel": "K1b",
                          "case": "random", "lanes": smoke.WB_BATCH,
                          "n": n, "me": me, "mi": mi, "dtype": "float32",
                          "ms": ms,
                          "converged": sol.converged.double().mean().item(),
                          "max_iters": int(sol.iters),
                          "mean_iters": sol.lane_iters.double().mean().item(),
                          **smoke.bound(*work), "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
