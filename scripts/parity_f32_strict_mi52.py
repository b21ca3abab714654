#!/usr/bin/env python3
"""Which lanes the float32 strict NMPC solve with the neighbour circle
(mi 52) leaves unconverged, in the port and in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/parity_f32_strict_mi52.py [--lanes 4096]

The QPs are `chip_smoke.nmpc_cycle_qps`'s "warm_mi52" case (the cycle's
second SCP solve, warm-started, with the obstacle and the neighbour's
circle) on the first `--lanes` benchmark lanes, with the benchmark's strict
solver configuration (abstol = reltol = 1e-6, 25 iterations). They go
through:

* the port's plain twin of kernel K1a (`qp_fused.solve_lanes_last_plain`)
  in float64 and float32, and in float32 again with h moved by one ulp up
  and down;
* the JAX package's interpret-mode fused kernel
  (`srbx.ops.qp_fused.solve_lanes_last`, tile 256) and its step-fused
  `qp_batch.solve(backend="xla")`, in float32, on the same operands.

Each line gives the unconverged lanes' count and how many of them each other
run leaves unconverged too. Off the Tier-1 suite: it takes about a minute.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=4096)
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp

    from srbx.config import QpConfig as JQpConfig
    from srbx.ops import qp_batch as jqp_batch
    from srbx.ops import qp_fused as jqp_fused
    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch.ops import qp_fused

    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.BATCH = args.lanes
    dev = torch.device("cpu")
    cfg = MpcConfig(use_sqp=True, sqp_iters=2, elide_box_rows=True,
                    elide_simplex=True)
    fields = dict(abstol=1e-6, reltol=1e-6, reg_primal=1e-6, reg_dual=1e-6,
                  max_iters=25)
    strict, jstrict = QpConfig(**fields), JQpConfig(**fields)
    inputs, p_start, pobs = smoke.benchmark_inputs(dev)

    failed = {}

    def report(name, conv, iters):
        bad = ~np.asarray(conv, bool)
        failed[name] = bad
        print(json.dumps({
            "run": name, "lanes": args.lanes, "unconverged": int(bad.sum()),
            "share": float(bad.mean()), "max_iters": float(np.max(iters)),
            "also_unconverged_in": {k: int((bad & v).sum())
                                    for k, v in failed.items() if k != name}}),
            flush=True)

    ops = {}
    for dtype in (torch.float64, torch.float32):
        qp, cases = smoke.nmpc_cycle_qps(cfg, strict, inputs, p_start, pobs,
                                         dev, dtype)
        name, G, h, x0 = cases[2]
        assert name == "warm_mi52" and G.shape[0] == 52
        tag = "f64" if dtype == torch.float64 else "f32"
        runs = [(f"port plain {tag}", h)]
        if dtype == torch.float32:
            up = torch.full_like(h, np.inf)
            runs += [("port plain f32, h + 1 ulp", torch.nextafter(h, up)),
                     ("port plain f32, h - 1 ulp", torch.nextafter(h, -up))]
            ops = {"P": qp.P, "c": qp.c, "G": G, "h": h, "x0": x0}
        for run, hh in runs:
            st = qp_fused.solve_lanes_last_plain(qp.P, qp.c, G, hh, strict,
                                                 x0=x0)[3]
            report(run, (st[2] > 0.5).numpy(), st[3].numpy())

    P, c, G, h, x0 = (ops[k].numpy() for k in ("P", "c", "G", "h", "x0"))
    st = jax.jit(lambda *a: jqp_fused.solve_lanes_last(
        *a[:4], jstrict, tile=256, interpret=True, x0=a[4])[3])(
        *(jnp.asarray(v) for v in (P, c, G, h, x0)))
    st = np.asarray(st)
    report("jax fused interpret f32", st[2] > 0.5, st[3])
    bsz = args.lanes
    sol = jax.jit(lambda *a: jqp_batch.solve(*a[:6], jstrict, backend="xla",
                                             x0=a[6]))(
        *(jnp.asarray(v) for v in (
            P.transpose(2, 0, 1), c.T, np.zeros((bsz, 0, 13), np.float32),
            np.zeros((bsz, 0), np.float32), G.transpose(2, 0, 1), h.T,
            x0.T)))
    report("jax xla f32", np.asarray(sol.converged), [int(sol.iters)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
