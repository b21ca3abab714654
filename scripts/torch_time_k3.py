#!/usr/bin/env python3
"""Times of kernels K3a and K3b (`srbx_torch/ops/pallas_linalg.py`) on one
CUDA card, at the shapes of the generic NMPC cycle.

    python3 scripts/torch_time_k3.py [--lanes 131072] [--label NAME]

Builds the kernels from the sources beside this script, then for K3a at
k 41 and 28 (the IPM's M and S) and K3b at (k, r) = (41, 28), (41, 1) and
(28, 1) (M^-1 A' and the KKT solves) on random well-conditioned SPD
matrices in float32: CUDA-event ms per launch, the mean of 20 launches,
twice; and the bound as `chip_smoke.py` counts it (`k3_work`, `bound`).
Each line checks the kernel against its plain version first (bitwise).
Prints one JSON line per shape, and the card's name and power limit. Needs
a CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import bound, event_ms, k3_work  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=131072)
    ap.add_argument("--label", default=str(ROOT.name))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from srbx_torch.ops import _build, pallas_linalg as plin

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    bsz = args.lanes
    for name, k, r in (("K3a", 41, 0), ("K3a", 28, 0), ("K3b", 41, 28),
                       ("K3b", 41, 1), ("K3b", 28, 1)):
        a = torch.randn(bsz, k, k, generator=gen, device=dev)
        m = a @ a.mT / k + torch.eye(k, device=dev)
        l = plin.batch_cholesky_plain(m)
        if name == "K3a":
            kern = lambda: plin.batch_cholesky(m)          # noqa: E731
            same = torch.equal(kern(), l)
        else:
            rhs = torch.randn(bsz, k, r, generator=gen, device=dev)
            kern = lambda: plin.batch_cho_solve(l, rhs)    # noqa: E731
            same = torch.equal(kern(), plin.batch_cho_solve_plain(l, rhs))
        torch.cuda.synchronize()
        if not same:
            raise SystemExit(f"{name} k {k} r {r}: kernel != plain version")
        ms = [event_ms(kern, 20), event_ms(kern, 20)]
        print(json.dumps({"label": args.label, "kernel": name, "k": k,
                          "r": r or None, "lanes": bsz, "dtype": "float32",
                          "ms": ms, **bound(*k3_work(k, r, bsz)),
                          "bitwise_equal_plain": same, "device": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
