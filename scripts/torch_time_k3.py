#!/usr/bin/env python3
"""Times of kernels K3a and K3b (`srbx_torch/ops/pallas_linalg.py`) on one
CUDA card, at the shapes of the generic NMPC cycle, built from a given
tree, so that two designs can be timed in turns in one call.

    python3 scripts/torch_time_k3.py [--root TREE] [--label NAME]
                                     [--lanes 131072] [--check]

`--root` is the repository tree whose `srbx_torch/` is built and timed (by
default this script's own); the matrices and the bounds come from this
script's `chip_smoke.py`, so every tree is timed on the same inputs. To
compare two designs, copy the other tree's `srbx_torch/` under the
git-ignored `_chip/` and run old, new, new, old in one command:

    mkdir -p _chip/old && git archive <commit> srbx_torch | tar -x -C _chip/old
    for t in _chip/old . . _chip/old; do
        python3 scripts/torch_time_k3.py --root $t --label $t; done

K3a runs at k 41 and 28 (the IPM's M and S), K3b at (k, r) = (41, 28),
(41, 1) and (28, 1) (M^-1 A' and the KKT solves), on random
well-conditioned SPD matrices made on the card from one seed, in float32.
Each line gives the CUDA-event ms per launch (the mean of 20 launches,
twice), the bound as `chip_smoke.py` counts it (`k3_work`, `bound`), the
launch geometry where the tree reports it, and the build's ptxas registers,
stack and spills for that kernel. Each shape is first held bitwise against
its plain version. `--check` first holds both kernels against their plain
versions bitwise on a ragged batch (B - 3 lanes) at the path's and edge
shapes, in float64 and float32. Needs a CUDA card; without one it exits
non-zero.
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
REPS = 20
SHAPES = (("K3a", 41, 0), ("K3a", 28, 0), ("K3b", 41, 28), ("K3b", 41, 1),
          ("K3b", 28, 1))
# kernel names in the ptxas log: the first design's, then this one's
PTXAS_NAMES = {"K3a": ("cholesky_kernel",),
               "K3b": ("cho_solve_kernel", "cho_solve1_kernel")}


def _smoke():
    """This tree's chip_smoke.py as a module (its helpers import srbx_torch
    lazily, so they use the tree on sys.path)."""
    spec = importlib.util.spec_from_file_location("k3_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spd(bsz, k, r, dtype, seed, dev):
    """Well-conditioned SPD matrices (bsz, k, k) and right-hand sides
    (bsz, k, r), made on the card from `seed`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(bsz, k, k, generator=gen, device=dev, dtype=dtype)
    m = a @ a.mT / k + torch.eye(k, device=dev, dtype=dtype)
    rhs = torch.randn(bsz, k, max(r, 1), generator=gen, device=dev,
                      dtype=dtype)
    return m, rhs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--lanes", type=int, default=131072)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    smoke = _smoke()
    from srbx_torch.ops import _build, pallas_linalg as plin

    label = args.label or str(root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib = _build.build()
    _build.load()
    log = lib.with_suffix(".log").read_text()
    print(json.dumps({"label": label, "root": str(root), "device": smi,
                      "ptxas": {kern: [e for name in names
                                       for e in smoke.ptxas_summary(log, name)]
                                for kern, names in PTXAS_NAMES.items()}}),
          flush=True)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    bsz = args.lanes

    if args.check:
        cut = bsz - 3
        for dtype in (torch.float64, torch.float32):
            for k, r in ((41, 28), (41, 1), (28, 1), (17, 4), (13, 1),
                         (1, 1), (33, 3), (64, 32), (64, 64)):
                m, rhs = spd(cut, k, r, dtype, 5, dev)
                lp = plin.batch_cholesky_plain(m)
                same = (torch.equal(plin.batch_cholesky(m), lp),
                        torch.equal(plin.batch_cho_solve(lp, rhs),
                                    plin.batch_cho_solve_plain(lp, rhs)))
                print(json.dumps({"label": label, "check": "bitwise",
                                  "lanes": cut, "k": k, "r": r,
                                  "dtype": str(dtype), "K3a": same[0],
                                  "K3b": same[1]}), flush=True)
                if not all(same):
                    raise SystemExit(f"k {k} r {r} {dtype}: kernel != plain")
                del m, rhs, lp

    for name, k, r in SHAPES:
        m, rhs = spd(bsz, k, r, torch.float32, 3, dev)
        l = plin.batch_cholesky_plain(m)
        if name == "K3a":
            def kern():
                return plin.batch_cholesky(m)
            same = torch.equal(kern(), l)
        else:
            def kern():
                return plin.batch_cho_solve(l, rhs)
            same = torch.equal(kern(), plin.batch_cho_solve_plain(l, rhs))
        torch.cuda.synchronize()
        if not same:
            raise SystemExit(f"{name} k {k} r {r}: kernel != plain version")
        ms = [smoke.event_ms(kern, REPS), smoke.event_ms(kern, REPS)]
        geometry = (plin.launch_geometry(torch.float32, k, r, bsz)
                    if hasattr(plin, "launch_geometry") else None)
        warps = _build.load().srbx_pallas_resident_warps(0, k, r)
        print(json.dumps({"label": label, "kernel": name, "k": k,
                          "r": r or None, "lanes": bsz, "dtype": "float32",
                          "ms": ms, **smoke.bound(*smoke.k3_work(k, r, bsz)),
                          "resident_warps_per_sm": warps,
                          "geometry": geometry, "bitwise_equal_plain": same,
                          "device": smi}), flush=True)
        del m, rhs, l
    return 0


if __name__ == "__main__":
    sys.exit(main())
