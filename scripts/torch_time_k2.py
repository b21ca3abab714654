#!/usr/bin/env python3
"""Device times of kernels K2a and K2b (`srbx_torch/ops/spd.py`) on one
CUDA card, at the whole-body loop's shapes, built from a given tree, so that
two designs can be timed in turns in one call.

    python3 scripts/torch_time_k2.py [--root TREE] [--label NAME]
                                     [--lanes 4096,65536] [--check]

`--root` is the repository tree whose `srbx_torch/` is built and timed (by
default this script's own); the matrices, the bounds and the timers come
from this script's `chip_smoke.py`, so every tree is timed on the same
inputs. To compare two designs, copy the other tree's `srbx_torch/` under
the git-ignored `_chip/` and run old, new, new, old in one command:

    mkdir -p _chip/old && git archive <commit> srbx_torch | tar -x -C _chip/old
    for t in _chip/old . . _chip/old; do
        python3 scripts/torch_time_k2.py --root $t --label $t; done

K2a runs at (k, r) = (18, 1) (the physics substeps' mass-matrix solve),
K2b at k 18 (D^-1 of the low-level QP build) and k 12 (the swing
operational-space inverse), in float32, on the loop's own matrices: A1 mass
matrices at random configurations and the swing matrices built from them,
made on the card from one seed (`chip_smoke.spd_inputs`), at B 4096 (the
loop's batch: one wave) and B 65536 (many waves). Each line gives, per
launch:

* `device_ms`: a CUDA graph of 100 launches, replayed three times between
  CUDA events (no host work between launches);
* `profiler_ms`: the kernel's own CUDA time from `torch.profiler`'s
  `key_averages()` over 20 calls, or null where the profiler shows none;
* `host_ms`: 10 back-to-back calls of the Python wrapper between CUDA
  events (what a caller pays: the checks, the allocation, the launch);
* the bound (`chip_smoke.k2_work`, `bound`);
* `torch.linalg.solve_ex` / `torch.linalg.inv_ex`'s time: the CUDA time
  of all its kernels per call from `torch.profiler` (`library_profiler_ms`;
  it cannot be captured in a CUDA graph) and its host-inclusive time
  (`library_host_ms`);
* the build's ptxas registers, stack and spills, the resident warps per SM
  and, where the tree reports it, the launch geometry.

Each line reports the kernel against its plain version on the timed
inputs (`bitwise_equal_plain` and the largest difference over the largest
value: the first design used fused multiply-adds and is not bitwise).
`--check` first holds both kernels bitwise against their plain versions on
a ragged batch (B - 3 lanes) at the path's and edge shapes, in float64 and
float32, and fails on any differing bit. Needs a CUDA card; without one it
exits non-zero.
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
SHAPES = (("K2a", 18, 1), ("K2b", 18, 18), ("K2b", 12, 12))
# kernel names in the ptxas log: the first design's, then this one's
PTXAS_NAMES = ("spd_kernel", "spd_lane_kernel")


def _smoke():
    """This tree's chip_smoke.py as a module (its helpers import srbx_torch
    lazily, so they use the tree on sys.path)."""
    spec = importlib.util.spec_from_file_location("k2_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--lanes", default="4096,65536")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    smoke = _smoke()
    from srbx_torch.ops import _build, spd

    label = args.label or str(root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib = _build.build()
    _build.load()
    log = lib.with_suffix(".log").read_text()
    print(json.dumps({"label": label, "root": str(root), "device": smi,
                      "ptxas": [e for name in PTXAS_NAMES
                                for e in smoke.ptxas_summary(log, name)]}),
          flush=True)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.check:
        for rec in smoke.k2_checks(spd, dev, 4096 - 3)[0]:
            print(json.dumps({"label": label, **rec}), flush=True)
            if not rec["ok"]:
                raise SystemExit(f"K2 kernel != plain version: {rec}")

    for bsz in (int(b) for b in args.lanes.split(",")):
        mats = smoke.spd_inputs(bsz, torch.float32, 3, dev)
        for name, k, r in SHAPES:
            d = mats["d18"] if k == 18 else mats["d12"]
            if name == "K2a":
                rhs = mats["rhs18"]

                def kern():
                    return spd.solve(d, rhs)

                def library():
                    return torch.linalg.solve_ex(d, rhs)[0]
                want = spd.solve_plain(d, rhs)
            else:
                def kern():
                    return spd.inverse(d)

                def library():
                    return torch.linalg.inv_ex(d)[0]
                want = spd.inverse_plain(d)
            got = kern()
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            rel = ((got - want).abs().max() / want.abs().max()).item()
            device_ms = smoke.graph_ms(kern)
            host_ms = [smoke.event_ms(kern, REPS), smoke.event_ms(kern, REPS)]
            prof_ms = smoke.profiler_ms(kern, "spd_")
            library()
            library_ms = smoke.profiler_ms(library)
            library_host_ms = smoke.event_ms(library, REPS)
            # this design takes r = 0 for the inverse; the first took r = k
            shape_r = 0 if name == "K2b" and hasattr(spd, "launch_geometry") \
                else r
            geometry = (spd.launch_geometry(torch.float32, k, shape_r, bsz)
                        if hasattr(spd, "launch_geometry") else None)
            warps = _build.load().srbx_spd_resident_warps(0, k, shape_r)
            print(json.dumps({
                "label": label, "kernel": name, "k": k, "r": r,
                "lanes": bsz, "dtype": "float32", "device_ms": device_ms,
                "profiler_ms": prof_ms, "host_ms": host_ms,
                "library_profiler_ms": library_ms,
                "library_host_ms": library_host_ms,
                **smoke.bound(*smoke.k2_work(k, r, bsz, name == "K2b")),
                "resident_warps_per_sm": warps, "geometry": geometry,
                "bitwise_equal_plain": same, "max_rel_err": rel,
                "device": smi}), flush=True)
            del got, want
        del mats
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
