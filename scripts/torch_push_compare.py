"""The push campaign's runs lane by lane: which lanes succeed in which run.

Reads the per-lane outcomes that scripts/torch_campaign_push.py wrote at
its point (16 lanes per magnitude of 0, 10, ..., 90 N, the same key(7)
pulses in every run) into the files of RUNS below:

  f32             the card, float32, "fused"
  f64             the card, float64, "fused"
  f64_ruiz5       the card, float64, "fused", the float32 run's LL solver
                  configuration (5 Ruiz sweeps)
  f64_cpu         the CPU, float64, "xla"
  f64_cpu_fused   the CPU, float64, "fused" (the kernels' plain versions)
  f32_cpu         the CPU, float32, "xla"
  jax_f64         the JAX package, float64, "xla", on the CPU
                  (tests/data/torch_push_jax.npz)
  jax_f32         the JAX package, float32, "xla", on the CPU (the same
                  file, under "f32.")

and prints, as one JSON object: each run's success by magnitude; for each
pair of runs the lanes whose success differs, with the run each sides
with; and, for each lane where any two runs differ, every run's outcome.
A run whose file is missing is left out.

    python scripts/torch_push_compare.py
"""

import itertools
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MAGS = [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]
RUNS = {"f32": "docs/CAMPAIGN_PUSH_TORCH.json",
        "f64": "docs/CAMPAIGN_PUSH_TORCH_F64.json",
        "f64_ruiz5": "docs/CAMPAIGN_PUSH_TORCH_F64_LLRUIZ5.json",
        "f64_cpu": "docs/CAMPAIGN_PUSH_TORCH_F64_CPU.json",
        "f64_cpu_fused": "docs/CAMPAIGN_PUSH_TORCH_F64_CPU_FUSED.json",
        "f32_cpu": "docs/CAMPAIGN_PUSH_TORCH_CPU.json",
        "jax_f64": "tests/data/torch_push_jax.npz",
        "jax_f32": "tests/data/torch_push_jax.npz"}


def load():
    runs = {}
    for name, rel in RUNS.items():
        path = ROOT / rel
        if not path.exists():
            continue
        if path.suffix == ".npz":
            key = "f32.success" if name == "jax_f32" else "success"
            with np.load(path) as f:
                if key in f:
                    runs[name] = f[key].astype(bool)
        else:
            with open(path) as f:
                runs[name] = np.array(json.load(f)["success_per_lane"])
    return runs


def main():
    runs = load()
    mags = np.repeat(MAGS, 16)
    out = {"sources": {k: RUNS[k] for k in runs},
           "success_vs_push_N": {
               k: {str(m): float(v[mags == m].mean()) for m in MAGS}
               for k, v in runs.items()},
           "success_total": {k: float(v.mean()) for k, v in runs.items()},
           "pairs": {}}
    for a, b in itertools.combinations(runs, 2):
        diff = np.nonzero(runs[a] != runs[b])[0]
        out["pairs"][f"{a} vs {b}"] = {
            "lanes_differing": len(diff),
            f"only_{a}_succeeds": [int(i) for i in diff if runs[a][i]],
            f"only_{b}_succeeds": [int(i) for i in diff if runs[b][i]]}
    stack = np.stack(list(runs.values()))
    lanes = np.nonzero(stack.min(0) != stack.max(0))[0]
    out["lanes"] = {str(int(i)): {"push_N": int(mags[i]),
                                  **{k: bool(v[i]) for k, v in runs.items()}}
                    for i in lanes}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
