"""The CLF-on/CLF-off closed-loop pair of scripts/campaign_clf.py (whose
record is docs/CLF_LOOP.json) through srbx_torch's batched whole-body loop.

The JAX script runs one agent's loop: 400 stand ticks, then 6 trot domains
of 172 ticks, float64, an obstacle-free trot (the two-agent APF reference,
loop 8000, the first agent from (0, 0.5)), the uncondensed NMPC without
SCP, `QpConfig()` for both QPs, the full LL build with
`LowLevelConfig(use_clf=True)` (the reference's params/LL_w_CLF.txt)
against `LowLevelConfig()`. Here that agent is the one lane of
`closedloop.run_batch` (backend "fused" on the card, "xla" on the CPU).
Every trot tick's CLF value V and derivative dV are read from the LL
output, and the record's fields follow: the share of trot ticks that break
the decrease condition dV <= -(c/eps) V by more than 1e-6 (the ticks where
the relaxation of the CLF row, row 44 of the LL QP, is used), and the
largest COM distance between the two loops over the trot ticks, each
beside the record's.

    python scripts/torch_clf_loop.py [n_domains] [--device cpu]

Prints the result; at 6 domains it also writes it to
docs/CLF_LOOP_TORCH.json (docs/CLF_LOOP_TORCH_CPU.json on the CPU).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from srbx_torch import refplan  # noqa: E402
from srbx_torch.config import (Gait, LowLevelConfig,  # noqa: E402
                               MotionConfig, MpcConfig, QpConfig)
from srbx_torch.models import a1  # noqa: E402
from srbx_torch.sim import closedloop, wholebody as wb  # noqa: E402

STAND, TPD = 400, 172
P_START = (0.0, 0.5, 0.0, -0.5)


def run(ll_cfg, n_domains, device):
    """One loop; returns (V, dV, LL converged, COM) over the trot ticks."""
    f64 = torch.float64
    pobs = torch.full((2, 20), 100.0, dtype=f64, device=device)
    ref = refplan.generate(refplan.two_agent_config(loop_size=8_000),
                           torch.tensor(P_START, dtype=f64, device=device),
                           pobs, dtype=f64, device=device)
    recs = []
    tick = closedloop._tick_batch

    def recording(*args, **kw):
        out = tick(*args, **kw)
        if args[4] == Gait.TROT:
            recs.append(torch.stack([out[0].v_lyap, out[0].dv_lyap,
                                     out[0].qp_converged.to(f64)], -1))
        return out

    with mock.patch.object(closedloop, "_tick_batch", recording):
        res = closedloop.run_batch(
            MpcConfig(use_sqp=False), ll_cfg, MotionConfig(), QpConfig(),
            wb.SimConfig(), closedloop.LoopConfig(STAND, n_domains, TPD),
            a1.model(), ref.pr[None, 0:2], ref.prd[None, 0:2],
            torch.tensor([P_START[0:2]], dtype=f64, device=device),
            pobs[None], dtype=f64,
            backend="fused" if device.type == "cuda" else "xla",
            device=device)
    rec = torch.stack(recs, 1)[0].cpu().numpy()           # (ticks, 3)
    com = res.com_hist[0].reshape(-1, 3).cpu().numpy()
    return rec[:, 0], rec[:, 1], rec[:, 2], com


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_domains", type=int, nargs="?", default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_clf_loop: no CUDA card; pass --device cpu",
              file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    clf_cfg = LowLevelConfig(use_clf=True)
    v, dv, ok, com = run(clf_cfg, args.n_domains, device)
    _, _, ok0, com0 = run(LowLevelConfig(), args.n_domains, device)
    margin = dv + v / clf_cfg.clf_eps
    viol = margin > 1e-6
    with open(ROOT / "docs" / "CLF_LOOP.json") as f:
        record = json.load(f)
    dist = np.abs(com - com0).max(1)
    out = {
        "n_domains": args.n_domains,
        "ticks": int(v.size),
        "ll_qp_converged_frac_clf": float(ok.mean()),
        "ll_qp_converged_frac_noclf": float(ok0.mean()),
        "V": {"mean": float(v.mean()), "p95": float(np.percentile(v, 95)),
              "max": float(v.max())},
        "dV_neg_frac": float((dv < 0).mean()),
        "decrease_condition_viol_frac": float(viol.mean()),
        "decrease_condition_viol_ticks": [int(i) for i in
                                          np.nonzero(viol)[0]],
        "decrease_margin_p95": float(np.percentile(margin, 95)),
        "com_final_z": float(com[-1, 2]),
        "com_dist_vs_noclf_max": float(dist.max()),
        "com_dist_vs_noclf_max_by_domain": [
            float(d.max()) for d in dist.reshape(args.n_domains, -1)],
        "clf_eps": clf_cfg.clf_eps,
        "clf_pen": clf_cfg.clf_pen,
        "record": {k: record[k] for k in (
            "ticks", "decrease_condition_viol_frac", "dV_neg_frac",
            "com_dist_vs_noclf_max", "ll_qp_converged_frac_clf",
            "ll_qp_converged_frac_noclf")},
        "loop": ("closedloop.run_batch, 1 lane, float64, backend "
                 + ("fused" if device.type == "cuda" else "xla")),
        "wall_s": time.perf_counter() - t0,
        "device": card_name() if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
    }
    print(json.dumps(out, indent=1))
    if args.n_domains == 6:
        name = "CLF_LOOP_TORCH" + ("" if device.type == "cuda" else "_CPU")
        path = ROOT / "docs" / f"{name}.json"
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
