"""LL ticks/s of estimation in the loop on the card, before and after one
torch.profiler run in the same process.

    python3 scripts/torch_est_rates.py          # from the repository root
    TEARDOWN_CUPTI=1 python3 scripts/torch_est_rates.py

Runs `chip_smoke.run_est` (run_batch with estimation in the loop at the
est_loop phase's configuration, B = 4096, float32) over 100 stand and 60
trot ticks twice, profiles a short run with `chip_smoke.device_profile`,
runs the loop twice more, and prints one dict: the environment's
TEARDOWN_CUPTI, the rates before and after, and the profile's seconds.
Builds the kernels first (about 80 s). Needs one CUDA card.
"""

import os
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from srbx_torch import refplan  # noqa: E402
from srbx_torch.config import (LowLevelConfig, MotionConfig,  # noqa: E402
                               MpcConfig, QpConfig)
from srbx_torch.models import a1  # noqa: E402
from srbx_torch.ops import _build  # noqa: E402
from srbx_torch.sim import closedloop, wholebody as wb  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_est_rates: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build()
    _build.load()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bsz = torch.float32, cs.WB_BATCH
    p_start = np.array([0.0, 0.5, 0.0, -0.5])
    a0 = p_start[:2] + np.linspace(0.0, 0.01, bsz)[:, None] * np.array(
        [1.0, 0.0])
    pobs = np.full((bsz, 2, 20), 100.0)
    ref = refplan.generate(
        refplan.two_agent_config(loop_size=4_000),
        torch.tensor(p_start, dtype=f32, device=dev),
        torch.tensor(pobs[0], dtype=f32, device=dev), dtype=f32, device=dev)
    w = types.SimpleNamespace(
        model=a1.model(), ll_cfg=LowLevelConfig(), motion_cfg=MotionConfig(),
        sim_cfg=wb.SimConfig(),
        mpc=MpcConfig(use_sqp=True, sqp_iters=1, condensed=True,
                      elide_box_rows=True, elide_simplex=True),
        relaxed=QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                         reg_dual=1e-6, max_iters=12), dev=dev,
        lanes=cs.loop_lanes(dev, ref.pr[0:2].expand(bsz, -1, -1),
                            ref.prd[0:2].expand(bsz, -1, -1), a0, pobs))
    loop = closedloop.LoopConfig(100, 1, 60)
    ticks = loop.stand_ticks + loop.ticks_per_domain
    cs.run_est(w, f32, bsz, closedloop.LoopConfig(2, 1, 2))     # warm-up

    def rate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.run_est(w, f32, bsz, loop)
        torch.cuda.synchronize()
        return bsz * ticks / (time.perf_counter() - t0)

    before = [rate(), rate()]
    t0 = time.perf_counter()
    cs.device_profile(lambda: cs.run_est(w, f32, bsz,
                                         closedloop.LoopConfig(2, 1, 3)))
    profile_s = time.perf_counter() - t0
    after = [rate(), rate()]
    print({"TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
           "before": before, "after": after, "profile_s": profile_s},
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
