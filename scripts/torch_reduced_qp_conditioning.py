#!/usr/bin/env python3
"""How far rounding moves the reduced low-level QP's solutions, against
the JAX package's own spread on the same inputs.

    JAX_PLATFORMS=cpu python3 scripts/torch_reduced_qp_conditioning.py

On the CPU in float64, from the committed fixture
`tests/data/torch_team_jax.npz` (`tests/test_torch_team.py`), prints one
JSON line per comparison, each a maximum of |a - b| / max(1, |b|):

* the reduced LL QPs (n 25, me 12, mi 45), raw and after 5 Ruiz sweeps:
  the JAX package's "xla" solver against its "fused" one (its own spread),
  the port's fused IPM (plain version) against each, and the port's plain
  solver against itself with h scaled by (1 + 4 eps), per quantity x, y,
  z and s;
* each form of `closedloop._tick_batch` ("xla", "pallas", "fused"; full
  and reduced build) against the JAX package's form, on tau;
* `run_team_batch` in the fixture's two forms against the JAX package's,
  per output.

These are the spreads `tests/test_torch_team.py`'s bounds are set from.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def main() -> int:
    import test_torch_team as tt
    from srbx_torch import agent
    from srbx_torch.config import Gait
    from srbx_torch.models import a1
    from srbx_torch.ops import qp_batch
    from srbx_torch.sim import closedloop

    torch.set_num_threads(1)
    with np.load(tt.FIXTURE) as f:
        fx = dict(f)
    eps = torch.finfo(torch.float64).eps
    for name, cfg in (("raw", tt.QP), ("ruiz", tt.RUIZ)):
        data = [tt._t(fx[f"qp.{k}"]) for k in "PcAbGh"]
        port = qp_batch.solve(*data, cfg, backend="fused")
        moved = qp_batch.solve(*data[:5], data[5] * (1.0 + 4.0 * eps), cfg,
                               backend="fused")
        for q in "xyzs":
            jx, jf = fx[f"qp.{name}.xla.{q}"], fx[f"qp.{name}.fused.{q}"]
            print(json.dumps({
                "what": "reduced LL QP", "config": name, "quantity": q,
                "jax_xla_vs_jax_fused": _rel(jx, jf),
                "port_vs_jax_xla": _rel(getattr(port, q), jx),
                "port_vs_jax_fused": _rel(getattr(port, q), jf),
                "port_h_4ulp": _rel(getattr(moved, q), getattr(port, q))}))

    st = tt.unflatten(fx, "trot.state", agent.AgentState, tt.SUB, tt._t)
    q, qd, force = (tt._t(fx[f"trot.{k}"]) for k in ("q", "qd", "force"))
    for backend, build in tt.TICK_FORMS:
        with qp_batch.full_f32_products():
            ll_out, _, _ = closedloop._tick_batch(
                tt.LL, tt.MOTION, tt.QP, a1.model(), Gait.TROT, st, q, qd,
                force, backend, allow_contact_trigger=False,
                reduced=build == "reduced")
        print(json.dumps({
            "what": "tick", "backend": backend, "build": build,
            "tau_port_vs_jax": _rel(ll_out.tau,
                                    fx[f"tick.{backend}.{build}.out.tau"]),
            "tau_jax_xla_vs_jax_fused": _rel(
                fx[f"tick.xla.{build}.out.tau"],
                fx[f"tick.fused.{build}.out.tau"])}))

    for form in tt.TEAM_FORMS:
        kw = tt.team_kwargs(form)
        sims, com_ends, margins, llok = closedloop.run_team_batch(
            *kw["cfgs"], tt.SIM, tt.LOOP, a1.model(),
            *(fx[f"team.{k}"] for k in ("pr", "prd", "a0", "pobs")),
            backend=kw["backend"], ll_reduced=True,
            ll_qp_cfg=kw["ll_qp_cfg"], device="cpu")
        print(json.dumps({
            "what": "run_team_batch", "form": form,
            **{k: _rel(v, fx[f"team.{form}.{k}"]) for k, v in (
                ("q", sims.q), ("qd", sims.qd), ("com_ends", com_ends),
                ("margins", margins), ("llok", llok))}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
