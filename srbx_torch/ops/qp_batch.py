"""Batched QP solve entry: the counterpart of `srbx/ops/qp_batch.py::solve`
on its `backend="fused"` dispatch, which is the one the whole-body loop
takes. The step-fused `xla`, `lanes` and `pallas` backends, Ruiz
equilibration and the inequality-only (me = 0) dispatch are not ported and
raise NotImplementedError (ROADMAP Queue 2 K3, M1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from srbx_torch.config import QpConfig


class BatchSolution(NamedTuple):
    x: torch.Tensor          # (B, n)
    y: torch.Tensor          # (B, me)
    z: torch.Tensor          # (B, mi)
    s: torch.Tensor          # (B, mi)
    iters: torch.Tensor      # () iterations executed (max over lanes)
    converged: torch.Tensor  # (B,)
    res: torch.Tensor        # (B,)
    gap: torch.Tensor        # (B,)
    # each lane's own iteration count (the TPU kernel counts per tile)
    lane_iters: Optional[torch.Tensor] = None   # (B,)


def solve(P, c, A, b, G, h, cfg: QpConfig = QpConfig(),
          backend: str = "fused", x0=None) -> BatchSolution:
    """All operands batch-leading (B, ...); x0 optionally warm-starts the
    primal iterate. backend="fused" runs the general fused IPM
    (`srbx_torch.ops.qp_fused.solve`, kernel K1b on the card)."""
    if backend != "fused" or cfg.ruiz_iters or A.shape[-2] == 0:
        raise NotImplementedError(
            "srbx_torch ports only qp_batch.solve(backend='fused') with "
            "equality rows and ruiz_iters=0; got "
            f"backend={backend!r}, ruiz_iters={cfg.ruiz_iters}, "
            f"me={A.shape[-2]} (ROADMAP Queue 2 K3, M1)")
    from srbx_torch.ops import qp_fused

    return qp_fused.solve(P, c, A, b, G, h, cfg, x0=x0)
