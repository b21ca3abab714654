"""Rows of the CBF sequential-convex-programming stage, batched over lanes.

Counterpart of the row functions in `srbx/sqp.py`. Per horizon knot k the
NLP adds the discrete-CBF constraint (x_k - ox)^2 + (y_k - oy)^2 + slack >=
eps for every active circle, linearised at the current iterate, and the
velocity saturation |dx_k|, |dy_k| <= vel_sat.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from srbx_torch.config import MpcConfig


def _knot_xy_indices(cfg: MpcConfig, device=None):
    ks = torch.arange(cfg.horizon, device=device)
    return 4 * ks, 4 * ks + 2          # x, y positions per knot


def _vel_rows(cfg: MpcConfig, dtype, device=None):
    """Lane-constant two-sided velocity-saturation rows: (16, n), (16,)."""
    ks = torch.arange(cfg.horizon, device=device)
    idx = torch.cat([4 * ks + 1, 4 * ks + 3])
    rows = F.one_hot(idx, cfg.num_dec).to(dtype)
    g = torch.cat([rows, -rows], 0)
    h = torch.full((2 * idx.shape[0],), cfg.vel_sat, dtype=dtype,
                   device=device)
    return g, h


def _cbf_rows(cfg: MpcConfig, x, circles, circle_mask, dtype):
    """Linearised CBF rows at iterates x (B, n).

    circles (B, n_circ, 2) centres; circle_mask (B, n_circ) 0/1. Returns
    G rows (B, n_circ*N, n) and h (B, n_circ*N) with G x <= h equivalent to
    grad_g(x_j) . x >= eps - g(x_j) + grad_g(x_j) . x_j; masked rows are
    inert (0 <= 1).
    """
    n = cfg.num_dec
    bsz, n_circ = circles.shape[:2]
    xi, yi = _knot_xy_indices(cfg, x.device)
    px = x[:, xi]                                       # (B, N)
    py = x[:, yi]
    slack = x[:, -1:, None]                             # (B, 1, 1)

    dx = px[:, None, :] - circles[:, :, 0:1]            # (B, n_circ, N)
    dy = py[:, None, :] - circles[:, :, 1:2]
    g_val = dx * dx + dy * dy + slack

    oh_x = F.one_hot(xi, n).to(dtype)                   # (N, n)
    oh_y = F.one_hot(yi, n).to(dtype)
    oh_s = F.one_hot(torch.tensor(n - 1, device=x.device), n).to(dtype)
    rows = ((-2.0 * dx)[..., None] * oh_x + (-2.0 * dy)[..., None] * oh_y
            - oh_s)
    grad_dot_xj = 2.0 * dx * px[:, None, :] + 2.0 * dy * py[:, None, :] + slack
    rhs = -cfg.cbf_eps + g_val - grad_dot_xj

    rows = rows * circle_mask[:, :, None, None]
    rhs = torch.where(circle_mask[:, :, None] > 0, rhs, 1.0)
    return rows.reshape(bsz, n_circ * cfg.horizon, n), rhs.reshape(bsz, -1)


def cbf_margins(cfg: MpcConfig, x, circles):
    """Squared-distance CBF values per (lane, circle, knot): x (B, n),
    circles (B, n_circ, 2) -> (B, n_circ, N)."""
    xi, yi = _knot_xy_indices(cfg, x.device)
    dx = x[:, None, xi] - circles[:, :, 0:1]
    dy = x[:, None, yi] - circles[:, :, 1:2]
    return dx * dx + dy * dy + x[:, -1:, None]
