"""Sequential convex programming for the discrete-CBF NMPC, over lanes.

Counterpart of `srbx/sqp.py`. Per horizon knot k the NLP adds the
discrete-CBF constraint (x_k - ox)^2 + (y_k - oy)^2 + slack >= eps for
every active circle, linearised at the current iterate (`_cbf_rows`), and
the velocity saturation |dx_k|, |dy_k| <= vel_sat (`_vel_rows`). `solve`
runs cfg.sqp_iters full-step SCP rounds from the plain-QP warm start, each
subproblem solved by the dense per-problem IPM (`srbx_torch.ops.qp.solve`);
`solve_penalty` is the penalty-method alternative. Both take a leading
lane axis of independent problems, each lane with the semantics `jax.vmap`
of the JAX function gives it. The batched NMPC cycle
(`srbx_torch.mpc_batch`) builds the same rows for its own SCP stage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from srbx_torch.config import MpcConfig, QpConfig
from srbx_torch.ocp import OcpData, condense_rows, contract, expand
from srbx_torch.ops import qp


class SqpResult(NamedTuple):
    x: torch.Tensor           # (B, n) final decision vectors
    converged: torch.Tensor   # (B,) last subproblem's convergence flag
    qp_iters: torch.Tensor    # (B,) int32 last subproblem's IPM iterations


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


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def solve(cfg: MpcConfig, qp_cfg: QpConfig, data: OcpData, x_init, circles,
          circle_mask, full_data: OcpData = None, e_mat=None, e0=None,
          contact_ind=None) -> SqpResult:
    """Run the SCP loop from the plain-QP warm starts x_init (B, n_full).

    circles (B, n_circ, 2), circle_mask (B, n_circ). When (e_mat, e0) are
    given, `data` is the condensed QP (`ocp.condense`) and full_data the
    full-space one: the CBF and velocity rows are built in full space
    around the full-space iterate, projected onto the condensed space, and
    each subproblem is solved in condensed coordinates, warm from the
    iterate contracted with contact_ind. With cfg.sqp_linesearch a lane
    takes the full step unless it worsens the exact-penalty merit against
    the current iterate, and then the best of the ladder t in (1, 0.5,
    0.25, 0). A lane whose step is not finite keeps its iterate."""
    condensed = e_mat is not None
    row_src = full_data if condensed else data
    dtype, device = data.P.dtype, data.P.device
    bsz = x_init.shape[0]
    vel_g, vel_h = _vel_rows(cfg, dtype, device)
    vel_g = vel_g.expand(bsz, -1, -1)
    vel_h = vel_h.expand(bsz, -1)
    x = x_init
    conv = torch.zeros(bsz, dtype=torch.bool, device=device)
    iters = torch.zeros(bsz, dtype=torch.int32, device=device)
    for _ in range(cfg.sqp_iters):
        cbf_g, cbf_h = _cbf_rows(cfg, x, circles, circle_mask, dtype)
        if condensed:
            ng, nh = condense_rows(torch.cat([vel_g, cbf_g], 1),
                                   torch.cat([vel_h, cbf_h], 1), e_mat, e0)
            g_ext = torch.cat([data.G, ng], 1)
            h_ext = torch.cat([data.h, nh], 1)
            x0_s = contract(cfg, x, contact_ind)
        else:
            g_ext = torch.cat([row_src.G, vel_g, cbf_g], 1)
            h_ext = torch.cat([row_src.h, vel_h, cbf_h], 1)
            x0_s = x
        sol = qp.solve(data.P, data.c, data.A, data.b, g_ext, h_ext, qp_cfg,
                       x0=x0_s)
        x_sol = expand(e_mat, e0, sol.x) if condensed else sol.x
        if cfg.sqp_linesearch:
            f_p, f_c = ((full_data.P, full_data.c) if condensed
                        else (data.P, data.c))
            ts = torch.tensor([1.0, 0.5, 0.25, 0.0], dtype=dtype,
                              device=device)
            cand = x[:, None, :] + ts[:, None] * (x_sol - x)[:, None, :]

            def merit(xc):                      # (B, n) -> (B,)
                f = 0.5 * (xc * _mv(f_p, xc)).sum(-1) + (f_c * xc).sum(-1)
                marg = cbf_margins(cfg, xc, circles)
                viol = (torch.clamp(cfg.cbf_eps - marg, min=0.0)
                        * circle_mask[:, :, None]).sum((1, 2))
                vv = torch.clamp(_mv(vel_g, xc) - vel_h, min=0.0).sum(-1)
                return f + cfg.merit_mu * (viol + vv)

            merits = torch.stack([merit(cand[:, j]) for j in range(4)], 1)
            # the full step unless it worsens the merit against the current
            # iterate (t = 0) by more than solver noise
            m_full, m_cur = merits[:, 0], merits[:, -1]
            slack = 1e-6 * torch.clamp(m_cur.abs(), min=1.0)
            best = cand[torch.arange(bsz, device=device), merits.argmin(1)]
            x_sol = torch.where((m_full <= m_cur + slack)[:, None], x_sol,
                                best)
        x = torch.where(torch.isfinite(x_sol).all(-1, keepdim=True), x_sol, x)
        conv, iters = sol.converged, sol.iters
    return SqpResult(x, conv, iters)


def solve_penalty(cfg: MpcConfig, qp_cfg: QpConfig, data: OcpData, x_init,
                  circles, circle_mask, mu: float = 1e6,
                  eps: float = 1.0) -> SqpResult:
    """Penalty-method alternative to the hard-constraint SCP (the
    reference's `AugCost` term): per knot and active circle the cost gains
    mu/2 max(0, eps - d_k)^2, d_k the distance of the knot's COM from the
    circle's centre. Each of cfg.sqp_iters rounds folds a Gauss-Newton
    model of the penalty at the current iterate into (P, c) and re-solves
    the QP, with no extra rows, warm from the iterate; a lane whose step
    is not finite keeps its iterate. x_init (B, n), circles (B, n_circ, 2),
    circle_mask (B, n_circ)."""
    dtype, device = data.P.dtype, data.P.device
    n, N = cfg.num_dec, cfg.horizon
    xi, yi = _knot_xy_indices(cfg, device)
    oh_x = F.one_hot(xi, n).to(dtype)                   # (N, n)
    oh_y = F.one_hot(yi, n).to(dtype)
    bsz, n_circ = circles.shape[:2]
    x = x_init
    conv = torch.zeros(bsz, dtype=torch.bool, device=device)
    iters = torch.zeros(bsz, dtype=torch.int32, device=device)
    for _ in range(cfg.sqp_iters):
        dx = x[:, None, xi] - circles[:, :, 0:1]          # (B, n_circ, N)
        dy = x[:, None, yi] - circles[:, :, 1:2]
        d = torch.sqrt(dx * dx + dy * dy + 1e-12)
        act = (d < eps).to(dtype) * circle_mask[:, :, None]
        ux, uy = dx / d, dy / d
        # J row per (circle, knot): -[ux, uy] on (x_k, y_k); residual
        # r = max(0, eps - d); grad = mu J'r, H = mu J'J
        r = act * (eps - d)
        jrows = ((-ux * act)[..., None] * oh_x
                 + (-uy * act)[..., None] * oh_y)          # (B, n_circ, N, n)
        jflat = jrows.reshape(bsz, n_circ * N, n)
        grad = mu * _mv(jflat.mT, r.reshape(bsz, -1))
        hess = mu * (jflat.mT @ jflat)
        p_aug = data.P + hess
        c_aug = data.c + grad - _mv(hess, x)
        sol = qp.solve(p_aug, c_aug, data.A, data.b, data.G, data.h, qp_cfg,
                       x0=x)
        x = torch.where(torch.isfinite(sol.x).all(-1, keepdim=True), sol.x, x)
        conv, iters = sol.converged, sol.iters
    return SqpResult(x, conv, iters)
