"""Ruiz equilibration of batched QP data.

Counterpart of `srbx/ops/qp.py::ruiz_equilibrate`, over a leading lane axis
where the JAX package vmaps the single-QP function. Only the equilibration is
ported: the batched IPM (`srbx_torch.ops.qp_batch`) is the port's solver.
"""

from __future__ import annotations

import torch


def ruiz_equilibrate(P, c, A, G, h, b, iters: int, clip: float = 0.0):
    """Ruiz equilibration per lane (OSQP-style, for the two-block constraint
    layout): P (B, n, n), c (B, n), A (B, me, n), G (B, mi, n), h (B, mi),
    b (B, me).

    Returns the scaled (P, c, A, b, G, h) and the scalings (d (B, n),
    e (B, me), f (B, mi), kappa (B,)) with x = d x_hat,
    y = e y_hat / kappa, z = f z_hat / kappa, s = s_hat / f. Each of `iters`
    rounds drives the inf-norms of the columns of [P; A; G] and of the rows
    of A and G toward 1 (all-zero rows keep scale 1; me >= 1), then scales
    the cost by 1 / max(mean column norm of P, |c|_inf). clip > 0 bounds
    every cumulative factor to [1/clip, clip].
    """
    dtype, device = P.dtype, P.device
    bsz, n = c.shape
    d = torch.ones(bsz, n, dtype=dtype, device=device)
    e = torch.ones(bsz, A.shape[-2], dtype=dtype, device=device)
    f = torch.ones(bsz, G.shape[-2], dtype=dtype, device=device)
    kappa = torch.ones(bsz, dtype=dtype, device=device)
    eps = torch.tensor(1e-8, dtype=dtype, device=device)

    def inv_sqrt_rows(m):
        row = m.abs().amax(-1)
        return torch.where(row > 0, 1.0 / torch.sqrt(torch.maximum(row, eps)),
                           torch.ones_like(row))

    for _ in range(iters):
        col = torch.maximum(P.abs().amax(-2), torch.maximum(
            A.abs().amax(-2), G.abs().amax(-2)))
        dd = 1.0 / torch.sqrt(torch.maximum(col, eps))
        ee = inv_sqrt_rows(A)
        ff = inv_sqrt_rows(G)
        if clip > 0:
            dd = (d * dd).clamp(1.0 / clip, clip) / d
            ee = (e * ee).clamp(1.0 / clip, clip) / e
            ff = (f * ff).clamp(1.0 / clip, clip) / f

        P = dd[:, :, None] * P * dd[:, None, :]
        A = ee[:, :, None] * A * dd[:, None, :]
        G = ff[:, :, None] * G * dd[:, None, :]
        c = dd * c
        b = ee * b
        h = ff * h
        d, e, f = d * dd, e * ee, f * ff

        cost_norm = torch.maximum(P.abs().amax(-2).mean(-1), c.abs().amax(-1))
        kk = 1.0 / torch.maximum(cost_norm, eps)
        P = kk[:, None, None] * P
        c = kk[:, None] * c
        kappa = kappa * kk

    return (P, c, A, b, G, h), (d, e, f, kappa)
