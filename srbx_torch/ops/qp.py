"""Dense primal-dual interior-point QP solver, per problem.

Counterpart of `srbx/ops/qp.py`. Solves

    min 1/2 x'Px + c'x   s.t.  Ax = b,  Gx <= h

with a Mehrotra predictor-corrector method on the condensed, regularized
KKT system [P + G'WG + dI, A'; A, -dI], factored by two dense Cholesky
factorizations (the Schur complement). The JAX function takes one problem
and its callers vmap it; here every operand carries a leading axis of
independent problems (lanes), and each lane keeps the semantics `jax.vmap`
of the JAX function gives it:

* each lane stops at its own exit test (converged, or a non-finite step)
  or at cfg.max_iters, and returns its own `iters`; a lane that has stopped
  is frozen, as in a vmapped `while_loop`. The loop tests the exit once an
  iteration with one host read (`bool(active.any())`), so a call runs as
  many iterations as its slowest lane and no more;
* the step-length sentinel is inf, the residual scales drop the equality
  terms when me = 0, and `converged` is recomputed from the final iterate;
* with cfg.ruiz_iters the data are equilibrated with cfg.ruiz_clip
  (`ruiz_equilibrate`), x0 is scaled by 1/d and the solution unscaled.

The factorizations are `torch.linalg.cholesky_ex` on the symmetrized
matrix, NaN where a lane's matrix does not factor (as `jnp.linalg.cholesky`
gives), and triangular solves; matrix products run in full float32 (no
TF32), as the JAX package asks with `default_matmul_precision("highest")`.
No kernel: the JAX function reaches no Pallas kernel either. The batched,
step-fused IPM of the loops is `srbx_torch.ops.qp_batch`.

Padding conventions: inert inequality rows are (g = 0, h = 1) and inert
equality rows (a = 0, b = 0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from srbx_torch.config import QpConfig
from srbx_torch.ops.qp_batch import full_f32_products, make_backend


class QpSolution(NamedTuple):
    x: torch.Tensor          # (B, n) primal solution
    y: torch.Tensor          # (B, me) equality multipliers
    z: torch.Tensor          # (B, mi) inequality multipliers
    s: torch.Tensor          # (B, mi) inequality slacks
    iters: torch.Tensor      # (B,) int32 iterations each lane took
    converged: torch.Tensor  # (B,) bool
    res: torch.Tensor        # (B,) final max relative KKT residual
    gap: torch.Tensor        # (B,) final duality measure s'z / mi


def qp_objective(P, c, x):
    """1/2 x'Px + c'x per lane: P (B, n, n), c and x (B, n) -> (B,)."""
    return 0.5 * (x * _mv(P, x)).sum(-1) + (c * x).sum(-1)


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def _mtv(m, v):
    return (m.mT @ v[..., None])[..., 0]


# the lower Cholesky factor of the symmetrized matrix, NaN on the lanes
# where it does not factor (jnp.linalg.cholesky's convention), and the
# solve of (L L') x = rhs for rhs (B, k) or (B, k, m)
_cholesky, _chol_solve = make_backend("xla")


class _Kkt(NamedTuple):
    l_m: torch.Tensor        # (B, n, n) Cholesky of M = P + G'WG + dI
    l_s: torch.Tensor        # (B, me, me) Cholesky of S = A M^-1 A' + dI
    minv_at: torch.Tensor    # (B, n, me) M^-1 A'


def _kkt_factor(P, A, G, w, delta_p, delta_d):
    """Factor the condensed, regularized KKT system for weights w = z/s."""
    n, me = P.shape[-1], A.shape[-2]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    m_mat = P + (G * w[..., None]).mT @ G + delta_p * eye
    l_m = _cholesky(m_mat)
    minv_at = _chol_solve(l_m, A.mT)
    s_mat = A @ minv_at + delta_d * torch.eye(me, dtype=P.dtype,
                                              device=P.device)
    return _Kkt(l_m, _cholesky(s_mat), minv_at)


def _kkt_solve(kkt: _Kkt, A, r1, r2):
    """Solve M dx + A'dy = r1, A dx - d dy = r2 (d folded into S)."""
    t = _chol_solve(kkt.l_m, r1)
    dy = _chol_solve(kkt.l_s, _mv(A, t) - r2)
    return t - _mv(kkt.minv_at, dy), dy


def _kkt_solve_refined(kkt: _Kkt, P, A, G, w, r1, r2, iters: int):
    """_kkt_solve and `iters` rounds of iterative refinement against the
    unregularized KKT operator [P + G'WG, A'; A, 0]: the static shifts bias
    every Newton direction, refinement removes the bias without a new
    factorization."""
    dx, dy = _kkt_solve(kkt, A, r1, r2)
    for _ in range(iters):
        t1 = r1 - (_mv(P, dx) + _mtv(G, w * _mv(G, dx)) + _mtv(A, dy))
        t2 = r2 - _mv(A, dx)
        ddx, ddy = _kkt_solve(kkt, A, t1, t2)
        dx = dx + ddx
        dy = dy + ddy
    return dx, dy


def _step_to_boundary(v, dv):
    """Per lane, the largest alpha in (0, 1] with v + alpha dv >= 0
    (v > 0)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(ratio.amin(-1), max=1.0)


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


def solve(P, c, A, b, G, h, cfg: QpConfig = QpConfig(),
          x0: Optional[torch.Tensor] = None) -> QpSolution:
    """Solve one QP per lane: P (B, n, n), c (B, n), A (B, me, n), b (B, me),
    G (B, mi, n), h (B, mi); x0 (B, n) optionally warm-starts the primal
    iterate (the SQP handoff). Runs on the device of its operands.
    cfg.ruiz_iters > 0 needs me >= 1, as in the JAX package."""
    if cfg.ruiz_iters and A.shape[-2] == 0:
        # as in the JAX package, whose equilibration reduces over A's rows
        raise ValueError("Ruiz equilibration (cfg.ruiz_iters > 0) needs at "
                         "least one equality row")
    with full_f32_products():
        if cfg.ruiz_iters:
            data, (d, e, f, kappa) = ruiz_equilibrate(
                P, c, A, G, h, b, cfg.ruiz_iters, clip=cfg.ruiz_clip)
            sol = _solve_impl(*data, cfg, None if x0 is None else x0 / d)
            return sol._replace(x=sol.x * d, y=sol.y * e / kappa[:, None],
                                z=sol.z * f / kappa[:, None], s=sol.s / f)
        return _solve_impl(P, c, A, b, G, h, cfg, x0)


def _solve_impl(P, c, A, b, G, h, cfg: QpConfig, x0):
    dtype, device = P.dtype, P.device
    bsz, n = c.shape
    me, mi = A.shape[-2], G.shape[-2]

    kkt0 = _kkt_factor(P, A, G, torch.ones(bsz, mi, dtype=dtype,
                                           device=device), 1.0, cfg.reg_dual)
    x, y = _kkt_solve(kkt0, A, -c + _mtv(G, h), b)
    if x0 is not None:
        x = x0
    s_tilde = h - _mv(G, x)
    shift = torch.clamp(-1.5 * s_tilde.amin(-1, keepdim=True), min=0.0) + 1.0
    s = s_tilde + shift
    z = torch.ones(bsz, mi, dtype=dtype, device=device)

    def amax(t):
        return t.abs().amax(-1)

    def residuals(x, y, s, z):
        rx = _mv(P, x) + c + _mtv(A, y) + _mtv(G, z)
        return rx, _mv(A, x) - b, _mv(G, x) + s - h

    def relative_residual(x, y, s, z):
        """The max KKT residual against OSQP-style scales: the dual residual
        against the gradient terms, the primal against the constraint
        terms; the equality terms drop out when me = 0."""
        rx, ry, rz = residuals(x, y, s, z)
        px, gtz, gx = _mv(P, x), _mtv(G, z), _mv(G, x)
        dual = torch.maximum(amax(px), amax(c))
        dual = torch.maximum(dual, amax(gtz))
        prim = torch.maximum(amax(gx), amax(h))
        res_prim = amax(rz)
        if me:
            dual = torch.maximum(dual, amax(_mtv(A, y)))
            prim = torch.maximum(prim, torch.maximum(amax(_mv(A, x)),
                                                     amax(b)))
            res_prim = torch.maximum(amax(ry), res_prim)
        return torch.maximum(amax(rx) / torch.clamp(dual, min=1.0),
                             res_prim / torch.clamp(prim, min=1.0))

    def converged(x, y, s, z, res):
        # the relative duality gap s'z <= abstol (1 + |obj|)
        obj = qp_objective(P, c, x)
        return (res <= cfg.abstol + cfg.reltol) & (
            (s * z).sum(-1) <= cfg.abstol * (1.0 + obj.abs()))

    iters = torch.zeros(bsz, dtype=torch.int32, device=device)
    done = torch.zeros(bsz, dtype=torch.bool, device=device)
    while True:
        active = (iters < cfg.max_iters) & ~done
        if not bool(active.any()):
            break
        rx, ry, rz = residuals(x, y, s, z)
        mu = (s * z).sum(-1) / mi

        w = z / s
        kkt = _kkt_factor(P, A, G, w, cfg.reg_primal, cfg.reg_dual)

        # affine (predictor) direction: s z -> 0
        r_c = -s * z
        r1 = -rx - _mtv(G, r_c / s + w * rz)
        dx_a, _ = _kkt_solve_refined(kkt, P, A, G, w, r1, -ry,
                                     cfg.kkt_refine_iters)
        ds_a = -rz - _mv(G, dx_a)
        dz_a = (r_c - z * ds_a) / s

        alpha_p_a = _step_to_boundary(s, ds_a)[:, None]
        alpha_d_a = _step_to_boundary(z, dz_a)[:, None]
        mu_aff = ((s + alpha_p_a * ds_a) * (z + alpha_d_a * dz_a)).sum(-1) / mi
        sigma = torch.clamp(
            (mu_aff / torch.clamp(mu, min=cfg.sigma_min)) ** 3, 0.0, 1.0)

        # corrector direction, on the same factorization
        r_c2 = (sigma * mu)[:, None] - s * z - ds_a * dz_a
        r1c = -rx - _mtv(G, r_c2 / s + w * rz)
        dx, dy = _kkt_solve_refined(kkt, P, A, G, w, r1c, -ry,
                                    cfg.kkt_refine_iters)
        ds = -rz - _mv(G, dx)
        dz = (r_c2 - z * ds) / s

        alpha_p = (cfg.step_frac * _step_to_boundary(s, ds))[:, None]
        alpha_d = (cfg.step_frac * _step_to_boundary(z, dz))[:, None]
        x_n, s_n = x + alpha_p * dx, s + alpha_p * ds
        y_n, z_n = y + alpha_d * dy, z + alpha_d * dz

        # the NaN guard: a lane whose step is not finite keeps its iterate
        # and stops; a stopped lane keeps its whole carry
        finite = (torch.isfinite(x_n).all(-1) & torch.isfinite(s_n).all(-1)
                  & torch.isfinite(z_n).all(-1))
        keep = (active & finite)[:, None]
        x = torch.where(keep, x_n, x)
        y = torch.where(keep, y_n, y)
        s = torch.where(keep, s_n, s)
        z = torch.where(keep, z_n, z)
        conv = converged(x, y, s, z, relative_residual(x, y, s, z))
        done = torch.where(active, conv | ~finite, done)
        iters = iters + active.to(torch.int32)

    res = relative_residual(x, y, s, z)
    return QpSolution(x, y, z, s, iters, converged(x, y, s, z, res), res,
                      (s * z).sum(-1) / mi)


def solve_batch(P, c, A, b, G, h, cfg: QpConfig = QpConfig()) -> QpSolution:
    """The JAX package's vmap of `solve` over a leading batch axis: here
    `solve` itself, whose operands carry that axis."""
    return solve(P, c, A, b, G, h, cfg)

