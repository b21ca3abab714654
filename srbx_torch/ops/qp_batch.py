"""Batched QP solve: the counterpart of `srbx/ops/qp_batch.py`.

`solve(P, c, A, b, G, h, cfg, backend, x0)` solves, per lane,
    min 1/2 x'Px + c'x   s.t.  Ax = b,  Gx <= h
with operands batch-leading (B, ...). Backends:

* "pallas" and "xla": the step-fused Mehrotra predictor-corrector IPM
  written over the lane axis (`_solve_impl`). The dense products are batched
  einsums in full float32 (no TF32); the factorizations and substitutions are
  the backend's:
  - "pallas": the Cholesky and Cholesky-solve kernels K3a and K3b
    (`srbx_torch.ops.pallas_linalg`) on batch-leading operands; their plain
    PyTorch versions for CPU tensors;
  - "xla": `torch.linalg.cholesky_ex` and `solve_triangular`, with the
    lanes that fail to factor set to NaN, as `jnp.linalg.cholesky` does.
  The loop exits when every lane is done, which costs one host
  synchronisation per iteration; `iters` is the number executed and each
  lane's x, y, z and s are frozen once it is done.
* "fused": the general fused IPM (`srbx_torch.ops.qp_fused.solve`, kernel
  K1b on the card; built for (n, me) = (43, 30) and (25, 12), the full
  and the reduced low-level QP, with mi <= 64, and (41, 28) and (17, 4),
  the NMPC's uncondensed and condensed QP, with mi <= 128). Without
  equality rows (me = 0) it runs the inequality-only kernel K1a (n 13,
  mi <= 128), as the JAX package does.
* "lanes" (the JAX package's pure-JAX unrolled kernels) is left out of the
  port and raises.

Inequality-only problems (me = 0) are solved on the step-fused backends, and
under Ruiz equilibration on every backend, with one inert 0 = 0 equality row,
which the dual regularization keeps at dy = 0 (on "fused" that row makes
(n, 1), which K1b is not built for: it raises). With cfg.ruiz_iters the data
are equilibrated first (`srbx_torch.ops.qp.ruiz_equilibrate`) and the solution
is unscaled; as in the JAX package, cfg.ruiz_clip is not passed on (reference
fault F7 in ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import NamedTuple, Optional

import torch

from srbx_torch.config import QpConfig

_log = logging.getLogger(__name__)


class BatchSolution(NamedTuple):
    x: torch.Tensor          # (B, n)
    y: torch.Tensor          # (B, me)
    z: torch.Tensor          # (B, mi)
    s: torch.Tensor          # (B, mi)
    iters: torch.Tensor      # () iterations executed (max over lanes)
    converged: torch.Tensor  # (B,)
    res: torch.Tensor        # (B,)
    gap: torch.Tensor        # (B,)
    # each lane's own iteration count (the fused kernels; the TPU kernel
    # counts per tile); None from the step-fused backends
    lane_iters: Optional[torch.Tensor] = None   # (B,)


def make_backend(backend: str = "xla"):
    """Factorization backend "xla" or "pallas": (chol, cho_solve) with
    chol (B, k, k) -> factor and cho_solve(factor, rhs) for rhs (B, k, r) or
    (B, k)."""
    if backend == "xla":

        def chol(m):
            # jnp.linalg.cholesky symmetrizes its input and returns NaN where
            # the factorization fails; torch.linalg.cholesky would raise
            l, info = torch.linalg.cholesky_ex(0.5 * (m + m.mT))
            return torch.where((info > 0)[:, None, None], torch.nan, l)

        def solve_factored(l, rhs):
            t = torch.linalg.solve_triangular(l, rhs, upper=False)
            return torch.linalg.solve_triangular(l.mT, t, upper=True)

    elif backend == "pallas":
        from srbx_torch.ops import pallas_linalg

        def chol(m):
            return pallas_linalg.batch_cholesky(m.contiguous())

        def solve_factored(l, rhs):
            return pallas_linalg.batch_cho_solve(l, rhs.contiguous())

    elif backend == "lanes":
        raise NotImplementedError(
            "the pure-JAX 'lanes' backend is left out of srbx_torch "
            "(ROADMAP.md); use 'pallas' or 'xla'")
    else:
        raise ValueError(f"unknown backend {backend!r}")

    def cho_solve(l, rhs):
        if rhs.dim() == 2:
            return solve_factored(l, rhs[:, :, None])[:, :, 0]
        return solve_factored(l, rhs)

    return chol, cho_solve


def _factor(P, A, At, G, w, delta_p, delta_d, chol, cho_solve):
    n = P.shape[-1]
    me = A.shape[-2]
    gw = G * w[..., None]                                   # (B, mi, n)
    m_mat = P + torch.einsum("bin,bim->bnm", gw, G)
    m_mat = m_mat + delta_p * torch.eye(n, dtype=P.dtype, device=P.device)
    l_m = chol(m_mat)
    minv_at = cho_solve(l_m, At)                            # (B, n, me)
    s_mat = A @ minv_at + delta_d * torch.eye(me, dtype=P.dtype,
                                              device=P.device)
    l_s = chol(s_mat)
    return l_m, l_s, minv_at


def _solve_kkt(l_m, l_s, minv_at, A, r1, r2, cho_solve):
    t = cho_solve(l_m, r1)
    dy = cho_solve(l_s, torch.einsum("bmn,bn->bm", A, t) - r2)
    dx = t - torch.einsum("bnm,bm->bn", minv_at, dy)
    return dx, dy


def _solve_kkt_refined(l_m, l_s, minv_at, P, A, G, w, r1, r2, cho_solve,
                       iters: int):
    """_solve_kkt and `iters` rounds of iterative refinement against the
    unregularized operator [P + G'WG  A'; A  0]."""
    dx, dy = _solve_kkt(l_m, l_s, minv_at, A, r1, r2, cho_solve)
    for _ in range(iters):
        gdx = torch.einsum("bmn,bn->bm", G, dx)
        t1 = r1 - (torch.einsum("bnm,bm->bn", P, dx)
                   + torch.einsum("bmn,bm->bn", G, w * gdx)
                   + torch.einsum("bmn,bm->bn", A, dy))
        t2 = r2 - torch.einsum("bmn,bn->bm", A, dx)
        ddx, ddy = _solve_kkt(l_m, l_s, minv_at, A, t1, t2, cho_solve)
        dx = dx + ddx
        dy = dy + ddy
    return dx, dy


def _step_len(v, dv):
    """Largest step in (0, 1] keeping v + step dv >= 0, per lane; the
    sentinel for rows that do not bind is inf (as in the JAX package's
    qp_batch; its fused kernel uses finfo.max / 4: fault F4)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.minimum(ratio.amin(-1), torch.ones_like(v[:, 0]))


@contextlib.contextmanager
def full_f32_products():
    """Full float32 matrix products (no TF32) inside, the caller's setting
    again after; also a function decorator. The JAX package measured
    reduced-precision products stalling the IPM (82 % of lanes converged
    against 100 %, srbx/ops/qp_batch.py)."""
    precision = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def solve(P, c, A, b, G, h, cfg: QpConfig = QpConfig(),
          backend: str = "xla", x0=None) -> BatchSolution:
    """All operands batch-leading (B, ...); x0 optionally warm-starts the
    primal iterate (the SQP handoff). The JAX signature without the TPU-only
    `tile` and `interpret`, and its default backend, "xla"; backend="fused"
    runs kernel K1b."""
    if A.shape[-2] == 0 and (cfg.ruiz_iters or backend != "fused"):
        # the step-fused backends and the equilibration need me >= 1: an
        # inert 0 = 0 row, kept at dy = 0 by the dual regularization
        bsz, n = c.shape
        sol = solve(P, c, c.new_zeros(bsz, 1, n), c.new_zeros(bsz, 1), G, h,
                    cfg, backend=backend, x0=x0)
        return sol._replace(y=sol.y[:, :0])
    if cfg.ruiz_iters:
        from srbx_torch.ops import qp

        if cfg.ruiz_clip > 0:
            # Mirrors the JAX package, whose batched solve does not pass
            # ruiz_clip on (reference fault F7 in ROADMAP.md).
            _log.warning("ruiz_clip=%g is ignored by the batched QP solve "
                         "(reference fault F7)", cfg.ruiz_clip)
        data, (d, e, f, kappa) = qp.ruiz_equilibrate(P, c, A, G, h, b,
                                                     cfg.ruiz_iters)
        sol = solve(*data, dataclasses.replace(cfg, ruiz_iters=0),
                    backend=backend, x0=None if x0 is None else x0 / d)
        return sol._replace(x=sol.x * d, y=sol.y * e / kappa[:, None],
                            z=sol.z * f / kappa[:, None], s=sol.s / f)
    if backend == "fused":
        from srbx_torch.ops import qp_fused

        # the kernel reads each lane's operands as one contiguous run (a
        # no-op for operands that are so already, as the LL build's are)
        return qp_fused.solve(
            *(t.contiguous() for t in (P, c, A, b, G, h)), cfg,
            x0=None if x0 is None else x0.contiguous())
    with full_f32_products():
        return _solve_impl(P, c, A, b, G, h, cfg, backend, x0)


def _solve_impl(P, c, A, b, G, h, cfg: QpConfig, backend, x0):
    dtype, device = P.dtype, P.device
    bsz, n = c.shape
    mi = G.shape[-2]
    chol, cho_solve = make_backend(backend)
    At = A.mT.contiguous()

    def mv(m, v):
        return torch.einsum("bmn,bn->bm", m, v)

    def mtv(m, v):
        return torch.einsum("bmn,bm->bn", m, v)

    def amax(t):
        return t.abs().amax(-1)

    ones_w = torch.ones(bsz, mi, dtype=dtype, device=device)
    l_m, l_s, minv_at = _factor(P, A, At, G, ones_w, 1.0, cfg.reg_dual, chol,
                                cho_solve)
    x, y = _solve_kkt(l_m, l_s, minv_at, A, -c + mtv(G, h), b, cho_solve)
    if x0 is not None:
        x = x0
    s_t = h - mv(G, x)
    shift = torch.clamp(-1.5 * s_t.amin(-1, keepdim=True), min=0.0) + 1.0
    s = s_t + shift
    z = torch.ones(bsz, mi, dtype=dtype, device=device)

    def evaluate(x, y, s, z):
        """Residuals (rx, ry, rz), the relative residual with OSQP-style
        denominators, and the stopping test, per lane."""
        px, aty, gtz = torch.einsum("bnm,bm->bn", P, x), mtv(A, y), mtv(G, z)
        ax, gx = mv(A, x), mv(G, x)
        rx, ry, rz = px + c + aty + gtz, ax - b, gx + s - h
        dual = torch.clamp(torch.maximum(
            torch.maximum(amax(px), amax(c)),
            torch.maximum(amax(aty), amax(gtz))), min=1.0)
        prim = torch.clamp(torch.maximum(
            torch.maximum(amax(ax), amax(b)),
            torch.maximum(amax(gx), amax(h))), min=1.0)
        res = torch.maximum(amax(rx) / dual,
                            torch.maximum(amax(ry), amax(rz)) / prim)
        obj = 0.5 * (x * px).sum(-1) + (c * x).sum(-1)
        conv = (res <= cfg.abstol + cfg.reltol) & (
            (s * z).sum(-1) <= cfg.abstol * (1.0 + obj.abs()))
        return (rx, ry, rz), res, conv

    done = torch.zeros(bsz, dtype=torch.bool, device=device)
    it = 0
    (rx, ry, rz), _, _ = evaluate(x, y, s, z)
    while it < cfg.max_iters and not bool(done.all()):
        mu = (s * z).sum(-1) / mi

        w = z / s
        l_m, l_s, minv_at = _factor(P, A, At, G, w, cfg.reg_primal,
                                    cfg.reg_dual, chol, cho_solve)

        r_c = -s * z
        r1 = -rx - mtv(G, r_c / s + w * rz)
        dx_a, _ = _solve_kkt_refined(l_m, l_s, minv_at, P, A, G, w, r1, -ry,
                                     cho_solve, cfg.kkt_refine_iters)
        ds_a = -rz - mv(G, dx_a)
        dz_a = (r_c - z * ds_a) / s

        ap_a = _step_len(s, ds_a)
        ad_a = _step_len(z, dz_a)
        mu_aff = ((s + ap_a[:, None] * ds_a)
                  * (z + ad_a[:, None] * dz_a)).sum(-1) / mi
        sigma = torch.clamp(
            (mu_aff / torch.clamp(mu, min=cfg.sigma_min)) ** 3, 0.0, 1.0)

        r_c2 = sigma[:, None] * mu[:, None] - s * z - ds_a * dz_a
        r1c = -rx - mtv(G, r_c2 / s + w * rz)
        dx, dy = _solve_kkt_refined(l_m, l_s, minv_at, P, A, G, w, r1c, -ry,
                                    cho_solve, cfg.kkt_refine_iters)
        ds = -rz - mv(G, dx)
        dz = (r_c2 - z * ds) / s

        ap = (cfg.step_frac * _step_len(s, ds))[:, None]
        ad = (cfg.step_frac * _step_len(z, dz))[:, None]
        x_n, s_n = x + ap * dx, s + ap * ds
        y_n, z_n = y + ad * dy, z + ad * dz

        # the NaN freeze: a lane whose step is not finite keeps its iterate
        # and is done; done lanes keep theirs
        finite = (torch.isfinite(x_n).all(-1) & torch.isfinite(s_n).all(-1)
                  & torch.isfinite(z_n).all(-1))
        keep = (finite & ~done)[:, None]
        x = torch.where(keep, x_n, x)
        y = torch.where(keep, y_n, y)
        s = torch.where(keep, s_n, s)
        z = torch.where(keep, z_n, z)

        # the residuals of the new iterate serve its test and, unchanged,
        # the next iteration's directions
        (rx, ry, rz), _, conv = evaluate(x, y, s, z)
        done = done | conv | ~finite
        it += 1

    _, res, converged = evaluate(x, y, s, z)
    return BatchSolution(x, y, z, s,
                         torch.tensor(it, dtype=torch.int32, device=device),
                         converged, res, (s * z).sum(-1) / mi)
