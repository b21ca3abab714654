"""Bezier curves, cubic Hermite segments and the per-domain COM fit,
batched over leading axes.

Counterpart of `srbx/ops/bezier.py`, same conventions: `bezier(alpha, s)`
evaluates the Bernstein polynomial of degree `alpha.shape[-1] - 1` at phase
s in [0, 1], and derivatives are taken with respect to s (callers scale by
1/T for time derivatives).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _powers(base, count: int):
    """[base^0, ..., base^count] along a new trailing axis, by cumulative
    products (exact at the endpoints, unlike pow(0, 0) through exp/log).
    base (..., 1)."""
    tiled = base.expand(base.shape[:-1] + (count,))
    return torch.cumprod(torch.cat([torch.ones_like(base), tiled], -1), -1)


@functools.lru_cache(maxsize=None)
def _binomials(degree: int, dtype, device):
    return torch.tensor([math.comb(degree, k) for k in range(degree + 1)],
                        dtype=dtype, device=device)


def _bernstein_basis(degree: int, s):
    """[C(M,j) s^j (1-s)^(M-j)]_{j=0..M} on a new trailing axis."""
    if not s.is_floating_point():
        s = s.to(torch.get_default_dtype())
    s = s[..., None]
    coef = _binomials(degree, s.dtype, s.device)
    return coef * _powers(s, degree) * _powers(1.0 - s, degree).flip(-1)


def bezier(alpha, s):
    """Evaluate a Bezier curve. alpha (..., M+1); s broadcastable to
    alpha[..., 0]."""
    degree = alpha.shape[-1] - 1
    return (alpha * _bernstein_basis(degree, s)).sum(-1)


def bezier_d(alpha, s):
    """dC/ds, forward-difference form."""
    degree = alpha.shape[-1] - 1
    d_alpha = degree * (alpha[..., 1:] - alpha[..., :-1])
    return (d_alpha * _bernstein_basis(degree - 1, s)).sum(-1)


def bezier_dd(alpha, s):
    """d2C/ds2."""
    degree = alpha.shape[-1] - 1
    dd_alpha = degree * (degree - 1) * (
        alpha[..., 2:] - 2.0 * alpha[..., 1:-1] + alpha[..., :-2])
    return (dd_alpha * _bernstein_basis(degree - 2, s)).sum(-1)


def varying_bezier(alpha, d_alpha, dd_alpha, s, dt):
    """Time-varying Bezier (pos, vel, acc): the control points themselves
    move with velocity `d_alpha` and acceleration `dd_alpha`."""
    pos = bezier(alpha, s)
    vel = bezier_d(alpha, s) / dt + bezier(d_alpha, s)
    acc = (bezier_dd(alpha, s) / (dt * dt) + 2.0 * bezier_d(d_alpha, s) / dt
           + bezier(dd_alpha, s))
    return pos, vel, acc


def _interp_matrix_inv(degree: int) -> np.ndarray:
    """Inverse of the Bernstein collocation matrix at uniform knots,
    B[i, j] = C(M,j) s_i^j (1-s_i)^(M-j), s_i = i/M. The constrained
    least-squares fit of a degree-M Bezier to M+1 knots reduces exactly to
    this interpolation."""
    s = np.linspace(0.0, 1.0, degree + 1)
    j = np.arange(degree + 1)
    coef = np.asarray([math.comb(degree, int(k)) for k in range(degree + 1)])
    b = coef * s[:, None] ** j * (1.0 - s[:, None]) ** (degree - j)
    return np.linalg.inv(b)


_BINV4 = _interp_matrix_inv(4)


def fit_domain_bezier(knots):
    """Degree-4 Bezier control points through 5 knots per channel.

    knots: (..., C, 5) values at s = 0, 1/4, 1/2, 3/4, 1 (the previous
    cycle's terminal state, then the 4 MPC knots). Returns (..., C, 5).
    """
    binv = torch.as_tensor(_BINV4, dtype=knots.dtype, device=knots.device)
    return torch.einsum("...ci,ji->...cj", knots, binv)


def cubic(t, t0, tf, p0, pf, v0, vf):
    """Cubic Hermite interpolation: the position at time t."""
    tau = torch.clamp((t - t0) / (tf - t0), 0.0, 1.0)
    h00 = 2 * tau**3 - 3 * tau**2 + 1
    h10 = tau**3 - 2 * tau**2 + tau
    h01 = -2 * tau**3 + 3 * tau**2
    h11 = tau**3 - tau**2
    dt = tf - t0
    return h00 * p0 + h10 * dt * v0 + h01 * pf + h11 * dt * vf


def cubic_dot(t, t0, tf, p0, pf, v0, vf):
    tau = torch.clamp((t - t0) / (tf - t0), 0.0, 1.0)
    dt = tf - t0
    dh00 = (6 * tau**2 - 6 * tau) / dt
    dh10 = (3 * tau**2 - 4 * tau + 1) / dt
    dh01 = (-6 * tau**2 + 6 * tau) / dt
    dh11 = (3 * tau**2 - 2 * tau) / dt
    return dh00 * p0 + dh10 * dt * v0 + dh01 * pf + dh11 * dt * vf


def cubic_dot_dot(t, t0, tf, p0, pf, v0, vf):
    tau = torch.clamp((t - t0) / (tf - t0), 0.0, 1.0)
    dt = tf - t0
    d2h00 = (12 * tau - 6) / (dt * dt)
    d2h10 = (6 * tau - 4) / (dt * dt)
    d2h01 = (-12 * tau + 6) / (dt * dt)
    d2h11 = (6 * tau - 2) / (dt * dt)
    return d2h00 * p0 + d2h10 * dt * v0 + d2h01 * pf + d2h11 * dt * vf
