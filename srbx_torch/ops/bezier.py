"""The per-domain COM Bezier fit, batched over leading axes.

Counterpart of `fit_domain_bezier` in `srbx/ops/bezier.py`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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
