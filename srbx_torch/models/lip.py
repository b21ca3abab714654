"""Linear inverted pendulum (LIP) template model: the NMPC's prediction model.

State x = (px, vx, py, vy), input u = COP (ux, uy). The matrices are numpy
constants, as in the JAX package's `srbx/models/lip.py`; they are restated
here because that module imports jax.
"""

from __future__ import annotations

import functools

import numpy as np

from srbx_torch.config import LipConfig


@functools.lru_cache(maxsize=None)
def continuous(cfg: LipConfig):
    """Continuous (A, B) as numpy constants.

    A = [[0,1,0,0],[g/h,0,0,0],[0,0,0,1],[0,0,g/h,0]], B couples COP with
    -g/h.
    """
    w2 = cfg.g / cfg.h
    a = np.zeros((4, 4))
    a[0, 1] = 1.0
    a[1, 0] = w2
    a[2, 3] = 1.0
    a[3, 2] = w2
    b = np.zeros((4, 2))
    b[1, 0] = -w2
    b[3, 1] = -w2
    return a, b


@functools.lru_cache(maxsize=None)
def discrete(cfg: LipConfig, order: int = 3):
    """Taylor-`order` discretization (Ad, Bd) as numpy constants:
    Ad = I + A T + (A T)^2/2 + (A T)^3/6,  Bd = A^{-1} (Ad - I) B."""
    a, b = continuous(cfg)
    t = cfg.ts
    ad = np.eye(4)
    term = np.eye(4)
    fact = 1.0
    for k in range(1, order + 1):
        term = term @ a * t
        fact *= k
        ad = ad + term / fact
    bd = np.linalg.solve(a, (ad - np.eye(4)) @ b)
    return ad, bd
