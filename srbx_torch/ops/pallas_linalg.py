"""Batched small Cholesky factorization and Cholesky solve (kernels K3a, K3b).

Counterpart of `srbx/ops/pallas_linalg.py`. Per lane, M = L L' by the
right-looking column loop (column j divided by sqrt(m_jj), its diagonal entry
included; the strict upper triangle of L exactly zero), and (L L') X = R by
forward then back substitution, each step dividing by L_jj. The square root is
not guarded: a lane whose M is not positive definite comes out non-finite, in
that lane only.

Two layouts:

* `cholesky(m)` and `cho_solve(l, rhs)` take the JAX package's lanes-last
  operands, (k, k, B) and (k, r, B), for any B (no `tile`, no padding);
* `batch_cholesky(m)` and `batch_cho_solve(l, rhs)` take batch-leading
  (B, k, k) and (B, k, r): the layout the batched IPM's products leave
  (`srbx_torch.ops.qp_batch` with backend="pallas"), so it pays no relayout.

Two implementations with one semantics:

* `batch_cholesky_plain` / `batch_cho_solve_plain`: plain PyTorch, the TPU
  kernels' column loops over a leading lane axis. The wrappers take them for
  CPU tensors; they are the reference the CUDA kernels are checked against
  on the card.
* `srbx_torch/csrc/pallas_linalg.cu`: hand-written CUDA kernels that keep a
  lane's rows or right-hand sides in registers, bitwise the plain loops'
  arithmetic. K3a gives each thread of a lane's group balanced rows of the
  triangle and broadcasts each finished column through a small shared
  buffer; K3b gives each thread entries x_i at r = 1 (one shuffle a step)
  and a column of X at r > 1, with L in shared memory. A block's groups
  loop over lanes, each lane's operands copied in once with cp.async. The
  wrappers launch them for CUDA tensors, or raise; `launch_geometry`
  reports how a launch is laid out.

The batch-leading wrappers count their launches in a plain integer attribute
(`batch_cholesky.launches`, `batch_cho_solve.launches`); the lanes-last
wrappers launch through them.
"""

from __future__ import annotations

import ctypes

import torch

from srbx_torch.ops.spd import (GEOMETRY_FIELDS, _cholesky_, _launch,
                                 _substitute_)

MAX_K = 64           # the kernels' largest k
MAX_R = 64           # and largest number of right-hand sides


def batch_cholesky_plain(m):
    """Plain PyTorch form of `batch_cholesky`: any k and device."""
    l = m.clone()
    _cholesky_(l)
    return torch.tril(l)


def batch_cho_solve_plain(l, rhs):
    """Plain PyTorch form of `batch_cho_solve`: any k, r and device."""
    x = rhs.clone()
    _substitute_(l, x)
    return x


def launch_geometry(dtype, k, r=0, batch=1):
    """How the CUDA kernels lay out a launch of K3a (r = 0) or K3b at (k, r)
    for `batch` lanes in `dtype`, as the kernels' source reports it: a dict
    of `GEOMETRY_FIELDS` (shared bytes per block, blocks resident per SM
    from the occupancy calculator, blocks in the grid)."""
    from srbx_torch.ops import _build

    out = (ctypes.c_int * len(GEOMETRY_FIELDS))()
    err = _build.load().srbx_pallas_launch_geometry(
        int(dtype == torch.float64), k, r, batch, out)
    if err != 0:
        raise ValueError(f"no K3 launch for k {k}, r {r}, batch {batch}: "
                         f"CUDA error {err}")
    return dict(zip(GEOMETRY_FIELDS, out))


def _check(m, rhs=None):
    if m.dim() != 3 or m.shape[1] != m.shape[2]:
        raise ValueError(f"the matrix must be (B, k, k), got {tuple(m.shape)}")
    bsz, k = m.shape[0], m.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if m.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {m.dtype}")
    named = [("matrix", m)]
    if rhs is not None:
        if rhs.dim() != 3 or tuple(rhs.shape[:2]) != (bsz, k):
            raise ValueError(f"rhs must be ({bsz}, {k}, r), "
                             f"got {tuple(rhs.shape)}")
        if not 1 <= rhs.shape[2] <= MAX_R:
            raise ValueError(f"r must be in [1, {MAX_R}], got {rhs.shape[2]}")
        named.append(("rhs", rhs))
    for name, t in named:
        if t.dtype != m.dtype:
            raise TypeError(f"{name} is {t.dtype}, the matrix {m.dtype}")
        if t.device != m.device:
            raise ValueError(f"{name} is on {t.device}, the matrix on "
                             f"{m.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if m.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Cholesky kernel for device {m.device}")


def _suffix(t):
    return "f32" if t.dtype == torch.float32 else "f64"


def batch_cholesky(m):
    """Lower Cholesky factors, batched: m (B, k, k) with k <= 64, float32
    or float64, contiguous; only its lower triangle is used. Returns L
    (B, k, k) with the strict upper triangle zero.

    CPU tensors go to `batch_cholesky_plain`. CUDA tensors launch the CUDA
    kernel (K3a), which adds one to `batch_cholesky.launches`; any failure
    raises."""
    _check(m)
    if m.device.type == "cpu":
        return batch_cholesky_plain(m)
    out = torch.empty_like(m)
    _launch(f"srbx_pallas_cholesky_{_suffix(m)}", m, out, m.shape[0],
            m.shape[1])
    batch_cholesky.launches += 1
    return out


def batch_cho_solve(l, rhs):
    """(L L') X = rhs, batched: l (B, k, k) from `batch_cholesky`, rhs
    (B, k, r) with r <= 64; one dtype, contiguous. Returns X (B, k, r).

    CPU tensors go to `batch_cho_solve_plain`. CUDA tensors launch the CUDA
    kernel (K3b), which adds one to `batch_cho_solve.launches`; any failure
    raises."""
    _check(l, rhs)
    if l.device.type == "cpu":
        return batch_cho_solve_plain(l, rhs)
    out = torch.empty_like(rhs)
    _launch(f"srbx_pallas_cho_solve_{_suffix(l)}", l, rhs, out, l.shape[0],
            l.shape[1], rhs.shape[2])
    batch_cho_solve.launches += 1
    return out


def cholesky(m):
    """The JAX package's `cholesky` without `tile` and `interpret`: m
    (k, k, B) SPD per lane -> lower L (k, k, B), any B."""
    return batch_cholesky(m.permute(2, 0, 1).contiguous()).permute(
        1, 2, 0).contiguous()


def cho_solve(l, rhs):
    """The JAX package's `cho_solve` without `tile` and `interpret`: solve
    (L L') X = RHS for l (k, k, B), rhs (k, r, B) -> (k, r, B), any B."""
    return batch_cho_solve(l.permute(2, 0, 1).contiguous(),
                           rhs.permute(2, 0, 1).contiguous()).permute(
        1, 2, 0).contiguous()


batch_cholesky.launches = 0
batch_cho_solve.launches = 0
