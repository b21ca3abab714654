"""Batched small SPD solves and inverses (kernels K2a and K2b).

Counterpart of `srbx/ops/spd.py`. Per lane, D = L L' by Cholesky, then
(L L') X = B by forward and back substitution:

* `solve(d, rhs)`: D X = rhs for d (B, k, k) and rhs (B, k) or (B, k, r).
  The TPU kernel is `srbx/ops/spd.py::_solve_kernel`; on the whole-body
  path it solves D qdd = rhs in each physics substep (k = 18, r = 1).
* `inverse(d)`: D^-1 for d (B, k, k), with the identity as right-hand side.
  The TPU kernel is `_inv_kernel`; on the whole-body path it inverts the
  18x18 mass matrix for the low-level QP build and the 12x12 swing
  operational-space matrix.

The arithmetic is the TPU kernel's: column j divides by sqrt(a_jj)
(diagonal included, so L_jj = a_jj / sqrt(a_jj)) and the substitutions
divide by L_jj. Operands are batch-leading, as at the JAX package's API.

Two implementations with one semantics:

* `solve_plain` / `inverse_plain`: plain PyTorch, the Cholesky loop written
  out over a leading lane axis. The wrappers take them for CPU tensors;
  they are the reference the CUDA kernels are checked against on the card.
* `srbx_torch/csrc/spd.cu`: hand-written CUDA kernels, one launch per
  call. Each lane is served by one group of threads (a warp; a half-warp up
  to k 16) that factors D with its rows in registers, hands L to shared
  memory and substitutes with x in registers: one row a thread for one
  right-hand side, one column of X a thread for several or for the
  identity, which starts in registers and is never read from memory. The
  routines are K3's (`csrc/lane_chol.cuh`). What bounds the kernels at the
  whole-body path's B = 4096 is each lane's chain of dependent column
  steps, not bytes: a launch is one wave. The wrappers launch them for CUDA
  tensors, or raise.

Both are bitwise equal: the kernels round every product and difference
(no fused multiply-add) and update each entry in the plain loop's order.

The JAX package's `backend`, `tile` and `interpret` are not taken. `tile`
and `interpret` are the TPU kernel's; `backend` picks between that kernel
("pallas") and jax.scipy's Cholesky ("xla", its default), a library path:
in the port the kernel is the only route on the card.
Each wrapper counts its launches in a plain integer attribute
(`solve.launches`, `inverse.launches`).
"""

from __future__ import annotations

import ctypes

import torch

MAX_K = 32           # the kernels' largest k
MAX_R = 32           # solve's largest number of right-hand sides
# what a launch_geometry query reports, here and in pallas_linalg
GEOMETRY_FIELDS = ("threads_per_lane", "lanes_per_block", "smem_bytes",
                   "row_capacity", "blocks_per_sm", "grid")


def _cholesky_(a):
    """In-place lower Cholesky of (B, k, k), as the TPU kernel does it:
    column j is divided by sqrt(a_jj), its own diagonal entry included.
    Only the lower triangle is meaningful afterwards."""
    k = a.shape[-1]
    for j in range(k):
        d = torch.sqrt(a[:, j, j])
        col = a[:, j:, j] / d[:, None]
        a[:, j:, j] = col
        if j + 1 < k:
            tail = col[:, 1:]
            a[:, j + 1:, j + 1:] -= tail[:, :, None] * tail[:, None, :]


def _substitute_(l, b):
    """In-place (L L') X = B on b (B, k, r) with L from `_cholesky_`."""
    k = l.shape[-1]
    for j in range(k):
        yj = b[:, j, :] / l[:, j, j, None]
        b[:, j, :] = yj
        if j + 1 < k:
            b[:, j + 1:, :] -= l[:, j + 1:, j, None] * yj[:, None, :]
    for j in range(k - 1, -1, -1):
        xj = b[:, j, :] / l[:, j, j, None]
        b[:, j, :] = xj
        if j > 0:
            b[:, :j, :] -= l[:, j, :j, None] * xj[:, None, :]


def solve_plain(d, rhs):
    """Plain PyTorch form of `solve`: any k, r and device."""
    single = rhs.dim() == 2
    l = d.clone()
    _cholesky_(l)
    x = (rhs[:, :, None] if single else rhs).clone()
    _substitute_(l, x)
    return x[:, :, 0] if single else x


def inverse_plain(d):
    """Plain PyTorch form of `inverse`: any k and device."""
    l = d.clone()
    _cholesky_(l)
    x = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device).repeat(
        d.shape[0], 1, 1)
    _substitute_(l, x)
    return x


def launch_geometry(dtype, k, r=0, batch=1):
    """How the CUDA kernel lays out a launch of the solve at (k, r), or with
    r = 0 of the inverse, for `batch` lanes in `dtype`, as the kernel's
    source reports it: a dict of `GEOMETRY_FIELDS`."""
    from srbx_torch.ops import _build

    out = (ctypes.c_int * len(GEOMETRY_FIELDS))()
    err = _build.load().srbx_spd_launch_geometry(
        int(dtype == torch.float64), k, r, batch, out)
    if err != 0:
        raise ValueError(f"no K2 launch for k {k}, r {r}, batch {batch}: "
                         f"CUDA error {err}")
    return dict(zip(GEOMETRY_FIELDS, out))


def _check(d, rhs=None):
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"d must be (B, k, k), got {tuple(d.shape)}")
    bsz, k = d.shape[0], d.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {d.dtype}")
    named = [("d", d)]
    if rhs is not None:
        if rhs.dim() not in (2, 3) or tuple(rhs.shape[:2]) != (bsz, k):
            raise ValueError(f"rhs must be ({bsz}, {k}) or ({bsz}, {k}, r), "
                             f"got {tuple(rhs.shape)}")
        r = 1 if rhs.dim() == 2 else rhs.shape[2]
        if not 1 <= r <= MAX_R:
            raise ValueError(f"r must be in [1, {MAX_R}], got {r}")
        named.append(("rhs", rhs))
    for name, t in named:
        if t.dtype != d.dtype:
            raise TypeError(f"{name} is {t.dtype}, d is {d.dtype}")
        if t.device != d.device:
            raise ValueError(f"{name} is on {t.device}, d on {d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SPD kernel for device {d.device}")


def _launch(entry, *args):
    from srbx_torch.ops import _build

    lib = _build.load()
    fn = getattr(lib, entry)
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"(shape {tuple(args[0].shape)}, {args[0].dtype})")


def solve(d, rhs):
    """D X = rhs for SPD D, batched: d (B, k, k), rhs (B, k) or (B, k, r),
    k <= 32, r <= 32, one dtype (float32 or float64), contiguous. Returns X
    with rhs's shape.

    CPU tensors go to `solve_plain`. CUDA tensors launch the CUDA kernel
    (K2a), which adds one to `solve.launches`; any failure raises. The JAX
    package's backend, tile and interpret are not taken (module
    docstring)."""
    _check(d, rhs)
    if d.device.type == "cpu":
        return solve_plain(d, rhs)
    bsz, k = d.shape[0], d.shape[1]
    r = 1 if rhs.dim() == 2 else rhs.shape[2]
    x = torch.empty_like(rhs)
    suffix = "f32" if d.dtype == torch.float32 else "f64"
    _launch(f"srbx_spd_solve_{suffix}", d, rhs, x, bsz, k, r)
    solve.launches += 1
    return x


def inverse(d):
    """D^-1 for SPD D, batched: d (B, k, k), k <= 32, float32 or float64,
    contiguous.

    CPU tensors go to `inverse_plain`. CUDA tensors launch the CUDA kernel
    (K2b), which adds one to `inverse.launches`; any failure raises. The
    JAX package's backend, tile and interpret are not taken (module
    docstring)."""
    _check(d)
    if d.device.type == "cpu":
        return inverse_plain(d)
    bsz, k = d.shape[0], d.shape[1]
    x = torch.empty_like(d)
    suffix = "f32" if d.dtype == torch.float32 else "f64"
    _launch(f"srbx_spd_inverse_{suffix}", d, x, bsz, k)
    inverse.launches += 1
    return x


solve.launches = 0
inverse.launches = 0
