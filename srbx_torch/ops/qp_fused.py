"""Fused interior-point QP solve on lanes-last operands (kernel K1a).

`solve_lanes_last` solves, for every lane b of a batch,

    min 1/2 x'P x + c'x   s.t.  G x <= h

by the Mehrotra predictor-corrector IPM of the JAX package's fused Pallas
kernel (`srbx/ops/qp_fused.py::_make_kernel` with `noeq=True`, entered
through its `solve_lanes_last`). Operands are lanes-last: P (n, n, B),
c (n, B), G (mi, n, B), h (mi, B), x0 (n, B).

Two implementations with one semantics:

* `solve_lanes_last_plain`: plain PyTorch, vectorised over the lane axis.
  The wrapper takes it for CPU tensors; it is also the reference that the
  CUDA kernel is checked against on the card.
* `srbx_torch/csrc/qp_fused.cu`: the hand-written CUDA kernel, one thread
  per lane, built for sm_90a by `srbx_torch.ops._build`. The wrapper
  launches it for CUDA tensors, or raises.

What bounds the kernel on an H100, and what its design does about it, is
noted at the top of the CUDA source: G is re-read from device memory about
eight times an iteration and is far larger than the L2 at the main path's
batch, so the first version streams it coalesced (lane-contiguous) and keeps
every per-lane quantity in registers or local memory.

Per-lane early exit: the kernel stops a lane when it is done; the TPU kernel
stops a 512-lane tile when all its lanes are done and freezes done lanes
until then. x, z and s agree; stat[3] holds the lane's own iteration count
here and the tile's on the TPU, so only its maximum over lanes compares.
"""

from __future__ import annotations

import torch

from srbx_torch.config import QpConfig

N_COND = 13          # the condensed NMPC QP's size, the kernel's template N
MAX_MI = 64          # the kernel's per-lane row capacity (kMaxMi)
STAT_ROWS = 8        # res, gap/mi, converged, iterations, 4 zero rows


def _mv(m, v):
    """Lanes-last matvec: (p, q, B) x (q, B) -> (p, B)."""
    return (m * v[None]).sum(1)


def _mtv(m, v):
    """Lanes-last transposed matvec: (p, q, B) x (p, B) -> (q, B)."""
    return (m * v[:, None]).sum(0)


def _cholesky_(a):
    """In-place lower Cholesky of a (k, k, B) tensor, diagonal stored as
    1/L_jj (the consumers multiply instead of dividing). Only the lower
    triangle is read."""
    k = a.shape[0]
    for j in range(k):
        di = 1.0 / torch.sqrt(a[j, j])
        a[j, j] = di
        if j + 1 < k:
            t = a[j + 1:, j] * di
            a[j + 1:, j] = t
            a[j + 1:, j + 1:] -= t[:, None] * t[None]


def _cho_solve(l, b):
    """Solve (L L') x = b for b (k, B), L from `_cholesky_`."""
    b = b.clone()
    k = l.shape[0]
    for j in range(k):
        yj = b[j] * l[j, j]
        b[j] = yj
        if j + 1 < k:
            b[j + 1:] -= l[j + 1:, j] * yj
    for j in range(k - 1, -1, -1):
        xj = b[j] * l[j, j]
        b[j] = xj
        if j > 0:
            b[:j] -= l[j, :j] * xj
    return b


def _step_len(v, dv, big):
    """Per-lane largest step in (0, 1] with v + a dv >= 0."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), big)
    return torch.minimum(ratio.amin(0), torch.ones_like(ratio[0]))


def solve_lanes_last_plain(P, c, G, h, cfg: QpConfig = QpConfig(), x0=None):
    """Plain PyTorch form of the fused IPM; same layout and outputs as
    `solve_lanes_last`, any n and mi, any device."""
    n, bsz = c.shape
    mi = G.shape[0]
    dtype = c.dtype
    big = torch.finfo(dtype).max / 4.0
    eye = torch.eye(n, dtype=dtype, device=c.device)[:, :, None]

    def factor(w, delta):
        m = P + delta * eye + torch.einsum("ikb,ilb->klb", G * w[:, None], G)
        _cholesky_(m)
        return m

    def kkt_solve_refined(l, r1, w):
        dx = _cho_solve(l, r1)
        for _ in range(cfg.kkt_refine_iters):
            mx = _mv(P, dx) + _mtv(G, w * _mv(G, dx))
            dx = dx + _cho_solve(l, r1 - mx)
        return dx

    def conv_test(x, s, z):
        px = _mv(P, x)
        gx = _mv(G, x)
        gtz = _mtv(G, z)
        rx = px + c + gtz
        rz = gx + s - h
        dual = torch.maximum(
            torch.maximum(px.abs().amax(0), c.abs().amax(0)),
            gtz.abs().amax(0),
        )
        prim = torch.maximum(gx.abs().amax(0), h.abs().amax(0))
        res = torch.maximum(
            rx.abs().amax(0) / dual.clamp(min=1.0),
            rz.abs().amax(0) / prim.clamp(min=1.0),
        )
        obj = 0.5 * (x * px).sum(0) + (c * x).sum(0)
        gap = (s * z).sum(0)
        conv = (res <= cfg.abstol + cfg.reltol) & (
            gap <= cfg.abstol * (1.0 + obj.abs())
        )
        return rx, rz, res, gap, conv

    # ---------------------------- start ---------------------------- #
    if x0 is not None:
        x = x0.clone()
    else:
        l0 = factor(torch.ones_like(h), 1.0)
        x = _cho_solve(l0, -c + _mtv(G, h))
    s = h - _mv(G, x)
    shift = torch.clamp(-1.5 * s.amin(0), min=0.0) + 1.0
    s = s + shift
    z = torch.ones_like(h)
    rx, rz, _, _, _ = conv_test(x, s, z)
    done = torch.zeros(bsz, dtype=torch.bool, device=c.device)
    iters = torch.zeros(bsz, dtype=dtype, device=c.device)

    # -------------------------- iterations -------------------------- #
    for _ in range(cfg.max_iters):
        if bool(done.all()):
            break
        iters = iters + (~done).to(dtype)
        mu = (s * z).sum(0) / mi
        s_inv = 1.0 / s
        w = z * s_inv
        l = factor(w, cfg.reg_primal)

        r_c = -s * z
        r1 = -rx - _mtv(G, r_c * s_inv + w * rz)
        dx_a = kkt_solve_refined(l, r1, w)
        ds_a = -rz - _mv(G, dx_a)
        dz_a = (r_c - z * ds_a) * s_inv
        ap_a = _step_len(s, ds_a, big)
        ad_a = _step_len(z, dz_a, big)
        mu_aff = ((s + ap_a * ds_a) * (z + ad_a * dz_a)).sum(0) / mi
        ratio = mu_aff / mu.clamp(min=cfg.sigma_min)
        sigma = torch.clamp(ratio * (ratio * ratio), 0.0, 1.0)

        r_c2 = sigma * mu - s * z - ds_a * dz_a
        r1c = -rx - _mtv(G, r_c2 * s_inv + w * rz)
        dx = kkt_solve_refined(l, r1c, w)
        ds = -rz - _mv(G, dx)
        dz = (r_c2 - z * ds) * s_inv
        ap = cfg.step_frac * _step_len(s, ds, big)
        ad = cfg.step_frac * _step_len(z, dz, big)

        x_n = x + ap * dx
        s_n = s + ap * ds
        z_n = z + ad * dz
        finite = (
            torch.isfinite(x_n).all(0)
            & torch.isfinite(s_n).all(0)
            & torch.isfinite(z_n).all(0)
        )
        keep = finite & ~done
        x = torch.where(keep, x_n, x)
        s = torch.where(keep, s_n, s)
        z = torch.where(keep, z_n, z)
        rx, rz, _, _, conv = conv_test(x, s, z)
        done = done | conv | ~finite

    # --------------------------- epilogue --------------------------- #
    _, _, res, gap, conv = conv_test(x, s, z)
    stat = torch.zeros((STAT_ROWS, bsz), dtype=dtype, device=c.device)
    stat[0] = res
    stat[1] = gap / mi
    stat[2] = conv.to(dtype)
    stat[3] = iters
    return x, z, s, stat


def _check(P, c, G, h, x0):
    if c.dim() != 2:
        raise ValueError(f"c must be (n, B), got {tuple(c.shape)}")
    n, bsz = c.shape
    if n != N_COND:
        raise ValueError(f"the fused kernel is built for n={N_COND}, got {n}")
    if G.dim() != 3:
        raise ValueError(f"G must be (mi, n, B), got {tuple(G.shape)}")
    mi = G.shape[0]
    if not 1 <= mi <= MAX_MI:
        raise ValueError(f"mi must be in [1, {MAX_MI}], got {mi}")
    shapes = {"P": (n, n, bsz), "G": (mi, n, bsz), "h": (mi, bsz)}
    if x0 is not None:
        shapes["x0"] = (n, bsz)
    named = {"P": P, "G": G, "h": h, "x0": x0}
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(named[name].shape)}")
    if c.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {c.dtype}")
    for name, t in [("P", P), ("c", c), ("G", G), ("h", h), ("x0", x0)]:
        if t is None:
            continue
        if t.dtype != c.dtype:
            raise TypeError(f"{name} is {t.dtype}, c is {c.dtype}")
        if t.device != c.device:
            raise ValueError(f"{name} is on {t.device}, c on {c.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def solve_lanes_last(P, c, G, h, cfg: QpConfig = QpConfig(), x0=None):
    """Inequality-only fused IPM on lanes-last operands.

    P (13, 13, B), c (13, B), G (mi, 13, B) with mi <= 64, h (mi, B),
    optional warm start x0 (13, B); all contiguous, one dtype (float32 or
    float64), one device. Returns (x (13, B), z (mi, B), s (mi, B),
    stat (8, B)) with stat rows res, gap/mi, converged, iterations.

    CPU tensors go to `solve_lanes_last_plain`. CUDA tensors launch the CUDA
    kernel, which adds one to `solve_lanes_last.launches`; any failure
    raises. Unlike the TPU entry, any B is accepted.
    """
    _check(P, c, G, h, x0)
    if c.device.type == "cpu":
        return solve_lanes_last_plain(P, c, G, h, cfg, x0)
    if c.device.type != "cuda":
        raise ValueError(f"no fused IPM for device {c.device}")

    from srbx_torch.ops import _build

    lib = _build.load()
    n, bsz = c.shape
    mi = G.shape[0]
    x = torch.empty((n, bsz), dtype=c.dtype, device=c.device)
    z = torch.empty((mi, bsz), dtype=c.dtype, device=c.device)
    s = torch.empty((mi, bsz), dtype=c.dtype, device=c.device)
    stat = torch.empty((STAT_ROWS, bsz), dtype=c.dtype, device=c.device)
    entry = (lib.srbx_qp_fused_noeq_f32 if c.dtype == torch.float32
             else lib.srbx_qp_fused_noeq_f64)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = entry(
            P.data_ptr(), c.data_ptr(), G.data_ptr(), h.data_ptr(),
            None if x0 is None else x0.data_ptr(),
            x.data_ptr(), z.data_ptr(), s.data_ptr(), stat.data_ptr(),
            bsz, mi, cfg.abstol, cfg.reltol, cfg.reg_primal, cfg.reg_dual,
            cfg.sigma_min, cfg.step_frac, cfg.max_iters, cfg.kkt_refine_iters,
            int(x0 is not None), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused IPM kernel launch failed: CUDA error {err} "
            f"(B={bsz}, mi={mi}, {c.dtype})")
    solve_lanes_last.launches += 1
    return x, z, s, stat


solve_lanes_last.launches = 0
