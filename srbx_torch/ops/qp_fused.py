"""Fused interior-point QP solves: kernel K1a (inequality rows only,
lanes-last) and kernel K1b (equality and inequality rows, batch-leading).

Both run, per lane, the Mehrotra predictor-corrector IPM of the JAX
package's fused Pallas kernel (`srbx/ops/qp_fused.py::_make_kernel`) for

    min 1/2 x'P x + c'x   s.t.  A x = b,  G x <= h

* `solve_lanes_last` (K1a, `noeq=True`, no A rows): operands lanes-last,
  P (n, n, B), c (n, B), G (mi, n, B), h (mi, B), x0 (n, B); the NMPC
  cycle's path (n 13, mi up to 128). CUDA kernel
  `srbx_torch/csrc/qp_fused.cu`, a half-warp per lane, 16 lanes per block
  (8 above mi 64): the block copies its lanes' operands into shared memory
  once (coalesced over neighbouring lanes), each thread owns rows of G with
  their iterates in registers, and x, z, s and stat are written back once.
* `solve` (K1b, `noeq=False`): operands batch-leading (B, ...), the JAX
  package's `qp_fused.solve`; the whole-body loop's LL QP, full (n 43,
  me 30) or reduced (n 25, me 12), and the NMPC's QP, uncondensed (n 41,
  me 28) or condensed with its simplex rows (n 17, me 4). CUDA kernel
  `srbx_torch/csrc/qp_general.cu`, one instantiation per shape, two warps
  per lane (one lane per block) with the lane's operands and factors in
  shared memory. With no equality rows (me = 0) `solve` runs K1a, as the
  JAX package runs its noeq kernel there.

Beside each kernel, a plain PyTorch version with the same semantics
(`solve_lanes_last_plain`, `solve_plain`, both through `_ipm_plain`). The
wrappers take it for CPU tensors; it is also the reference the kernels are
checked against on the card. For CUDA tensors the wrappers launch the
kernel or raise, and count launches (`solve_lanes_last.launches`,
`solve.launches`).

Per-lane early exit: the kernels stop a lane when it is done; the TPU kernel
stops a 512-lane tile when all its lanes are done and freezes done lanes
until then. x, y, z and s agree; stat[3] holds the lane's own iteration
count here and the tile's on the TPU, so only its maximum over lanes
compares.
"""

from __future__ import annotations

import torch

from srbx_torch.config import QpConfig

N_COND = 13          # the condensed NMPC QP's size, the kernel's template N
MAX_MI = 128         # K1a's per-lane row capacity (kMaxMi)
STAT_ROWS = 8        # res, gap/mi, converged, iterations, 4 zero rows


def resident_warps(dtype, mi, general=False, shape=(43, 30)):
    """Warps of K1a (or of K1b at `shape` = (n, me) with `general`)
    resident on one SM of the card at mi rows, from the CUDA occupancy
    calculator; -1 where no instantiation serves that shape and mi."""
    from srbx_torch.ops import _build

    lib = _build.load()
    f64 = int(dtype == torch.float64)
    if general:
        return lib.srbx_qp_general_resident_warps(f64, *shape, mi)
    return lib.srbx_qp_fused_noeq_resident_warps(f64, mi)


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
    """Solve (L L') X = B for b (k, ..., B), L from `_cholesky_`."""
    b = b.clone()
    k = l.shape[0]
    tail = (1,) * (b.dim() - 2)
    for j in range(k):
        yj = b[j] * l[j, j].view(tail + (-1,))
        b[j] = yj
        if j + 1 < k:
            b[j + 1:] -= l[j + 1:, j].view((k - j - 1,) + tail + (-1,)) * yj
    for j in range(k - 1, -1, -1):
        xj = b[j] * l[j, j].view(tail + (-1,))
        b[j] = xj
        if j > 0:
            b[:j] -= l[j, :j].view((j,) + tail + (-1,)) * xj
    return b


def _step_len(v, dv, big):
    """Per-lane largest step in (0, 1] with v + a dv >= 0."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), big)
    return torch.minimum(ratio.amin(0), torch.ones_like(ratio[0]))


def _ipm_plain(P, c, A, b, G, h, cfg: QpConfig, x0):
    """The fused IPM in plain PyTorch on lanes-last operands: P (n, n, B),
    c (n, B), A (me, n, B) and b (me, B) or both None (the inequality-only
    form, K1a), G (mi, n, B), h (mi, B), x0 (n, B) or None. Returns
    (x, y, z, s, stat), y None without A."""
    n, bsz = c.shape
    mi = G.shape[0]
    noeq = A is None
    dtype = c.dtype
    big = torch.finfo(dtype).max / 4.0
    eye = torch.eye(n, dtype=dtype, device=c.device)[:, :, None]
    if not noeq:
        a_t = A.transpose(0, 1)                        # (n, me, B)
        eye_me = torch.eye(A.shape[0], dtype=dtype, device=c.device)[:, :, None]

    def factor(w, delta):
        """(L_M, M^-1 A', L_S) with M = P + G' diag(w) G + delta I and
        S = A M^-1 A' + reg_dual I, both factored."""
        m = P + delta * eye + torch.einsum("ikb,ilb->klb", G * w[:, None], G)
        _cholesky_(m)
        if noeq:
            return m, None, None
        m_at = _cho_solve(m, a_t)
        s_mat = torch.einsum("rkb,kqb->rqb", A, m_at) + cfg.reg_dual * eye_me
        _cholesky_(s_mat)
        return m, m_at, s_mat

    def kkt_solve(fac, r1, r2):
        """M dx + A' dy = r1, A dx - reg_dual dy = r2."""
        l, m_at, l_s = fac
        t = _cho_solve(l, r1)
        if noeq:
            return t, None
        dy = _cho_solve(l_s, _mv(A, t) - r2)
        return t - _mv(m_at, dy), dy

    def kkt_solve_refined(fac, r1, r2, w):
        dx, dy = kkt_solve(fac, r1, r2)
        for _ in range(cfg.kkt_refine_iters):
            mx = _mv(P, dx) + _mtv(G, w * _mv(G, dx))
            t2 = None
            if not noeq:
                mx = mx + _mtv(A, dy)
                t2 = r2 - _mv(A, dx)
            ddx, ddy = kkt_solve(fac, r1 - mx, t2)
            dx = dx + ddx
            if not noeq:
                dy = dy + ddy
        return dx, dy

    def conv_test(x, y, s, z):
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
        prim_res = rz.abs().amax(0)
        ry = None
        if not noeq:
            aty = _mtv(A, y)
            ax = _mv(A, x)
            rx = rx + aty
            ry = ax - b
            dual = torch.maximum(dual, aty.abs().amax(0))
            prim = torch.maximum(
                prim, torch.maximum(ax.abs().amax(0), b.abs().amax(0)))
            prim_res = torch.maximum(ry.abs().amax(0), prim_res)
        res = torch.maximum(rx.abs().amax(0) / dual.clamp(min=1.0),
                            prim_res / prim.clamp(min=1.0))
        obj = 0.5 * (x * px).sum(0) + (c * x).sum(0)
        gap = (s * z).sum(0)
        conv = (res <= cfg.abstol + cfg.reltol) & (
            gap <= cfg.abstol * (1.0 + obj.abs())
        )
        return rx, ry, rz, res, gap, conv

    # ---------------------------- start ---------------------------- #
    y = None
    if x0 is not None and noeq:
        x = x0.clone()
    else:
        fac = factor(torch.ones_like(h), 1.0)
        x, y = kkt_solve(fac, -c + _mtv(G, h), b)
        if x0 is not None:
            x = x0.clone()
    s = h - _mv(G, x)
    shift = torch.clamp(-1.5 * s.amin(0), min=0.0) + 1.0
    s = s + shift
    z = torch.ones_like(h)
    rx, ry, rz, _, _, _ = conv_test(x, y, s, z)
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
        fac = factor(w, cfg.reg_primal)
        r2 = None if noeq else -ry

        r_c = -s * z
        r1 = -rx - _mtv(G, r_c * s_inv + w * rz)
        dx_a, _ = kkt_solve_refined(fac, r1, r2, w)
        ds_a = -rz - _mv(G, dx_a)
        dz_a = (r_c - z * ds_a) * s_inv
        ap_a = _step_len(s, ds_a, big)
        ad_a = _step_len(z, dz_a, big)
        mu_aff = ((s + ap_a * ds_a) * (z + ad_a * dz_a)).sum(0) / mi
        ratio = mu_aff / mu.clamp(min=cfg.sigma_min)
        sigma = torch.clamp(ratio * (ratio * ratio), 0.0, 1.0)

        r_c2 = sigma * mu - s * z - ds_a * dz_a
        r1c = -rx - _mtv(G, r_c2 * s_inv + w * rz)
        dx, dy = kkt_solve_refined(fac, r1c, r2, w)
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
        if not noeq:
            y = torch.where(keep, y + ad * dy, y)
        s = torch.where(keep, s_n, s)
        z = torch.where(keep, z_n, z)
        rx, ry, rz, _, _, conv = conv_test(x, y, s, z)
        done = done | conv | ~finite

    # --------------------------- epilogue --------------------------- #
    _, _, _, res, gap, conv = conv_test(x, y, s, z)
    stat = torch.zeros((STAT_ROWS, bsz), dtype=dtype, device=c.device)
    stat[0] = res
    stat[1] = gap / mi
    stat[2] = conv.to(dtype)
    stat[3] = iters
    return x, y, z, s, stat


def solve_lanes_last_plain(P, c, G, h, cfg: QpConfig = QpConfig(), x0=None):
    """Plain PyTorch form of `solve_lanes_last`; same layout and outputs,
    any n and mi, any device."""
    x, _, z, s, stat = _ipm_plain(P, c, None, None, G, h, cfg, x0)
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

    P (13, 13, B), c (13, B), G (mi, 13, B) with mi <= 128, h (mi, B),
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


# --------------------------------------------------------------------------- #
# General form (kernel K1b): equality and inequality rows, batch-leading.
# --------------------------------------------------------------------------- #

# the K1b kernel's shapes (n, me) and the most inequality rows each is built
# for: the whole-body low-level QP, full and reduced (one row a thread), and
# the NMPC's QP, uncondensed and condensed with its simplex rows (two rows a
# thread above 64)
GENERAL_SHAPES = {(43, 30): 64, (25, 12): 64, (41, 28): 128, (17, 4): 128}


def _lanes_last(t):
    return None if t is None else t.movedim(0, -1)


def _solution(x, y, z, s, stat):
    """BatchSolution from batch-leading (x, y, z, s) and stat (B, 8)."""
    from srbx_torch.ops.qp_batch import BatchSolution

    return BatchSolution(
        x=x, y=y, z=z, s=s,
        iters=stat[:, 3].max().to(torch.int32),
        converged=stat[:, 2] > 0.5,
        res=stat[:, 0],
        gap=stat[:, 1],
        lane_iters=stat[:, 3],
    )


def _solve_noeq(lanes_last_solve, P, c, G, h, cfg, x0):
    """A batch-leading QP without equality rows through a lanes-last
    inequality-only solve (K1a or its plain version); y (B, 0)."""
    x, z, s, stat = lanes_last_solve(
        *(_lanes_last(t).contiguous() for t in (P, c, G, h)), cfg,
        None if x0 is None else _lanes_last(x0).contiguous())
    return _solution(x.T, c.new_zeros(c.shape[0], 0), z.T, s.T, stat.T)


def solve_plain(P, c, A, b, G, h, cfg: QpConfig = QpConfig(), x0=None):
    """Plain PyTorch form of `solve`: any n, me, mi and device.
    Batch-leading operands, computed lanes-last as the TPU kernel does; with
    me = 0 the inequality-only IPM (K1a's plain version), y (B, 0)."""
    if A.shape[1] == 0:
        return _solve_noeq(solve_lanes_last_plain, P, c, G, h, cfg, x0)
    x, y, z, s, stat = _ipm_plain(
        *(_lanes_last(t) for t in (P, c, A, b, G, h)), cfg, _lanes_last(x0))
    return _solution(x.T, y.T, z.T, s.T, stat.T)


def shapes_built():
    """K1b's (n, me) shapes and row capacities, as text for messages."""
    return ", ".join(f"(n, me) = ({n}, {me}) with mi <= {cap}"
                     for (n, me), cap in GENERAL_SHAPES.items())


def _check_general(P, c, A, b, G, h, x0):
    if c.dim() != 2:
        raise ValueError(f"c must be (B, n), got {tuple(c.shape)}")
    bsz, n = c.shape
    if A.dim() != 3 or G.dim() != 3:
        raise ValueError("A and G must be (B, rows, n)")
    me, mi = A.shape[1], G.shape[1]
    if me == 0 and n != N_COND:
        raise ValueError(
            f"with no equality rows the fused IPM runs the inequality-only "
            f"kernel, built for n={N_COND}; the general one is built for "
            f"{shapes_built()}; got n={n}, me=0")
    if me and (n, me) not in GENERAL_SHAPES:
        raise ValueError(f"the general fused kernel is built for "
                         f"{shapes_built()}, got n={n}, me={me}")
    cap = GENERAL_SHAPES.get((n, me), MAX_MI)
    if not 1 <= mi <= cap:
        raise ValueError(f"mi must be in [1, {cap}] at n={n}, me={me}, "
                         f"got {mi}")
    shapes = {"P": (bsz, n, n), "A": (bsz, me, n), "b": (bsz, me),
              "G": (bsz, mi, n), "h": (bsz, mi)}
    if x0 is not None:
        shapes["x0"] = (bsz, n)
    named = {"P": P, "A": A, "b": b, "G": G, "h": h, "x0": x0}
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(named[name].shape)}")
    if c.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {c.dtype}")
    for name, t in [("c", c)] + list(named.items()):
        if t is None:
            continue
        if t.dtype != c.dtype:
            raise TypeError(f"{name} is {t.dtype}, c is {c.dtype}")
        if t.device != c.device:
            raise ValueError(f"{name} is on {t.device}, c on {c.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused IPM for device {c.device}")


def solve(P, c, A, b, G, h, cfg: QpConfig = QpConfig(), x0=None):
    """General fused IPM (equality and inequality rows) on batch-leading
    operands; the JAX package's `qp_fused.solve` without `tile` and
    `interpret`.

    P (B, n, n), c (B, n), A (B, me, n), b (B, me), G (B, mi, n), h
    (B, mi), optional x0 (B, n); all contiguous, one dtype (float32 or
    float64), one device. (n, me) is one of GENERAL_SHAPES, with mi up to
    its capacity: (43, 30) and (25, 12) with mi <= 64, (41, 28) and (17, 4)
    with mi <= 128. Returns a BatchSolution (with each lane's own iteration
    count in `lane_iters`).

    CPU tensors go to `solve_plain`. CUDA tensors launch the CUDA kernel
    (K1b), which adds one to `solve.launches`; any failure raises. Any B is
    accepted: no padding lanes. With me = 0 (n 13, mi <= 128) the operands
    are moved lanes-last and solved by `solve_lanes_last` (K1a, which counts
    the launch), y (B, 0), as the JAX package's `solve` runs its noeq
    kernel.
    """
    _check_general(P, c, A, b, G, h, x0)
    if A.shape[1] == 0:
        return _solve_noeq(solve_lanes_last, P, c, G, h, cfg, x0)
    if c.device.type == "cpu":
        return solve_plain(P, c, A, b, G, h, cfg, x0)

    from srbx_torch.ops import _build

    lib = _build.load()
    bsz, n = c.shape
    me, mi = A.shape[1], G.shape[1]

    def out(*shape):
        return torch.empty(shape, dtype=c.dtype, device=c.device)

    x, y, z, s, stat = (out(bsz, n), out(bsz, me), out(bsz, mi),
                        out(bsz, mi), out(bsz, STAT_ROWS))
    entry = (lib.srbx_qp_general_f32 if c.dtype == torch.float32
             else lib.srbx_qp_general_f64)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = entry(
            P.data_ptr(), c.data_ptr(), A.data_ptr(), b.data_ptr(),
            G.data_ptr(), h.data_ptr(),
            None if x0 is None else x0.data_ptr(),
            x.data_ptr(), y.data_ptr(), z.data_ptr(), s.data_ptr(),
            stat.data_ptr(), bsz, n, me, mi, cfg.abstol, cfg.reltol,
            cfg.reg_primal, cfg.reg_dual, cfg.sigma_min, cfg.step_frac,
            cfg.max_iters, cfg.kkt_refine_iters, int(x0 is not None), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"general fused IPM kernel launch failed: CUDA error {err} "
            f"(B={bsz}, mi={mi}, {c.dtype})")
    solve.launches += 1
    return _solution(x, y, z, s, stat)


solve.launches = 0
