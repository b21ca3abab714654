"""1 kHz whole-body low-level controller, batched over lanes: virtual
constraints and the QP for torques.

Counterpart of `srbx/lowlevel.py` on the paths of the closed loops:
`virtual_constraints`, `ll_qp_build` (the full 43-variable QP), the swing
operational-space matrix `swing_delta_inv`, `ll_qp_finish`, and the
per-agent `calc_torque` (build, the dense per-problem IPM, finish). Static
padded shapes, variable contact counts by masking, exactly as there:

    decision x = [F (12: 3 per leg) | tau (12) | aux (18) | clf defect]  n 43
    equalities: contact rows (12, masked to stance legs),
                output rows (18, masked to base and swing legs)        me 30
    inequalities: friction pyramids (20, masked), +-tau (24), CLF      mi 45

The reduced build (`ll_qp_build_reduced`) eliminates the 18 aux variables
through the output rows in closed form, which leaves the soft-output cost
aux_pen ||A'x + C||^2 of the reference's alternative formulation:

    decision x = [F (12) | tau (12) | clf defect]                    n 25
    equalities: contact rows (12, masked to stance legs)             me 12
    inequalities: friction pyramids (20, masked), +-tau (24), CLF    mi 45

`expand_reduced_x` maps its solution back to the full layout and
`ll_qp_finish_reduced` finishes it with the full build's post-solve math.

Every argument carries a leading lane axis B. The operands are built
batched with `torch.cat` and products (no per-lane writes); where the JAX
package multiplies by the constant selector B = [0; I12] the port slices,
which gives the same numbers.

With `LowLevelConfig.use_clf` both builds carry the CLF decrease row
(`src/LowLevelCtrl.cpp:171-225`), row 44 of the inequalities: LgV . aux -
delta <= -LfV - (c/eps) V, where V is the closed-form Lyapunov function of
the output error (y, dy) (`_clf_terms`) and delta, the last decision
variable, is penalised by clf_pen; the reduced build substitutes aux =
-(a_out x + c_out). Without it row 44 is inert (0 <= 1) and delta's weight
is 1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from srbx_torch.config import (TOTAL_DOF, LowLevelConfig, MotionConfig,
                               QpConfig)
from srbx_torch.models import a1, rbd
from srbx_torch.ops import bezier as bz

N_DEC = 43
N_EQ = 30
N_INEQ = 45
N_DEC2 = 25          # the reduced build
N_EQ2 = 12
N_INEQ2 = 45


class VcOut(NamedTuple):
    y: torch.Tensor         # (B, 18) outputs (masked rows zero)
    dy: torch.Tensor        # (B, 18)
    h0_mat: torch.Tensor    # (B, 18, 18) output map H0 (masked rows zero)
    dh0: torch.Tensor       # (B, 18) J̇q̇ of the outputs
    hd: torch.Tensor        # (B, 18) desired outputs
    dhd: torch.Tensor       # (B, 18)
    ddhd: torch.Tensor      # (B, 18)
    out_mask: torch.Tensor  # (B, 18) 1 on active output rows


class TrajIn(NamedTuple):
    """Per-domain trajectory data (the motion planner's outputs)."""

    com_des: torch.Tensor      # (B, 12)
    toe_init: torch.Tensor     # (B, 3, 4)
    step_len: torch.Tensor     # (B, 3)
    dom_ticks: torch.Tensor    # (B,)
    toe_offset_z: torch.Tensor  # () ground-contact z offset


class LLOut(NamedTuple):
    tau: torch.Tensor          # (B, 12) joint torques
    grf: torch.Tensor          # (B, 12) QP contact forces (masked 0)
    y: torch.Tensor
    dy: torch.Tensor
    ddq: torch.Tensor          # (B, 18) commanded acceleration
    q_next: torch.Tensor       # (B, 18) integrated joint command
    dq_next: torch.Tensor
    v_lyap: torch.Tensor       # (B,) CLF value (0 when unused)
    dv_lyap: torch.Tensor
    qp_converged: torch.Tensor


class LLQpData(NamedTuple):
    """The LL QP operands, batch-leading."""

    P: torch.Tensor     # (B, 43, 43)
    c: torch.Tensor     # (B, 43)
    A: torch.Tensor     # (B, 30, 43)
    b: torch.Tensor     # (B, 30)
    G: torch.Tensor     # (B, 45, 43)
    h: torch.Tensor     # (B, 45)


class LLCtx(NamedTuple):
    """What the finish stage needs from the build."""

    d_inv: torch.Tensor     # (B, 18, 18)
    b_mat: torch.Tensor     # (B, 18, 12)
    h_bias: torch.Tensor    # (B, 18)
    jc_flat: torch.Tensor   # (B, 12, 18) masked contact Jacobian
    toe_jac: torch.Tensor   # (B, 4, 3, 18)
    toe_pos: torch.Tensor   # (B, 4, 3)
    con: torch.Tensor       # (B, 4)
    v: torch.Tensor         # (B,) CLF terms, zeros without use_clf
    lf_v: torch.Tensor      # (B,)
    lg_v: torch.Tensor      # (B, 18)
    c_eps: torch.Tensor     # (B,)


def virtual_constraints(ll_cfg: LowLevelConfig, motion: MotionConfig, q, qd,
                        contact_ind, phase, traj: TrajIn, prev_ddq, toe_pos,
                        toe_jac, toe_jdqd, hip_pos, hip_jac, hip_jdqd) -> VcOut:
    """Outputs y, dy and the output map (18 rows: base pose, then each
    leg's toe, masked to swing legs). Shapes: q, qd, prev_ddq (B, 18);
    contact_ind (B, 4); phase (B,); toe/hip positions (B, 4, 3), Jacobians
    (B, 4, 3, 18), J̇q̇ (B, 4, 3)."""
    dtype = q.dtype
    bsz = q.shape[0]
    swing = 1.0 - contact_ind.to(dtype)                       # (B, 4)
    zeros6 = torch.zeros((bsz, 6), dtype=dtype, device=q.device)

    h0_base = torch.eye(6, TOTAL_DOF, dtype=dtype, device=q.device).expand(
        bsz, 6, TOTAL_DOF)
    h0_mat = torch.cat(
        [h0_base, (swing[:, :, None, None] * toe_jac).reshape(bsz, 12, -1)], 1)
    dh0 = torch.cat([zeros6, (swing[:, :, None] * toe_jdqd).reshape(bsz, 12)],
                    1)

    dt = traj.dom_ticks / (1.0 * ll_cfg.ctrl_hz)             # (B,)
    ds = 1.0 / dt

    hip_vel = torch.einsum("blin,bn->bli", hip_jac, qd)      # (B, 4, 3)
    hip_acc = torch.einsum("blin,bn->bli", hip_jac, prev_ddq) + hip_jdqd
    s = phase[:, None]
    zero = torch.zeros_like(hip_vel[..., 0])                  # (B, 4)

    def lateral(axis):
        target = hip_pos[..., axis] + traj.step_len[:, axis, None]
        start = traj.toe_init[:, axis, :]
        alpha = torch.stack([start, start, target, target], -1)
        d_alpha = torch.stack([zero, zero, hip_vel[..., axis],
                               hip_vel[..., axis]], -1)
        dd_alpha = torch.stack([zero, zero, hip_acc[..., axis],
                                hip_acc[..., axis]], -1)
        return bz.varying_bezier(alpha, d_alpha, dd_alpha, s, dt[:, None])

    px, vx, axx = lateral(0)
    py, vy, ayy = lateral(1)
    to = traj.toe_offset_z
    sw = torch.full_like(zero, motion.swing_height)
    start_z = traj.toe_init[:, 2, :]
    az = torch.stack([start_z, start_z, sw, sw, sw, zero + (to + 0.005),
                      zero + (to + 0.005), zero + to], -1)
    pz = bz.bezier(az, s)
    vz = bz.bezier_d(az, s) * ds[:, None]
    azz = bz.bezier_dd(az, s) * ds[:, None] * ds[:, None]
    toe_hd = torch.stack([px, py, pz], -1)                   # (B, 4, 3)
    toe_dhd = torch.stack([vx, vy, vz], -1)
    toe_ddhd = torch.stack([axx, ayy, azz], -1)

    sw3 = swing[:, :, None]
    hd = torch.cat([traj.com_des[:, 0:3], traj.com_des[:, 6:9],
                    (sw3 * toe_hd).reshape(bsz, 12)], 1)
    dhd = torch.cat([traj.com_des[:, 3:6], traj.com_des[:, 9:12],
                     (sw3 * toe_dhd).reshape(bsz, 12)], 1)
    ddhd = torch.cat([zeros6, (sw3 * toe_ddhd).reshape(bsz, 12)], 1)
    out_mask = torch.cat([torch.ones_like(zeros6),
                          swing.repeat_interleave(3, -1)], 1)
    h0 = torch.cat([q[:, 0:6], (sw3 * toe_pos).reshape(bsz, 12)], 1)
    dh0_vel = (h0_mat @ qd[:, :, None])[..., 0]
    y = (h0 - hd) * out_mask
    dy = (dh0_vel - dhd) * out_mask
    return VcOut(y, dy, h0_mat, dh0 * out_mask, hd, dhd, ddhd, out_mask)


@functools.lru_cache(maxsize=None)
def _qp_consts(ll_cfg: LowLevelConfig, dtype, device):
    """The LL QP's lane-independent parts: diag(P), G with every friction
    block present, and the torque-bound rows of h."""
    p_diag = np.concatenate([np.full(12, ll_cfg.df_pen),
                             np.full(12, ll_cfg.tau_pen),
                             np.full(18, ll_cfg.aux_pen),
                             [_delta_pen(ll_cfg)]])
    mu = ll_cfg.mu
    gc = np.array([[1.0, 0.0, -mu / np.sqrt(2)],
                   [-1.0, 0.0, -mu / np.sqrt(2)],
                   [0.0, 1.0, -mu / np.sqrt(2)],
                   [0.0, -1.0, -mu / np.sqrt(2)],
                   [0.0, 0.0, -1.0]])
    g = np.zeros((N_INEQ, N_DEC))
    for i in range(4):
        g[5 * i:5 * i + 5, 3 * i:3 * i + 3] = gc
    g[20:32, 12:24] = np.eye(12)
    g[32:44, 12:24] = -np.eye(12)
    sat = np.tile(np.asarray(ll_cfg.sat), 4)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    sel = np.zeros((TOTAL_DOF, 12))
    sel[6:] = np.eye(12)
    return (t(np.diag(p_diag)), t(g), t(np.concatenate([sat, sat, [1.0]])),
            t(np.eye(N_EQ - 12)), t(sel))


def _delta_pen(ll_cfg: LowLevelConfig) -> float:
    """The weight of the CLF relaxation delta: clf_pen with the CLF row,
    else 1."""
    return ll_cfg.clf_pen if ll_cfg.use_clf else 1.0


def _clf_terms(ll_cfg: LowLevelConfig, y, dy, out_mask):
    """The CLF from the closed-form Lyapunov solution
    (`src/LowLevelCtrl.cpp:171-225`), per lane: (V (B,), LfV (B,), LgV
    (B, 18) masked to the active outputs, c / eps), P's top-left block
    scaled by 1/eps^2 and its off-diagonal blocks by 1/eps."""
    kp, kd = ll_cfg.kp, ll_cfg.kd
    p1 = (kd * kd + kp * kp + kp) / (2.0 * kp * kd)
    pd = 1.0 / (2.0 * kp)
    p2 = (kp + 1.0) / (2.0 * kd * kp)
    cc = 1.0 / (0.5 * (p1 + p2 + np.sqrt(p1 * p1 - 2 * p1 * p2 + p2 * p2
                                          + 4 * pd * pd)))
    eps = ll_cfg.clf_eps
    yy, ydy, dydy = (y * y).sum(-1), (y * dy).sum(-1), (dy * dy).sum(-1)
    v = (p1 / eps**2) * yy + 2.0 * (pd / eps) * ydy + p2 * dydy
    lf_v = (-2.0 * kp * (pd / eps) * yy
            + 2.0 * ((p1 / eps**2) - kp * p2 - kd * (pd / eps)) * ydy
            + 2.0 * ((pd / eps) - kd * p2) * dydy)
    lg_v = 2.0 * ((pd / eps) * y + p2 * dy)
    return v, lf_v, lg_v * out_mask, torch.full_like(v, cc / eps)


def _clf_row(ll_cfg, vc, g, h, lg_cols, h_extra=None):
    """G and h with row 44 the CLF row: lg_cols (B, n - 1) on the decision
    variables before delta, -1 on delta, and h = -LfV - (c/eps) V (+
    h_extra). Returns (G, h, (V, LfV, LgV, c/eps))."""
    terms = _clf_terms(ll_cfg, vc.y, vc.dy, vc.out_mask)
    v, lf_v, lg_v, c_eps = terms
    row = torch.cat([lg_cols(lg_v), -torch.ones_like(v)[:, None]], 1)
    h44 = -lf_v - c_eps * v
    if h_extra is not None:
        h44 = h44 + h_extra(lg_v)
    return (torch.cat([g[:, :N_INEQ - 1], row[:, None]], 1),
            torch.cat([h[:, :N_INEQ - 1], h44[:, None]], 1), terms)


class _Terms(NamedTuple):
    """What both LL builds compute from the state, batched."""

    h_bias: torch.Tensor    # (B, 18)
    d_inv: torch.Tensor     # (B, 18, 18)
    b_mat: torch.Tensor     # (B, 18, 12)
    toe_jac: torch.Tensor   # (B, 4, 3, 18)
    con: torch.Tensor       # (B, 4)
    con3: torch.Tensor      # (B, 12)
    jc_flat: torch.Tensor   # (B, 12, 18)
    djc_qd: torch.Tensor    # (B, 12)


def _terms(ll_cfg, model, q, qd, contact_ind, include_coriolis, d_inv):
    from srbx_torch.ops import spd

    bsz = q.shape[0]
    h_bias = rbd.bias_forces(model, q, qd, include_coriolis=include_coriolis)
    if d_inv is None:
        d_inv = spd.inverse(rbd.mass_matrix(model, q))
    sel = _qp_consts(ll_cfg, q.dtype, q.device)[4]
    sj, jdqd = rbd.site_jacobians_and_jdot_qd(model, q, qd)
    toe_jac = sj[:, a1.TOE_SITES]                                # (B, 4, 3, 18)
    toe_jdqd = jdqd[:, a1.TOE_SITES]
    con = contact_ind.to(q.dtype)
    return _Terms(
        h_bias, d_inv, sel.expand(bsz, TOTAL_DOF, 12), toe_jac, con,
        con.repeat_interleave(3, -1),
        (toe_jac * con[:, :, None, None]).reshape(bsz, 12, TOTAL_DOF),
        (toe_jdqd * con[:, :, None]).reshape(bsz, 12))


def _inequalities(ll_cfg, con, n_dec):
    """G (B, 45, n_dec) and h (B, 45): the friction pyramids scaled by
    contact, the torque bounds, and row 44 inert (0 <= 1), which the CLF
    row replaces under use_clf (`_clf_row`)."""
    g_full, h_bounds = _qp_consts(ll_cfg, con.dtype, con.device)[1:3]
    bsz = con.shape[0]
    con5 = con.repeat_interleave(5, -1)                          # (B, 20)
    row_scale = torch.cat([con5, torch.ones((bsz, N_INEQ - 20),
                                            dtype=con.dtype,
                                            device=con.device)], 1)
    G = g_full[:, :n_dec] * row_scale[:, :, None]
    h = torch.cat([torch.where(con5 > 0, 0.0, 1.0),
                   h_bounds.expand(bsz, N_INEQ - 20)], 1)
    return G.contiguous(), h.contiguous()


def _ctx(model, q, t: _Terms, clf=None):
    """The finish stage's context; clf: the CLF terms, zeros without."""
    bsz = q.shape[0]
    if clf is None:
        zero = torch.zeros(bsz, dtype=q.dtype, device=q.device)
        clf = (zero, zero, torch.zeros((bsz, 18), dtype=q.dtype,
                                       device=q.device), zero)
    toe_pos = rbd.site_positions(model, q)[:, a1.TOE_SITES]
    return LLCtx(t.d_inv, t.b_mat, t.h_bias, t.jc_flat, t.toe_jac, toe_pos,
                 t.con, *clf)


def ll_qp_build(ll_cfg: LowLevelConfig, model: rbd.Model, q, qd, contact_ind,
                vc: VcOut, f_des, include_coriolis: bool = False, d_inv=None):
    """Assemble the LL QP for every lane without solving it. Returns
    (LLQpData, LLCtx); the batched loop solves all lanes in one call of the
    fused IPM and then runs `ll_qp_finish`.

    d_inv: (B, 18, 18) D(q)^-1; when None it is computed here with
    `srbx_torch.ops.spd.inverse` (the JAX package's per-lane inverse is an
    LU one; its batched loop's "xla" form passes that in). With use_clf
    row 44 is the CLF row on the aux columns 24:42 and delta (column 42)."""
    dtype = q.dtype
    bsz = q.shape[0]
    t = _terms(ll_cfg, model, q, qd, contact_ind, include_coriolis, d_inv)
    h_bias, d_inv, jc_flat, djc_qd, con3 = (t.h_bias, t.d_inv, t.jc_flat,
                                            t.djc_qd, t.con3)
    p_mat, _, _, eye18, _ = _qp_consts(ll_cfg, dtype, q.device)
    kp, kd = ll_cfg.kp, ll_cfg.kd

    # cost
    P = p_mat.expand(bsz, N_DEC, N_DEC).contiguous()
    c = torch.cat([-ll_cfg.df_pen * f_des * con3,
                   torch.zeros((bsz, N_DEC - 12), dtype=dtype,
                               device=q.device)], 1)

    # equalities: rows 0:12 contact, rows 12:30 outputs
    jc_t = jc_flat.transpose(1, 2)
    jc_dinv = jc_flat @ d_inv                                    # (B, 12, 18)
    h0_dinv = vc.h0_mat @ d_inv                                  # (B, 18, 18)
    zeros_c = torch.zeros((bsz, 12, N_DEC - 24), dtype=dtype, device=q.device)
    a_eq = torch.cat([
        torch.cat([jc_dinv @ jc_t, jc_dinv[:, :, 6:], zeros_c], 2),
        torch.cat([h0_dinv @ jc_t, h0_dinv[:, :, 6:],
                   eye18 * vc.out_mask[:, None, :],
                   torch.zeros((bsz, 18, 1), dtype=dtype, device=q.device)],
                  2),
    ], 1)
    b_eq = torch.cat([
        (jc_dinv @ h_bias[:, :, None])[..., 0] - djc_qd,
        (-kp * vc.y - kd * vc.dy + (h0_dinv @ h_bias[:, :, None])[..., 0]
         - vc.dh0) * vc.out_mask,
    ], 1)

    # inequalities: friction pyramids scaled by contact, torque bounds, and
    # with use_clf the CLF row on the aux columns
    G, h = _inequalities(ll_cfg, t.con, N_DEC)
    clf = None
    if ll_cfg.use_clf:
        G, h, clf = _clf_row(ll_cfg, vc, G, h, lambda lg_v: torch.cat(
            [torch.zeros((bsz, 24), dtype=dtype, device=q.device), lg_v], 1))
    data = LLQpData(P, c.contiguous(), a_eq.contiguous(), b_eq.contiguous(),
                    G.contiguous(), h.contiguous())
    return data, _ctx(model, q, t, clf)


class LLCtxR(NamedTuple):
    """The reduced build's context: the full build's, and the output map
    that recovers the eliminated aux variables, aux = -(a_out x + c_out)."""

    base: LLCtx
    a_out: torch.Tensor     # (B, 18, 24)
    c_out: torch.Tensor     # (B, 18)


def ll_qp_build_reduced(ll_cfg: LowLevelConfig, model: rbd.Model, q, qd,
                        contact_ind, vc: VcOut, f_des,
                        include_coriolis: bool = False, d_inv=None):
    """The reduced LL QP for every lane: the 18 aux output-defect variables
    eliminated through the output rows, aux = r - A'x, so that aux_pen
    ||aux||^2 becomes aux_pen ||A'x + C||^2 with A' = H0 D^-1 [Jc' | B] and
    C = -H0 D^-1 H + dH0 + kp y + kd dy on the active output rows. n 25,
    me 12 (the contact rows), mi 45: the same solution set as the full
    build to eps-optimality. d_inv as in `ll_qp_build`. With use_clf row 44
    is the CLF row with aux substituted: -(LgV a_out) on columns 0:24, -1
    on delta (column 24), h = -LfV - (c/eps) V + LgV . c_out.

    Returns (LLQpData, LLCtxR); `ll_qp_finish_reduced` completes it."""
    dtype = q.dtype
    bsz = q.shape[0]
    t = _terms(ll_cfg, model, q, qd, contact_ind, include_coriolis, d_inv)
    kp, kd = ll_cfg.kp, ll_cfg.kd
    zeros = functools.partial(torch.zeros, dtype=dtype, device=q.device)

    # cost over (F, tau): aux_pen A'^T A' and aux_pen A'^T C
    h0_dinv = vc.h0_mat @ t.d_inv                                # (B, 18, 18)
    a_out = torch.cat([h0_dinv @ t.jc_flat.transpose(1, 2),
                       h0_dinv[:, :, 6:]], 2) * vc.out_mask[:, :, None]
    c_out = ((-h0_dinv @ t.h_bias[:, :, None])[..., 0] + vc.dh0
             + kp * vc.y + kd * vc.dy) * vc.out_mask
    a_out_t = a_out.transpose(1, 2)
    p_diag = torch.tensor([ll_cfg.df_pen] * 12 + [ll_cfg.tau_pen] * 12
                          + [_delta_pen(ll_cfg)], dtype=dtype,
                          device=q.device)
    P = torch.nn.functional.pad(ll_cfg.aux_pen * (a_out_t @ a_out),
                                (0, 1, 0, 1)) + torch.diag(p_diag)
    atc = ll_cfg.aux_pen * (a_out_t @ c_out[:, :, None])[..., 0]   # (B, 24)
    c = torch.cat([-ll_cfg.df_pen * f_des * t.con3 + atc[:, 0:12],
                   atc[:, 12:24], zeros((bsz, 1))], 1)

    # equalities: the contact rows
    jc_dinv = t.jc_flat @ t.d_inv                                # (B, 12, 18)
    a_eq = torch.cat([jc_dinv @ t.jc_flat.transpose(1, 2), jc_dinv[:, :, 6:],
                      zeros((bsz, N_EQ2, 1))], 2)
    b_eq = (jc_dinv @ t.h_bias[:, :, None])[..., 0] - t.djc_qd

    G, h = _inequalities(ll_cfg, t.con, N_DEC2)
    clf = None
    if ll_cfg.use_clf:
        G, h, clf = _clf_row(
            ll_cfg, vc, G, h,
            lambda lg_v: -(lg_v[:, None, :] @ a_out)[:, 0],
            lambda lg_v: (lg_v * c_out).sum(-1))
    data = LLQpData(P.contiguous(), c.contiguous(), a_eq.contiguous(),
                    b_eq.contiguous(), G.contiguous(), h.contiguous())
    return data, LLCtxR(_ctx(model, q, t, clf), a_out, c_out)


def expand_reduced_x(ctx: LLCtxR, sol_x):
    """A reduced solution [F, tau, clf] (B, 25) in the full layout
    [F, tau, aux, clf] (B, 43), with aux = -(a_out x + c_out)."""
    aux = -((ctx.a_out @ sol_x[:, 0:24, None])[..., 0] + ctx.c_out)
    return torch.cat([sol_x[:, 0:24], aux, sol_x[:, 24:25]], 1)


def swing_delta_inv(ctx: LLCtx):
    """Js D^-1 Js' (+ I on the stance legs' rows), (B, 12, 12): the swing
    operational-space matrix whose inverse's diagonal sets the swing-PD
    gain."""
    bsz = ctx.con.shape[0]
    swing = 1.0 - ctx.con
    js_flat = (ctx.toe_jac * swing[:, :, None, None]).reshape(bsz, 12,
                                                              TOTAL_DOF)
    return (js_flat @ ctx.d_inv @ js_flat.transpose(1, 2)
            + torch.diag_embed(ctx.con.repeat_interleave(3, -1)))


def ll_qp_finish(ll_cfg: LowLevelConfig, ctx: LLCtx, q, qd, vc: VcOut, sol_x,
                 converged, delta=None) -> LLOut:
    """Torques from the solved LL QP: forces and torques from x, the
    swing-leg PD add-on, and the joint-command integration.

    delta: (B, 12, 12) inverse of `swing_delta_inv(ctx)`; when None it is
    computed here with `srbx_torch.ops.spd.inverse`. With use_clf, dv_lyap
    is the CLF's derivative along the solution, LfV + (c/eps) V + LgV .
    aux; zeros without."""
    from srbx_torch.ops import spd

    dtype = q.dtype
    bsz = q.shape[0]
    con = ctx.con
    swing = 1.0 - con
    con3 = con.repeat_interleave(3, -1)
    f_qp = sol_x[:, 0:12] * con3
    tau = sol_x[:, 12:24]
    dv = (ctx.lf_v + ctx.c_eps * ctx.v + (ctx.lg_v * sol_x[:, 24:42]).sum(-1)
          if ll_cfg.use_clf else torch.zeros_like(ctx.v))

    js_flat = (ctx.toe_jac * swing[:, :, None, None]).reshape(bsz, 12,
                                                              TOTAL_DOF)
    if delta is None:
        delta = spd.inverse(swing_delta_inv(ctx))
    wd, kd_sw = 40.0, 40.0
    sw3 = swing[:, :, None]
    p_err = (sw3 * (vc.hd[:, 6:18].reshape(bsz, 4, 3) - ctx.toe_pos)
             ).reshape(bsz, 12)
    toe_vel = torch.einsum("blin,bn->bli", ctx.toe_jac, qd)
    v_err = (sw3 * (vc.dhd[:, 6:18].reshape(bsz, 4, 3) - toe_vel)
             ).reshape(bsz, 12)
    kp_sw = wd * wd * torch.diagonal(delta, dim1=1, dim2=2)
    zeros6 = torch.zeros((bsz, 6), dtype=dtype, device=q.device)
    pd = kp_sw * p_err + kd_sw * v_err
    tau_full = torch.cat([zeros6, tau], 1) \
        + (js_flat.transpose(1, 2) @ pd[:, :, None])[..., 0]

    gen = (torch.cat([zeros6, tau_full[:, 6:]], 1)
           + (ctx.jc_flat.transpose(1, 2) @ f_qp[:, :, None])[..., 0]
           - ctx.h_bias)
    ddq = (ctx.d_inv @ gen[:, :, None])[..., 0]
    hz = float(ll_cfg.ctrl_hz)
    dq_next = qd + ddq / hz
    q_next = q + dq_next / hz + 0.5 / (hz * hz) * ddq
    return LLOut(tau=tau_full[:, 6:], grf=f_qp, y=vc.y, dy=vc.dy, ddq=ddq,
                 q_next=q_next, dq_next=dq_next, v_lyap=ctx.v,
                 dv_lyap=dv, qp_converged=converged)


def ll_qp_finish_reduced(ll_cfg: LowLevelConfig, ctx: LLCtxR, q, qd,
                         vc: VcOut, sol_x, converged, delta=None) -> LLOut:
    """Finish a reduced solve with the full build's post-solve math (the
    swing-leg PD add-on included); delta as in `ll_qp_finish`, of
    `swing_delta_inv(ctx.base)`."""
    return ll_qp_finish(ll_cfg, ctx.base, q, qd, vc,
                        expand_reduced_x(ctx, sol_x), converged, delta=delta)


def calc_torque(ll_cfg: LowLevelConfig, qp_cfg: QpConfig, model: rbd.Model,
                q, qd, contact_ind, vc: VcOut, f_des,
                include_coriolis: bool = False) -> LLOut:
    """Solve the LL QP and produce the torques (`LowLevelCtrl::calcTorque`)
    for every lane: `ll_qp_build`, the dense per-problem IPM
    (`srbx_torch.ops.qp.solve`), `ll_qp_finish`. f_des (B, 12): the desired
    per-leg ground forces (zeros where no force distribution supplies them).
    D^-1 and the swing operational-space inverse are LU inverses, as the JAX
    package's per-lane build and finish compute them; matrix products run
    in full float32 (no TF32)."""
    from srbx_torch.ops import qp
    from srbx_torch.ops.qp_batch import full_f32_products

    with full_f32_products():
        d_inv = torch.linalg.inv_ex(rbd.mass_matrix(model, q))[0]
        data, ctx = ll_qp_build(ll_cfg, model, q, qd, contact_ind, vc, f_des,
                                include_coriolis, d_inv=d_inv)
        sol = qp.solve(data.P, data.c, data.A, data.b, data.G, data.h, qp_cfg)
        delta = torch.linalg.inv_ex(swing_delta_inv(ctx))[0]
        return ll_qp_finish(ll_cfg, ctx, q, qd, vc, sol.x, sol.converged,
                            delta=delta)
