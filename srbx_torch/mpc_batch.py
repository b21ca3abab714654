"""Batched CBF-NMPC control cycle: `run_nmpc_batch`.

Counterpart of `srbx/mpc_batch.py::run_nmpc_batch`. One call runs one
control cycle for every lane:

1. slice the reference window and pick footholds;
2. build the QP: the full one (n 41, me 28, mi 92 with the JAX package's
   default rows), or condensed onto (lambda, slack) through x = e0 + E v
   (n 17, me 4), or condensed with one lambda per knot eliminated
   (cfg.elide_simplex: n 13, me 0);
3. solve it (cold, or warm from x0_warm);
4. with cfg.use_sqp, run `cfg.sqp_iters` SCP rounds: velocity and
   linearised CBF rows are appended (projected onto the condensed space
   where the QP is condensed) and the QP is re-solved warm;
5. fall back to holding position in any lane that went non-finite;
6. unpack the knots and fit the per-domain Bezier.

Two branches, chosen as the JAX package chooses them:

* lanes-last (condensed, cfg.elide_simplex and backend "fused"): the full
  P is diagonal and the full G, h are the same for every lane, so only
  diag(P), c and E, e0 are built per lane and the condensed operands are
  formed directly lanes-last for the fused IPM
  (`ops.qp_fused.solve_lanes_last`, kernel K1a). Its products are written
  as einsum/matmul: as broadcast multiply-and-sum, eager PyTorch would
  materialise multi-GB temporaries at B = 131072.
* generic (everything else): `ocp.assemble`, optionally `ocp.condense`,
  and the batched IPM `ops.qp_batch.solve` with the given backend;
  backend "pallas" runs the Cholesky kernels K3a and K3b, backend "fused"
  the general fused IPM (kernel K1b: n 41, me 28 uncondensed; n 17, me 4
  condensed with the simplex rows kept), one launch per QP.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import torch

from srbx_torch import mpc, sqp
from srbx_torch.config import MpcConfig, QpConfig
from srbx_torch.ocp import (
    assemble,
    condense,
    condense_rows,
    contract,
    cost,
    default_footholds,
    expand,
    expansion,
    inequalities,
    reference_window,
    unpack,
)
from srbx_torch.ops import qp_batch, qp_fused
from srbx_torch.ops.bezier import fit_domain_bezier

_log = logging.getLogger(__name__)


class LanesLastQp(NamedTuple):
    """The condensed QP of one cycle, with its expansion x = e0 + E v."""

    e: torch.Tensor     # (B, n_full, n_cond)
    e0: torch.Tensor    # (B, n_full)
    P: torch.Tensor     # (n_cond, n_cond, B)
    c: torch.Tensor     # (n_cond, B)
    G: torch.Tensor     # (mi, n_cond, B)
    h: torch.Tensor     # (mi, B)


def effective_contacts(carry: mpc.MpcCarry, contact_ind):
    """All legs in stance before locomotion starts (gait_domain <= 1)."""
    return torch.where((carry.gait_domain <= 1)[:, None],
                       torch.ones_like(contact_ind), contact_ind)


def _lane_state(cfg: MpcConfig, carry: mpc.MpcCarry, q_xy, dq_xy, toe_xy,
                pr_agent, prd_agent, agent_initial):
    """Per lane: the LIP state x0 (B, 4), the reference window (B, 4, N)
    and the footholds (B, 2, 4), nominal before locomotion starts."""
    x0 = torch.stack([q_xy[:, 0], dq_xy[:, 0], q_xy[:, 1], dq_xy[:, 1]], 1)
    ref = reference_window(pr_agent, prd_agent, 0, carry.gait_domain,
                           cfg.horizon)
    nominal = default_footholds(agent_initial.to(q_xy.dtype))
    foot = torch.where((carry.gait_domain <= 1)[:, None, None], nominal,
                       toe_xy)
    return x0, ref.to(q_xy.dtype), foot


def condensed_qp(cfg: MpcConfig, carry: mpc.MpcCarry, q_xy, dq_xy, toe_xy,
                 ci_eff, pr_agent, prd_agent, agent_initial) -> LanesLastQp:
    """Build the condensed, simplex-eliminated QP lanes-last."""
    dtype, device = q_xy.dtype, q_xy.device
    x0, ref, foot = _lane_state(cfg, carry, q_xy, dq_xy, toe_xy, pr_agent,
                                prd_agent, agent_initial)
    d, c = cost(cfg, ref, ci_eff)                  # diag(P), c
    e, e0 = expansion(cfg, x0, foot, ci_eff, dtype=dtype)
    g_full, h_full = inequalities(cfg, dtype, device)

    p_ll = torch.einsum("bnk,bnl->klb", e * d[:, :, None], e)
    p_ll = 0.5 * (p_ll + p_ll.transpose(0, 1))
    c_ll = torch.einsum("bnk,bn->kb", e, c + d * e0)
    g_ll = torch.einsum("mn,bnk->mkb", g_full, e)
    h_ll = h_full[:, None] - torch.einsum("mn,bn->mb", g_full, e0)
    return LanesLastQp(e, e0, p_ll.contiguous(), c_ll.contiguous(),
                       g_ll.contiguous(), h_ll.contiguous())


def project_rows(qp: LanesLastQp, rows, rhs):
    """Append full-space rows (B, r, n_full) . x <= rhs (B, r), projected
    onto the condensed space, to the QP's inequality block."""
    g_new = torch.einsum("brn,bnk->rkb", rows, qp.e)
    h_new = rhs.T - torch.einsum("brn,bn->rb", rows, qp.e0)
    return (torch.cat([qp.G, g_new], 0).contiguous(),
            torch.cat([qp.h, h_new], 0).contiguous())


def expand_ll(qp: LanesLastQp, x_ll):
    """Full-space decision vectors (B, n_full) from condensed (n_cond, B)."""
    return expand(qp.e, qp.e0, x_ll.T)


def fused_qp_shape(cfg: MpcConfig, condensed: bool):
    """(n, me, mi) of the QPs the cycle solves on backend "fused": n 41 /
    me 28 uncondensed, 17 / 4 condensed, 13 / 0 condensed with the simplex
    rows eliminated (the lanes-last branch); mi the most rows of any of its
    solves (an SCP round's velocity and CBF rows and a neighbour circle
    included)."""
    if not condensed:
        n, me = cfg.num_dec, cfg.n_eq
    elif cfg.elide_simplex:
        n, me = 3 * cfg.ndomain + 1, 0
    else:
        n, me = cfg.n_lambda + 1, cfg.n_input * cfg.horizon // 2
    mi = cfg.n_ineq + (cfg.n_ineq_sqp - cfg.n_ineq + 4 if cfg.use_sqp else 0)
    return n, me, mi


def check_fused(cfg: MpcConfig, condensed: bool):
    """Raise NotImplementedError where the cycle on backend "fused" would
    reach a fused IPM at a shape it is not built for (K1a: n 13, mi <= 128;
    K1b: `qp_fused.GENERAL_SHAPES`)."""
    n, me, mi = fused_qp_shape(cfg, condensed)
    if me == 0:
        ok, built = (n == qp_fused.N_COND and mi <= qp_fused.MAX_MI,
                     f"n = {qp_fused.N_COND} with mi <= {qp_fused.MAX_MI}")
    else:
        ok = mi <= qp_fused.GENERAL_SHAPES.get((n, me), 0)
        built = qp_fused.shapes_built()
    if not ok:
        raise NotImplementedError(
            f"on backend 'fused' this MpcConfig's NMPC solves QPs of (n, me) "
            f"= ({n}, {me}) with up to {mi} inequality rows; the fused IPM "
            f"{'K1a' if me == 0 else 'K1b'} is built for {built} (ROADMAP "
            "Queue 2); backends 'pallas' and 'xla' run any MpcConfig")


def _contract_ll(cfg: MpcConfig, x, ci_eff):
    return contract(cfg, x, ci_eff).T.contiguous()


@qp_batch.full_f32_products()
def run_nmpc_batch(
    cfg: MpcConfig,
    qp_cfg: QpConfig,
    carry: mpc.MpcCarry,          # (B,) int32, (B, 4)
    q_xy,                         # (B, 2)
    dq_xy,                        # (B, 2)
    toe_xy,                       # (B, 2, 4)
    contact_ind,                  # (B, 4)
    pr_agent,                     # (B, 2, T)
    prd_agent,                    # (B, 2, T)
    agent_initial,                # (B, 2)
    pobs_real,                    # (B, 2, n_obs)
    backend: str = "pallas",
    condensed: bool | None = None,
    state_other=None,             # optional (B, 4) neighbour (x, y, dx, dy)
    agent_circle_eps: float = 0.0,
    x0_warm=None,                 # optional (B, num_dec) first-QP warm start
) -> mpc.MpcOutput:
    """One NMPC cycle for every lane; the JAX signature without the
    TPU-only `tile` and `interpret`.

    The default backend is the JAX package's, "pallas". The condensed,
    simplex-eliminated configuration of the benchmark and the whole-body
    loop takes the lanes-last branch through kernel K1a only with
    backend="fused", which its callers pass (mi 28 / 48 / 52 with the box
    rows elided, 92 / 112 / 116 without). Any other call takes the generic
    branch through `qp_batch.solve`: "pallas" (kernels K3a and K3b), "xla"
    (torch.linalg) or "fused" (kernel K1b at (n, me) = (41, 28)
    uncondensed or (17, 4) condensed, mi up to 128; `check_fused` says
    which configurations it serves). qp_converged and qp_iters are the
    first QP's, qp_iters its iteration count (max over lanes), as in the JAX
    package. Matrix products run in full float32 (no TF32); the caller's
    setting is restored after.
    """
    if condensed is None:
        condensed = cfg.condensed
    dtype, device = q_xy.dtype, q_xy.device
    bsz = q_xy.shape[0]

    ci_eff = effective_contacts(carry, contact_ind)
    if condensed and backend == "fused" and cfg.elide_simplex:
        if qp_cfg.ruiz_iters:
            # Mirrors the JAX package, whose lanes-last gate ignores
            # ruiz_iters (reference fault F2 in ROADMAP.md): no equilibration
            # is applied.
            _log.warning("ruiz_iters=%d is ignored on the lanes-last fused "
                         "path (reference fault F2)", qp_cfg.ruiz_iters)
        qp = condensed_qp(cfg, carry, q_xy, dq_xy, toe_xy, ci_eff, pr_agent,
                          prd_agent, agent_initial)
        x0_ll = None if x0_warm is None else _contract_ll(cfg, x0_warm,
                                                          ci_eff)
        x_ll, _, _, stat1 = qp_fused.solve_lanes_last(
            qp.P, qp.c, qp.G, qp.h, qp_cfg, x0=x0_ll)
        qp_converged = stat1[2] > 0.5
        qp_iters = stat1[3].max().to(torch.int32)
        x = expand_ll(qp, x_ll)

        def scp_solve(x, rows, rhs):
            g_s, h_s = project_rows(qp, rows, rhs)
            x_ll2, _, _, _ = qp_fused.solve_lanes_last(
                qp.P, qp.c, g_s, h_s, qp_cfg, x0=_contract_ll(cfg, x, ci_eff))
            return expand_ll(qp, x_ll2)
    else:
        x0, ref, foot = _lane_state(cfg, carry, q_xy, dq_xy, toe_xy,
                                    pr_agent, prd_agent, agent_initial)
        data = assemble(cfg, x0, ref, foot, ci_eff, dtype=dtype)
        if condensed:
            e_mat, e0 = expansion(cfg, x0, foot, ci_eff, dtype=dtype)
            data_s = condense(cfg, data, e_mat, e0)
            if x0_warm is not None:
                x0_warm = contract(cfg, x0_warm, ci_eff)
        else:
            data_s = data
        sol = qp_batch.solve(*data_s, qp_cfg, backend=backend, x0=x0_warm)
        qp_converged, qp_iters = sol.converged, sol.iters
        x = expand(e_mat, e0, sol.x) if condensed else sol.x

        def scp_solve(x, rows, rhs):
            if condensed:
                rows, rhs = condense_rows(rows, rhs, e_mat, e0)
                x_start = contract(cfg, x, ci_eff)
            else:
                x_start = x
            sol = qp_batch.solve(
                data_s.P, data_s.c, data_s.A, data_s.b,
                torch.cat([data_s.G, rows], 1), torch.cat([data_s.h, rhs], 1),
                qp_cfg, backend=backend, x0=x_start)
            return expand(e_mat, e0, sol.x) if condensed else sol.x

    obs_xy = mpc.closest_obstacle(q_xy, pobs_real.to(dtype))[0]
    if state_other is None:
        circles = obs_xy[:, None, :]                       # (B, 1, 2)
        mask = torch.ones(bsz, 1, dtype=dtype, device=device)
    else:
        # the neighbour's broadcast position is a second CBF circle
        circles = torch.stack([obs_xy, state_other[:, :2].to(dtype)], 1)
        mask = torch.tensor([1.0, 1.0 if agent_circle_eps > 0 else 0.0],
                            dtype=dtype, device=device).expand(bsz, 2)

    if cfg.use_sqp:
        vel_g, vel_h = sqp._vel_rows(cfg, dtype, device)
        for _ in range(cfg.sqp_iters):
            cbf_g, cbf_h = sqp._cbf_rows(cfg, x, circles, mask, dtype)
            x_new = scp_solve(
                x, torch.cat([vel_g.expand(bsz, -1, -1), cbf_g], 1),
                torch.cat([vel_h.expand(bsz, -1), cbf_h], 1))
            x = torch.where(torch.isfinite(x_new).all(-1, keepdim=True),
                            x_new, x)

    # per-lane hold-position fallback, with the stance mask the QP used
    x0s = torch.stack([q_xy[:, 0], dq_xy[:, 0], q_xy[:, 1], dq_xy[:, 1]], 1)
    holds = mpc.hold_position_x(cfg, x0s, ci_eff)
    x = torch.where(torch.isfinite(x).all(-1, keepdim=True), x, holds)

    states, inputs, _, _ = unpack(cfg, x)
    knots = torch.cat([carry.alpha_buffer[:, :, None],
                       states.transpose(1, 2)], 2)
    alpha_com = fit_domain_bezier(knots)
    new_carry = mpc.MpcCarry(carry.gait_domain + 1, states[:, -1])
    margin = sqp.cbf_margins(cfg, x, circles).amin((1, 2))
    return mpc.MpcOutput(alpha_com, states, inputs, new_carry, qp_converged,
                         qp_iters, margin, x)
