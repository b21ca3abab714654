"""NMPC optimal-control-problem assembly, batched over a leading lane axis.

Counterpart of `srbx/ocp.py`. The padded event-based LIP MPC QP:

  decision x = [ x_1..x_N (4 each) | u_1..u_N (2 each) | lambda (4 per grid,
                 one slot per leg, padded) | slack ]          -> n = 41
  equalities  : LIP dynamics rollout, COP = sum(foothold * lambda),
                sum(lambda) = 1 per grid                      -> me = 28
  inequalities: |com_k - u_{k+1}| <= mu*h/sqrt(2), +-box on x and u,
                0 <= lambda <= 1                              -> mi = 92

Every function takes and returns tensors with a leading lane axis B. The
cost is diagonal and the inequality block is the same for every lane;
`cost` and `inequalities` build exactly those parts, and the lanes-last
NMPC cycle (`srbx_torch.mpc_batch`) calls them instead of `assemble`, which
would write per-lane P, A and G that that branch never reads; the generic
branch calls `assemble` and, condensed, `condense`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from srbx_torch.config import MpcConfig
from srbx_torch.models import lip


class OcpData(NamedTuple):
    """Padded QP operands, lane-leading: (B,n,n),(B,n),(B,me,n),(B,me),
    (B,mi,n),(B,mi)."""

    P: torch.Tensor
    c: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    G: torch.Tensor
    h: torch.Tensor


def reference_window(pr, prd, agent_id: int, gait_domain, horizon: int):
    """Slice the N-knot desired-COM window per lane.

    pr, prd: (B, 2*n_agents, T) position / velocity tables; gait_domain
    (B,) integer. Window rows are (x, dx, y, dy) of agent `agent_id`,
    columns [N*gait_domain, N*gait_domain + N). As with JAX's
    dynamic_slice, the start is clamped to [0, T - N], so a domain past the
    end of the table reads its last N columns. Returns (B, 4, N).
    """
    t_len = pr.shape[-1]
    start = (gait_domain.long() * horizon).clamp(0, t_len - horizon)
    idx = start[:, None] + torch.arange(horizon, device=pr.device)
    rows = (pr[:, 2 * agent_id], prd[:, 2 * agent_id],
            pr[:, 2 * agent_id + 1], prd[:, 2 * agent_id + 1])
    return torch.stack([r.gather(1, idx) for r in rows], 1)


def _q_diag(cfg: MpcConfig) -> np.ndarray:
    n_s, m, N = cfg.n_state, cfg.n_input, cfg.horizon
    nN, mN = n_s * N, m * N
    q = np.zeros(cfg.num_dec)
    q[:nN] = cfg.q_weight
    q[n_s * (N - 1):nN] = cfg.p_weight              # terminal block
    q[nN:nN + mN] = cfg.r_weight
    q[-1] = cfg.slack_weight
    return q


def cost(cfg: MpcConfig, ref_traj, contact_ind):
    """Diagonal of P and the linear term c, per lane: (B, n), (B, n).

    ref_traj (B, 4, N); contact_ind (B, 4) 0/1. Padded lambda slots of
    absent legs get a stiff cost 1e2 that pins them; real slots cost 0.
    """
    dtype, device = ref_traj.dtype, ref_traj.device
    bsz = ref_traj.shape[0]
    nN = cfg.n_state * cfg.horizon
    nN_mN = nN + cfg.n_input * cfg.horizon
    q = torch.as_tensor(_q_diag(cfg), dtype=dtype, device=device)
    lam_mask = contact_ind.to(dtype).repeat(1, cfg.ndomain)   # grid-major
    lam_cost = 1e2 * (1.0 - lam_mask)
    p_diag = torch.cat([q[:nN_mN].expand(bsz, -1), lam_cost,
                        q[-1:].expand(bsz, -1)], 1)
    ref_vec = ref_traj.transpose(1, 2).reshape(bsz, -1)    # knot-major
    c = torch.cat([-ref_vec * q[:nN],
                   torch.zeros(bsz, cfg.num_dec - nN, dtype=dtype,
                               device=device)], 1)
    return p_diag, c


@functools.lru_cache(maxsize=None)
def _inequalities_np(cfg: MpcConfig):
    """(G, h) of the full inequality block in float64, COP rows of h zero
    (their bound is computed in the working dtype by `inequalities`)."""
    n_s, m, N = cfg.n_state, cfg.n_input, cfg.horizon
    nN, mN, n_lam, n = n_s * N, m * N, cfg.n_lambda, cfg.num_dec
    mi = 2 * m * (N - 1) + 2 * nN + 2 * mN + 2 * n_lam
    g = np.zeros((mi, n))
    h = np.ones(mi)

    # |com_k - u_{k+1}| <= mu*h/sqrt(2): row pair i couples state knot i
    # (x_{i+1}) with input u_{i+2}
    xsel = np.zeros((m, n_s))
    xsel[0, 0] = 1.0
    xsel[1, 2] = 1.0
    gsubx = np.zeros((m * (N - 1), nN))
    gsubu = np.zeros((m * (N - 1), mN))
    for i in range(N - 1):
        gsubx[i * m:(i + 1) * m, i * n_s:(i + 1) * n_s] = xsel
        gsubu[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] = np.eye(m)
    r_cop = m * (N - 1)
    g[:r_cop, :nN] = gsubx
    g[:r_cop, nN:nN + mN] = -gsubu
    g[r_cop:2 * r_cop, :nN] = -gsubx
    g[r_cop:2 * r_cop, nN:nN + mN] = gsubu
    h[:2 * r_cop] = 0.0

    # +-box on states and inputs
    r1 = 2 * r_cop
    g[r1:r1 + nN, :nN] = np.eye(nN)
    g[r1 + nN:r1 + 2 * nN, :nN] = -np.eye(nN)
    g[r1 + 2 * nN:r1 + 2 * nN + mN, nN:nN + mN] = np.eye(mN)
    g[r1 + 2 * nN + mN:r1 + 2 * nN + 2 * mN, nN:nN + mN] = -np.eye(mN)
    h[r1:r1 + 2 * nN + 2 * mN] = cfg.box_bound

    # 0 <= lambda <= 1
    r2 = r1 + 2 * nN + 2 * mN
    lam = slice(nN + mN, nN + mN + n_lam)
    g[r2:r2 + n_lam, lam] = -np.eye(n_lam)
    h[r2:r2 + n_lam] = 0.0
    g[r2 + n_lam:r2 + 2 * n_lam, lam] = np.eye(n_lam)
    h[r2 + n_lam:r2 + 2 * n_lam] = 1.0

    if cfg.elide_box_rows:
        # the box rows can never bind at operating scale, and lambda <= 1
        # follows from sum(lambda) = 1 with lambda >= 0
        keep = np.r_[0:cfg.box_row_range[0], r2:r2 + n_lam]
        g, h = g[keep], h[keep]
    return g, h, 2 * r_cop


def inequalities(cfg: MpcConfig, dtype, device=None):
    """The lane-constant inequality block (G (mi, n), h (mi,))."""
    g_np, h_np, n_cop = _inequalities_np(cfg)
    g = torch.as_tensor(g_np, dtype=dtype, device=device)
    h = torch.as_tensor(h_np, dtype=dtype, device=device).clone()
    h[:n_cop] = cfg.mu * cfg.lip.h / torch.tensor(np.sqrt(2.0), dtype=dtype)
    return g, h


def assemble(cfg: MpcConfig, x0, ref_traj, foothold_xy, contact_ind,
             dtype=None) -> OcpData:
    """Build the padded NMPC QP per lane.

    x0 (B, 4) LIP state (x, dx, y, dy); ref_traj (B, 4, N); foothold_xy
    (B, 2, 4) world xy per leg (FR, FL, RR, RL); contact_ind (B, 4) 0/1.
    G and h are the lane-constant block, expanded (not copied) over lanes.
    """
    dtype = dtype or x0.dtype
    device = x0.device
    bsz = x0.shape[0]
    n_s, m, N = cfg.n_state, cfg.n_input, cfg.horizon
    nN, mN, n = n_s * N, m * N, cfg.num_dec
    me = cfg.n_eq
    ci = contact_ind.to(dtype)
    ad_np, bd_np = lip.discrete(cfg.lip)
    ad = torch.as_tensor(ad_np, dtype=dtype, device=device)

    p_diag, c = cost(cfg, ref_traj.to(dtype), ci)
    P = torch.diag_embed(p_diag)

    # LIP rollout rows (Abig - I) x + Bbig u = -Abigx0 x0
    shift = np.eye(N, k=-1)
    a_dyn = np.kron(shift, ad_np) - np.eye(nN)
    b_dyn = np.kron(np.eye(N), bd_np)
    a_eq = torch.zeros(bsz, me, n, dtype=dtype, device=device)
    b_eq = torch.zeros(bsz, me, dtype=dtype, device=device)
    a_eq[:, :nN, :nN] = torch.as_tensor(a_dyn, dtype=dtype, device=device)
    a_eq[:, :nN, nN:nN + mN] = torch.as_tensor(b_dyn, dtype=dtype,
                                               device=device)
    b_eq[:, :n_s] = -(x0.to(dtype) @ ad.T)

    # COP = foothold combination: u_k - Fp lambda_k = 0
    fp = foothold_xy.to(dtype) * ci[:, None, :]              # (B, 2, 4)
    eye_m = torch.eye(m, dtype=dtype, device=device)
    for k in range(N):
        rows = slice(nN + k * m, nN + (k + 1) * m)
        a_eq[:, rows, nN + k * m:nN + (k + 1) * m] = eye_m
        a_eq[:, rows, nN + mN + 4 * k:nN + mN + 4 * (k + 1)] = -fp
    # sum(lambda_k) = 1 over present legs
    for k in range(N):
        a_eq[:, nN + mN + k, nN + mN + 4 * k:nN + mN + 4 * (k + 1)] = ci
        b_eq[:, nN + mN + k] = 1.0

    g, h = inequalities(cfg, dtype, device)
    return OcpData(P, c, a_eq, b_eq, g.expand(bsz, -1, -1),
                   h.expand(bsz, -1))


def unpack(cfg: MpcConfig, x):
    """Split decision vectors (..., n) into (states (..., N, 4), inputs
    (..., N, 2), lambda, slack)."""
    n_s, m, N = cfg.n_state, cfg.n_input, cfg.horizon
    nN, mN = n_s * N, m * N
    states = x[..., :nN].reshape(*x.shape[:-1], N, n_s)
    inputs = x[..., nN:nN + mN].reshape(*x.shape[:-1], N, m)
    lam = x[..., nN + mN:nN + mN + cfg.n_lambda]
    slack = x[..., -1]
    return states, inputs, lam, slack


@functools.lru_cache(maxsize=None)
def _rollout_operators(cfg: MpcConfig):
    """(Sx (nN, n_s), Su (nN, mN)) with the state knots x = Sx x0 + Su u."""
    n_s, m, N = cfg.n_state, cfg.n_input, cfg.horizon
    ad, bd = lip.discrete(cfg.lip)
    pows = [np.eye(n_s)]
    for _ in range(N):
        pows.append(pows[-1] @ ad)                 # pows[i] = Ad^i
    sx = np.concatenate([pows[k + 1] for k in range(N)], axis=0)
    su = np.zeros((n_s * N, m * N))
    for k in range(N):
        for j in range(k + 1):
            su[k * n_s:(k + 1) * n_s, j * m:(j + 1) * m] = pows[k - j] @ bd
    return sx, su


def _block_diag(block, count: int):
    """kron(I_count, block) per lane: (B, r, c) -> (B, count*r, count*c)."""
    bsz, r, c = block.shape
    eye = torch.eye(count, dtype=block.dtype, device=block.device)
    return torch.einsum("de,bij->bdiej", eye, block).reshape(
        bsz, count * r, count * c)


def expansion(cfg: MpcConfig, x0, foothold_xy, contact_ind, dtype=None):
    """Affine expansion of the condensed decision space, per lane.

    The dynamics and COP equalities are eliminated in closed form:
    x_full = e0 + E v with v = [lambda (n_lambda), slack]. With
    cfg.elide_simplex each knot's first stance leg's lambda is also
    eliminated through its sum(lambda) = 1 row, leaving n_cond = 13 and no
    equality rows. Returns E (B, num_dec, n_cond), e0 (B, num_dec).
    """
    dtype = dtype or x0.dtype
    device = x0.device
    bsz = x0.shape[0]
    N, n_lam, n = cfg.horizon, cfg.n_lambda, cfg.num_dec
    nN = cfg.n_state * N
    sx_np, su_np = _rollout_operators(cfg)
    sx = torch.as_tensor(sx_np, dtype=dtype, device=device)
    su = torch.as_tensor(su_np, dtype=dtype, device=device)

    ci = contact_ind.to(dtype)
    fp = foothold_xy.to(dtype) * ci[:, None, :]
    efp = _block_diag(fp, N)                        # (B, mN, n_lam)

    def with_zero_col(block):
        return torch.cat([block, block.new_zeros(block.shape[:-1] + (1,))],
                         -1)

    eye_lam = torch.eye(n_lam, dtype=dtype, device=device)
    slack_row = torch.cat([torch.zeros(1, n_lam, dtype=dtype, device=device),
                           torch.ones(1, 1, dtype=dtype, device=device)], -1)
    e_mat = torch.cat([
        with_zero_col(su @ efp),                    # states = Su u
        with_zero_col(efp),                         # inputs = Fp lambda
        with_zero_col(eye_lam).expand(bsz, -1, -1),
        slack_row.expand(bsz, -1, -1),
    ], 1)
    e0 = torch.cat([x0.to(dtype) @ sx.T,
                    torch.zeros(bsz, n - nN, dtype=dtype, device=device)], 1)

    if cfg.elide_simplex:
        t_knot, d_knot = _simplex_elim_maps(ci, dtype)
        n_cond2 = 3 * cfg.ndomain + 1
        t_core = _block_diag(t_knot, cfg.ndomain)   # (B, n_lam, 3*nd)
        t_mat = torch.cat([
            with_zero_col(t_core),
            torch.cat([torch.zeros(bsz, 1, n_cond2 - 1, dtype=dtype,
                                   device=device),
                       torch.ones(bsz, 1, 1, dtype=dtype, device=device)],
                      -1),
        ], 1)
        d_vec = torch.cat([d_knot.repeat(1, cfg.ndomain),
                           torch.zeros(bsz, 1, dtype=dtype, device=device)],
                          1)
        e0 = e0 + (e_mat @ d_vec[:, :, None])[:, :, 0]
        e_mat = e_mat @ t_mat
    return e_mat, e0


def _simplex_order(contact_ind):
    """Per-knot lambda ordering [j*, rest...] with j* the first stance leg.

    torch.argmax returns the first maximal index, as jnp.argmax does, and
    the sort keys are distinct, so the order is the JAX package's."""
    idx = torch.arange(4, device=contact_ind.device)
    j_star = contact_ind.argmax(-1)
    key = torch.where(idx == j_star[:, None], -1, idx)
    return key.argsort(-1)


def _simplex_elim_maps(contact_ind, dtype):
    """(t_knot (B, 4, 3), d_knot (B, 4)) with lambda_k = t_knot v_k + d_knot."""
    ci = contact_ind.to(dtype)
    bsz = ci.shape[0]
    order = _simplex_order(ci)
    pm = F.one_hot(order, 4).to(dtype)              # row r = e_{order[r]}
    s_rest = ci.gather(1, order)[:, 1:]             # kept coords' stance
    eye3 = torch.eye(3, dtype=dtype, device=ci.device).expand(bsz, -1, -1)
    pm_t = pm.transpose(1, 2)
    t_knot = pm_t @ torch.cat([-s_rest[:, None, :], eye3], 1)
    e_first = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=ci.device)
    d_knot = pm_t @ e_first
    return t_knot, d_knot


def contract(cfg: MpcConfig, x_full, contact_ind=None):
    """Condensed coordinates of full decision vectors (B, n) -> (B, n_cond):
    (lambda, slack), or with cfg.elide_simplex the kept lambdas per knot
    (contact_ind (B, 4) sets the elimination order)."""
    nN_mN = (cfg.n_state + cfg.n_input) * cfg.horizon
    lam = x_full[:, nN_mN:nN_mN + cfg.n_lambda]
    if cfg.elide_simplex:
        if contact_ind is None:
            raise ValueError("contract with elide_simplex needs contact_ind")
        bsz = x_full.shape[0]
        keep = _simplex_order(contact_ind.to(x_full.dtype))[:, 1:]
        lam = lam.reshape(bsz, cfg.ndomain, 4).gather(
            2, keep[:, None, :].expand(-1, cfg.ndomain, -1)).reshape(bsz, -1)
    return torch.cat([lam, x_full[:, -1:]], 1)


def condense(cfg: MpcConfig, data: OcpData, e_mat, e0) -> OcpData:
    """Project the assembled QP onto the condensed space x = e0 + E v, per
    lane (E (B, n, n_cond), e0 (B, n) from `expansion`).

    The dynamics and COP equalities hold identically under the expansion,
    so only the sum-lambda rows stay as equalities (me 4); with
    cfg.elide_simplex those hold too and the condensed QP has none (me 0).
    Cost and inequalities are exact affine substitutions.
    """
    nN_mN = (cfg.n_state + cfg.n_input) * cfg.horizon
    e_t = e_mat.mT
    p_c = e_t @ (data.P @ e_mat)
    p_c = 0.5 * (p_c + p_c.mT)
    c_c = _matvec(e_t, data.c + _matvec(data.P, e0))
    if cfg.elide_simplex:
        bsz, n_c = e_mat.shape[0], e_mat.shape[-1]
        a_c = e_mat.new_zeros(bsz, 0, n_c)
        b_c = e_mat.new_zeros(bsz, 0)
    else:
        a_keep = data.A[:, nN_mN:]
        a_c = a_keep @ e_mat
        b_c = data.b[:, nN_mN:] - _matvec(a_keep, e0)
    g_c, h_c = condense_rows(data.G, data.h, e_mat, e0)
    return OcpData(p_c, c_c, a_c, b_c, g_c, h_c)


def condense_rows(rows, rhs, e_mat, e0):
    """Project inequality rows (B, r, n) . x <= rhs (B, r) onto the condensed
    space: (rows E) v <= rhs - rows . e0."""
    return rows @ e_mat, rhs - _matvec(rows, e0)


def _matvec(m, v):
    return (m @ v[:, :, None])[:, :, 0]


def expand(e_mat, e0, v):
    """Full decision vectors from condensed ones: e0 + E v, per lane."""
    return e0 + _matvec(e_mat, v)


def default_footholds(agent_initial, dtype=None):
    """Nominal stance footholds before locomotion starts: the initial
    footprint plus the agent's start xy. (..., 2) -> (..., 2, 4)."""
    dtype = dtype or agent_initial.dtype
    init = torch.tensor(
        [[0.2188, 0.2188, -0.1472, -0.1472], [-0.1320, 0.1320, -0.1320, 0.1320]],
        dtype=dtype, device=agent_initial.device,
    )
    return init + agent_initial.to(dtype)[..., :, None]
