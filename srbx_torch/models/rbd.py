"""Rigid-body algorithms for floating-base kinematic trees, batched.

Counterpart of `srbx/models/rbd.py`, same coordinates: q = [base position
(3), base XYZ-Euler angles (3), joint angles], and qd = dq/dt (Euler-angle
rates, not the world angular velocity). Forward kinematics is the only
recursion; the positional Jacobians are analytic (cross products), and the
gravity vector, Coriolis bias, J̇q̇ terms and site velocities/forces come from
it by automatic differentiation with `torch.func` (`grad`, `jvp`, `vjp`);
the Coriolis bias differentiates the analytic mass matrix (see
`bias_forces`).

Every function takes q (and qd) with any leading lane axes, (..., nq). The
lanes are independent, so a gradient of the sum over lanes is each lane's
own gradient: no `vmap` is needed. The tree is walked one depth level at a
time (all hips, then all thighs, then all calves of the A1), and frames are
kept stacked, (..., 1 + n_links, 3, 3), and gathered with `index_select`,
so a forward kinematics pass is a few batched operations per level instead
of a few per link (each operation costs a kernel launch and, under
torch.func, its transforms' dispatch).

The model is static data; its constant tensors are built once per
(model, dtype, device) and cached.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, jvp, vjp

from srbx_torch.utils import transforms as tf


@dataclasses.dataclass(frozen=True)
class Link:
    """One moving link: a revolute joint connecting it to its parent."""

    name: str
    parent: int              # index into links; -1 = base
    joint_origin: tuple      # xyz of the joint in the parent frame
    joint_axis: tuple        # rotation axis in the local frame
    mass: float
    com: tuple               # com offset in the link frame
    inertia: tuple           # (ixx, ixy, ixz, iyy, iyz, izz) about the com
    point_masses: tuple = ()  # ((mass, (x, y, z)), ...) rigidly attached


@dataclasses.dataclass(frozen=True)
class Model:
    """Floating-base tree. The base link's index is -1."""

    base_mass: float
    base_com: tuple
    base_inertia: tuple
    links: tuple             # tuple[Link]
    sites: tuple             # ((name, link_index, offset_xyz), ...)
    g: float = 9.81

    @property
    def nq(self) -> int:
        return 6 + len(self.links)

    def total_mass(self) -> float:
        m = self.base_mass
        for link in self.links:
            m += link.mass + sum(pm[0] for pm in link.point_masses)
        return m


def _inertia_tensor(i6):
    ixx, ixy, ixz, iyy, iyz, izz = i6
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


def _link_ancestors(model: Model) -> np.ndarray:
    """(n_links, n_links) bool: anc[i, j] <=> joint j moves link i."""
    nl = len(model.links)
    anc = np.zeros((nl, nl), bool)
    for i in range(nl):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = model.links[j].parent
    return anc


def _body_masses(model: Model) -> np.ndarray:
    out = [model.base_mass]
    for link in model.links:
        out.append(link.mass)
        out.extend(pm[0] for pm in link.point_masses)
    return np.asarray(out)


def _body_link_map(model: Model) -> np.ndarray:
    """Link carrying each mass body of com_positions' order (base = -1,
    then each link followed by its point masses)."""
    out = [-1]
    for i, link in enumerate(model.links):
        out.append(i)
        out.extend(i for _ in link.point_masses)
    return np.asarray(out)


class _Level(NamedTuple):
    """The links at one depth of the tree."""

    idx: torch.Tensor        # link ids
    parent_pos: torch.Tensor  # each one's parent in computation order
    k_axis: torch.Tensor     # (nd, 3, 3) hat(joint axis)
    k_axis2: torch.Tensor    # (nd, 3, 3) hat(joint axis)^2
    origins: torch.Tensor    # (nd, 3) joint origins in the parent frame


class _Consts(NamedTuple):
    """A model's constant tensors in one dtype on one device (indices too:
    indexing with a host list would copy it to the card on every call)."""

    levels: tuple            # _Level per depth, root first
    frame_order: torch.Tensor  # computation position of frame 0, 1 + i, ...
    axes: torch.Tensor       # (nl, 3) joint axes
    parent_frames: torch.Tensor  # frame id of each link's parent (0 = base)
    body_frames: torch.Tensor  # frame id of each mass body
    body_offsets: torch.Tensor  # (nb, 3) body com offsets in their frame
    masses: torch.Tensor     # (nb,)
    inertias: torch.Tensor   # (1 + nl, 3, 3) base and link inertias
    site_frames: torch.Tensor  # frame id of each site
    site_offsets: torch.Tensor  # (ns, 3)
    site_mask: torch.Tensor  # (ns, nl) joint j moves site s
    body_mask: torch.Tensor  # (nb, nl) joint j moves body b
    ang_mask: torch.Tensor   # (1 + nl, nl) joint j turns frame k
    eye3: torch.Tensor


@functools.lru_cache(maxsize=None)
def _consts(model: Model, dtype: torch.dtype, device: torch.device) -> _Consts:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    nl = len(model.links)
    depth = []
    for link in model.links:
        depth.append(0 if link.parent < 0 else depth[link.parent] + 1)
    axes = np.asarray([link.joint_axis for link in model.links], np.float64)
    k_axis = np.stack([np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                                 [-a[1], a[0], 0.0]]) for a in axes])
    origins = np.asarray([link.joint_origin for link in model.links])

    def index(ids):
        return torch.as_tensor(ids, dtype=torch.long, device=device)

    levels, order = [], [0]            # order: computed frames, by frame id
    for d in range(max(depth) + 1 if depth else 0):
        ids = [i for i in range(nl) if depth[i] == d]
        parents = [order.index(model.links[i].parent + 1) for i in ids]
        levels.append(_Level(index(ids), index(parents), t(k_axis[ids]),
                             t(k_axis[ids] @ k_axis[ids]), t(origins[ids])))
        order += [1 + i for i in ids]
    anc = _link_ancestors(model)
    body_links = _body_link_map(model)
    offsets = [model.base_com]
    for link in model.links:
        offsets.append(link.com)
        offsets.extend(pm[1] for pm in link.point_masses)

    def mask(link_ids):
        m = np.zeros((len(link_ids), nl), bool)
        for b, li in enumerate(link_ids):
            if li >= 0:
                m[b] = anc[li]
        return t(m)

    site_links = [li for _, li, _ in model.sites]
    inertias = [_inertia_tensor(model.base_inertia)] + [
        _inertia_tensor(link.inertia) for link in model.links]
    return _Consts(
        levels=tuple(levels),
        frame_order=index([order.index(f) for f in range(nl + 1)]),
        axes=t(axes),
        parent_frames=index([link.parent + 1 for link in model.links]),
        body_frames=index([li + 1 for li in body_links]),
        body_offsets=t(offsets),
        masses=t(_body_masses(model)),
        inertias=t(np.stack(inertias)),
        site_frames=index([li + 1 for li in site_links]),
        site_offsets=t([off for _, _, off in model.sites]),
        site_mask=mask(site_links),
        body_mask=mask(body_links),
        ang_mask=t(np.concatenate([np.zeros((1, nl), bool), anc])),
        eye3=torch.eye(3, dtype=dtype, device=device),
    )


def _c(model: Model, q) -> _Consts:
    return _consts(model, q.dtype, q.device)


def euler_rate_matrix(eul):
    """E with w_world = E(eul) @ d(eul)/dt for the XYZ convention."""
    r, p = eul[..., 0], eul[..., 1]
    sr, cr = torch.sin(r), torch.cos(r)
    sp, cp = torch.sin(p), torch.cos(p)
    one = torch.ones_like(r)
    zero = torch.zeros_like(r)
    return torch.stack([
        torch.stack([one, zero, sp], -1),
        torch.stack([zero, cr, -sr * cp], -1),
        torch.stack([zero, sr, cr * cp], -1),
    ], -2)


def _mv(m, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return (m @ v[..., None])[..., 0]


def link_frames(model: Model, q):
    """World rotation and joint-origin position of the base and every link.

    Returns (rots (..., 1 + nl, 3, 3), pos (..., 1 + nl, 3)): frame 0 is
    the base, frame 1 + i link i's frame at its joint origin (the JAX
    package returns the same frames as lists)."""
    k = _c(model, q)
    r = tf.rot_xyz(q[..., 3:6])[..., None, :, :]
    p = q[..., None, 0:3]
    joints = q[..., 6:]
    for lv in k.levels:
        pr = r.index_select(-3, lv.parent_pos)               # (..., nd, 3, 3)
        pp = p.index_select(-2, lv.parent_pos)               # (..., nd, 3)
        ang = joints.index_select(-1, lv.idx)[..., None, None]
        rot = k.eye3 + torch.sin(ang) * lv.k_axis \
            + (1.0 - torch.cos(ang)) * lv.k_axis2
        r = torch.cat([r, pr @ rot], -3)
        p = torch.cat([p, pp + _mv(pr, lv.origins)], -2)
    return r.index_select(-3, k.frame_order), p.index_select(-2, k.frame_order)


def _points(rots, pos, frames, offsets):
    return pos.index_select(-2, frames) + _mv(rots.index_select(-3, frames),
                                              offsets)


def site_positions(model: Model, q):
    """(..., n_sites, 3) world positions of the model's named sites."""
    rots, pos = link_frames(model, q)
    k = _c(model, q)
    return _points(rots, pos, k.site_frames, k.site_offsets)


def com_positions(model: Model, q):
    """(..., n_bodies, 3) world com of the base, links and point masses."""
    rots, pos = link_frames(model, q)
    k = _c(model, q)
    return _points(rots, pos, k.body_frames, k.body_offsets)


def _joint_axes_world(model: Model, rots):
    """(..., n_links, 3) world joint axes."""
    k = _c(model, rots)
    return _mv(rots.index_select(-3, k.parent_frames), k.axes)


def link_ang_velocities(model: Model, q, qd):
    """(..., 1 + n_links, 3) world angular velocity of the base and links."""
    k = _c(model, q)
    rots, _ = link_frames(model, q)
    axes = _joint_axes_world(model, rots)
    w = _mv(euler_rate_matrix(q[..., 3:6]), qd[..., 3:6])[..., None, :]
    joint_rates = qd[..., 6:]
    for lv in k.levels:
        w = torch.cat([w, w.index_select(-2, lv.parent_pos)
                       + axes.index_select(-2, lv.idx)
                       * joint_rates.index_select(-1, lv.idx)[..., None]], -2)
    return w.index_select(-2, k.frame_order)


def _point_jacobians(model: Model, q, rots, pos, points, mask):
    """Analytic positional Jacobians (..., np, 3, nq) of world points
    rigidly attached to links; mask (np, nl) marks the joints that move
    each point. Columns: base translation I3; base Euler rates E_k x r
    about the base origin; revolute joint j: a_j x (point - p_j)."""
    k = _c(model, q)
    axes = _joint_axes_world(model, rots)                   # (..., nl, 3)
    jpos = pos[..., 1:, :]                                  # (..., nl, 3)
    r_j = points[..., :, None, :] - jpos[..., None, :, :]   # (..., np, nl, 3)
    jv_joint = torch.linalg.cross(axes[..., None, :, :].expand(r_j.shape),
                                  r_j) * mask[:, :, None]
    e_cols = euler_rate_matrix(q[..., 3:6]).transpose(-1, -2)   # (..., 3, 3)
    r_b = points - pos[..., 0:1, :]                         # (..., np, 3)
    jv_eul = torch.linalg.cross(
        e_cols[..., None, :, :].expand(r_b.shape[:-1] + (3, 3)),
        r_b[..., :, None, :].expand(r_b.shape[:-1] + (3, 3)))
    jv_trans = k.eye3.expand(r_b.shape[:-1] + (3, 3))
    jv = torch.cat([jv_trans, jv_eul, jv_joint], -2)         # (..., np, nq, 3)
    return jv.transpose(-1, -2)


def _link_ang_jacobians(model: Model, q, rots):
    """(..., 1 + n_links, 3, nq) world angular-velocity Jacobians."""
    k = _c(model, q)
    nb = 1 + len(model.links)
    axes = _joint_axes_world(model, rots)                   # (..., nl, 3)
    jw_joint = axes[..., None, :, :] * k.ang_mask[:, :, None]
    e_cols = euler_rate_matrix(q[..., 3:6]).transpose(-1, -2)
    shape = e_cols.shape[:-2] + (nb, 3, 3)
    jw = torch.cat([torch.zeros(shape, dtype=q.dtype, device=q.device),
                    e_cols[..., None, :, :].expand(shape), jw_joint], -2)
    return jw.transpose(-1, -2)


def mass_matrix(model: Model, q):
    """D(q) = sum m Jv'Jv + Jw' I_world Jw over analytic body Jacobians."""
    k = _c(model, q)
    rots, pos = link_frames(model, q)
    cs = _points(rots, pos, k.body_frames, k.body_offsets)
    jv = _point_jacobians(model, q, rots, pos, cs, k.body_mask)
    d = torch.einsum("b,...bin,...bim->...nm", k.masses, jv, jv)
    jw = _link_ang_jacobians(model, q, rots)
    i_world = rots @ k.inertias @ rots.transpose(-1, -2)    # (..., nb, 3, 3)
    return d + torch.einsum("...kin,...kij,...kjm->...nm", jw, i_world, jw)


def potential_energy(model: Model, q):
    k = _c(model, q)
    return model.g * (k.masses * com_positions(model, q)[..., 2]).sum(-1)


def gravity_vector(model: Model, q):
    """G(q) = dPE/dq."""
    return grad(lambda qq: potential_energy(model, qq).sum())(q)


def kinetic_energy(model: Model, q, qd):
    """1/2 qd' D qd from the body velocities (a jvp of the com positions and
    the angular-velocity recursion), never forming D."""
    k = _c(model, q)
    _, com_v = jvp(lambda qq: com_positions(model, qq), (q,), (qd,))
    ke = 0.5 * (k.masses * (com_v * com_v).sum(-1)).sum(-1)
    ws = link_ang_velocities(model, q, qd)                  # (..., nb, 3)
    rots, _ = link_frames(model, q)
    wl = (rots.transpose(-1, -2) @ ws[..., None])[..., 0]   # body frame
    return ke + 0.5 * torch.einsum("...ki,kij,...kj->...", wl, k.inertias, wl)


def bias_forces(model: Model, q, qd, include_coriolis: bool = True):
    """H(q, qd) = C(q, qd) qd + G(q), with C qd = d/dt(dT/dqd)|_{qdd=0} -
    dT/dq. With p = D(q) qd that is D'(q)[qd] qd - 1/2 qd' dD/dq qd: one
    jvp and one vjp of the analytic mass matrix. (The JAX package takes
    the same identity through forward-over-reverse AD of the kinetic
    energy; that nesting costs four times as much dispatch in eager
    PyTorch, and both agree to rounding.)"""
    g = gravity_vector(model, q)
    if not include_coriolis:
        return g

    def crba(qq):
        return mass_matrix(model, qq)

    _, d_dot = jvp(crba, (q,), (qd,))
    p_dot = (d_dot @ qd[..., None])[..., 0]
    _, pull = vjp(crba, q)
    dt_dq = pull(0.5 * qd[..., :, None] * qd[..., None, :])[0]
    return p_dot - dt_dq + g


def site_jacobians(model: Model, q):
    """(..., n_sites, 3, nq) positional Jacobians of all sites."""
    k = _c(model, q)
    rots, pos = link_frames(model, q)
    pts = _points(rots, pos, k.site_frames, k.site_offsets)
    return _point_jacobians(model, q, rots, pos, pts, k.site_mask)


def site_jacobians_and_jdot_qd(model: Model, q, qd):
    """(site_jacobians, site_jdot_qd) from one jvp of the Jacobians."""
    jac, jdot = jvp(lambda qq: site_jacobians(model, qq), (q,), (qd,))
    return jac, torch.einsum("...sin,...n->...si", jdot, qd)


def site_jdot_qd(model: Model, q, qd):
    """(..., n_sites, 3) J̇ qd of each site: a jvp of the Jacobians."""
    return site_jacobians_and_jdot_qd(model, q, qd)[1]


def site_velocities(model: Model, q, qd):
    """(..., n_sites, 3) world site velocities: one jvp of the kinematics."""
    return jvp(lambda qq: site_positions(model, qq), (q,), (qd,))[1]


def apply_site_forces(model: Model, q, f_sites):
    """sum_s J_s' f_s through one vjp of the site kinematics."""
    _, pull = vjp(lambda qq: site_positions(model, qq), q)
    return pull(f_sites)[0]


def forward_dynamics(model: Model, q, qd, tau, f_ext_sites=None, d=None):
    """qdd = D^-1 (tau + sum J' f_ext - H) for lanes (B, nq), each lane's D
    factored by LAPACK's Cholesky (`torch.linalg.cholesky_ex`, then
    `torch.cholesky_solve`), as the JAX package's per-lane
    `forward_dynamics` does with `cho_factor` / `cho_solve`; a lane whose
    D does not factor comes out NaN there and here.

    d: optional precomputed (B, nq, nq) mass matrices at q."""
    if d is None:
        d = mass_matrix(model, q)
    rhs = tau - bias_forces(model, q, qd)
    if f_ext_sites is not None:
        rhs = rhs + apply_site_forces(model, q, f_ext_sites)
    l, info = torch.linalg.cholesky_ex(d)
    l = torch.where((info > 0)[..., None, None], torch.nan, l)
    return torch.cholesky_solve(rhs[..., None], l)[..., 0]


def forward_dynamics_batch(model: Model, q, qd, tau, f_ext_sites=None,
                           d=None):
    """qdd = D^-1 (tau + sum J' f_ext - H) for lanes (B, nq); the SPD solve
    runs through `srbx_torch.ops.spd.solve` (kernel K2a on the card).

    d: optional precomputed (B, nq, nq) mass matrices at q. The JAX
    package's `backend` and `tile` are not taken: they choose spd.solve's
    route there, the TPU kernel or jax.scipy's Cholesky (a library path);
    here K2a is the only route on the card. `forward_dynamics` is the
    per-lane LAPACK form that the JAX package's "xla" loops take."""
    from srbx_torch.ops import spd

    if d is None:
        d = mass_matrix(model, q)
    rhs = tau - bias_forces(model, q, qd)
    if f_ext_sites is not None:
        rhs = rhs + apply_site_forces(model, q, f_ext_sites)
    return spd.solve(d, rhs)
