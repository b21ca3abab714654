"""Properties that srbx_torch's whole-body modules must have whatever the JAX
package computes: identities of the rigid-body model, the algebra of the
rotation helpers and the Bezier and cubic curves, the SPD plain versions
against `torch.linalg`, the general fused IPM's KKT conditions, and the
ground contact model's friction cone.

Torch only, float64 on the CPU; inputs from numpy seeds. Bounds are
relative to max(1, |value|): 1e-10 for identities that hold exactly in
exact arithmetic (rounding of a few hundred operations), 1e-6 where a
central finite difference with step 1e-5 stands for a derivative (its
truncation error is about step^2 times the third derivative).
"""

import numpy as np
import pytest
import torch

from srbx_torch.config import QpConfig
from srbx_torch.models import a1, rbd
from srbx_torch.ops import bezier as bz
from srbx_torch.ops import qp_fused, spd
from srbx_torch.sim import wholebody as wb
from srbx_torch.utils import transforms as tf

torch.set_num_threads(1)

M = a1.model()
SEEDS = [0, 1, 2]
STEP = 1e-5


def _state(seed, bsz=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bsz, 18)) * 0.4
    q[:, 2] += 0.3
    return torch.tensor(q), torch.tensor(rng.normal(size=(bsz, 18)))


def _close(got, want, tol=1e-10):
    err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
    assert err <= tol, f"{err:.3e} > {tol:.0e}"


def _fd(fn, x, dx):
    """Central difference of fn at x along dx."""
    return (fn(x + STEP * dx) - fn(x - STEP * dx)) / (2 * STEP)


# ------------------------------ rigid body -------------------------------- #

@pytest.mark.parametrize("seed", SEEDS)
def test_mass_matrix_is_symmetric_positive_definite(seed):
    q, _ = _state(seed)
    d = rbd.mass_matrix(M, q)
    _close(d, d.transpose(1, 2), 1e-12)
    assert torch.linalg.eigvalsh(d).min() > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_kinetic_energy_is_the_mass_matrix_quadratic_form(seed):
    q, qd = _state(seed)
    d = rbd.mass_matrix(M, q)
    _close(rbd.kinetic_energy(M, q, qd),
           0.5 * torch.einsum("bi,bij,bj->b", qd, d, qd))


@pytest.mark.parametrize("seed", SEEDS)
def test_site_velocities_are_the_jacobian_times_qd(seed):
    q, qd = _state(seed)
    _close(rbd.site_velocities(M, q, qd),
           torch.einsum("bsin,bn->bsi", rbd.site_jacobians(M, q), qd))


@pytest.mark.parametrize("seed", SEEDS)
def test_site_forces_map_through_the_jacobian_transpose(seed):
    q, _ = _state(seed)
    f = torch.tensor(np.random.default_rng(seed + 10).normal(
        size=(q.shape[0], len(M.sites), 3)) * 20.0)
    _close(rbd.apply_site_forces(M, q, f),
           torch.einsum("bsin,bsi->bn", rbd.site_jacobians(M, q), f))


@pytest.mark.parametrize("seed", SEEDS)
def test_jdot_qd_is_the_jacobian_rate_times_qd(seed):
    q, qd = _state(seed)
    jdot = _fd(lambda qq: rbd.site_jacobians(M, qq), q, qd)
    _close(rbd.site_jdot_qd(M, q, qd),
           torch.einsum("bsin,bn->bsi", jdot, qd), 1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_coriolis_power_is_half_the_mass_matrix_rate(seed):
    """qd' C(q, qd) qd = qd' D'(q) qd / 2, the skew property's energy form,
    with C qd = H - G."""
    q, qd = _state(seed)
    c_qd = rbd.bias_forces(M, q, qd) - rbd.gravity_vector(M, q)
    d_dot = _fd(lambda qq: rbd.mass_matrix(M, qq), q, qd)
    _close((qd * c_qd).sum(1),
           0.5 * torch.einsum("bi,bij,bj->b", qd, d_dot, qd), 1e-6)


def test_gravity_holds_the_whole_mass_on_the_base_height():
    q, qd = _state(3)
    g = rbd.gravity_vector(M, q)
    _close(g[:, 2], torch.full_like(g[:, 2], M.total_mass() * M.g), 1e-12)
    _close(g[:, 0:2], torch.zeros_like(g[:, 0:2]), 1e-12)
    _close(rbd.bias_forces(M, q, qd, include_coriolis=False), g, 0.0)


# ------------------------------ transforms -------------------------------- #

def _angles(seed, scale=0.6):
    return torch.tensor(np.random.default_rng(seed).normal(size=(4, 3))
                        * scale)


@pytest.mark.parametrize("seed", SEEDS)
def test_rot_xyz_is_a_rotation(seed):
    r = tf.rot_xyz(_angles(seed))
    _close(r @ r.transpose(1, 2), torch.eye(3).expand_as(r).double(), 1e-12)
    _close(torch.linalg.det(r), torch.ones(r.shape[0]).double(), 1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_hat_is_the_cross_product_and_vee_its_inverse(seed):
    a, b = _angles(seed), _angles(seed + 5)
    _close(tf.hat(a) @ b[..., None], torch.linalg.cross(a, b)[..., None],
           1e-12)
    _close(tf.vee(tf.hat(a)), a, 0.0)


@pytest.mark.parametrize("scale", [1.0, 1e-7])
def test_rodrigues_is_the_matrix_exponential(scale):
    a = _angles(4, scale)
    _close(tf.rodrigues(a), torch.linalg.matrix_exp(tf.hat(a)), 1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_quaternions_round_trip_with_euler_angles(seed):
    e = _angles(seed, 0.4)
    quat = tf.xyz_to_quat(e)
    _close(quat.norm(dim=-1), torch.ones(quat.shape[0]).double(), 1e-12)
    _close(tf.quat_to_rot(quat), tf.rot_xyz(e), 1e-12)
    _close(tf.quat_to_xyz(quat), e, 1e-12)
    r = tf.rot_xyz(e)
    v = _angles(seed + 7)
    _close(tf.to_body(tf.to_world(v, r), r), v, 1e-12)


# ------------------------------ curves ------------------------------------ #

@pytest.mark.parametrize("degree", [3, 4, 7])
def test_bezier_endpoints_and_derivatives(degree):
    alpha = torch.tensor(np.random.default_rng(degree).normal(
        size=(2, 3, degree + 1)))
    _close(bz.bezier(alpha, torch.zeros(2, 3).double()), alpha[..., 0], 0.0)
    _close(bz.bezier(alpha, torch.ones(2, 3).double()), alpha[..., -1],
           1e-12)
    s = torch.full((2, 3), 0.37, dtype=torch.float64)
    one = torch.ones_like(s)
    _close(bz.bezier_d(alpha, s), _fd(lambda x: bz.bezier(alpha, x), s, one),
           1e-6)
    _close(bz.bezier_dd(alpha, s),
           _fd(lambda x: bz.bezier_d(alpha, x), s, one), 1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_cubic_meets_its_end_conditions(seed):
    rng = np.random.default_rng(seed)
    p0, pf, v0, vf = (torch.tensor(rng.normal(size=(2, 3)))
                      for _ in range(4))
    t0 = torch.zeros(2, 1, dtype=torch.float64)
    tf_ = torch.full((2, 1), 0.8, dtype=torch.float64)
    args = (t0, tf_, p0, pf, v0, vf)
    _close(bz.cubic(t0, *args), p0, 1e-12)
    _close(bz.cubic(tf_, *args), pf, 1e-12)
    _close(bz.cubic_dot(t0, *args), v0, 1e-12)
    _close(bz.cubic_dot(tf_, *args), vf, 1e-12)
    t = torch.full((2, 1), 0.3, dtype=torch.float64)
    one = torch.ones_like(t)
    _close(bz.cubic_dot(t, *args),
           _fd(lambda x: bz.cubic(x, *args), t, one), 1e-6)
    _close(bz.cubic_dot_dot(t, *args),
           _fd(lambda x: bz.cubic_dot(x, *args), t, one), 1e-6)


# ------------------------------ SPD --------------------------------------- #

def _spd(k, seed, bsz=5):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(bsz, k, k))
    return torch.tensor(a @ a.transpose(0, 2, 1) / k + np.eye(k)), rng


@pytest.mark.parametrize("k", [1, 3, 7, 12, 18, 32])
@pytest.mark.parametrize("op", ["solve_r1", "solve_r5", "inverse"])
def test_plain_spd_matches_torch_linalg(op, k):
    """1e-12: D's condition here is below 1e2."""
    d, rng = _spd(k, k)
    if op == "inverse":
        _close(spd.inverse_plain(d), torch.linalg.inv(d), 1e-12)
        return
    r = 1 if op == "solve_r1" else 5
    rhs = torch.tensor(rng.normal(size=(d.shape[0], k, r)))
    if r == 1:
        _close(spd.solve_plain(d, rhs[..., 0]),
               torch.linalg.solve(d, rhs)[..., 0], 1e-12)
    else:
        _close(spd.solve_plain(d, rhs), torch.linalg.solve(d, rhs), 1e-12)


# ---------------------------- general IPM --------------------------------- #

@pytest.mark.parametrize("shape", [(6, 2, 5), (43, 30, 45)],
                         ids=["small", "ll"])
@pytest.mark.parametrize("seed", [0, 1])
def test_general_ipm_meets_the_kkt_conditions(shape, seed):
    """On random feasible QPs: converged, and x, y, z, s satisfy the stopping
    test when it is recomputed from them (1.000001 of its limits), with
    s, z > 0."""
    n, me, mi = shape
    rng = np.random.default_rng(seed)
    bsz = 4
    p = np.zeros((bsz, n, n))
    p[:, np.arange(n), np.arange(n)] = rng.uniform(0.1, 10.0, (bsz, n))
    a = rng.normal(size=(bsz, me, n))
    g = rng.normal(size=(bsz, mi, n))
    xf = rng.normal(size=(bsz, n))
    qp = [torch.tensor(v) for v in (
        p, rng.normal(size=(bsz, n)), a, np.einsum("bmn,bn->bm", a, xf), g,
        np.einsum("bmn,bn->bm", g, xf) + rng.uniform(0.1, 1.0, (bsz, mi)))]
    cfg = QpConfig()
    sol = qp_fused.solve_plain(*qp, cfg)
    assert bool(sol.converged.all())
    assert bool((sol.s > 0).all() and (sol.z > 0).all())
    P, c, A, b, G, h = qp
    px = torch.einsum("bij,bj->bi", P, sol.x)
    gtz = torch.einsum("bij,bi->bj", G, sol.z)
    aty = torch.einsum("bij,bi->bj", A, sol.y)
    ax = torch.einsum("bij,bj->bi", A, sol.x)
    gx = torch.einsum("bij,bj->bi", G, sol.x)

    def amax(*ts):
        return torch.stack([t.abs().amax(1) for t in ts]).amax(0)

    res = torch.maximum(
        amax(px + c + gtz + aty) / amax(px, c, gtz, aty).clamp(min=1.0),
        amax(gx + sol.s - h, ax - b) / amax(gx, h, ax, b).clamp(min=1.0))
    obj = 0.5 * (sol.x * px).sum(1) + (c * sol.x).sum(1)
    slack = 1.0 + 1e-6
    assert bool((res <= (cfg.abstol + cfg.reltol) * slack).all())
    assert bool(((sol.s * sol.z).sum(1)
                 <= cfg.abstol * (1.0 + obj.abs()) * slack).all())
    _close(res, sol.res, 1e-12)


# ------------------------------ contact ----------------------------------- #

@pytest.mark.parametrize("seed", SEEDS)
def test_contact_forces_lie_in_the_friction_cone(seed):
    rng = np.random.default_rng(seed)
    cfg = wb.SimConfig()
    q = wb.default_crouch(M, device="cpu").repeat(6, 1)
    q[:, 2] -= torch.tensor(rng.uniform(-0.002, 0.01, 6))
    q[:, 6:] += torch.tensor(rng.normal(size=(6, 12)) * 0.05)
    qd = torch.tensor(rng.normal(size=(6, 18)) * 0.5)
    f = wb.contact_forces(cfg, M, q, qd)
    toe_z = rbd.site_positions(M, q)[:, a1.TOE_SITES, 2]
    assert bool((f[..., 2] >= 0).all())
    assert bool((f[toe_z > 0] == 0).all())
    assert bool((f[..., 0:2].norm(dim=-1)
                 <= cfg.mu * f[..., 2] * (1 + 1e-12) + 1e-12).all())
    assert bool((f[toe_z < -1e-4][..., 2] > 0).any())


def test_default_crouch_puts_the_lowest_toe_a_millimetre_up():
    q = wb.default_crouch(M, device="cpu")
    toe_z = rbd.site_positions(M, q)[a1.TOE_SITES, 2]
    _close(toe_z.min(), torch.tensor(0.001, dtype=torch.float64), 1e-12)
