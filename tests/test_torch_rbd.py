"""srbx_torch's rigid-body algorithms and A1 model against the JAX package,
in float64 on the CPU at B = 3 lanes, with the rest of
`utils/transforms` and `ops/bezier`.

Inputs are made with numpy from a seed. The JAX oracle of each bundle is one
jitted, tuple-returning `jax.vmap` of the per-lane JAX functions, with the
inputs as jit arguments; the bundles are split so that each compiles in
under 25 s (the Coriolis bias alone takes 18 s). Tolerance 1e-12 relative to
max(1, |value|): the same arithmetic (forward kinematics, analytic
Jacobians, AD through torch.func), summed in another order;
forward_dynamics_batch 1e-10 (an 18x18 solve, D's condition about 1e3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbx.models import a1 as ja1
from srbx.models import rbd as jrbd
from srbx.ops import bezier as jbz
from srbx.utils import transforms as jtf
from srbx_torch.models import a1, rbd
from srbx_torch.ops import bezier as bz
from srbx_torch.utils import transforms as tf

torch.set_num_threads(1)

TOL = 1e-12
B = 3
RNG = np.random.default_rng(7)
Q = RNG.normal(size=(B, 18)) * 0.4
Q[:, 2] += 0.3
QD = RNG.normal(size=(B, 18))
TAU = RNG.normal(size=(B, 18)) * 5.0
F_SITES = RNG.normal(size=(B, 8, 3)) * 20.0
JM = ja1.model()
M = a1.model()

# bundle -> {name: (JAX per-lane function of (q, qd, tau, f), port call)}
BUNDLES = {
    "kinematics": {
        "site_positions": (lambda q, qd, u, f: jrbd.site_positions(JM, q),
                           lambda q, qd, u, f: rbd.site_positions(M, q)),
        "com_positions": (lambda q, qd, u, f: jrbd.com_positions(JM, q),
                          lambda q, qd, u, f: rbd.com_positions(M, q)),
        "mass_matrix": (lambda q, qd, u, f: jrbd.mass_matrix(JM, q),
                        lambda q, qd, u, f: rbd.mass_matrix(M, q)),
        "site_jacobians": (lambda q, qd, u, f: jrbd.site_jacobians(JM, q),
                           lambda q, qd, u, f: rbd.site_jacobians(M, q)),
        "link_ang_velocities": (
            lambda q, qd, u, f: jrbd.link_ang_velocities(JM, q, qd),
            lambda q, qd, u, f: rbd.link_ang_velocities(M, q, qd)),
        "link_frames_rot": (
            lambda q, qd, u, f: jnp.stack(jrbd.link_frames(JM, q)[0]),
            lambda q, qd, u, f: rbd.link_frames(M, q)[0]),
        "link_frames_pos": (
            lambda q, qd, u, f: jnp.stack(jrbd.link_frames(JM, q)[1]),
            lambda q, qd, u, f: rbd.link_frames(M, q)[1]),
    },
    "energy": {
        "gravity_vector": (lambda q, qd, u, f: jrbd.gravity_vector(JM, q),
                           lambda q, qd, u, f: rbd.gravity_vector(M, q)),
        "kinetic_energy": (
            lambda q, qd, u, f: jrbd.kinetic_energy(JM, q, qd),
            lambda q, qd, u, f: rbd.kinetic_energy(M, q, qd)),
        "bias_forces_no_coriolis": (
            lambda q, qd, u, f: jrbd.bias_forces(JM, q, qd, False),
            lambda q, qd, u, f: rbd.bias_forces(M, q, qd, False)),
    },
    # forward-over-reverse AD of the kinetic energy: the slowest compile
    "dynamics": {
        "bias_forces": (lambda q, qd, u, f: jrbd.bias_forces(JM, q, qd),
                        lambda q, qd, u, f: rbd.bias_forces(M, q, qd)),
    },
    "velocities": {
        "site_jdot_qd": (lambda q, qd, u, f: jrbd.site_jdot_qd(JM, q, qd),
                         lambda q, qd, u, f: rbd.site_jdot_qd(M, q, qd)),
        "site_velocities": (
            lambda q, qd, u, f: jrbd.site_velocities(JM, q, qd),
            lambda q, qd, u, f: rbd.site_velocities(M, q, qd)),
        "apply_site_forces": (
            lambda q, qd, u, f: jrbd.apply_site_forces(JM, q, f),
            lambda q, qd, u, f: rbd.apply_site_forces(M, q, f)),
        "rot_xyz": (lambda q, qd, u, f: jtf.rot_xyz(q[3:6]),
                    lambda q, qd, u, f: tf.rot_xyz(q[:, 3:6])),
        "hat": (lambda q, qd, u, f: jtf.hat(qd[0:3]),
                lambda q, qd, u, f: tf.hat(qd[:, 0:3])),
        "quat_to_rot": (lambda q, qd, u, f: jtf.quat_to_rot(qd[0:4]),
                        lambda q, qd, u, f: tf.quat_to_rot(qd[:, 0:4])),
    },
    # the rest of utils/transforms and ops/bezier, per lane
    "transforms_bezier": {
        "quat_to_xyz": (
            lambda q, qd, u, f: jtf.quat_to_xyz(
                qd[0:4] / jnp.linalg.norm(qd[0:4])),
            lambda q, qd, u, f: tf.quat_to_xyz(
                qd[:, 0:4] / qd[:, 0:4].norm(dim=-1, keepdim=True))),
        "xyz_to_quat": (lambda q, qd, u, f: jtf.xyz_to_quat(q[3:6]),
                        lambda q, qd, u, f: tf.xyz_to_quat(q[:, 3:6])),
        "to_world": (
            lambda q, qd, u, f: jtf.to_world(qd[0:3], jtf.rot_xyz(q[3:6])),
            lambda q, qd, u, f: tf.to_world(qd[:, 0:3],
                                            tf.rot_xyz(q[:, 3:6]))),
        "to_body": (
            lambda q, qd, u, f: jtf.to_body(qd[0:3], jtf.rot_xyz(q[3:6])),
            lambda q, qd, u, f: tf.to_body(qd[:, 0:3],
                                           tf.rot_xyz(q[:, 3:6]))),
        "vee": (lambda q, qd, u, f: jtf.vee(f[0:3]),
                lambda q, qd, u, f: tf.vee(f[:, 0:3])),
        "rodrigues": (lambda q, qd, u, f: jtf.rodrigues(q[3:6]),
                      lambda q, qd, u, f: tf.rodrigues(q[:, 3:6])),
        "rodrigues_small": (
            lambda q, qd, u, f: jtf.rodrigues(q[3:6] * 1e-7),
            lambda q, qd, u, f: tf.rodrigues(q[:, 3:6] * 1e-7)),
        **{name: (
            lambda q, qd, u, f, name=name: getattr(jbz, name)(
                0.3 * u[0], 0.0, 1.0 + jnp.abs(u[1]), q[0:3], q[3:6],
                qd[0:3], qd[3:6]),
            lambda q, qd, u, f, name=name: getattr(bz, name)(
                0.3 * u[:, 0:1], 0.0, 1.0 + u[:, 1:2].abs(), q[:, 0:3],
                q[:, 3:6], qd[:, 0:3], qd[:, 3:6]))
           for name in ("cubic", "cubic_dot", "cubic_dot_dot")},
        **{name: (
            lambda q, qd, u, f, name=name: getattr(jbz, name)(
                f[0:2], jnp.clip(0.2 * u[2:4], 0.0, 1.0)),
            lambda q, qd, u, f, name=name: getattr(bz, name)(
                f[:, 0:2], (0.2 * u[:, 2:4]).clamp(0.0, 1.0)))
           for name in ("bezier", "bezier_d", "bezier_dd")},
        "varying_bezier": (
            lambda q, qd, u, f: jnp.stack(jbz.varying_bezier(
                f[0:2], f[2:4], f[4:6], 0.4, 0.17)),
            lambda q, qd, u, f: torch.stack(bz.varying_bezier(
                f[:, 0:2], f[:, 2:4], f[:, 4:6],
                torch.tensor(0.4, dtype=f.dtype), 0.17), 1)),
    },
}


def _bundle(name):
    """The JAX bundle's outputs, and the port's, by function name."""
    fns = BUNDLES[name]
    want = jax.jit(jax.vmap(lambda q, qd, u, f: tuple(
        jf(q, qd, u, f) for jf, _ in fns.values())))(
        *(jnp.asarray(a) for a in (Q, QD, TAU, F_SITES)))
    args = [torch.as_tensor(a) for a in (Q, QD, TAU, F_SITES)]
    return {k: (pf(*args).numpy(), np.asarray(w))
            for (k, (_, pf)), w in zip(fns.items(), want)}


def _close(name, got, want, tol=TOL):
    assert got.shape == want.shape, name
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"{name}: {err.max():.3e}"


@pytest.mark.parametrize("bundle", list(BUNDLES))
def test_rbd_matches_jax(bundle):
    """For "dynamics": the Coriolis bias, where the port differentiates the
    mass matrix and the JAX package the kinetic energy."""
    for name, (got, want) in _bundle(bundle).items():
        _close(name, got, want)


def test_forward_dynamics_batch():
    """forward_dynamics_batch through the SPD solve's plain version against
    D^-1 (tau + J' f - H) (D, J' f and H are held to the JAX package's in
    the bundles), with and without a precomputed D."""
    q, qd, u, f = (torch.as_tensor(a) for a in (Q, QD, TAU, F_SITES))
    d = rbd.mass_matrix(M, q).numpy()
    jtf = rbd.apply_site_forces(M, q, f).numpy()
    h = rbd.bias_forces(M, q, qd).numpy()
    want = np.linalg.solve(d, (TAU - h + jtf)[:, :, None])[:, :, 0]
    for d_pre in (None, rbd.mass_matrix(M, q)):
        got = rbd.forward_dynamics_batch(M, q, qd, u, f_ext_sites=f,
                                         d=d_pre).numpy()
        _close("forward_dynamics_batch", got, want, 1e-10)


def test_a1_model_is_the_jax_model():
    """The A1 model is static data, rebuilt in the port: every field of
    every link and site equals the JAX package's."""
    assert dataclasses.asdict(M) == dataclasses.asdict(JM)
    assert M.nq == JM.nq == 18
    assert M.total_mass() == JM.total_mass()
    assert (a1.TOE_SITES, a1.HIP_SITES) == (ja1.TOE_SITES, ja1.HIP_SITES)
    np.testing.assert_array_equal(rbd._body_masses(M), jrbd._body_masses(JM))
    np.testing.assert_array_equal(rbd._link_ancestors(M),
                                  jrbd._link_ancestors(JM))
    np.testing.assert_array_equal(rbd._body_link_map(M),
                                  jrbd._body_link_map(JM))
