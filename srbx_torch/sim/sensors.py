"""Synthetic onboard sensor streams from the whole-body plant, batched over
lanes.

Counterpart of `srbx/sim/sensors.py`: given the true `SimState`, it makes
what an A1's sensors would measure (IMU specific force and angular rate, an
orientation estimate, joint encoders, foot-force sensors) with white noise
and constant per-run biases, so that the estimation stack
(`srbx_torch.estimation.pipeline`) closes the loops with ground truth
confined to the plant. The noise comes from the JAX package's own keys
(`srbx_torch.utils.prng`), split and drawn as it draws them: `init` splits a
lane's key 3 ways (kb, kg, key), `read` 7 ways every tick (key, then one
subkey for each of the six draws of shapes (3,), (3,), (3,), (12,), (12,),
(4,)); a run of the port then sees the JAX package's noise lane by lane.

Conventions as `srbx_torch.models.rbd`: q = [base position, XYZ Euler,
joints], qd = dq/dt. The IMU measures in the body frame: specific force
f_b = R'(a_world + g e_z), angular rate w_b = R' E(eul) d(eul)/dt. Every
field carries a leading lane axis B.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from srbx_torch.models import rbd
from srbx_torch.sim import wholebody as wb
from srbx_torch.utils import prng
from srbx_torch.utils import transforms as tf

_READ_SHAPES = ((3,), (3,), (3,), (12,), (12,), (4,))


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Per-sample (1 kHz) noise standard deviations and bias magnitudes."""

    accel_noise: float = 0.30      # m/s^2 per sample
    gyro_noise: float = 0.02       # rad/s per sample
    accel_bias: float = 0.05       # m/s^2, constant per run
    gyro_bias: float = 0.002       # rad/s, constant per run
    eul_noise: float = 0.002       # rad, onboard orientation-filter error
    enc_noise: float = 5e-4        # rad, joint encoder noise
    encvel_noise: float = 0.02     # rad/s, joint velocity noise
    force_noise: float = 2.0       # N, foot force sensor noise


class SensorState(NamedTuple):
    key: torch.Tensor          # (B, 2) int64 words of the lane's key
    accel_bias: torch.Tensor   # (B, 3) constant per run
    gyro_bias: torch.Tensor    # (B, 3)
    prev_qd: torch.Tensor      # (B, 18) for the accelerometer's difference


class Reading(NamedTuple):
    """One tick of onboard measurements."""

    imu_accel: torch.Tensor    # (B, 3) body-frame specific force
    gyro: torch.Tensor         # (B, 3) body-frame angular velocity
    eul: torch.Tensor          # (B, 3) orientation estimate (XYZ Euler)
    q_joints: torch.Tensor     # (B, 12)
    qd_joints: torch.Tensor    # (B, 12)
    foot_force: torch.Tensor   # (B, 4) normal-force sensor


def init(cfg: SensorConfig, key, qd0) -> SensorState:
    """key (B, 2), qd0 (B, 18): the per-lane biases and the noise key."""
    ks = prng.split(key, 3)
    nb, ng = prng.normals(ks[:, 0:2], ((3,), (3,)), qd0.dtype)
    return SensorState(key=ks[:, 2], accel_bias=cfg.accel_bias * nb,
                       gyro_bias=cfg.gyro_bias * ng, prev_qd=qd0)


def _mv_t(rot, v):
    """rot' v for (B, 3, 3) and (B, 3)."""
    return (rot.transpose(-1, -2) @ v[..., None])[..., 0]


def read(cfg: SensorConfig, sim_cfg: wb.SimConfig, model: rbd.Model,
         state: SensorState, sim: wb.SimState
         ) -> tuple[SensorState, Reading]:
    """Measure one tick, after `wholebody.step_batch`: the accelerometer
    reads the mean specific force over the elapsed tick (a difference of
    the base velocity), as a sampled IMU integrates it."""
    dtype = sim.q.dtype
    ks = prng.split(state.key, 7)
    noise = prng.normals(ks[:, 1:], _READ_SHAPES, dtype)

    eul_true = sim.q[:, 3:6]
    rot = tf.rot_xyz(eul_true)

    # specific force R'(a_w + g e_z), a_w from the base-velocity difference
    a_w = (sim.qd[:, 0:3] - state.prev_qd[:, 0:3]) / sim_cfg.dt
    f_b = _mv_t(rot, torch.cat([a_w[:, 0:2], a_w[:, 2:3] + model.g], 1))
    imu_accel = f_b + state.accel_bias + cfg.accel_noise * noise[0]

    # body angular rate R' w_world, w_world = E(eul) d(eul)/dt
    w_world = (rbd.euler_rate_matrix(eul_true) @ sim.qd[:, 3:6, None])[..., 0]
    gyro = _mv_t(rot, w_world) + state.gyro_bias + cfg.gyro_noise * noise[1]

    eul = eul_true + cfg.eul_noise * noise[2]
    q_joints = sim.q[:, 6:] + cfg.enc_noise * noise[3]
    qd_joints = sim.qd[:, 6:] + cfg.encvel_noise * noise[4]
    force = wb.foot_force_measurement(sim_cfg, model, sim)
    foot_force = torch.clamp(force + cfg.force_noise * noise[5], min=0.0)

    new_state = SensorState(ks[:, 0], state.accel_bias, state.gyro_bias,
                            sim.qd)
    return new_state, Reading(imu_accel, gyro, eul, q_joints, qd_joints,
                              foot_force)
