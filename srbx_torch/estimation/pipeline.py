"""In-the-loop state estimation, batched over lanes: sensors -> (kinEst, KF,
prob-contact) -> the controller's (q_hat, qd_hat).

Counterpart of `srbx/estimation/pipeline.py`. In the deployable topology the
controller never sees ground truth: every 1 ms tick the sensor model
(`srbx_torch.sim.sensors`) measures the plant, kinematic odometry and the
contact-gated KF turn the measurements into base position and velocity,
and the controller consumes

  q_hat  = [base position (kinEst, or the KF), eul (IMU), joints (encoders)]
  qd_hat = [base velocity (likewise), E(eul)^-1 R w_gyro, joint velocities]

Contact gating uses the controller's own contact index of the previous tick
(`set_contact_ind` after each tick), and the probabilistic contact filter
runs alongside. Every field carries a leading lane axis B.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from srbx_torch.estimation import contact as contact_mod
from srbx_torch.estimation import kalman, kinest
from srbx_torch.models import a1, rbd
from srbx_torch.sim import sensors
from srbx_torch.sim import wholebody as wb
from srbx_torch.utils import transforms as tf


@dataclasses.dataclass(frozen=True)
class EstConfig:
    """The JAX package's `EstConfig`, field for field."""

    sensor: sensors.SensorConfig = sensors.SensorConfig()
    # base position and velocity from "kinest" (stance-anchored odometry,
    # the default) or "kf" (the IMU and kinematics filter)
    source: str = "kinest"
    kf_accel_noise: float = 0.5
    kf_meas_noise: float = 1e-5
    kf_swing_noise: float = 1e3
    contact_force_thresh: float = 15.0  # N, as agent.tick_build's


class EstState(NamedTuple):
    sens: sensors.SensorState
    kf: kalman.KfState
    kin: kinest.KinEstState
    p_contact: torch.Tensor     # (B, 4) probabilistic contact posterior
    contact_ind: torch.Tensor   # (B, 4) int32 controller index, last tick
    q_hat: torch.Tensor         # (B, 18) latest estimate
    qd_hat: torch.Tensor        # (B, 18)


class EstOut(NamedTuple):
    q_hat: torch.Tensor         # (B, 18)
    qd_hat: torch.Tensor        # (B, 18)
    foot_force: torch.Tensor    # (B, 4) measured (noisy) foot force
    p_contact: torch.Tensor     # (B, 4)


def init(cfg: EstConfig, model: rbd.Model, sim: wb.SimState,
         key) -> EstState:
    """Estimators at a known start pose; key (B, 2) one key per lane."""
    q, qd = sim.q, sim.qd
    bsz, dtype = q.shape[0], q.dtype
    toes = rbd.site_positions(model, q)[:, a1.TOE_SITES]
    kf = kalman.KfState(
        x=torch.cat([q[:, 0:3], qd[:, 0:3], toes.reshape(bsz, 12)], 1),
        p=(1e-2 * torch.eye(18, dtype=dtype, device=q.device)).expand(
            bsz, 18, 18).clone())
    pinned = torch.cat([torch.zeros_like(q[:, 0:3]), q[:, 3:]], 1)
    kin = kinest.KinEstState(
        com=q[:, 0:3],
        toe_prev=rbd.site_positions(model, pinned)[:, a1.TOE_SITES])
    return EstState(
        sens=sensors.init(cfg.sensor, key, qd), kf=kf, kin=kin,
        p_contact=torch.ones((bsz, 4), dtype=dtype, device=q.device),
        contact_ind=torch.ones((bsz, 4), dtype=torch.int32, device=q.device),
        q_hat=q, qd_hat=qd)


def update(cfg: EstConfig, sim_cfg: wb.SimConfig, model: rbd.Model,
           est: EstState, sim: wb.SimState, phase
           ) -> tuple[EstState, EstOut]:
    """One 1 kHz estimation tick for every lane: measure the plant, run
    kinEst, the KF and the contact filter, assemble (q_hat, qd_hat). phase
    (B,) is the gait phase (the contact filter's prior); `sim` is ground
    truth and is read only through the sensor model."""
    sens, rd = sensors.read(cfg.sensor, sim_cfg, model, est.sens, sim)

    rot = tf.rot_xyz(rd.eul)
    # Euler rates from the gyro: E(eul)^-1 R w_b, a partial-pivoting LU
    # solve as the JAX package's; solve_ex makes no host sync for its check
    eul_rate = torch.linalg.solve_ex(
        rbd.euler_rate_matrix(rd.eul), (rot @ rd.gyro[..., None])[..., 0])[0]

    # base-pinned kinematics on the measured orientation and encoders
    zeros3 = torch.zeros_like(rd.eul)
    q_fk = torch.cat([zeros3, rd.eul, rd.q_joints], 1)
    qd_fk = torch.cat([zeros3, eul_rate, rd.qd_joints], 1)
    toes_rel, toe_vel = kinest.toes_and_velocities(model, q_fk, qd_fk)

    contact_ind = est.contact_ind.to(q_fk.dtype)
    kf = kalman.update(
        est.kf, contact_ind, rd.imu_accel, rot, -toes_rel,
        dt=sim_cfg.dt, accel_noise=cfg.kf_accel_noise,
        meas_noise=cfg.kf_meas_noise, g=model.g,
        swing_noise=cfg.kf_swing_noise)
    kin, kin_com, kin_vel = kinest.update(
        model, est.kin, rd.q_joints, qd_fk, rd.eul, rd.foot_force,
        contact_ind, force_thresh=cfg.contact_force_thresh,
        fk=(toes_rel, toe_vel))

    # the contact filter, on foot heights from the estimated base
    use_kf = cfg.source == "kf"
    base_pos = kf.x[:, 0:3] if use_kf else kin_com
    base_vel = kf.x[:, 3:6] if use_kf else kin_vel
    foot_z = base_pos[:, 2:3] + toes_rel[:, :, 2]
    p_contact = contact_mod.prob_contact_update(
        est.p_contact, rd.foot_force, foot_z, phase)

    q_hat = torch.cat([base_pos, rd.eul, rd.q_joints], 1)
    qd_hat = torch.cat([base_vel, eul_rate, rd.qd_joints], 1)
    new_est = EstState(sens=sens, kf=kf, kin=kin, p_contact=p_contact,
                       contact_ind=est.contact_ind, q_hat=q_hat,
                       qd_hat=qd_hat)
    return new_est, EstOut(q_hat, qd_hat, rd.foot_force, p_contact)


def set_contact_ind(est: EstState, ind) -> EstState:
    """Record the controller's contact index (B, 4) for the next tick's
    gating."""
    return est._replace(contact_ind=ind.to(torch.int32))
