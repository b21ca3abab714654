"""The configuration dataclasses of srbx_torch.

The port keeps its own copy of the settings it reads, field for field and
default for default the same as the JAX package's `srbx/config.py`
(tests/test_torch_package.py compares them), so that importing the port
loads nothing of the JAX package. All dataclasses are frozen and hashable.
"""

from __future__ import annotations

import dataclasses
import enum


class Gait(enum.IntEnum):
    """Gait IDs (reference: `include/global_loco_opts.h:38-45`)."""

    STAND = 0
    POSE = 1
    TAP = 2
    INPLACE_WALK = 3
    INPLACE_TROT = 4
    WALK = 5
    TROT = 6
    PACE = 7


TOTAL_DOF = 18  # floating base (6) + 12 actuated joints


@dataclasses.dataclass(frozen=True)
class LipConfig:
    """LIP template model."""

    g: float = 9.81
    h: float = 0.29           # pendulum height
    ts: float = 0.043         # grid time length


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """Event-based NMPC settings."""

    lip: LipConfig = LipConfig()
    n_state: int = 4          # (x, xd, y, yd)
    n_input: int = 2          # COP (ux, uy)
    horizon: int = 4          # N = CTRL_HORIZ * NDOMAIN
    ndomain: int = 4          # grids per domain
    total_steps: int = 700
    q_weight: float = 3e2
    r_weight: float = 1e-1
    p_weight: float = 2e3
    slack_weight: float = 0.3e4
    mu: float = 0.7           # COP box half-width mu*h/sqrt(2)
    box_bound: float = 1e3    # +-1e3 state/input box
    goal: tuple = (10.0, 0.0)
    use_sqp: bool = True      # CBF-SQP stage
    sqp_iters: int = 4
    sqp_linesearch: bool = False
    merit_mu: float = 1e4
    cbf_eps: float = 1.9      # squared-distance safety margin
    vel_sat: float = 0.35     # +-0.35 m/s velocity saturation
    n_obstacles: int = 20
    fail_radius: float = 0.5
    # condensed QP (dynamics and COP equalities eliminated): n 41 -> 17
    condensed: bool = False
    # drop the statically redundant +-box_bound and lambda <= 1 rows
    elide_box_rows: bool = False
    # with `condensed`, eliminate one lambda per knot: n 17 -> 13, me 4 -> 0
    elide_simplex: bool = False

    @property
    def max_contacts(self) -> int:
        return 4

    @property
    def n_lambda(self) -> int:
        """Padded lambda count: ndomain * max_contacts."""
        return self.ndomain * self.max_contacts

    @property
    def num_dec(self) -> int:
        """Padded decision count: n*N + m*N + ndomain*4 + slack."""
        return (self.n_state * self.horizon + self.n_input * self.horizon
                + self.n_lambda + 1)

    @property
    def n_eq(self) -> int:
        """Equality rows: n*N (dynamics) + m*N (COP) + m*N/2 (sum lambda)."""
        nN, mN = self.n_state * self.horizon, self.n_input * self.horizon
        return nN + mN + mN // 2

    @property
    def box_row_range(self) -> tuple:
        """(start, stop) of the +-box_bound rows in the full inequality
        block (order: COP-COM | box | lambda)."""
        nN, mN = self.n_state * self.horizon, self.n_input * self.horizon
        r1 = 2 * self.n_input * (self.horizon - 1)
        return r1, r1 + 2 * nN + 2 * mN

    @property
    def n_ineq(self) -> int:
        """Inequality rows, less the elided ones when elide_box_rows."""
        nN, mN = self.n_state * self.horizon, self.n_input * self.horizon
        full = (2 * self.n_input * (self.horizon - 1) + 2 * nN + 2 * mN
                + 2 * self.n_lambda)
        if self.elide_box_rows:
            full -= 2 * nN + 2 * mN + self.n_lambda
        return full

    @property
    def n_ineq_sqp(self) -> int:
        """SQP subproblem rows: QP rows + 4 CBF + 2*8 velocity."""
        return self.n_ineq + 4 + 16


@dataclasses.dataclass(frozen=True)
class QpConfig:
    """Interior-point solver settings."""

    max_iters: int = 25
    abstol: float = 1e-6
    reltol: float = 1e-6
    reg_primal: float = 1e-9
    reg_dual: float = 1e-9
    kkt_refine_iters: int = 2
    sigma_min: float = 1e-12
    step_frac: float = 0.99
    ruiz_iters: int = 0
    ruiz_clip: float = 0.0


@dataclasses.dataclass(frozen=True)
class LowLevelConfig:
    """1 kHz QP torque controller."""

    mu: float = 0.7
    kp: float = 400.0
    kd: float = 40.0
    use_clf: bool = False
    tau_pen: float = 1.0
    df_pen: float = 0.1
    aux_pen: float = 1e6
    clf_pen: float = 1e8
    aux_max: float = 100.0
    clf_eps: float = 0.8
    sat: tuple = (22.0, 50.0, 50.0)   # per-joint torque limit (hip, thigh, calf)
    ctrl_hz: int = 1000


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Gait scheduling and swing parameters."""

    stand_height: float = 0.28
    swing_height: float = 0.125
    pose_type: int = 0
    fwd_speed: float = 0.0
    lat_speed: float = 0.0
    yaw_speed: float = 0.0
    ts_opt_tick: int = 43
    grids_per_domain: int = 4
    max_phase: float = 1.05   # stale-solution clamp
    toe_offset_z: float = -0.01   # swing touchdown aim, 1 cm below ground

    @property
    def trot_dom_ticks(self) -> int:
        return self.ts_opt_tick * self.grids_per_domain


@dataclasses.dataclass(frozen=True)
class RefPlanConfig:
    """APF reference planner."""

    n_agents: int = 2
    n_obstacles: int = 20
    alpha: float = 100.0
    eta: float = 200.0
    dmin: float = 2.0
    lj_epsilon: float = 1.0
    lj_sigma: float = 0.75
    ramp_up_iters: int = 0
    loop_size: int = 100_000
    downsample: int = 40
    goal: tuple = (10.0, 0.0)
    damping_c: float = 625.0
    mass_m: float = 8.0
    ts: float = 0.043 / 10.0
    # literal discrete matrices (reference-matrix mode) when non-empty
    ad_ref: tuple = ()
    bd_ref: tuple = ()


__all__ = ["Gait", "LipConfig", "LowLevelConfig", "MotionConfig",
           "MpcConfig", "QpConfig", "RefPlanConfig", "TOTAL_DOF"]
