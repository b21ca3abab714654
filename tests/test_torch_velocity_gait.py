"""The velocity-commanded and in-place gaits of srbx_torch against the JAX
package, in float64 on the CPU.

The JAX package compiles one `run_velocity_gait` form in about 70 s on a
CPU, so every comparison here reads `tests/data/torch_velocity_jax.npz`,
which holds inputs made with numpy from a fixed seed and what the JAX
package computes from them (`JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
tests/test_torch_velocity_gait.py` rewrites it in about 35 minutes: 17
loop compiles, the Pallas kernels of the "fused" and "pallas" windows
interpreted):

* the planners on 3 lanes whose domain changes on lanes 0 and 2 only:
  `plan_walk`, `plan_pace`, `plan_inplace_trot`, `plan_tap`,
  `plan_inplace_walk`, `com_des_from_velocity`, `_ramp_vel` toward
  positive, negative, zero and overshot targets, and `pose_com` for every
  pose_type 0-5;
* `agent.tick_build` for STAND, POSE, WALK, PACE, INPLACE_TROT,
  INPLACE_WALK and TAP on 3 crafted lanes: mid-domain, past max_phase,
  and a swing leg touching down after phase 0.7 (the contact trigger);
  D^-1 is given, the same to both packages;
* `closedloop.run_velocity_gait` at 2 lanes and 4 stand ticks: each gait
  on "xla" over 12 gait ticks (PACE with the raw reduced LL build, the
  rest with the full one), WALK on "fused" and INPLACE_TROT on "pallas"
  over 6, both with the raw reduced build (their kernels' plain versions
  here; interpreted Pallas kernels in the JAX package);
* the raw reduced build of INPLACE_WALK and POSE on both of the JAX
  package's solvers, "xla" and "fused", over 12 gait ticks;
* under `-m slow`, each stepping gait's long window, past its second
  domain change after the forced one (TAP's 1.5 s domains and POSE's
  single one have none in reach), WALK's also on "fused" with the build
  the card runs (reduced, 5 Ruiz sweeps).

Bounds, relative to max(1, |value|): 1e-12 for the planners and the tick
builds (the same arithmetic; D^-1 given); for the loops 1e-8 on the full
build and after Ruiz, 1e-7 on the raw reduced one (its condition near
1e10 in float64, ROADMAP F10), as `test_torch_team.py` holds its loops,
with equal LL converged shares and equal domain counts. On the raw
reduced build the JAX package's own two solvers part on a leg's qd by
4.5e-8 (INPLACE_WALK) and 8.0e-8 (POSE) over 12 ticks, and the port's
runs part from them by up to 1.35e-7: Tier-1 holds those two gaits on the
full build, and the slow tests hold qd on the raw reduced build and over
the long windows at the fixed QD_DRIFT_TOL. WALK and PACE end their domains
by touchdown at 15 N, so a foot force near the threshold could part the
two packages' schedules by a tick: the windows hold `domains` and the
per-tick COM exactly where the fixture has them.

Slow: `test_fixture_provenance` recomputes the fixture at 1e-12; the
JAX package's own behaviour claims (`tests/test_wholebody.py:199-290`,
`tests/test_substeps.py:36-51`) run through the port at their depths.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from srbx_torch import agent, motion
from srbx_torch.config import Gait, LowLevelConfig, MotionConfig, QpConfig
from srbx_torch.models import a1, rbd
from srbx_torch.sim import closedloop, wholebody as wb
from srbx_torch.utils import transforms as tf
from test_torch_wholebody import SUB, _close, _t, _toes, flatten, unflatten

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_velocity_jax.npz"
SEED = 2033
N = 3                      # the planners' and tick builds' lanes
B = 2                      # the loops' lanes
TOL = 1e-12
LOOP_TOL = 1e-8
REDUCED_LOOP_TOL = 1e-7    # test_torch_team.py's: the raw reduced build
# a leg's qd on the raw reduced build (ROADMAP F10) or over a long window,
# relative; measured: 1.35e-7 and 1.07e-7 INPLACE_WALK and POSE raw
# reduced on "xla" (6.9e-8 and 4.4e-8 on "fused"); over the long windows
# 1.9e-7 WALK raw reduced 450 ticks, 7.0e-9 WALK on "fused" after 5 Ruiz
# sweeps 450, 2.1e-8 PACE full 250, 5.0e-9 INPLACE_TROT raw reduced 360,
# 3.6e-13 INPLACE_WALK full 640
QD_DRIFT_TOL = 5e-7
LL = LowLevelConfig()
SIM = wb.SimConfig()
QP = QpConfig()
RUIZ = dataclasses.replace(QP, ruiz_iters=5)   # the card's reduced build
MOTION = MotionConfig(fwd_speed=0.15, lat_speed=-0.05)
LOOP = closedloop.LoopConfig(stand_ticks=4)
GAIT_TICKS = 12
KERNEL_TICKS = 6           # the "fused" and "pallas" windows' (CPU time)
CHANGE = np.array([True, False, True])
# the ramp's targets (fwd, lat) against des_vel's lanes (_planner_inputs):
# positive and negative, reversed, zero, and one that lane 1 overshoots
RAMP_TARGETS = ((0.15, -0.05), (-0.15, 0.05), (0.0, 0.0), (0.1, -0.01))
TICK_GAITS = (Gait.STAND, Gait.POSE, Gait.WALK, Gait.PACE, Gait.INPLACE_TROT,
              Gait.INPLACE_WALK, Gait.TAP)
# each gait's stance pattern in the crafted tick states (leg 1 or 0 swings)
TICK_DES = {Gait.STAND: (1, 1, 1, 1), Gait.POSE: (1, 1, 1, 1),
            Gait.WALK: (0, 1, 1, 1), Gait.PACE: (0, 1, 0, 1),
            Gait.INPLACE_TROT: (0, 1, 1, 0), Gait.INPLACE_WALK: (1, 0, 1, 1),
            Gait.TAP: (1, 0, 1, 1)}
# each gait's domain length in ticks (STAND's and POSE's: the stand's)
DOM_TICKS = {Gait.STAND: 800.0, Gait.POSE: 800.0, Gait.WALK: 200.0,
             Gait.PACE: 100.0, Gait.INPLACE_TROT: 160.0,
             Gait.INPLACE_WALK: 300.0, Gait.TAP: 1500.0}
TICK_POSE_TYPE = 4
# name -> (gait, backend, LL build, pose_type, gait ticks); the build is
# "full", "reduced" (raw) or "ruiz" (reduced, after 5 Ruiz sweeps)
LOOP_FORMS = {
    "walk_xla_full": (Gait.WALK, "xla", "full", 0, GAIT_TICKS),
    "pace_xla_reduced": (Gait.PACE, "xla", "reduced", 0, GAIT_TICKS),
    "inplace_trot_xla_full": (Gait.INPLACE_TROT, "xla", "full", 0,
                              GAIT_TICKS),
    "inplace_walk_xla_full": (Gait.INPLACE_WALK, "xla", "full", 0,
                              GAIT_TICKS),
    "tap_xla_full": (Gait.TAP, "xla", "full", 0, GAIT_TICKS),
    "pose_xla_full": (Gait.POSE, "xla", "full", 2, GAIT_TICKS),
    "walk_fused_reduced": (Gait.WALK, "fused", "reduced", 0, KERNEL_TICKS),
    "inplace_trot_pallas_reduced": (Gait.INPLACE_TROT, "pallas", "reduced",
                                    0, KERNEL_TICKS),
}
# the long windows (slow): past the second domain change after tick 0's
LONG_FORMS = {
    "long_walk_reduced": (Gait.WALK, "xla", "reduced", 0, 450),
    "long_walk_fused_ruiz": (Gait.WALK, "fused", "ruiz", 0, 450),
    "long_pace_full": (Gait.PACE, "xla", "full", 0, 250),
    "long_inplace_trot_reduced": (Gait.INPLACE_TROT, "xla", "reduced", 0,
                                  360),
    "long_inplace_walk_full": (Gait.INPLACE_WALK, "xla", "full", 0, 640),
}
# the raw reduced build of INPLACE_WALK and POSE on both of the JAX
# package's solvers: its own witness for how far that build determines qd
WITNESS_FORMS = {
    f"{g.name.lower()}_{backend}_reduced": (g, backend, "reduced", pose,
                                            GAIT_TICKS)
    for g, pose in ((Gait.INPLACE_WALK, 0), (Gait.POSE, 2))
    for backend in ("xla", "fused")}
PLANNERS = ("walk", "pace", "inplace_trot", "tap", "inplace_walk",
            "com_des_from_velocity")


# ------------------------------- the inputs ------------------------------- #

def _standing(rng, n):
    """n standing configurations, toes at or just below the ground, yawed
    up to 0.4 rad."""
    q = np.zeros((n, 18))
    q[:, 7::3] = 0.8 + rng.normal(size=(n, 4)) * 0.05
    q[:, 8::3] = -1.6 + rng.normal(size=(n, 4)) * 0.05
    q[:, 3:5] = rng.normal(size=(n, 2)) * 0.02
    q[:, 5] = rng.uniform(-0.4, 0.4, n)
    q[:, 0:2] = rng.normal(size=(n, 2)) * 0.1
    q[:, 2] = -_toes(q)[:, :, 2].min(1) - 0.001
    return q


def _planner_state(rng, q, des, dom_ticks):
    """A PlannerState of N lanes in numpy form (field -> array)."""
    toe_t = _toes(q).transpose(0, 2, 1)
    com = np.zeros((N, 12))
    com[:, 0:3] = q[:, 0:3] + rng.normal(size=(N, 3)) * 0.01
    com[:, 3:5] = rng.normal(size=(N, 2)) * 0.05
    com[:, 6:9] = rng.normal(size=(N, 3)) * 0.02
    return {
        "com_des": com,
        "toe_init": toe_t + rng.normal(size=(N, 3, 4)) * 0.005,
        "toe_final": toe_t + rng.normal(size=(N, 3, 4)) * 0.002,
        "step_len": rng.normal(size=(N, 3)) * 0.02,
        "dom_ticks": np.full(N, dom_ticks),
        "des_domain": np.tile(np.asarray(des, np.int32), (N, 1)),
        "stand_from": q[:, 0:3] - np.array([0.0, 0.0, 0.1]),
        "des_vel": np.array([[0.05, 0.0, 0.0], [0.2, -0.08, 0.01],
                             [-0.03, 0.02, 0.0]]),
        "cycle_idx": np.array([1, 2, 3], np.int32),
    }


def _tick_state(rng, q, gait):
    """An AgentState of N crafted lanes in numpy form: lane 0 mid-domain,
    lane 1 past max_phase, lane 2 at phase 0.8 with its swing leg's force
    history one tick short of a touchdown (the contact trigger when its
    force crosses 15 N this tick)."""
    des = np.tile(np.asarray(TICK_DES[gait], np.int32), (N, 1))
    dom = DOM_TICKS[gait]
    hist = np.full((N, 4), 1023, np.int32)
    hist[0:2] = rng.integers(0, 1024, (2, 4))
    hist[2] = np.where(des[2] == 1, 1023, 511)
    est = np.ones((N, 4), bool)
    est[0:2] = rng.random((2, 4)) > 0.3
    est[2] = des[2] == 1
    state = {f"planner.{k}": v
             for k, v in _planner_state(rng, q, TICK_DES[gait], dom).items()}
    state.update({
        "loco_tick": np.array([0.5, 1.1, 0.8]) * dom,
        "gait_domain": np.array([2, 3, 4], np.int32),
        "con.hist": hist,
        "con.est": est,
        "con.rise": np.ones((N, 4), bool),
        "con.stance": des > 0,
        "con.ind": des,
        "con.ind_prev": des,
        "con.des": des,
        "con.change_domain": np.zeros(N, bool),
        "con.cnt": des.sum(1).astype(np.int32),
        "mpc_alpha": np.zeros((N, 4, 5)),
        "mpc_states": np.zeros((N, 4, 4)),
        "mpc_available": np.zeros(N, bool),
        "prev_ddq": rng.normal(size=(N, 18)) * 0.5,
    })
    return state


def fixture_inputs():
    """Every input of the fixture, from numpy seed 2033."""
    rng = np.random.default_rng(SEED)
    inp = {}
    q = _standing(rng, N)
    for k, v in _planner_state(rng, q, (1, 0, 1, 0), 100.0).items():
        inp[f"plan.state.{k}"] = v
    sites = rbd.site_positions(a1.model(), torch.as_tensor(q)).numpy()
    inp["plan.q"] = q
    inp["plan.toe_pos"] = sites[:, a1.TOE_SITES]
    inp["plan.hip_pos"] = sites[:, a1.HIP_SITES]
    inp["plan.prev_des"] = np.array([[1, 0, 0, 1], [0, 1, 0, 1],
                                     [1, 0, 1, 0]], np.int32)
    inp["plan.com_filtered"] = rng.normal(size=(N, 3)) * 0.2
    inp["plan.rot"] = tf.rot_xyz(torch.as_tensor(q[:, 3:6])).numpy()
    inp["plan.change"] = CHANGE
    inp["pose.t"] = np.array([0.0, 0.37, 1.234])
    inp["pose.lock"] = rng.normal(size=(N, 12)) * 0.1
    for gait in TICK_GAITS:
        q = _standing(rng, N)
        for k, v in _tick_state(rng, q, gait).items():
            inp[f"tick.{gait.name}.state.{k}"] = v
        inp[f"tick.{gait.name}.q"] = q
        inp[f"tick.{gait.name}.qd"] = rng.normal(size=(N, 18)) * 0.1
        force = rng.uniform(20.0, 60.0, (N, 4))
        force[2] = np.where(np.asarray(TICK_DES[gait]) == 1, 60.0, 40.0)
        inp[f"tick.{gait.name}.force"] = force
        inp[f"tick.{gait.name}.d_inv"] = np.linalg.inv(rbd.mass_matrix(
            a1.model(), torch.as_tensor(q)).numpy())
    inp["loop.a0"] = np.array([[0.0, 0.0], [0.01, -0.6]])
    return inp


def _motion(pose_type):
    return dataclasses.replace(MOTION, pose_type=pose_type)


def _ll_build(build):
    """run_velocity_gait's (ll_reduced, ll_qp_cfg) for a form's build."""
    return build != "full", RUIZ if build == "ruiz" else None


# --------------------------- the JAX fixture ------------------------------ #

def build_fixture():
    """The fixture's contents: its inputs and the JAX package's outputs."""
    import jax
    import jax.numpy as jnp

    from srbx import agent as jagent
    from srbx import motion as jmotion
    from srbx.estimation import contact as jcontact
    from srbx.models import a1 as ja1
    from srbx.sim import closedloop as jclosedloop
    from srbx.sim import wholebody as jwb
    from test_torch_team import _interpreted, _jcfg

    jax.config.update("jax_enable_x64", True)
    jmodel = ja1.model()
    jll, jmo, jsim = _jcfg(LL), _jcfg(MOTION), jwb.SimConfig()
    inp = fixture_inputs()
    out = dict(inp)
    arr = jnp.asarray
    jsub = {"planner": jmotion.PlannerState, "con": jcontact.ConState}

    def planners(st, ch, prev, toe, hip, com_f, rot, q_xy, t, lock):
        lane = {
            "walk": lambda s, c, p, tp, hp, cf, r, qx: jmotion.plan_walk(
                jmo, s, c, tp, cf, r, jmo.fwd_speed, jmo.lat_speed),
            "pace": lambda s, c, p, tp, hp, cf, r, qx: jmotion.plan_pace(
                jmo, s, c, p, tp, cf, r, jmo.fwd_speed, jmo.lat_speed),
            "inplace_trot": lambda s, c, p, tp, hp, cf, r, qx:
                jmotion.plan_inplace_trot(jmo, s, c, p, tp, hp),
            "tap": lambda s, c, p, tp, hp, cf, r, qx: jmotion.plan_tap(
                jmo, s, c, tp),
            "inplace_walk": lambda s, c, p, tp, hp, cf, r, qx:
                jmotion.plan_inplace_walk(jmo, s, c, tp),
            "com_des_from_velocity": lambda s, c, p, tp, hp, cf, r, qx:
                jmotion.com_des_from_velocity(s, qx, r, jmo.stand_height),
        }
        res = {name: jax.vmap(fn)(st, ch, prev, toe, hip, com_f, rot, q_xy)
               for name, fn in lane.items()}
        for i, (fwd, lat) in enumerate(RAMP_TARGETS):
            res[f"ramp{i}"] = jax.vmap(lambda v, fwd=fwd, lat=lat:
                                       jmotion._ramp_vel(v, fwd, lat))(
                st.des_vel)
        for p in range(6):
            res[f"pose{p}"] = jax.vmap(lambda t_, l_, p=p: jmotion.pose_com(
                jmo, p, t_, 0.1, l_))(t, lock)
        return res

    st = unflatten(inp, "plan.state", jmotion.PlannerState, {}, arr)
    res = jax.jit(planners)(
        st, *(arr(inp[f"plan.{k}"]) for k in (
            "change", "prev_des", "toe_pos", "hip_pos", "com_filtered",
            "rot")), arr(inp["plan.q"][:, 0:2]), arr(inp["pose.t"]),
        arr(inp["pose.lock"]))
    for name, v in res.items():
        flatten(v, f"plan.out.{name}", out)

    tick_mo = _jcfg(_motion(TICK_POSE_TYPE))
    for gait in TICK_GAITS:
        pre = f"tick.{gait.name}"
        st = unflatten(inp, f"{pre}.state", jagent.AgentState, jsub, arr)

        def build(st, q, qd, f, d_inv, gait=gait):
            return jax.vmap(lambda s_, q_, qd_, f_, d_: jagent.tick_build(
                jll, tick_mo, jmodel, gait, s_, q_, qd_, f_,
                d_inv=d_))(st, q, qd, f, d_inv)

        data, ctx = jax.jit(build)(*([st] + [arr(inp[f"{pre}.{k}"]) for k in
                                             ("q", "qd", "force", "d_inv")]))
        flatten(data, f"{pre}.data", out)
        flatten(ctx.state_pre, f"{pre}.state_pre", out)
        out[f"{pre}.run_mpc"] = np.asarray(ctx.run_mpc)

    for name, (gait, backend, build, pose_type, ticks) in {
            **LOOP_FORMS, **LONG_FORMS, **WITNESS_FORMS}.items():
        reduced, ll_qp_cfg = _ll_build(build)

        def loop(a0, gait=gait, backend=backend, reduced=reduced,
                 ll_qp_cfg=ll_qp_cfg, pose_type=pose_type, ticks=ticks):
            return jclosedloop.run_velocity_gait(
                gait, jll, _jcfg(_motion(pose_type)), _jcfg(QP), jsim,
                jclosedloop.LoopConfig(*LOOP), jmodel, a0, ticks,
                backend=backend, tile=B, ll_reduced=reduced,
                ll_qp_cfg=None if ll_qp_cfg is None else _jcfg(ll_qp_cfg))

        with _interpreted():
            res = jax.jit(loop)(arr(inp["loop.a0"]))
        _loop_record(res, name, out)
    return out


def _loop_record(res, name, out):
    """What the loop tests compare of a run_velocity_gait result."""
    for k, v in (("com_hist", res.com_hist), ("q", res.sim.q),
                 ("qd", res.sim.qd), ("qp_ok", res.qp_ok),
                 ("domains", res.domains),
                 ("loco_tick", res.agent.loco_tick),
                 ("des_vel", res.agent.planner.des_vel)):
        out[f"{name}.{k}"] = np.asarray(v.detach().cpu() if isinstance(
            v, torch.Tensor) else v)
    return out


# ------------------------------- the tests -------------------------------- #

@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return dict(f)


def _close_tree(got, fx, prefix, tol=TOL):
    keys = [k for k in fx if k.startswith(prefix + ".")]
    assert keys and set(keys) <= set(got), (prefix, sorted(set(keys) -
                                                           set(got)))
    for k in keys:
        if fx[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], fx[k], err_msg=k)
        else:
            _close(got[k], fx[k], tol, relative=True, what=k)


def test_fixture_matches_inputs(fx):
    """The committed inputs are the ones the seed makes."""
    for k, v in fixture_inputs().items():
        np.testing.assert_array_equal(fx[k], v, err_msg=k)


def test_planners_match_jax(fx):
    """Every planner of the slice at 1e-12 on 3 lanes, the domain changing
    on lanes 0 and 2; lane 1 passes through unchanged."""
    st = unflatten(fx, "plan.state", motion.PlannerState, {}, _t)
    ch, prev, toe, hip, com_f, rot = (_t(fx[f"plan.{k}"]) for k in (
        "change", "prev_des", "toe_pos", "hip_pos", "com_filtered", "rot"))
    q_xy = _t(fx["plan.q"][:, 0:2])
    fwd, lat = MOTION.fwd_speed, MOTION.lat_speed
    res = {
        "walk": motion.plan_walk(MOTION, st, ch, toe, com_f, rot, fwd, lat),
        "pace": motion.plan_pace(MOTION, st, ch, prev, toe, com_f, rot, fwd,
                                 lat),
        "inplace_trot": motion.plan_inplace_trot(MOTION, st, ch, prev, toe,
                                                 hip),
        "tap": motion.plan_tap(MOTION, st, ch, toe),
        "inplace_walk": motion.plan_inplace_walk(MOTION, st, ch, toe),
        "com_des_from_velocity": motion.com_des_from_velocity(
            st, q_xy, rot, MOTION.stand_height),
    }
    got = {}
    for name, v in res.items():
        flatten(v, f"plan.out.{name}", got)
        if name != "com_des_from_velocity":
            for f in ("toe_init", "dom_ticks", "des_domain", "cycle_idx"):
                assert torch.equal(getattr(v, f)[1], getattr(st, f)[1]), f
    for name in PLANNERS:
        _close_tree(got, fx, f"plan.out.{name}")


@pytest.mark.parametrize("i", range(len(RAMP_TARGETS)),
                         ids=["pos_neg", "reversed", "zero", "overshot"])
def test_ramp_vel_matches_jax(fx, i):
    """The signed ramp: a step of 0.01 toward the target while short of
    it, none past it or at a zero target."""
    des_vel = _t(fx["plan.state.des_vel"])
    got = motion._ramp_vel(des_vel, *RAMP_TARGETS[i])
    _close(got, fx[f"plan.out.ramp{i}"], TOL, relative=True, what="ramp")
    if RAMP_TARGETS[i] == (0.0, 0.0):
        assert torch.equal(got, des_vel)


@pytest.mark.parametrize("pose_type", range(6))
def test_pose_com_matches_jax(fx, pose_type):
    """POSE's sinusoid for every pose_type, each on its own axis and rate
    row only."""
    lock = _t(fx["pose.lock"])
    got = motion.pose_com(MOTION, pose_type, _t(fx["pose.t"]), 0.1, lock)
    _close(got, fx[f"plan.out.pose{pose_type}"], TOL, relative=True,
           what=f"pose{pose_type}")
    moved = (got != lock).any(0).nonzero().flatten().tolist()
    assert moved == {0: [0, 3], 1: [1, 4], 2: [2, 5]}.get(
        pose_type, [pose_type + 3, pose_type + 6])
    with pytest.raises(ValueError):
        motion.pose_com(MOTION, 6, _t(fx["pose.t"]), 0.1, lock)


@pytest.mark.parametrize("gait", TICK_GAITS, ids=[g.name for g in TICK_GAITS])
def test_tick_build_matches_jax(fx, gait):
    """tick_build on the crafted lanes at 1e-12: the LL QP, the planner,
    the contact state, gait_domain and run_mpc. Lane 0 keeps its domain;
    lane 1 (past max_phase) and lane 2 (touchdown) start one, except on
    STAND and POSE, which take neither trigger."""
    pre = f"tick.{gait.name}"
    st = unflatten(fx, f"{pre}.state", agent.AgentState, SUB, _t)
    data, ctx = agent.tick_build(
        LL, _motion(TICK_POSE_TYPE), a1.model(), gait, st,
        *(_t(fx[f"{pre}.{k}"]) for k in ("q", "qd", "force")),
        d_inv=_t(fx[f"{pre}.d_inv"]))
    got = {f"{pre}.run_mpc": ctx.run_mpc.numpy()}
    flatten(data, f"{pre}.data", got)
    flatten(ctx.state_pre, f"{pre}.state_pre", got)
    for part in ("data", "state_pre", "run_mpc"):
        _close_tree(got, fx, f"{pre}.{part}") if part != "run_mpc" else \
            np.testing.assert_array_equal(got[f"{pre}.run_mpc"],
                                          fx[f"{pre}.run_mpc"])
    untriggered = gait in (Gait.STAND, Gait.POSE)
    np.testing.assert_array_equal(
        ctx.run_mpc.numpy(), [False, not untriggered, not untriggered])
    assert ctx.state_pre.gait_domain.tolist() == (
        [2, 3, 4] if untriggered else [2, 4, 5])


def _run(name, forms):
    gait, backend, build, pose_type, ticks = forms[name]
    reduced, ll_qp_cfg = _ll_build(build)
    return closedloop.run_velocity_gait(
        gait, LL, _motion(pose_type), QP, SIM, LOOP, a1.model(),
        np.asarray(fixture_inputs()["loop.a0"]), ticks, backend=backend,
        ll_reduced=reduced, ll_qp_cfg=ll_qp_cfg, device="cpu")


def _check_loop(fx, name, forms, qd_tol=0.0):
    """Hold a window to the fixture: qp_ok and domains equal, the rest at
    the loop bound of its build (qd at qd_tol where that is larger)."""
    gait, _, build, _, ticks = forms[name]
    got = _loop_record(_run(name, forms), name, {})
    assert got[f"{name}.com_hist"].shape == (B, ticks, 3)
    tol = REDUCED_LOOP_TOL if build == "reduced" else LOOP_TOL
    for k in ("qp_ok", "domains"):
        np.testing.assert_array_equal(got[f"{name}.{k}"], fx[f"{name}.{k}"],
                                      err_msg=k)
    keys = [k for k in fx if k.startswith(name + ".")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        _close(got[k], fx[k], max(tol, qd_tol) if k.endswith(".qd") else tol,
               relative=True, what=k)
    if gait == Gait.POSE:
        assert got[f"{name}.domains"].max() <= 1
    return got


@pytest.mark.parametrize("name", LOOP_FORMS)
def test_run_velocity_gait_matches_jax(fx, name):
    """Each gait's window through the port on the CPU against the JAX
    package's: COM, q, qd, des_vel and loco_tick at the loop bounds; LL
    converged shares and domain counts equal."""
    _check_loop(fx, name, LOOP_FORMS)


def test_run_velocity_gait_refuses_other_gaits():
    for gait in (Gait.STAND, Gait.TROT):
        with pytest.raises(ValueError, match="drives"):
            closedloop.run_velocity_gait(
                gait, LL, MOTION, QP, SIM, LOOP, a1.model(), np.zeros((1, 2)),
                1, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("name", LONG_FORMS)
def test_long_window_matches_jax(fx, name):
    """Past the second domain change after the forced one, each against
    the JAX package's run on the same solver ("fused" against its
    interpreted kernel): the domain schedule (phase overrun or touchdown),
    qp_ok, the per-tick COM, q and des_vel at the loop bounds. The legs'
    joint rates carry the weakly determined part of the LL solution and
    drift further over such a window: qd is held at QD_DRIFT_TOL."""
    got = _check_loop(fx, name, LONG_FORMS, qd_tol=QD_DRIFT_TOL)
    assert got[f"{name}.domains"].min() >= 3


@pytest.mark.parametrize("gait", ["inplace_walk", "pose"])
def test_raw_reduced_build_parts_the_jax_solvers(fx, gait):
    """ROADMAP F10 from the JAX package alone: on the raw reduced build its
    own "xla" and "fused" solvers run INPLACE_WALK's and POSE's windows to
    equal domains, qp_ok and loco_tick and COM within 1e-11, yet part on a
    leg's qd by more than the full build's loop bound (4.5e-8 and 8.0e-8):
    the order by which the port's runs of these windows part from them
    (test_raw_reduced_windows_match_jax), so Tier-1 holds these two gaits
    on the full build."""
    xla, fused = (f"{gait}_{backend}_reduced" for backend in ("xla",
                                                               "fused"))
    for k in ("domains", "qp_ok", "loco_tick"):
        np.testing.assert_array_equal(fx[f"{xla}.{k}"], fx[f"{fused}.{k}"],
                                      err_msg=k)
    _close(fx[f"{fused}.com_hist"], fx[f"{xla}.com_hist"], 1e-11,
           relative=True, what="com_hist")
    gap = np.abs(fx[f"{fused}.qd"] - fx[f"{xla}.qd"]) / np.maximum(
        1.0, np.abs(fx[f"{xla}.qd"]))
    assert LOOP_TOL < gap.max() < QD_DRIFT_TOL


@pytest.mark.slow
@pytest.mark.parametrize("name", WITNESS_FORMS)
def test_raw_reduced_windows_match_jax(fx, name):
    """The port's raw reduced INPLACE_WALK and POSE windows, each against
    the JAX package's run on the same solver: qp_ok and domains equal, the
    COM, q, loco_tick and des_vel at the raw reduced bound, qd at
    QD_DRIFT_TOL."""
    _check_loop(fx, name, WITNESS_FORMS, qd_tol=QD_DRIFT_TOL)


@pytest.mark.slow
def test_raw_reduced_walk_qps_part_the_jax_solvers():
    """F10 in single LL QPs, where the raw reduced build's long WALK
    window on "fused" parts from the JAX package's: WALK ticks 222-231.
    Each tick's LL QP, taken from the port's
    run, is solved by the port's "fused" (the kernel's plain version) and
    by the JAX package's "fused" (interpreted) and "xla". Over the ticks
    the port's x parts from JAX's "fused" by no more than twice what JAX's
    own two solvers part by, and those part by more than 1e-5 relative:
    the QPs fix x no better than that in float64."""
    import jax
    import jax.numpy as jnp
    from unittest import mock

    from srbx.ops import qp_batch as jqp_batch
    from srbx_torch.ops import qp_batch
    from test_torch_team import _interpreted, _jcfg

    jax.config.update("jax_enable_x64", True)
    stand, ticks = LOOP.stand_ticks, range(222, 232)
    real_solve, depth, qps = qp_batch.solve, [0], []

    def capture(*a, **kw):
        if depth[0] == 0:
            qps.append((a[:6], a[6]) if len(qps) - stand in ticks else None)
        depth[0] += 1
        try:
            return real_solve(*a, **kw)
        finally:
            depth[0] -= 1

    with mock.patch.object(qp_batch, "solve", capture):
        _run("w", {"w": (Gait.WALK, "fused", "reduced", 0, ticks[-1] + 1)})
    own = port = 0.0
    for data, cfg in filter(None, qps):
        x = qp_batch.solve(*data, cfg, backend="fused").x.numpy()
        jx = {}
        for solver in ("xla", "fused"):
            with _interpreted():
                jx[solver] = np.asarray(jax.jit(lambda *d: jqp_batch.solve(
                    *d, _jcfg(cfg), backend=solver))(*(
                        jnp.asarray(t.numpy()) for t in data)).x)
        scale = np.maximum(1.0, np.abs(jx["fused"]))
        own = max(own, float((np.abs(jx["xla"] - jx["fused"]) / scale).max()))
        port = max(port, float((np.abs(x - jx["fused"]) / scale).max()))
    print(f"port vs JAX fused {port:.3e}, JAX xla vs fused {own:.3e}")
    assert own > 1e-5 and port <= 2 * own


@pytest.mark.slow
def test_fixture_provenance(fx):
    """The committed fixture is what the JAX package computes from the seed
    (about 25 minutes on a CPU)."""
    live = build_fixture()
    assert set(live) == set(fx)
    for k, v in live.items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(fx[k], v, err_msg=k)
        else:
            _close(fx[k], v, 1e-12, relative=True, what=k)


# ------------ the JAX package's own claims, through the port ------------- #

RELAXED = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6, reg_dual=1e-6,
                   max_iters=12)


def _claim_run(gait, a0, n_ticks, motion_cfg=MotionConfig(), qp_cfg=RELAXED,
               sim_cfg=SIM, ll_reduced=True):
    return closedloop.run_velocity_gait(
        gait, LL, motion_cfg, qp_cfg, sim_cfg,
        closedloop.LoopConfig(stand_ticks=400), a1.model(), a0, n_ticks,
        backend="xla", ll_reduced=ll_reduced, device="cpu")


@pytest.mark.slow
def test_velocity_gait_walk_and_pace_through_the_port():
    """tests/test_wholebody.py::test_velocity_gait_walk_and_pace: WALK
    advances with the ramped forward command at held height, PACE cycles
    stably (2 lanes, 400 stand ticks, 2000 / 1200 gait ticks)."""
    mo = dataclasses.replace(MotionConfig(), fwd_speed=0.15)
    a0 = np.zeros((2, 2))
    walk = _claim_run(Gait.WALK, a0, 2000, mo)
    assert int(walk.domains.min()) >= 8
    assert float(walk.qp_ok.min()) > 0.95
    assert float(walk.com_hist[:, :, 2].min()) > 0.25
    assert float(walk.sim.q[:, 0].min()) > 0.05
    pace = _claim_run(Gait.PACE, a0, 1200, mo)
    assert int(pace.domains.min()) >= 8
    assert float(pace.qp_ok.min()) > 0.9
    assert float(pace.com_hist[:, :, 2].min()) > 0.25


@pytest.mark.slow
def test_inplace_gaits_and_pose_through_the_port():
    """tests/test_wholebody.py::test_inplace_gaits_and_pose_through_plant:
    the in-place gaits cycle their tables with bounded drift at held
    height; POSE oscillates x by 0.02-0.06 m and never cycles domains."""
    a0 = np.zeros((1, 2))
    for gait, nt, min_dom in ((Gait.INPLACE_TROT, 1000, 5),
                              (Gait.INPLACE_WALK, 1300, 4),
                              (Gait.TAP, 1800, 1)):
        res = _claim_run(gait, a0, nt)
        assert int(res.domains.min()) >= min_dom, gait.name
        assert float(res.qp_ok.min()) > 0.95, gait.name
        assert float(res.com_hist[:, :, 2].min()) > 0.25, gait.name
        assert float(res.sim.q[:, 0:2].abs().max()) < 0.05, gait.name
    res = _claim_run(Gait.POSE, a0, 2500,
                     dataclasses.replace(MotionConfig(), pose_type=0))
    ch = res.com_hist.numpy()
    amp = (ch[0, 400:, 0].max() - ch[0, 400:, 0].min()) / 2
    assert 0.02 < amp < 0.06
    assert float(res.qp_ok.min()) > 0.95
    assert int(res.domains.max()) <= 1


@pytest.mark.slow
@pytest.mark.parametrize("gait", [Gait.PACE, Gait.TAP],
                         ids=["PACE", "TAP"])
def test_substeps_default_accuracy_through_the_port(gait):
    """tests/test_substeps.py::test_substeps_default_accuracy_stiff_gaits:
    two physics substeps track four within 5 mm of COM through PACE and
    TAP, LL-QP convergence unaffected (the full build, QpConfig())."""
    a0 = np.array([[0.0, 0.0], [0.0, -0.6]])
    runs = [_claim_run(gait, a0, 500, qp_cfg=QpConfig(), ll_reduced=False,
                       sim_cfg=dataclasses.replace(SIM, substeps=s))
            for s in (2, 4)]
    com2, com4 = (r.com_hist.numpy() for r in runs)
    assert np.isfinite(com2).all() and np.isfinite(com4).all()
    assert np.abs(com2 - com4).max() < 5e-3
    for r in runs:
        assert float(r.qp_ok.min()) > 0.97


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(f"wrote {FIXTURE}")
