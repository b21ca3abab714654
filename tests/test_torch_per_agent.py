"""The per-agent path of srbx_torch against the JAX package, in float64 on
the CPU.

The JAX package compiles one closed loop in about a minute on a CPU, so
every comparison with it reads `tests/data/torch_per_agent_jax.npz`, which
holds inputs made with numpy from a fixed seed (and, where they are states,
what the JAX package makes of them) and what the JAX package computes from
them (`JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
tests/test_torch_per_agent.py` rewrites it):

* `sqp.solve` (with and without the line search, condensed and
  uncondensed) and `sqp.solve_penalty` on the NMPC's own QPs of 4 lanes,
  as `mpc.run_nmpc` assembles them, held at 1e-9;
* `mpc.run_nmpc` on those 4 lanes (two before locomotion starts, on the
  nominal footholds), uncondensed and condensed, with and without the SCP
  stage, with the neighbour circle, simplex-eliminated (me = 0), at 1e-9
  with equal first-QP `converged` and `iters`;
* `agent.tick` for STAND and TROT (one lane's domain change forced) and
  `lowlevel.calc_torque`, at 1e-10;
* `wholebody.step` with d0, a trunk force and stick-slip contact, and
  without them, at 1e-12;
* `closedloop.run` over 20 stand ticks and 2 trot domains of 10 ticks,
  without the SCP stage, with it and stick-slip contact, and without it
  with stick-slip contact from a perturbed crouch `q0`, and
  `closedloop.run_team` (two agents, the SCP stage, 10 stand ticks and 2
  domains of 5), at the loops' 1e-8 with equal qp_ok, mpc_ok and llok.
  A tick of these loops costs about 0.1 s on a CPU core, so they are cut
  to these depths to keep the file near 20 s.

Under CBF rows a lane whose last SCP QP does not converge is held at the
JAX package's own 3e-2 (ROADMAP F8); the fixture records which lanes those
are. On the lanes with four legs in stance the condensed QP's P is
singular along the load split, so the SCP's lambdas there are held at
1e-7 (measured 2.0e-8 apart) and the rest of x at 1e-9. Every bound is
relative to max(1, |value|).

The port's batched loops are held to its per-agent ones as the JAX package
holds its own (tests/test_wholebody.py:165-199, tests/test_team.py:50-100):
`run_batch(backend="xla")` to `run` at 1e-8, `run_team_batch` to
`run_team` at 2e-3 on the COM and 1e-2 on the margins.

Slow: `test_fixture_provenance` recomputes the fixture at 1e-12; the JAX
package's claims of tests/test_wholebody.py:71-97 (one agent, 800 stand
ticks and 10 trot domains) and tests/test_team.py:15-48 (two agents, 800
and 8 domains, the SCP stage on) run through the port.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from srbx_torch import agent, lowlevel, mpc, refplan, sqp
from srbx_torch.config import (Gait, LowLevelConfig, MotionConfig, MpcConfig,
                               QpConfig)
from srbx_torch.estimation import contact
from srbx_torch.models import a1
from srbx_torch.motion import PlannerState
from srbx_torch.ocp import OcpData
from srbx_torch.sim import closedloop, wholebody as wb

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_per_agent_jax.npz"
SEED = 2034
B = 4                      # the NMPC's lanes
NMPC_TOL = 1e-9
TICK_TOL = 1e-10
STEP_TOL = 1e-12
LOOP_TOL = 1e-8
F8_TOL = 3e-2              # a lane whose SCP QP did not converge (F8)
# the load split of four stance legs in the condensed QP: P is singular
# along it, so rounding picks the lambdas (measured: 2.0e-8 apart)
SPLIT_TOL = 1e-7
LL = LowLevelConfig()
MOTION = MotionConfig()
SIM = wb.SimConfig()
QP = QpConfig()
LOOP = closedloop.LoopConfig(stand_ticks=20, n_domains=2, ticks_per_domain=10)
SUB = {"planner": PlannerState, "con": contact.ConState}
SQP2 = dict(use_sqp=True, sqp_iters=2)
# name -> (MpcConfig, the neighbour circle)
NMPC_FORMS = {
    "uncondensed_qp": (MpcConfig(use_sqp=False), False),
    "uncondensed_sqp_neighbour": (MpcConfig(**SQP2), True),
    "condensed_sqp": (MpcConfig(condensed=True, **SQP2), False),
    "elided_sqp_neighbour": (MpcConfig(condensed=True, elide_box_rows=True,
                                       elide_simplex=True, **SQP2), True),
    "linesearch_neighbour": (MpcConfig(sqp_linesearch=True, **SQP2), True),
}
SQP_FORMS = [name for name, (cfg, _) in NMPC_FORMS.items() if cfg.use_sqp]
# name -> (MpcConfig, stiction, from the perturbed crouch loop.q0)
RUN_FORMS = {
    "run_qp": (MpcConfig(use_sqp=False), False, False),
    "run_sqp_stiction": (MpcConfig(**SQP2), True, False),
    "run_qp_stiction_q0": (MpcConfig(use_sqp=False), True, True),
}
TEAM_MPC = MpcConfig(**SQP2)
TEAM_LOOP = closedloop.LoopConfig(stand_ticks=10, n_domains=2,
                                  ticks_per_domain=5)


# ------------------------------- the inputs ------------------------------- #

def _nmpc_inputs(rng):
    """4 lanes of run_nmpc's inputs: the COM near the origin moving forward,
    a straight reference, the closest obstacle 1.40-1.45 m away (the CBF's
    sqrt(1.9) = 1.38 m), a neighbour 1.40-1.45 m aside; lanes 0 and 1
    before locomotion starts (gait_domain 0 and 1)."""
    q_xy = rng.normal(size=(B, 2)) * 0.1
    dq_xy = np.stack([rng.uniform(0.1, 0.3, B), rng.normal(size=B) * 0.05],
                     1)
    nominal = np.array([[0.2188, 0.2188, -0.1472, -0.1472],
                        [-0.1320, 0.1320, -0.1320, 0.1320]])
    toe_xy = nominal + q_xy[:, :, None] + rng.normal(size=(B, 2, 4)) * 0.01
    t = np.arange(60) * 0.043
    pr = q_xy[:, :, None] + np.broadcast_to(
        np.stack([0.25 * t, 0.02 * np.sin(t)]), (B, 2, 60))
    prd = np.broadcast_to(np.stack([np.full(60, 0.25), 0.02 * np.cos(t)]),
                          (B, 2, 60)).copy()
    angle = rng.uniform(0.3, 1.2, B) * np.array([1.0, -1.0, 1.0, -1.0])
    dist = rng.uniform(1.40, 1.45, B)
    pobs = np.full((B, 2, 20), 100.0) + rng.normal(size=(B, 2, 20))
    pobs[:, :, 3] = q_xy + dist[:, None] * np.stack([np.cos(angle),
                                                     np.sin(angle)], 1)
    other = np.concatenate([q_xy + np.stack([rng.normal(size=B) * 0.1,
                                             -np.sign(angle) * rng.uniform(
                                                 1.40, 1.45, B)], 1),
                            rng.normal(size=(B, 2)) * 0.1], 1)
    return {
        "carry.gait_domain": np.array([0, 1, 2, 5], np.int32),
        "carry.alpha_buffer": np.stack([q_xy[:, 0], dq_xy[:, 0], q_xy[:, 1],
                                        dq_xy[:, 1]], 1)
        + rng.normal(size=(B, 4)) * 0.01,
        "q_xy": q_xy, "dq_xy": dq_xy, "toe_xy": toe_xy,
        "contact_ind": np.array([[1, 0, 0, 1], [0, 1, 1, 0], [1, 0, 0, 1],
                                 [0, 1, 1, 0]], np.float64),
        "pr": pr, "prd": prd, "a0": q_xy.copy(),
        "pobs": pobs, "other": other,
    }


def fixture_inputs():
    """The inputs made with numpy alone, from seed 2034."""
    rng = np.random.default_rng(SEED)
    inp = {f"nmpc.{k}": v for k, v in _nmpc_inputs(rng).items()}
    inp["stand.noise_q"] = rng.normal(size=(2, 18)) * 1e-3
    inp["stand.qd"] = rng.normal(size=(2, 18)) * 0.05
    inp["stand.force"] = rng.uniform(20.0, 60.0, (2, 4))
    inp["stand.loco_tick"] = np.array([5.0, 13.0])
    inp["stand.a0"] = np.array([[0.0, 0.0], [0.3, -0.2]])
    inp["trot.force_new_domain"] = np.array([True, False])
    inp["torque.f_des"] = rng.normal(size=(2, 12)) * 20.0
    inp["step.noise_q"] = rng.normal(size=(3, 18)) * 1e-4
    inp["step.noise_qd"] = rng.normal(size=(3, 18)) * 1e-2
    inp["step.tau"] = rng.uniform(-10.0, 10.0, (3, 12))
    inp["step.base_force"] = rng.normal(size=(3, 3)) * 20.0
    inp["step.anchor_noise"] = rng.normal(size=(3, 4, 2)) * 2e-3
    inp["step.slip"] = rng.uniform(0.0, 0.01, (3, 4))
    inp["loop.p_start"] = np.array([0.0, 0.0, 0.0, -1.0])
    inp["loop.pobs"] = np.full((2, 20), 100.0)
    inp["loop.pobs"][:, 0] = [0.35, 1.40]
    inp["team.p_start"] = np.array([0.0, 0.6, 0.0, -0.6])
    inp["loop.q0_noise"] = rng.normal(size=18) * 5e-3
    return inp


# --------------------------- the JAX fixture ------------------------------ #

def build_fixture():
    """The fixture's contents: its inputs and the JAX package's outputs."""
    import jax
    import jax.numpy as jnp

    from srbx import agent as jagent
    from srbx import lowlevel as jlowlevel
    from srbx import mpc as jmpc
    from srbx import refplan as jrefplan
    from srbx import sqp as jsqp
    from srbx.models import a1 as ja1
    from srbx.models import rbd as jrbd
    from srbx.ocp import assemble, condense, expand, expansion
    from srbx.ops import qp as jqp
    from srbx.sim import closedloop as jclosedloop
    from srbx.sim import wholebody as jwb
    from test_torch_team import _jcfg
    from test_torch_wholebody import flatten

    jax.config.update("jax_enable_x64", True)
    arr = jnp.asarray
    jmodel = ja1.model()
    jll, jmo, jqpc = _jcfg(LL), _jcfg(MOTION), _jcfg(QP)
    jsim = jwb.SimConfig()
    inp = fixture_inputs()
    out = dict(inp)

    # -------- run_nmpc and the SCP stage on the NMPC's own QPs -------- #
    nm = {k[5:]: arr(v) for k, v in inp.items() if k.startswith("nmpc.")}
    carry = jmpc.MpcCarry(nm["carry.gait_domain"], nm["carry.alpha_buffer"])
    for name, (cfg, neighbour) in NMPC_FORMS.items():
        jcfg = _jcfg(cfg)
        eps = cfg.cbf_eps if neighbour else 0.0

        def lane(cr, qx, dqx, toe, ci, pr, prd, a0, pobs, other, jcfg=jcfg,
                 neighbour=neighbour, eps=eps):
            return jmpc.run_nmpc(jcfg, jqpc, cr, qx, dqx, toe, ci, pr, prd,
                                 a0, pobs,
                                 state_other=other if neighbour else None,
                                 agent_circle_eps=eps)

        res = jax.jit(jax.vmap(lane))(carry, *(nm[k] for k in (
            "q_xy", "dq_xy", "toe_xy", "contact_ind", "pr", "prd", "a0",
            "pobs", "other")))
        flatten(res, f"nmpc.{name}.out", out)
        if not cfg.use_sqp:
            out["nmpc.eval_s"] = np.array([0.0, 0.3, 1.0, 1.05])
            flatten(jax.vmap(jmpc.eval_com_traj)(
                res.alpha_com, arr(out["nmpc.eval_s"])), "nmpc.eval", out)
            continue

        def scp(cr, qx, dqx, toe, ci, pr, prd, a0, pobs, other, jcfg=jcfg,
                neighbour=neighbour, eps=eps):
            """run_nmpc's steps up to its SCP stage: the stage's inputs and
            its result, and solve_penalty's on the full-space QP."""
            x0, ref, foot, ci = jmpc.nmpc_qp_inputs(jcfg, cr, qx, dqx, toe,
                                                     ci, pr, prd, a0)
            data = assemble(jcfg, x0, ref, foot, ci, dtype=qx.dtype)
            if jcfg.condensed:
                e_mat, e0 = expansion(jcfg, x0, foot, ci, dtype=qx.dtype)
                data_s = condense(jcfg, data, e_mat, e0)
                x = expand(e_mat, e0, jqp.solve(*data_s, jqpc).x)
            else:
                e_mat = e0 = jnp.zeros((0,), qx.dtype)
                data_s = data
                x = jqp.solve(*data, jqpc).x
            obs, _ = jmpc.closest_obstacle(qx, pobs)
            circles = jnp.stack([obs, other[:2]])
            mask = jnp.asarray([1.0, 1.0 if eps > 0 else 0.0], qx.dtype)
            res = jsqp.solve(jcfg, jqpc, data_s, x, circles, mask,
                             full_data=data,
                             e_mat=e_mat if jcfg.condensed else None,
                             e0=e0 if jcfg.condensed else None,
                             contact_ind=ci)
            inputs = {"data": data, "data_s": data_s, "x_init": x,
                      "circles": circles, "mask": mask, "ci": ci,
                      "e_mat": e_mat, "e0": e0}
            if not jcfg.condensed:
                inputs["penalty"] = jsqp.solve_penalty(
                    jcfg, jqpc, data, x, circles, mask)
            return inputs, res

        inputs, res = jax.jit(jax.vmap(scp))(carry, *(nm[k] for k in (
            "q_xy", "dq_xy", "toe_xy", "contact_ind", "pr", "prd", "a0",
            "pobs", "other")))
        for k, v in inputs.items():
            flatten(v, f"scp.{name}.{k}", out)
        flatten(res, f"scp.{name}.out", out)

    # ------------------------------- loops ------------------------------- #
    ref = jrefplan.generate(jrefplan.two_agent_config(loop_size=400),
                            arr(inp["loop.p_start"]), arr(inp["loop.pobs"]))
    out["loop.pr"] = np.asarray(ref.pr[0:2])
    out["loop.prd"] = np.asarray(ref.prd[0:2])
    jloop = jclosedloop.LoopConfig(*LOOP)
    q0 = jwb.default_crouch(jmodel) + arr(inp["loop.q0_noise"])
    out["loop.q0"] = np.asarray(q0)
    finals = {}
    for name, (cfg, stiction, from_q0) in RUN_FORMS.items():
        res = jax.jit(lambda pr, prd, a0, pobs, cfg=cfg, stiction=stiction,
                      q0=q0 if from_q0 else None:
                      jclosedloop.run(_jcfg(cfg), jll, jmo, jqpc, jsim,
                                      jloop, jmodel, pr, prd, a0, pobs,
                                      q0=q0, stiction=stiction))(
            arr(out["loop.pr"]), arr(out["loop.prd"]),
            arr(inp["loop.p_start"][:2]), arr(inp["loop.pobs"]))
        flatten(res, f"{name}", out)
        finals[name] = res
    tref = jrefplan.generate(jrefplan.two_agent_config(loop_size=400),
                             arr(inp["team.p_start"]), arr(inp["loop.pobs"]))
    out["team.pr"] = np.asarray(tref.pr).reshape(2, 2, -1)
    out["team.prd"] = np.asarray(tref.prd).reshape(2, 2, -1)
    sims, com_ends, margins, llok = jax.jit(
        lambda pr, prd, a0, pobs: jclosedloop.run_team(
            _jcfg(TEAM_MPC), jll, jmo, jqpc, jsim,
            jclosedloop.LoopConfig(*TEAM_LOOP), jmodel, pr, prd, a0, pobs))(
        arr(out["team.pr"]), arr(out["team.prd"]),
        arr(inp["team.p_start"].reshape(2, 2)), arr(inp["loop.pobs"]))
    flatten(sims, "team.sims", out)
    out["team.com_ends"] = np.asarray(com_ends)
    out["team.margins"] = np.asarray(margins)
    out["team.llok"] = np.asarray(llok)

    # --------------------- ticks, calc_torque, step --------------------- #
    def stand_state(a0, noise, loco):
        q0 = jwb.default_crouch(jmodel).at[0:2].add(a0)
        st = jagent.init(jmo, jmodel, q0)
        st = st._replace(loco_tick=loco, planner=st.planner._replace(
            stand_from=q0[0:3] - jnp.asarray([0.0, 0.0, 0.02]),
            dom_ticks=jnp.asarray(800.0)))
        return q0 + noise, st

    q_st, st = jax.jit(jax.vmap(stand_state))(
        arr(inp["stand.a0"]), arr(inp["stand.noise_q"]),
        arr(inp["stand.loco_tick"]))
    out["stand.q"] = np.asarray(q_st)
    flatten(st, "stand.state", out)
    ll_out, new, run_mpc = jax.jit(jax.vmap(
        lambda s, q, qd, f: jagent.tick(jll, jmo, jqpc, jmodel, Gait.STAND,
                                        s, q, qd, f)))(
        st, q_st, arr(inp["stand.qd"]), arr(inp["stand.force"]))
    flatten(ll_out, "stand.ll_out", out)
    flatten(new, "stand.new", out)
    out["stand.run_mpc"] = np.asarray(run_mpc)

    # the trot state: the end of the loops without and with the SCP stage
    pick = lambda *xs: jnp.stack(xs)                      # noqa: E731
    t_qp, t_sqp = finals["run_qp"], finals["run_sqp_stiction"]
    t_sim = jax.tree_util.tree_map(pick, t_qp.sim._replace(con=None),
                                   t_sqp.sim._replace(con=None))
    t_st = jax.tree_util.tree_map(pick, t_qp.agent, t_sqp.agent)
    force = jax.vmap(lambda s: jwb.foot_force_measurement(jsim, jmodel, s))(
        t_sim)
    out["trot.force"] = np.asarray(force)
    out["trot.q"], out["trot.qd"] = np.asarray(t_sim.q), np.asarray(t_sim.qd)
    flatten(t_st, "trot.state", out)
    ll_out, new, run_mpc = jax.jit(jax.vmap(
        lambda s, q, qd, f, fnd: jagent.tick(
            jll, jmo, jqpc, jmodel, Gait.TROT, s, q, qd, f,
            force_new_domain=fnd)))(
        t_st, t_sim.q, t_sim.qd, force, arr(inp["trot.force_new_domain"]))
    flatten(ll_out, "trot.ll_out", out)
    flatten(new, "trot.new", out)
    out["trot.run_mpc"] = np.asarray(run_mpc)

    _, ctx = jax.vmap(lambda s, q, qd, f: jagent.tick_build(
        jll, jmo, jmodel, Gait.TROT, s, q, qd, f))(t_st, t_sim.q, t_sim.qd,
                                                   force)
    flatten(ctx.vc, "torque.vc", out)
    out["torque.contact_ind"] = np.asarray(ctx.ll_ctx.con)
    torque = jax.jit(jax.vmap(lambda q, qd, ci, vc, fd: jlowlevel.calc_torque(
        jll, jqpc, jmodel, q, qd, ci, vc, fd)))(
        t_sim.q, t_sim.qd, ctx.ll_ctx.con, ctx.vc, arr(inp["torque.f_des"]))
    flatten(torque, "torque.out", out)

    q = jnp.concatenate([t_sim.q, q_st[:1]]) + arr(inp["step.noise_q"])
    qd = jnp.concatenate([t_sim.qd, arr(inp["stand.qd"][:1])]) \
        + arr(inp["step.noise_qd"])
    con = jax.vmap(lambda q: jwb.init_contact_state(jmodel, q))(q)
    con = jwb.ContactState(con.anchor + arr(inp["step.anchor_noise"]),
                           arr(inp["step.slip"]))
    out["step.q"], out["step.qd"] = np.asarray(q), np.asarray(qd)
    flatten(con, "step.con", out)
    d0 = jax.vmap(lambda q: jrbd.mass_matrix(jmodel, q))(q)
    out["step.d0"] = np.asarray(d0)
    full = jax.jit(jax.vmap(lambda q, qd, con, tau, f, d: jwb.step(
        jsim, jmodel, jwb.SimState(q, qd, con), tau, base_force=f, d0=d)))(
        q, qd, con, arr(inp["step.tau"]), arr(inp["step.base_force"]), d0)
    flatten(full, "step.full", out)
    plain = jax.jit(jax.vmap(lambda q, qd, tau: jwb.step(
        jsim, jmodel, jwb.SimState(q, qd), tau)))(q, qd, arr(inp["step.tau"]))
    flatten(plain, "step.plain", out)
    return out


# ------------------------------- the tests -------------------------------- #

def _t(a):
    return torch.as_tensor(np.asarray(a))


def _tree(fx, prefix, cls, sub=None):
    """The NamedTuple cls (with nested NamedTuples `sub`) from the fixture's
    flattened fields under prefix."""
    sub = sub or {}
    return cls(*(_tree(fx, f"{prefix}.{f}", sub[f]) if f in sub
                 else (_t(fx[f"{prefix}.{f}"]) if f"{prefix}.{f}" in fx
                       else None)
                 for f in cls._fields))


def _flat(tree, prefix, out=None):
    from test_torch_wholebody import flatten

    return flatten(tree, prefix, {} if out is None else out)


def _hold(got, fx, prefix, tol, lane_tol=None, bounds=None):
    """Every field of the fixture under prefix against got's, relative to
    max(1, |value|); integer and boolean fields equal. lane_tol: a (B,)
    bound per leading lane, where given; bounds: {key: elementwise bound}
    for the keys it names."""
    keys = [k for k in fx if k.startswith(prefix + ".") or k == prefix]
    assert keys and set(keys) <= set(got), (prefix, sorted(set(keys) -
                                                           set(got)))
    for k in keys:
        g, w = np.asarray(got[k]), fx[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        bound = tol if lane_tol is None else lane_tol.reshape(
            (-1,) + (1,) * (w.ndim - 1))
        if bounds and k in bounds:
            bound = np.maximum(bound, bounds[k])
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
        assert (np.isfinite(g) == np.isfinite(w)).all(), k
        err = np.where(np.isfinite(w), err, 0.0)
        assert (err <= bound).all(), f"{k}: {err.max():.3e}"


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return dict(f)


def test_fixture_matches_inputs(fx):
    """The committed inputs are the ones the seed makes."""
    for k, v in fixture_inputs().items():
        np.testing.assert_array_equal(fx[k], v, err_msg=k)


def _f8_lanes(fx, name):
    """The bound per lane: F8_TOL where the JAX package's last SCP QP did
    not converge, NMPC_TOL elsewhere."""
    conv = fx[f"scp.{name}.out.converged"]
    return np.where(conv, NMPC_TOL, F8_TOL)


@pytest.mark.parametrize("name", SQP_FORMS)
def test_sqp_solve_matches_jax(fx, name):
    cfg, _ = NMPC_FORMS[name]
    pre = f"scp.{name}"
    data = _tree(fx, f"{pre}.data", OcpData)
    data_s = _tree(fx, f"{pre}.data_s", OcpData)
    cond = cfg.condensed
    res = sqp.solve(cfg, QP, data_s, _t(fx[f"{pre}.x_init"]),
                    _t(fx[f"{pre}.circles"]), _t(fx[f"{pre}.mask"]),
                    full_data=data,
                    e_mat=_t(fx[f"{pre}.e_mat"]) if cond else None,
                    e0=_t(fx[f"{pre}.e0"]) if cond else None,
                    contact_ind=_t(fx[f"{pre}.ci"]))
    # on the lanes with four legs in stance the condensed QP leaves the load
    # split free: their lambdas at SPLIT_TOL, the trajectory at NMPC_TOL
    split = np.zeros_like(fx[f"{pre}.out.x"])
    if cond:
        lam = slice((cfg.n_state + cfg.n_input) * cfg.horizon,
                    (cfg.n_state + cfg.n_input) * cfg.horizon + cfg.n_lambda)
        split[fx[f"{pre}.ci"].all(1), lam] = SPLIT_TOL
    _hold(_flat(res, f"{pre}.out"), fx, f"{pre}.out", NMPC_TOL,
          _f8_lanes(fx, name), {f"{pre}.out.x": split})
    if not cond:
        pen = sqp.solve_penalty(cfg, QP, data, _t(fx[f"{pre}.x_init"]),
                                _t(fx[f"{pre}.circles"]),
                                _t(fx[f"{pre}.mask"]))
        _hold(_flat(pen, f"{pre}.penalty"), fx, f"{pre}.penalty", NMPC_TOL)


def _nmpc_args(fx):
    g = lambda k: _t(fx[f"nmpc.{k}"])                     # noqa: E731
    return (mpc.MpcCarry(g("carry.gait_domain"), g("carry.alpha_buffer")),
            g("q_xy"), g("dq_xy"), g("toe_xy"), g("contact_ind"), g("pr"),
            g("prd"), g("a0"), g("pobs"))


@pytest.mark.parametrize("name", list(NMPC_FORMS))
def test_run_nmpc_matches_jax(fx, name):
    cfg, neighbour = NMPC_FORMS[name]
    out = mpc.run_nmpc(cfg, QP, *_nmpc_args(fx),
                       state_other=_t(fx["nmpc.other"]) if neighbour
                       else None,
                       agent_circle_eps=cfg.cbf_eps if neighbour else 0.0)
    assert out.qp_iters.shape == (B,) and out.x is None
    lanes = _f8_lanes(fx, name) if cfg.use_sqp else None
    _hold(_flat(out, f"nmpc.{name}.out"), fx, f"nmpc.{name}.out", NMPC_TOL,
          lanes)


def test_eval_com_traj_matches_jax(fx):
    """The fitted Bezier's position, velocity and acceleration at phases 0,
    0.3, 1 and the stale 1.05."""
    out = mpc.eval_com_traj(_t(fx["nmpc.uncondensed_qp.out.alpha_com"]),
                            _t(fx["nmpc.eval_s"]))
    _hold({"nmpc.eval": torch.stack(out).numpy()}, fx, "nmpc.eval",
          TICK_TOL)


def _state(fx, prefix):
    return _tree(fx, prefix, agent.AgentState, SUB)


def test_tick_stand_matches_jax(fx):
    out = agent.tick(LL, MOTION, QP, a1.model(), Gait.STAND,
                     _state(fx, "stand.state"), _t(fx["stand.q"]),
                     _t(fx["stand.qd"]), _t(fx["stand.force"]))
    got = _flat(out[0], "stand.ll_out")
    _flat(out[1], "stand.new", got)
    got["stand.run_mpc"] = out[2].numpy()
    for part in ("ll_out", "new", "run_mpc"):
        _hold(got, fx, f"stand.{part}", TICK_TOL)


def _trot_inputs(fx):
    return (_state(fx, "trot.state"), _t(fx["trot.q"]), _t(fx["trot.qd"]))


def test_tick_trot_matches_jax(fx):
    st, q, qd = _trot_inputs(fx)
    out = agent.tick(LL, MOTION, QP, a1.model(), Gait.TROT, st, q, qd,
                     _t(fx["trot.force"]),
                     force_new_domain=_t(fx["trot.force_new_domain"]))
    got = _flat(out[0], "trot.ll_out")
    _flat(out[1], "trot.new", got)
    got["trot.run_mpc"] = out[2].numpy()
    for part in ("ll_out", "new", "run_mpc"):
        _hold(got, fx, f"trot.{part}", TICK_TOL)


def test_calc_torque_matches_jax(fx):
    _, q, qd = _trot_inputs(fx)
    out = lowlevel.calc_torque(LL, QP, a1.model(), q, qd,
                               _t(fx["torque.contact_ind"]),
                               _tree(fx, "torque.vc", lowlevel.VcOut),
                               _t(fx["torque.f_des"]))
    _hold(_flat(out, "torque.out"), fx, "torque.out", TICK_TOL)


@pytest.mark.parametrize("form", ["full", "plain"])
def test_step_matches_jax(fx, form):
    """wholebody.step with d0 on the first substep, a trunk force and
    stick-slip contact ("full"), and without any of them ("plain")."""
    state = wb.SimState(_t(fx["step.q"]), _t(fx["step.qd"]),
                        _tree(fx, "step.con", wb.ContactState)
                        if form == "full" else None)
    kw = (dict(base_force=_t(fx["step.base_force"]), d0=_t(fx["step.d0"]))
          if form == "full" else {})
    got = wb.step(SIM, a1.model(), state, _t(fx["step.tau"]), **kw)
    _hold(_flat(got, f"step.{form}"), fx, f"step.{form}", STEP_TOL)


def _run(fx, name):
    cfg, stiction, from_q0 = RUN_FORMS[name]
    return closedloop.run(cfg, LL, MOTION, QP, SIM, LOOP, a1.model(),
                          fx["loop.pr"], fx["loop.prd"],
                          fx["loop.p_start"][:2], fx["loop.pobs"],
                          q0=fx["loop.q0"] if from_q0 else None,
                          stiction=stiction, device="cpu")


@pytest.fixture(scope="module")
def runs(fx):
    return {}


def _cached_run(fx, runs, name):
    if name not in runs:
        runs[name] = _run(fx, name)
    return runs[name]


@pytest.mark.parametrize("name", list(RUN_FORMS))
def test_run_matches_jax(fx, runs, name):
    res = _cached_run(fx, runs, name)
    assert res.com_hist.shape == (LOOP.n_domains, LOOP.ticks_per_domain, 3)
    assert res.qp_ok.shape == () and res.sim.q.shape == (18,)
    assert (res.sim.con is None) == (not RUN_FORMS[name][1])
    _hold(_flat(res, name), fx, name, LOOP_TOL)


def test_run_batch_matches_run(fx, runs):
    """tests/test_wholebody.py:165-199's claim through the port: the batched
    loop on "xla" reproduces the per-agent run (1e-8, LL and MPC converged
    shares 1e-12)."""
    res = _cached_run(fx, runs, "run_qp")
    bat = closedloop.run_batch(
        RUN_FORMS["run_qp"][0], LL, MOTION, QP, SIM, LOOP, a1.model(),
        fx["loop.pr"][None], fx["loop.prd"][None], fx["loop.p_start"][None,
                                                                      :2],
        fx["loop.pobs"][None], backend="xla", device="cpu")
    for a, b, tol in ((bat.sim.q[0], res.sim.q, LOOP_TOL),
                      (bat.com_hist[0], res.com_hist, LOOP_TOL),
                      (bat.qp_ok[0], res.qp_ok, 1e-12),
                      (bat.mpc_ok[0], res.mpc_ok, 1e-12)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def team(fx):
    return closedloop.run_team(TEAM_MPC, LL, MOTION, QP, SIM, TEAM_LOOP,
                               a1.model(), fx["team.pr"], fx["team.prd"],
                               fx["team.p_start"].reshape(2, 2),
                               fx["loop.pobs"], device="cpu")


def test_run_team_matches_jax(fx, team):
    sims, com_ends, margins, llok = team
    assert com_ends.shape == (TEAM_LOOP.n_domains, 2, 3)
    assert margins.shape == (TEAM_LOOP.n_domains, 2) and llok.shape == (
        TEAM_LOOP.n_domains,)
    got = _flat(sims, "team.sims")
    got.update({"team.com_ends": com_ends.numpy(),
                "team.margins": margins.numpy(), "team.llok": llok.numpy()})
    for part in ("sims", "com_ends", "margins", "llok"):
        _hold(got, fx, f"team.{part}", LOOP_TOL)


def test_run_team_batch_matches_run_team(fx, team):
    """tests/test_team.py:50-100's claim through the port: the scenario-
    batched team loop on "xla" (S 1) matches the per-agent run_team (COM
    2e-3, margins 1e-2, LL converged share > 0.95)."""
    _, com1, mar1, _ = team
    _, com2, mar2, ok2 = closedloop.run_team_batch(
        TEAM_MPC, LL, MOTION, QP, SIM, TEAM_LOOP, a1.model(),
        fx["team.pr"][None], fx["team.prd"][None],
        fx["team.p_start"].reshape(1, 2, 2), fx["loop.pobs"][None],
        backend="xla", device="cpu")
    np.testing.assert_allclose(com2[:, 0].numpy(), com1.numpy(), atol=2e-3)
    np.testing.assert_allclose(mar2[:, 0].numpy(), mar1.numpy(), atol=1e-2)
    assert float(ok2.mean()) > 0.95


@pytest.mark.slow
def test_fixture_provenance(fx):
    """The committed fixture is what the JAX package computes from the seed
    (several minutes on a CPU)."""
    live = build_fixture()
    assert set(live) == set(fx)
    for k, v in live.items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(fx[k], v, err_msg=k)
        else:
            err = np.abs(fx[k] - v) / np.maximum(1.0, np.abs(v))
            assert np.nan_to_num(err).max(initial=0.0) <= 1e-12, k


# ------------ the JAX package's own claims, through the port ------------- #

def _far_obstacles():
    return torch.full((2, 20), 100.0, dtype=torch.float64)


@pytest.mark.slow
def test_full_fidelity_trot_tracks_reference_through_the_port():
    """tests/test_wholebody.py:71-97 through the port: 800 stand ticks and
    10 NMPC trot domains; forward progress tracking the APF reference,
    level posture, bounded torques."""
    pobs = _far_obstacles()
    traj = refplan.generate(refplan.two_agent_config(loop_size=20_000),
                            torch.tensor([0.0, 0.0, 0.0, -1.0],
                                         dtype=torch.float64), pobs,
                            device="cpu")
    res = closedloop.run(
        MpcConfig(use_sqp=False), LL, MOTION, QP, SIM,
        closedloop.LoopConfig(stand_ticks=800, n_domains=10), a1.model(),
        traj.pr[0:2], traj.prd[0:2], torch.zeros(2, dtype=torch.float64),
        pobs, device="cpu")
    q = res.sim.q.numpy()
    ref_x = float(traj.pr[0, 40])
    assert q[0] > 0.15, f"no forward progress: x={q[0]}"
    assert abs(q[0] - ref_x) < 0.15, f"x tracking off: {q[0]} vs {ref_x}"
    assert abs(q[1]) < 0.1, f"lateral drift: y={q[1]}"
    assert abs(q[2] - MOTION.stand_height) < 0.02
    assert np.abs(q[3:6]).max() < 0.1
    assert float(res.qp_ok) > 0.98
    assert float(res.mpc_ok) == 1.0
    assert float(res.tau_hist[:, 0].max()) <= 50.0 + 1e-6


@pytest.mark.slow
def test_two_agent_team_trots_without_collision_through_the_port():
    """tests/test_team.py:15-48 through the port: two agents 1.2 m apart,
    800 stand ticks and 8 domains with the SCP stage: both advance and stay
    upright, keep apart, and every planned knot respects the CBF margin."""
    pobs = _far_obstacles()
    p_start = torch.tensor([0.0, 0.6, 0.0, -0.6], dtype=torch.float64)
    traj = refplan.generate(refplan.two_agent_config(loop_size=20_000),
                            p_start, pobs, device="cpu")
    sims, _, margins, llok = closedloop.run_team(
        MpcConfig(use_sqp=True, sqp_iters=2), LL, MOTION, QP, SIM,
        closedloop.LoopConfig(stand_ticks=800, n_domains=8), a1.model(),
        traj.pr.reshape(2, 2, -1), traj.prd.reshape(2, 2, -1),
        p_start.reshape(2, 2), pobs, device="cpu")
    q = sims.q.numpy()
    assert np.isfinite(q).all()
    assert (q[:, 0] > 0.1).all(), f"x: {q[:, 0]}"
    assert np.abs(q[:, 3:6]).max() < 0.15
    assert np.abs(q[:, 2] - 0.28).max() < 0.03
    sep = np.linalg.norm(q[0, 0:2] - q[1, 0:2])
    assert sep > 0.8, f"agents converged dangerously: sep={sep}"
    assert float(margins.min()) >= MpcConfig().cbf_eps - 1e-3
    assert float(llok.min()) > 0.95


@pytest.mark.slow
def test_float32_team_ll_convergence_is_the_jax_packages():
    """The smoke's float32 team (phase 19: the paper's configuration, two
    agents, 100 stand ticks and one domain of 172) in both packages on the
    CPU. Under QpConfig() in float32 the LL QP's IPM meets a non-finite
    step on some ticks in both (measured: the JAX package converges 0.860
    of the LL QPs, the port 0.863), so the JAX test's 0.95 holds in float64
    only; both agents stand, keep the CBF margin, and the two shares agree
    within 0.05."""
    import jax
    import jax.numpy as jnp

    from srbx import refplan as jrefplan
    from srbx.models import a1 as ja1
    from srbx.sim import closedloop as jclosedloop
    from srbx.sim import wholebody as jwb
    from test_torch_team import _jcfg

    f32 = torch.float32
    p_start = [0.0, 0.6, 0.0, -0.6]
    loop = closedloop.LoopConfig(100, 1, 172)
    cfg = MpcConfig(use_sqp=True, sqp_iters=2)
    pobs = torch.full((2, 20), 100.0, dtype=f32)
    ref = refplan.generate(refplan.two_agent_config(loop_size=4000),
                           torch.tensor(p_start, dtype=f32), pobs, dtype=f32,
                           device="cpu")
    sims, _, margins, llok = closedloop.run_team(
        cfg, LL, MOTION, QP, SIM, loop, a1.model(), ref.pr.reshape(2, 2, -1),
        ref.prd.reshape(2, 2, -1), torch.tensor(p_start, dtype=f32).reshape(
            2, 2), pobs, dtype=f32, device="cpu")
    jp, jpobs = jnp.asarray(p_start, jnp.float32), jnp.asarray(pobs.numpy())
    jref = jrefplan.generate(jrefplan.two_agent_config(loop_size=4000), jp,
                             jpobs, dtype=jnp.float32)
    jsims, _, jmargins, jllok = jax.jit(lambda: jclosedloop.run_team(
        _jcfg(cfg), _jcfg(LL), _jcfg(MOTION), _jcfg(QP), jwb.SimConfig(),
        jclosedloop.LoopConfig(*loop), ja1.model(), jref.pr.reshape(2, 2, -1),
        jref.prd.reshape(2, 2, -1), jp.reshape(2, 2), jpobs,
        dtype=jnp.float32))()
    for q, m in ((sims.q.numpy(), margins.numpy()),
                 (np.asarray(jsims.q), np.asarray(jmargins))):
        assert np.isfinite(q).all()
        assert np.abs(q[:, 2] - 0.28).max() < 0.03
        assert np.abs(q[:, 3:5]).max() < 0.15
        assert m.min() >= cfg.cbf_eps - 1e-3
    ours, theirs = float(llok.min()), float(np.asarray(jllok).min())
    print(f"float32 LL qp_ok: port {ours:.4f}, JAX package {theirs:.4f}")
    assert abs(ours - theirs) <= 0.05


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(f"wrote {FIXTURE}")
