"""Estimation in the loop and the event-driven loop of srbx_torch against the
JAX package, in float64 on the CPU.

Live JAX oracles, one jitted JAX function over 3 lanes whose inputs are
made with numpy from a fixed seed, hold the modules:

* `utils/prng.py` against `jax.random`: `split` bitwise, `normal` and
  `uniform` within 4 ulps in float64 and float32 on several keys (the
  module follows jax's partitionable threefry, so the test first asserts
  that jax runs it);
* `sim/sensors.py` (`init`, `read`), `estimation/kalman.py`, `kinest.py`,
  `contact.py`'s `prob_contact_update`, `force_domain_change` and
  `impact_detection`, and `estimation/pipeline.py` (`init`, `update` with
  both sources), each at 1e-12 relative to max(1, |value|); keys equal;
* the JAX package's `EstState`, converted by `convert.from_numpy`, equals
  the port's `pipeline.init` from the same key.

The loops cost minutes a call in the JAX package on the CPU (its "fused"
forms run the Pallas kernels in interpret mode), so they are held to
`tests/data/torch_est_jax.npz`, which the JAX package computed from the
same seeds (`JAX_PLATFORMS=cpu python tests/test_torch_estimation.py`
rewrites it): `run_batch(est_cfg)` on "xla" with the full LL build and on
"fused" with the reduced one (the KF as the source), `run_team_batch(
est_cfg)` on 1 x 4 lanes, and `run_batch_event` without and with
`est_cfg`, each over 2 stand ticks and 2 or 3 trot ticks of 2 lanes (the
event loops with an HL poll every 2 ticks and a latency of 2, so that the
first tick's solution is delivered inside the window). Bounds, as `test_torch_team.py`
holds its loops: 1e-8 relative; trigger ticks, domains, solve counts and
LL converged shares equal.

Slow: `test_fixture_provenance` recomputes the fixture and holds it at
1e-12; the `est_loop` and `event_loop` goldens of `docs/golden/golden.json`
run through the port on "xla" at the goldens' own bounds.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from srbx_torch import convert
from srbx_torch.config import LowLevelConfig, MotionConfig, MpcConfig, QpConfig
from srbx_torch.estimation import contact, kalman, kinest, pipeline
from srbx_torch.models import a1, rbd
from srbx_torch.sim import closedloop, sensors, wholebody as wb
from srbx_torch.utils import prng
from test_torch_team import (P_START, PROD_MPC, PROD_QP, _interpreted, _jcfg,
                             _obstacles)
from test_torch_wholebody import _close, _t

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_est_jax.npz"
GOLDEN = ROOT / "docs" / "golden" / "golden.json"
LANES = 3
TOL = 1e-12
LOOP_TOL = 1e-8
EST = pipeline.EstConfig()
EST_KF = pipeline.EstConfig(source="kf")
SIM = wb.SimConfig()
LL = LowLevelConfig()
MOTION = MotionConfig()
QP = QpConfig()
LOOP = closedloop.LoopConfig(stand_ticks=2, n_domains=1, ticks_per_domain=2)
EVENT_LOOP = closedloop.LoopConfig(stand_ticks=2, n_domains=1,
                                   ticks_per_domain=2, mpc_latency_ticks=2)
EVENT_TICKS = 3
SEED = 2027
PRNG_SHAPES = ((3,), (4, 5))
COM0 = (0.1, -0.2, 0.3)
# (name, function, backend, LL build, MpcConfig, QpConfig, EstConfig)
RUIZ_LL = dataclasses.replace(PROD_QP, ruiz_iters=5)
LOOP_FORMS = {
    "batch_xla": ("run_batch", "xla", False, MpcConfig(use_sqp=False), QP,
                  None, EST),
    "batch_fused_kf": ("run_batch", "fused", True, PROD_MPC, PROD_QP,
                       RUIZ_LL, EST_KF),
    "team_fused": ("run_team_batch", "fused", True, PROD_MPC, PROD_QP,
                   RUIZ_LL, EST),
    "event_xla": ("run_batch_event", "xla", False, MpcConfig(use_sqp=False),
                  QP, None, None),
    "event_fused": ("run_batch_event", "fused", True, PROD_MPC, PROD_QP,
                    RUIZ_LL, EST),
}


def flatten(tree, prefix, out):
    """Tree of dicts, NamedTuples and tuples -> {prefix.key, .field or
    .index ...: numpy array}; None is left out."""
    if tree is None:
        return out
    if isinstance(tree, dict):
        for name, value in tree.items():
            flatten(value, f"{prefix}.{name}" if prefix else name, out)
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or map(str, range(len(tree)))
        for name, value in zip(names, tree):
            flatten(value, f"{prefix}.{name}", out)
    else:
        out[prefix] = np.asarray(tree.detach().cpu() if isinstance(
            tree, torch.Tensor) else tree)
    return out


def _jest(cfg):
    """The JAX package's EstConfig of the same fields."""
    from srbx.estimation import pipeline as jpipeline
    from srbx.sim import sensors as jsensors

    fields = dataclasses.asdict(cfg)
    fields["sensor"] = jsensors.SensorConfig(**fields["sensor"])
    return jpipeline.EstConfig(**fields)


# ------------------------------- the inputs ------------------------------- #

def _standing(rng, lanes):
    """Standing configurations, toes on the ground."""
    q = np.zeros((lanes, 18))
    q[:, 7::3] = 0.8 + rng.normal(size=(lanes, 4)) * 0.05
    q[:, 8::3] = -1.6 + rng.normal(size=(lanes, 4)) * 0.05
    q[:, 3:6] = rng.normal(size=(lanes, 3)) * 0.02
    q[:, 0:2] = rng.normal(size=(lanes, 2)) * 0.1
    toes = rbd.site_positions(a1.model(), torch.as_tensor(q))[
        :, a1.TOE_SITES].numpy()
    q[:, 2] = -toes[:, :, 2].min(1) - 0.002
    return q


def module_inputs():
    """The modules' inputs, 3 lanes from numpy seed 2027."""
    rng = np.random.default_rng(SEED)
    n = LANES
    q = _standing(rng, n)
    qd = rng.normal(size=(n, 18)) * 0.1
    a = rng.normal(size=(n, 18, 18))
    inp = {
        "q": q, "qd": qd,
        "q1": q + rng.normal(size=(n, 18)) * 1e-3,
        "qd1": qd + rng.normal(size=(n, 18)) * 0.02,
        "key": rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint32),
        "kf.x": rng.normal(size=(n, 18)) * 0.1,
        "kf.p": a @ a.transpose(0, 2, 1) / 18 + 0.01 * np.eye(18),
        "contact": (rng.random((n, 4)) > 0.4).astype(np.float64),
        "imu": rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 9.81]),
        "eul": rng.normal(size=(n, 3)) * 0.05,
        "rel": rng.normal(size=(n, 4, 3)) * 0.2,
        "kin.com": rng.normal(size=(n, 3)) * 0.1,
        "kin.toe_prev": rng.normal(size=(n, 4, 3)) * 0.2,
        "force": rng.uniform(0.0, 60.0, (n, 4)),
        "p_prev": rng.uniform(0.0, 1.0, (n, 4)),
        "foot_z": rng.uniform(-0.01, 0.05, (n, 4)),
        "phase": rng.uniform(0.0, 1.1, n),
        "jv": rng.normal(size=(n, 12)),
        "jv_prev": rng.normal(size=(n, 12)),
        "total": rng.integers(2, 5, n).astype(np.int32),
        "is_stand": np.array([False, True, False]),
        "prng.keys": rng.integers(0, 2 ** 32, (4, 2), dtype=np.uint32),
    }
    inp["phase"][0] = 0.97
    return inp


# --------------------------- the JAX oracles ------------------------------ #

# the modules the pipeline's tick calls, with the positions of their
# array arguments: the oracle captures those and each module's result
CAPTURED = {"sensors.init": ("sensors", "init", (1, 2)),
            "sensors.read": ("sensors", "read", (3, 4)),
            "kalman": ("kalman", "update", (0, 1, 2, 3, 4)),
            "kinest": ("kinest", "update", (1, 2, 3, 4, 5, 6)),
            "prob_contact": ("contact", "prob_contact_update", (0, 1, 2, 3))}


def jax_modules(inp):
    """What the JAX package computes from `inp`, lane by lane, in one jitted
    function of a lane: pipeline.init and a pipeline.update of each source, the
    inputs and results of the modules that update calls (sensors.init and
    read, kalman.update, kinest.update, prob_contact_update, captured as it
    calls them), and kalman.update, prob_contact_update and
    impact_detection on random inputs."""
    import jax
    import jax.numpy as jnp

    from srbx.estimation import contact as jcontact
    from srbx.estimation import kalman as jkalman
    from srbx.estimation import kinest as jkinest
    from srbx.estimation import pipeline as jpipeline
    from srbx.models import a1 as ja1
    from srbx.sim import sensors as jsensors
    from srbx.sim import wholebody as jwb
    from srbx.utils import transforms as jtf

    from srbx.models import rbd as jrbd

    jax.config.update("jax_enable_x64", True)
    model, sim_cfg = ja1.model(), jwb.SimConfig()
    mods = {"sensors": jsensors, "kalman": jkalman, "kinest": jkinest,
            "contact": jcontact}
    # the kinematics, traced once: the pipeline evaluates them a dozen
    # times a tick, and their trace is most of the oracle's cost
    fk = jax.jit(jrbd.site_positions, static_argnums=0)

    def lane(d):
        out = {}
        saved = []
        for name, (mod, fn, pos) in CAPTURED.items():
            real = getattr(mods[mod], fn)

            def capture(*a, name=name, real=real, pos=pos, **k):
                res = real(*a, **k)
                out[name] = {"in": tuple(a[i] for i in pos), "out": res}
                return res

            saved.append((mods[mod], fn, real))
            setattr(mods[mod], fn, capture)
        try:
            est = jpipeline.init(_jest(EST), model,
                                 jwb.SimState(d["q"], d["qd"]), d["key"])
            sim1 = jwb.SimState(d["q1"], d["qd1"])
            out["pipeline.kinest.update"] = jpipeline.update(
                _jest(EST), sim_cfg, model, est, sim1, d["phase"])
        finally:
            for mod, fn, real in saved:
                setattr(mod, fn, real)
        # init does not read the source
        out["pipeline.init"] = est
        out["pipeline.kf.update"] = jpipeline.update(
            _jest(EST_KF), sim_cfg, model, est, sim1, d["phase"])
        out["kalman_random"] = jkalman.update(
            jkalman.KfState(d["kf.x"], d["kf.p"]), d["contact"], d["imu"],
            jtf.rot_xyz(d["eul"]), d["rel"], dt=sim_cfg.dt,
            accel_noise=EST.kf_accel_noise, meas_noise=EST.kf_meas_noise,
            g=model.g, swing_noise=EST.kf_swing_noise)
        out["kalman_init"] = jkalman.init(sim_cfg.dt, com0=COM0)
        out["kinest_init"] = jkinest.init(model, d["q"][6:], com0=COM0)
        out["prob_contact_random"] = jcontact.prob_contact_update(
            d["p_prev"], d["force"], d["foot_z"], d["phase"])
        out["impact"] = jcontact.impact_detection(
            d["phase"], d["total"], d["jv"], d["jv_prev"], d["is_stand"])
        return out

    def draws(keys):
        """jax.random on the prng keys: splits, and normal and uniform
        draws in both dtypes."""
        out = {"split7": jax.vmap(lambda k: jax.random.split(k, 7))(keys),
               "split3": jax.vmap(lambda k: jax.random.split(k, 3))(keys)}
        for dt in ("float64", "float32"):
            for shape in PRNG_SHAPES:
                tag = "x".join(map(str, shape))
                out[f"normal.{dt}.{tag}"] = jax.vmap(
                    lambda k: jax.random.normal(k, shape, dt))(keys)
                out[f"uniform.{dt}.{tag}"] = jax.vmap(
                    lambda k: jax.random.uniform(k, shape, dt, -0.5,
                                                 2.0))(keys)
        return out

    # one lane at a time through one compiled program (tracing the lane
    # function under vmap costs more than the three calls)
    lane_fn = jax.jit(lane)
    real_fk, jrbd.site_positions = jrbd.site_positions, fk
    try:
        per_lane = [flatten(lane_fn({k: jnp.asarray(v[i])
                                     for k, v in inp.items()
                                     if not k.startswith("prng.")}), "", {})
                    for i in range(LANES)]
    finally:
        jrbd.site_positions = real_fk
    out = {k: np.stack([np.asarray(p[k]) for p in per_lane])
           for k in per_lane[0]}
    out.update(flatten({"prng": jax.jit(draws)(jnp.asarray(
        inp["prng.keys"]))}, "", {}))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def oracle():
    inp = module_inputs()
    return inp, jax_modules(inp)


def _cmp(got: dict, want: dict, prefix, tol=TOL):
    keys = [k for k in want if k == prefix or k.startswith(prefix + ".")]
    assert keys and set(keys) <= set(got), (prefix, sorted(set(keys)
                                                          - set(got)))
    for k in keys:
        if want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(np.asarray(got[k]).astype(
                np.int64), want[k].astype(np.int64), err_msg=k)
        else:
            _close(got[k], want[k], tol, relative=True, what=k)


# ------------------------------ the modules ------------------------------- #

def test_prng_split_is_jax_bitwise(oracle):
    import jax

    assert jax.config.jax_threefry_partitionable, (
        "srbx_torch.utils.prng follows jax's partitionable threefry")
    for seed in (0, 11, 2024, 2 ** 40 + 5):
        k = prng.key(seed, "cpu")
        np.testing.assert_array_equal(k.numpy(),
                                      np.asarray(jax.random.PRNGKey(seed)))
    inp, want = oracle
    keys = prng.as_key(inp["prng.keys"], "cpu")
    for n in (7, 3):
        np.testing.assert_array_equal(prng.split(keys, n).numpy(),
                                      want[f"prng.split{n}"])
        np.testing.assert_array_equal(prng.split(keys[2], n).numpy(),
                                      want[f"prng.split{n}"][2])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_prng_normal_and_uniform_match_jax(oracle, dtype):
    """normal and uniform within 4 ulps of jax.random's on four keys,
    batched over the keys and singly; `normals` draws several shapes in one
    hash, each as `normal` draws it alone."""
    inp, want = oracle
    tdt = getattr(torch, dtype)
    keys = prng.as_key(inp["prng.keys"], "cpu")

    def ulps(got, w):
        return (np.abs(got.numpy() - w)
                / np.spacing(np.abs(w).astype(w.dtype))).max()

    for shape in PRNG_SHAPES:
        tag = "x".join(map(str, shape))
        jn, ju = (want[f"prng.{f}.{dtype}.{tag}"]
                  for f in ("normal", "uniform"))
        assert ulps(prng.normal(keys, shape, tdt), jn) <= 4
        assert ulps(prng.uniform(keys, shape, tdt, -0.5, 2.0), ju) <= 4
        assert ulps(prng.normal(keys[1], shape, tdt), jn[1]) <= 4
    sub = prng.split(keys, 3)
    parts = prng.normals(sub, ((3,), (2, 2), (12,)), tdt)
    for j, part in enumerate(parts):
        np.testing.assert_array_equal(
            part.numpy(), prng.normal(sub[:, j], part.shape[1:], tdt).numpy())


def _arg(flat, prefix, cls=None):
    """A captured argument: a tensor, or a NamedTuple of them (a PRNG key
    in the port's layout)."""
    if cls is None:
        a = flat[prefix]
        return prng.as_key(a, "cpu") if a.dtype == np.uint32 else _t(a)
    return cls(*(_arg(flat, f"{prefix}.{f}") for f in cls._fields
                 if f"{prefix}.{f}" in flat))


def test_sensors_match_jax(oracle):
    """sensors.init and sensors.read on the inputs the JAX pipeline handed
    them (its start and its tick)."""
    _, want = oracle
    got = {}
    flatten(sensors.init(EST.sensor, _arg(want, "sensors.init.in.0"),
                         _arg(want, "sensors.init.in.1")),
            "sensors.init.out", got)
    flatten(sensors.read(EST.sensor, SIM, a1.model(),
                         _arg(want, "sensors.read.in.0", sensors.SensorState),
                         _arg(want, "sensors.read.in.1", wb.SimState)),
            "sensors.read.out", got)
    _cmp(got, want, "sensors.init.out")
    _cmp(got, want, "sensors.read.out")


@pytest.mark.parametrize("case", ["pipeline", "random"])
def test_kalman_update_matches_jax(oracle, case):
    """kalman.update on the pipeline's tick (from its start, P = 1e-2 I)
    and on random inputs with a random SPD P; kalman.init."""
    from srbx_torch.utils import transforms as tf

    inp, want = oracle
    kw = dict(dt=SIM.dt, accel_noise=EST.kf_accel_noise,
              meas_noise=EST.kf_meas_noise, g=a1.model().g,
              swing_noise=EST.kf_swing_noise)
    if case == "pipeline":
        args = [_arg(want, "kalman.in.0", kalman.KfState)] + [
            _arg(want, f"kalman.in.{i}") for i in range(1, 5)]
        pre = "kalman.out"
    else:
        args = [kalman.KfState(_t(inp["kf.x"]), _t(inp["kf.p"])),
                _t(inp["contact"]), _t(inp["imu"]),
                tf.rot_xyz(_t(inp["eul"])), _t(inp["rel"])]
        pre = "kalman_random"
    st = kalman.update(*args, **kw)
    _cmp(flatten(st, pre, {}), want, pre)
    assert torch.equal(st.p, st.p.transpose(1, 2))
    _cmp(flatten(kalman.init(LANES, SIM.dt, COM0, device="cpu"),
                 "kalman_init", {}), want, "kalman_init")


def test_kinest_update_matches_jax(oracle):
    inp, want = oracle
    got = kinest.update(
        a1.model(), _arg(want, "kinest.in.0", kinest.KinEstState),
        *(_arg(want, f"kinest.in.{i}") for i in range(1, 6)),
        force_thresh=EST.contact_force_thresh)
    _cmp(flatten(got, "kinest.out", {}), want, "kinest.out")
    _cmp(flatten(kinest.init(a1.model(), _t(inp["q"])[:, 6:], COM0),
                 "kinest_init", {}), want, "kinest_init")


def test_contact_estimators_match_jax(oracle):
    inp, want = oracle
    got = {"prob_contact.out": contact.prob_contact_update(
        *(_arg(want, f"prob_contact.in.{i}") for i in range(4))).numpy(),
        "prob_contact_random": contact.prob_contact_update(
            _t(inp["p_prev"]), _t(inp["force"]), _t(inp["foot_z"]),
            _t(inp["phase"])).numpy(),
        "impact": contact.impact_detection(
            _t(inp["phase"]), _t(inp["total"]), _t(inp["jv"]),
            _t(inp["jv_prev"]), _t(inp["is_stand"])).numpy()}
    _cmp(got, want, "prob_contact.out")
    _cmp(got, want, "prob_contact_random")
    np.testing.assert_array_equal(got["impact"], want["impact"])
    con = contact.force_domain_change(contact.init(LANES, device="cpu"))
    assert con.change_domain.dtype == torch.bool and con.change_domain.all()


@pytest.mark.parametrize("source", ["kinest", "kf"])
def test_pipeline_matches_jax(oracle, source):
    inp, want = oracle
    cfg = EST if source == "kinest" else EST_KF
    sim0 = wb.SimState(_t(inp["q"]), _t(inp["qd"]))
    est = pipeline.init(cfg, a1.model(), sim0, prng.as_key(inp["key"], "cpu"))
    got = flatten(est, "pipeline.init", {})
    flatten(pipeline.update(cfg, SIM, a1.model(), est,
                            wb.SimState(_t(inp["q1"]), _t(inp["qd1"])),
                            _t(inp["phase"])),
            f"pipeline.{source}.update", got)
    _cmp(got, want, "pipeline.init")
    _cmp(got, want, f"pipeline.{source}.update")
    assert est.contact_ind.dtype == torch.int32
    ind = torch.tensor([[1, 0, 0, 1]] * LANES)
    assert torch.equal(pipeline.set_contact_ind(est, ind).contact_ind,
                       ind.to(torch.int32))


def test_converted_jax_est_state_is_the_ports_init(oracle):
    """The JAX package's EstState, converted, is the port's init from the
    same key: the port's types, and values within 1e-12 (the key exact)."""
    from srbx.estimation import kalman as jkalman
    from srbx.estimation import kinest as jkinest
    from srbx.estimation import pipeline as jpipeline
    from srbx.sim import sensors as jsensors

    inp, want = oracle

    def tree(cls, prefix):
        return cls(*(want[f"{prefix}.{f}"] for f in cls._fields))

    jest = jpipeline.EstState(
        tree(jsensors.SensorState, "pipeline.init.sens"),
        tree(jkalman.KfState, "pipeline.init.kf"),
        tree(jkinest.KinEstState, "pipeline.init.kin"),
        *(want[f"pipeline.init.{f}"] for f in jpipeline.EstState._fields[3:]))
    got = convert.from_numpy(jest, device="cpu")
    assert isinstance(got, pipeline.EstState)
    assert isinstance(got.sens, sensors.SensorState)
    assert isinstance(got.kf, kalman.KfState)
    assert isinstance(got.kin, kinest.KinEstState)
    assert got.sens.key.dtype == torch.int64
    ours = pipeline.init(EST, a1.model(),
                         wb.SimState(_t(inp["q"]), _t(inp["qd"])),
                         prng.as_key(inp["key"], "cpu"))
    a, b = flatten(got, "s", {}), flatten(ours, "s", {})
    assert a.keys() == b.keys()
    for k in a:
        if a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            _close(a[k], b[k], TOL, relative=True, what=k)


# ------------------------------- the loops -------------------------------- #

def loop_inputs():
    """The loops' inputs: two lanes of the team's agents 0 and 2 and their
    field, the team's four agents (the port's APF reference, loop 2000),
    and the noise key of the est_loop golden."""
    from srbx_torch import refplan

    pobs = _obstacles()
    ref = refplan.generate(refplan.four_agent_config(loop_size=2_000),
                           torch.tensor(P_START, dtype=torch.float64),
                           torch.tensor(pobs), device="cpu")
    pr = ref.pr.numpy().reshape(1, 4, 2, -1)
    prd = ref.prd.numpy().reshape(1, 4, 2, -1)
    a0 = np.asarray(P_START).reshape(1, 4, 2)
    return {
        "team.pr": pr, "team.prd": prd, "team.a0": a0, "team.pobs": pobs[None],
        "loop.pr": pr[0, 0:3:2], "loop.prd": prd[0, 0:3:2],
        "loop.a0": a0[0, 0:3:2], "loop.pobs": np.repeat(pobs[None], 2, 0),
        "est_key": np.array([0, 2024], np.uint32),
    }


def _loop_call(form, cfgs, inp, run_batch, run_team_batch, run_batch_event,
               sim_cfg, model, loop_cls, est_cfg, extra):
    """Call the form's loop of either package; cfgs = (mpc, ll, motion, qp,
    ll_qp) of that package."""
    fn, backend, reduced = LOOP_FORMS[form][0:3]
    mpc_cfg, ll_cfg, motion_cfg, qp_cfg, ll_qp_cfg = cfgs
    loop = EVENT_LOOP if fn == "run_batch_event" else LOOP
    kw = dict(backend=backend, ll_reduced=reduced, ll_qp_cfg=ll_qp_cfg,
              est_cfg=est_cfg, **extra)
    if est_cfg is not None:
        kw["est_key"] = inp["est_key"]
    head = (mpc_cfg, ll_cfg, motion_cfg, qp_cfg, sim_cfg, loop_cls(*loop),
            model)
    if fn == "run_team_batch":
        return run_team_batch(*head, *(inp[f"team.{k}"] for k in
                                       ("pr", "prd", "a0", "pobs")), **kw)
    args = [inp[f"loop.{k}"] for k in ("pr", "prd", "a0", "pobs")]
    if fn == "run_batch_event":
        return run_batch_event(*head, *args, EVENT_TICKS, mpc_period_ticks=2,
                               **kw)
    return run_batch(*head, *args, **kw)


def _loop_record(form, res, out):
    """The fields of a loop's result that the fixture keeps."""
    fn = LOOP_FORMS[form][0]
    pre = f"loop.{form}"
    if fn == "run_team_batch":
        names = ("q", "qd", "com_ends", "margins", "llok", "est_rmse")
        values = (res[0].q, res[0].qd) + tuple(res[1:])
    else:
        names = ("q", "qd", "com_hist", "qp_ok", "est_rmse")
        values = (res.sim.q, res.sim.qd, res.com_hist, res.qp_ok,
                  res.est_rmse)
        if fn == "run_batch":
            names += ("mpc_ok", "tau_max")
            values += (res.mpc_ok, res.tau_hist[..., 0])
        else:
            names += ("domains", "mpc_solves", "trigger_hist")
            values += (res.domains, res.mpc_solves, res.trigger_hist)
    for name, v in zip(names, values):
        if v is not None:
            out[f"{pre}.{name}"] = np.asarray(
                v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def build_fixture():
    """The fixture's contents: the loops' inputs and the JAX package's
    results."""
    import jax
    import jax.numpy as jnp

    from srbx.models import a1 as ja1
    from srbx.sim import closedloop as jcl
    from srbx.sim import wholebody as jwb

    jax.config.update("jax_enable_x64", True)
    inp = loop_inputs()
    out = dict(inp)
    jinp = {k: (v if k == "est_key" else jnp.asarray(v))
            for k, v in inp.items()}
    for form, (fn, backend, _, mpc_cfg, qp_cfg, ll_qp_cfg, est) in \
            LOOP_FORMS.items():
        cfgs = (_jcfg(mpc_cfg), _jcfg(LL), _jcfg(MOTION), _jcfg(qp_cfg),
                None if ll_qp_cfg is None else _jcfg(ll_qp_cfg))
        # tile 8 > B: the JAX package's NMPC then takes its generic branch
        # (its lanes-last gate asks B % tile == 0; the port's does not), as
        # in tests/test_torch_team.py, and both solve the same QPs
        extra = {"tile": 8}

        def call(jinp=jinp, form=form, cfgs=cfgs, est=est, extra=extra):
            return _loop_call(
                form, cfgs, jinp, jcl.run_batch, jcl.run_team_batch,
                jcl.run_batch_event, jwb.SimConfig(), ja1.model(),
                jcl.LoopConfig, None if est is None else _jest(est), extra)

        with _interpreted():
            res = jax.jit(call)()
        _loop_record(form, res, out)
    return out


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return dict(f)


def test_fixture_matches_inputs(fx):
    for k, v in loop_inputs().items():
        np.testing.assert_array_equal(fx[k], v, err_msg=k)


@pytest.mark.parametrize("form", list(LOOP_FORMS))
def test_loops_match_jax(fx, form):
    fn, _, _, mpc_cfg, qp_cfg, ll_qp_cfg, est = LOOP_FORMS[form]
    res = _loop_call(form, (mpc_cfg, LL, MOTION, qp_cfg, ll_qp_cfg), fx,
                     closedloop.run_batch, closedloop.run_team_batch,
                     closedloop.run_batch_event, SIM, a1.model(),
                     closedloop.LoopConfig, est, {"device": "cpu"})
    got = _loop_record(form, res, {})
    pre = f"loop.{form}"
    keys = sorted(k for k in fx if k.startswith(pre + "."))
    assert keys == sorted(got), (keys, sorted(got))
    for k in keys:
        if fx[k].dtype.kind in "biu" or k.endswith(("qp_ok", "llok",
                                                    "mpc_ok")):
            np.testing.assert_array_equal(got[k], fx[k], err_msg=k)
        else:
            _close(got[k], fx[k], LOOP_TOL, relative=True, what=k)
    assert (est is None) == (f"{pre}.est_rmse" not in got)
    if fn == "run_batch_event":
        # the poll of tick 0, its solution delivered at tick 2
        assert got[f"{pre}.mpc_solves"].min() >= 1
        assert bool(res.agent.mpc_available.all())


@pytest.mark.slow
def test_fixture_provenance(fx):
    """The committed fixture is what the JAX package computes."""
    live = build_fixture()
    assert set(live) == set(fx)
    for k, v in live.items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(fx[k], v, err_msg=k)
        else:
            _close(fx[k], v, TOL, relative=True, what=k)


# ------------------------------ the goldens ------------------------------- #

def _golden(name):
    with open(GOLDEN) as f:
        return json.load(f)[name]


def _golden_lanes():
    """The goldens' two lanes (scripts/make_golden.py:122-146, 168-195):
    the two-agent APF reference among obstacles 100 m away."""
    from srbx_torch import refplan

    ref = refplan.generate(refplan.two_agent_config(loop_size=20_000),
                           torch.tensor([0.0, 0.0, 0.0, -1.0],
                                        dtype=torch.float64),
                           torch.full((2, 20), 100.0, dtype=torch.float64),
                           device="cpu")
    return (ref.pr[0:2].expand(2, -1, -1), ref.prd[0:2].expand(2, -1, -1),
            torch.tensor([[0.0, 0.0], [0.0, -1.0]], dtype=torch.float64),
            torch.full((2, 2, 20), 100.0, dtype=torch.float64))


@pytest.mark.slow
def test_golden_est_loop_through_the_port():
    """The `est_loop` golden: run_batch with estimation in the loop at the
    key PRNGKey(2024), MpcConfig(use_sqp=False), the full LL build, 300
    stand ticks and 3 domains, "xla"; est_rmse 1e-6, COM every 20 ticks and
    final q 1e-5 (the golden's bounds)."""
    gold = _golden("est_loop")
    res = closedloop.run_batch(
        MpcConfig(use_sqp=False), LL, MOTION, QP, SIM,
        closedloop.LoopConfig(stand_ticks=300, n_domains=3,
                              ticks_per_domain=172), a1.model(),
        *_golden_lanes(), backend="xla", est_cfg=EST,
        est_key=prng.key(2024, "cpu"), device="cpu")
    np.testing.assert_allclose(res.est_rmse.numpy(),
                               np.asarray(gold["est_rmse"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res.com_hist[:, :, ::20].numpy(),
                               np.asarray(gold["com_subsampled"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(res.sim.q.numpy(), np.asarray(gold["final_q"]),
                               rtol=0, atol=1e-5)


@pytest.mark.slow
def test_golden_event_loop_through_the_port():
    """The `event_loop` golden: run_batch_event, 500 ticks after 300 stand
    ticks, the HL polled every 20 ticks, MpcConfig(use_sqp=False), "xla";
    trigger ticks, domains and solves exact, COM every 20 ticks and final q
    1e-5 (the golden's bounds)."""
    gold = _golden("event_loop")
    res = closedloop.run_batch_event(
        MpcConfig(use_sqp=False), LL, MOTION, QP, SIM,
        closedloop.LoopConfig(stand_ticks=300, n_domains=4,
                              ticks_per_domain=172), a1.model(),
        *_golden_lanes(), 500, backend="xla", mpc_period_ticks=20,
        device="cpu")
    for lane, expect in enumerate(gold["trigger_ticks"]):
        np.testing.assert_array_equal(
            np.nonzero(res.trigger_hist[lane].numpy())[0], expect)
    np.testing.assert_array_equal(res.domains.numpy(), gold["domains"])
    np.testing.assert_array_equal(res.mpc_solves.numpy(), gold["mpc_solves"])
    np.testing.assert_allclose(res.com_hist[:, ::20].numpy(),
                               np.asarray(gold["com_subsampled"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(res.sim.q.numpy(), np.asarray(gold["final_q"]),
                               rtol=0, atol=1e-5)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "tests"))
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(f"wrote {FIXTURE}")
