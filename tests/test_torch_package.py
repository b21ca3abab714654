"""srbx_torch's package boundary: neither jax nor the JAX package at
import, its own copy of the configuration, the kernel build's errors, the
fused-IPM wrapper's input checks, the entry points' default device, the
branches that are not ported, and the state conversion between the two
packages."""

import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import srbx.config as jconfig
from srbx import agent as jagent
from srbx import lowlevel as jlowlevel
from srbx import motion as jmotion
from srbx import mpc as jmpc
from srbx import mpc_batch as jmpc_batch
from srbx import refplan as jrefplan
from srbx import sqp as jsqp
from srbx.config import MpcConfig, QpConfig
from srbx.estimation import contact as jcontact
from srbx.estimation import pipeline as jpipeline
from srbx.eval import campaign as jcampaign
from srbx.ops import qp as jqp
from srbx.ops import qp_batch as jqp_batch
from srbx.ops import qp_fused as jqp_fused
from srbx.models import rbd as jrbd
from srbx.ops import spd as jspd
from srbx.sim import closedloop as jclosedloop
from srbx.sim import sensors as jsensors
from srbx.sim import wholebody as jwb
from srbx_torch import (agent, config, convert, lowlevel, motion, mpc,
                        mpc_batch, refplan, sqp)
from srbx_torch.estimation import contact, pipeline
from srbx_torch.eval import campaign
from srbx_torch.models import a1, rbd
from srbx_torch.ocp import default_footholds
from srbx_torch.ops import _build, qp, qp_batch, qp_fused, spd
from srbx_torch.sim import closedloop, sensors, wholebody as wb
from srbx_torch.utils import prng

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (ROOT / "srbx_torch").rglob("*.py"))


# the port's own scripts, imported (not run) with the package
SCRIPTS = [ROOT / "scripts" / name for name in (
    "torch_campaign_push.py", "torch_clf_loop.py", "torch_push_compare.py",
    "torch_velocity_gait_depth.py", "torch_smoke_parts.py",
    "torch_per_agent_depth.py")]


def test_import_pulls_in_no_jax():
    """Importing every module of srbx_torch, and the port's scripts, loads
    neither jax nor any module of the JAX package `srbx`."""
    assert {"srbx_torch.sim.closedloop", "srbx_torch.ops.spd",
            "srbx_torch.models.rbd", "srbx_torch.lowlevel", "srbx_torch.gait",
            "srbx_torch.eval", "srbx_torch.eval.campaign",
            "srbx_torch.eval.analysis",
            "srbx_torch.eval.run_campaign_ab",
            "srbx_torch.eval.run_team", "srbx_torch.estimation.pipeline",
            "srbx_torch.estimation.kalman", "srbx_torch.estimation.kinest",
            "srbx_torch.sim.sensors", "srbx_torch.utils.prng"} <= set(MODULES)
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            f"for path in {[str(p) for p in SCRIPTS]!r}:\n"
            "    spec = importlib.util.spec_from_file_location('s', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'srbx')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["LipConfig", "MpcConfig", "QpConfig",
                                  "RefPlanConfig", "LowLevelConfig",
                                  "MotionConfig"])
def test_config_is_a_copy_of_the_jax_packages(name):
    """Every field, default and derived property equals srbx.config's."""
    mine, theirs = getattr(config, name), getattr(jconfig, name)
    assert [(f.name, f.type) for f in dataclasses.fields(mine)] == \
        [(f.name, f.type) for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(mine()) == dataclasses.asdict(theirs())
    props = [k for k, v in vars(theirs).items() if isinstance(v, property)]
    assert props == [k for k, v in vars(mine).items()
                     if isinstance(v, property)]
    for variant in ({}, {"condensed": True, "elide_box_rows": True}):
        if name == "MpcConfig" or not variant:
            a, b = mine(**variant), theirs(**variant)
            assert [getattr(a, p) for p in props] == \
                [getattr(b, p) for p in props]


def test_gait_and_dof_are_the_jax_packages():
    assert [(g.name, int(g)) for g in config.Gait] == \
        [(g.name, int(g)) for g in jconfig.Gait]
    assert config.TOTAL_DOF == jconfig.TOTAL_DOF


def _default(value):
    """A default in a form that compares across the two packages: a
    configuration by its fields, a dtype by its name."""
    if dataclasses.is_dataclass(value):
        return type(value).__name__, dataclasses.asdict(value)
    if "float" in str(value) or "int" in str(value):
        return "dtype", str(value).rsplit(".", 1)[-1].rstrip("'>")
    return value


@pytest.mark.parametrize("mine,theirs", [
    (mpc_batch.run_nmpc_batch, jmpc_batch.run_nmpc_batch),
    (qp_batch.solve, jqp_batch.solve),
    (closedloop.run_batch, jclosedloop.run_batch),
    (qp_fused.solve, jqp_fused.solve),
    (qp_fused.solve_lanes_last, jqp_fused.solve_lanes_last),
    (spd.solve, jspd.solve), (spd.inverse, jspd.inverse),
    (campaign.run_campaign_batch, jcampaign.run_campaign_batch),
    (campaign._run_campaign_batch_core, jcampaign._run_campaign_batch_core),
    (closedloop.run_team_batch, jclosedloop.run_team_batch),
    (wb.step_batch, jwb.step_batch),
    (closedloop.run_batch_event, jclosedloop.run_batch_event),
    (pipeline.update, jpipeline.update), (sensors.read, jsensors.read),
    (campaign.run_campaign_chunked, jcampaign.run_campaign_chunked),
    (closedloop.run_velocity_gait, jclosedloop.run_velocity_gait),
    (motion.plan_walk, jmotion.plan_walk),
    (motion.plan_pace, jmotion.plan_pace),
    (motion.com_des_from_velocity, jmotion.com_des_from_velocity),
    (motion._ramp_vel, jmotion._ramp_vel),
    (qp.solve, jqp.solve), (qp.solve_batch, jqp.solve_batch),
    (sqp.solve, jsqp.solve), (sqp.solve_penalty, jsqp.solve_penalty),
    (mpc.nmpc_qp_inputs, jmpc.nmpc_qp_inputs), (mpc.run_nmpc, jmpc.run_nmpc),
    (mpc.eval_com_traj, jmpc.eval_com_traj),
    (lowlevel.calc_torque, jlowlevel.calc_torque), (agent.tick, jagent.tick),
    (wb.step, jwb.step), (closedloop.run, jclosedloop.run),
    (closedloop.run_team, jclosedloop.run_team),
], ids=["run_nmpc_batch", "qp_batch_solve", "run_batch", "qp_fused_solve",
        "solve_lanes_last", "spd_solve", "spd_inverse", "run_campaign_batch",
        "run_campaign_batch_core", "run_team_batch", "step_batch",
        "run_batch_event", "pipeline_update", "sensors_read",
        "run_campaign_chunked", "run_velocity_gait", "plan_walk",
        "plan_pace", "com_des_from_velocity", "ramp_vel", "qp_solve",
        "qp_solve_batch", "sqp_solve", "solve_penalty", "nmpc_qp_inputs",
        "run_nmpc", "eval_com_traj", "calc_torque", "tick", "step", "run",
        "run_team"])
def test_entry_points_keep_the_jax_defaults(mine, theirs):
    """Every parameter that a port entry point shares with its JAX
    counterpart has the same default, so that a call ported from the JAX
    package without that argument runs the same branch."""
    ours = inspect.signature(mine).parameters
    ref = inspect.signature(theirs).parameters
    shared = [name for name in ours if name in ref]
    assert shared[:2] == list(ours)[:2]
    assert {n: _default(ours[n].default) for n in shared} == \
        {n: _default(ref[n].default) for n in shared}


@pytest.mark.parametrize("mine,theirs,ours_only,theirs_only,key", [
    (campaign.run_campaign_batch, jcampaign.run_campaign_batch,
     ["dtype", "device"], ["tile"], "key"),
    (campaign._run_campaign_batch_core, jcampaign._run_campaign_batch_core,
     [], ["tile"], "k_run"),
    (campaign.run_campaign_chunked, jcampaign.run_campaign_chunked,
     ["dtype", "device"], [], "key"),
], ids=["run_campaign_batch", "run_campaign_batch_core",
        "run_campaign_chunked"])
def test_campaign_signatures_differ_only_as_documented(mine, theirs,
                                                       ours_only,
                                                       theirs_only, key):
    """The campaign entries take the JAX arguments in the JAX order, the
    JAX key (`key`, the core's `k_run`) in its place, without the TPU-only
    tile; run_campaign_batch and run_campaign_chunked add the run's dtype
    and device at the end. A torch.Generator took the key's place until
    the JAX package's streams were reproduced."""
    ours = list(inspect.signature(mine).parameters)
    ref = list(inspect.signature(theirs).parameters)
    assert [n for n in ours if n not in ref] == ours_only
    assert [n for n in ref if n not in ours] == theirs_only
    assert [n for n in ours if n in ref] == [n for n in ref if n in ours]
    assert ours.index(key) == ref.index(key)
    assert ours[len(ours) - len(ours_only):] == ours_only


def test_run_team_batch_signature_differs_only_as_documented():
    """run_team_batch takes the JAX arguments in the JAX order, without the
    TPU-only tile, and adds device at the end."""
    ours = list(inspect.signature(closedloop.run_team_batch).parameters)
    ref = list(inspect.signature(jclosedloop.run_team_batch).parameters)
    assert [n for n in ref if n not in ours] == ["tile"]
    assert [n for n in ours if n not in ref] == ["device"] == ours[-1:]
    assert [n for n in ours if n in ref] == [n for n in ref if n != "tile"]


@pytest.mark.parametrize("mine,theirs,ours_only,theirs_only", [
    (spd.solve, jspd.solve, [], ["backend", "tile", "interpret"]),
    (spd.inverse, jspd.inverse, [], ["backend", "tile", "interpret"]),
    (rbd.forward_dynamics_batch, jrbd.forward_dynamics_batch, [],
     ["backend", "tile"]),
    (refplan.generate, jrefplan.generate, ["device"], []),
    (wb.step_batch, jwb.step_batch, [], ["tile"]),
    (closedloop.run_velocity_gait, jclosedloop.run_velocity_gait,
     ["device"], ["tile"]),
    (motion.plan_walk, jmotion.plan_walk, [], []),
    (motion.plan_pace, jmotion.plan_pace, [], []),
    (motion.plan_inplace_trot, jmotion.plan_inplace_trot, [], []),
    (motion.plan_tap, jmotion.plan_tap, [], []),
    (motion.plan_inplace_walk, jmotion.plan_inplace_walk, [], []),
    (motion.pose_com, jmotion.pose_com, [], []),
    (motion.com_des_from_velocity, jmotion.com_des_from_velocity, [], []),
    (motion._ramp_vel, jmotion._ramp_vel, [], []),
    (qp.solve, jqp.solve, [], []), (qp.solve_batch, jqp.solve_batch, [], []),
    (sqp.solve, jsqp.solve, [], []),
    (sqp.solve_penalty, jsqp.solve_penalty, [], []),
    (mpc.nmpc_qp_inputs, jmpc.nmpc_qp_inputs, [], []),
    (mpc.run_nmpc, jmpc.run_nmpc, [], []),
    (mpc.eval_com_traj, jmpc.eval_com_traj, [], []),
    (lowlevel.calc_torque, jlowlevel.calc_torque, [], []),
    (agent.tick, jagent.tick, [], []), (wb.step, jwb.step, [], []),
    (closedloop.run, jclosedloop.run, ["device"], []),
    (closedloop.run_team, jclosedloop.run_team, ["device"], []),
], ids=["spd_solve", "spd_inverse", "forward_dynamics_batch", "generate",
        "step_batch", "run_velocity_gait", "plan_walk", "plan_pace",
        "plan_inplace_trot", "plan_tap", "plan_inplace_walk", "pose_com",
        "com_des_from_velocity", "ramp_vel", "qp_solve", "qp_solve_batch",
        "sqp_solve", "solve_penalty", "nmpc_qp_inputs", "run_nmpc",
        "eval_com_traj", "calc_torque", "tick", "step", "run", "run_team"])
def test_dropped_parameters_are_documented(mine, theirs, ours_only,
                                           theirs_only):
    """The parameters a port entry point drops from its JAX counterpart, and
    each named in its docstring (or its module's) as not taken: tile and
    interpret are the TPU kernels', the backend of spd and
    forward_dynamics_batch picks a TPU kernel or jax.scipy's Cholesky (the
    port runs K2a and K2b on the card). The rest keep the JAX order;
    refplan.generate and run_velocity_gait add device, refplan.generate
    takes return_raw, step_batch base_force; the gait planners and the
    per-agent path take the JAX parameters as they are (run and run_team
    add device)."""
    ours = list(inspect.signature(mine).parameters)
    ref = list(inspect.signature(theirs).parameters)
    assert [n for n in ref if n not in ours] == theirs_only
    assert [n for n in ours if n not in ref] == ours_only == ours[
        len(ours) - len(ours_only):]
    assert [n for n in ours if n in ref] == [n for n in ref if n in ours]
    doc = (mine.__doc__ or "") + (sys.modules[mine.__module__].__doc__ or "")
    for name in theirs_only:
        assert f"`{name}`" in doc or f" {name}" in doc, name


def test_generate_return_raw_is_the_jax_packages():
    """refplan.generate(return_raw=True) adds every step's pre-step state,
    as the JAX package does, and leaves the reference as it was."""
    import jax
    import jax.numpy as jnp

    cfg = refplan.two_agent_config(loop_size=130)
    p0 = np.array([0.0, 0.5, 0.0, -0.5])
    pobs = np.stack([np.linspace(1.0, 4.0, 20), np.linspace(-1, 1, 20)])
    ref, (pos, vel) = refplan.generate(cfg, torch.tensor(p0),
                                       torch.tensor(pobs), return_raw=True,
                                       device="cpu")
    plain = refplan.generate(cfg, torch.tensor(p0), torch.tensor(pobs),
                             device="cpu")
    assert torch.equal(ref.pr, plain.pr) and torch.equal(ref.prd, plain.prd)
    with jax.enable_x64(True):
        jref, (jpos, jvel) = jax.jit(lambda p, o: jrefplan.generate(
            jrefplan.two_agent_config(loop_size=130), p, o,
            return_raw=True))(jnp.asarray(p0), jnp.asarray(pobs))
        jpos, jvel = np.asarray(jpos), np.asarray(jvel)
    assert pos.shape == jpos.shape == (130, 2, 2)
    np.testing.assert_allclose(pos.numpy(), jpos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(vel.numpy(), jvel, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ref.pr.numpy(), np.asarray(jref.pr), rtol=0,
                               atol=1e-12)


def test_entry_points_default_to_the_card():
    """device=None means the CUDA card: without one, the call fails rather
    than running on the CPU."""
    cfg = refplan.two_agent_config(loop_size=40)
    calls = [lambda: convert.from_numpy(np.zeros(2)),
             lambda: refplan.resolve_matrices(cfg),
             lambda: refplan.generate(cfg, torch.zeros(4),
                                      torch.zeros(2, 20)),
             lambda: campaign.sample_obstacles(prng.key(0, "cpu"), 2, 20),
             lambda: campaign.run_campaign_batch(
                 MpcConfig(use_sqp=False, condensed=True, elide_box_rows=True,
                           elide_simplex=True), QpConfig(),
                 campaign.CampaignConfig(n_domains=1), cfg, torch.zeros(4),
                 prng.key(0, "cpu"), 1),
             lambda: closedloop.run_team_batch(
                 *_loop_args()[:7], np.zeros((1, 4, 2, 10)),
                 np.zeros((1, 4, 2, 10)), np.zeros((1, 4, 2)),
                 np.full((1, 2, 20), 100.0))[1],
             lambda: closedloop.run_batch_event(*_loop_args(), 1).com_hist,
             lambda: closedloop.run_velocity_gait(
                 config.Gait.WALK, *_loop_args()[1:7], np.zeros((2, 2)),
                 1).com_hist,
             lambda: closedloop.run(
                 *_loop_args()[:7], np.zeros((2, 10)), np.zeros((2, 10)),
                 np.zeros(2), np.full((2, 20), 100.0)).com_hist,
             lambda: closedloop.run_team(
                 *_loop_args()[:7], np.zeros((2, 2, 10)),
                 np.zeros((2, 2, 10)), np.zeros((2, 2)),
                 np.full((2, 20), 100.0))[1],
             lambda: prng.key(0)]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            first = out[0] if isinstance(out, tuple) else out
            assert first.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    assert {"qp_fused.cu", "qp_general.cu", "spd.cu"} <= {
        s.name for s in _build.sources()}
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "qp_fused.cu").write_text(
        (_build.CSRC_DIR / "qp_fused.cu").read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    assert _build.library_path().name != first.name


def _qp(n=13, mi=28, bsz=5, dtype=torch.float64):
    return (torch.eye(n, dtype=dtype)[:, :, None].repeat(1, 1, bsz),
            torch.zeros(n, bsz, dtype=dtype),
            torch.zeros(mi, n, bsz, dtype=dtype),
            torch.ones(mi, bsz, dtype=dtype))


@pytest.mark.parametrize("bad,error", [
    (lambda P, c, G, h: _qp(n=12), ValueError),                 # n != 13
    (lambda P, c, G, h: _qp(mi=129), ValueError),               # mi > 128
    (lambda P, c, G, h: _qp(dtype=torch.float16), TypeError),
    (lambda P, c, G, h: (P, c, G.transpose(0, 2).contiguous()
                         .transpose(0, 2), h), ValueError),     # strided
    (lambda P, c, G, h: (P, c.float(), G, h), TypeError),       # mixed dtype
    (lambda P, c, G, h: (P[:, :, :4], c, G, h), ValueError),    # shapes
    (lambda P, c, G, h: tuple(t.to("meta") for t in (P, c, G, h)),
     ValueError),                                               # device
], ids=["n", "mi", "dtype", "contiguous", "mixed_dtype", "shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        qp_fused.solve_lanes_last(*bad(*_qp()), QpConfig())
    assert qp_fused.solve_lanes_last.launches == 0


def test_wrapper_cpu_path_is_the_plain_version():
    P, c, G, h = _qp()
    G[0, 0] = 1.0                         # x_0 <= 1 binds: c pulls it to 2
    c[0] = -2.0
    out = qp_fused.solve_lanes_last(P, c, G, h, QpConfig())
    ref = qp_fused.solve_lanes_last_plain(P, c, G, h, QpConfig())
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    np.testing.assert_allclose(out[0][0].numpy(), 1.0, atol=1e-6)
    assert out[3][2].all() and qp_fused.solve_lanes_last.launches == 0


def _cycle_inputs(bsz=2):
    """Small cycle inputs: lanes at rest at the origin, a straight-line
    reference, obstacles far away."""
    t = torch.linspace(0.0, 1.0, 40, dtype=torch.float64)
    pr = torch.stack([t, torch.zeros_like(t)]).expand(bsz, -1, -1)
    q = torch.zeros(bsz, 2, dtype=torch.float64)
    return (mpc.MpcCarry(torch.zeros(bsz, dtype=torch.int32),
                         torch.zeros(bsz, 4, dtype=torch.float64)),
            q, q.clone(), default_footholds(q), torch.ones(bsz, 4,
                                                           dtype=q.dtype),
            pr, 0.2 * torch.ones_like(pr), q.clone(),
            torch.full((bsz, 2, 20), 50.0, dtype=q.dtype))


@pytest.mark.parametrize("change", [
    dict(condensed=False, backend="pallas"), dict(backend="xla"),
    dict(backend="pallas"),
    dict(cfg=MpcConfig(elide_simplex=False, elide_box_rows=True)),
    dict(cfg=MpcConfig(use_sqp=False, elide_simplex=True,
                       elide_box_rows=True)),
    dict(backend="lanes"),
], ids=["uncondensed", "xla", "pallas", "no_elide_simplex", "no_sqp",
        "lanes"])
def test_unported_branches_raise(change, monkeypatch):
    """Which branch of run_nmpc_batch runs. These configurations raised
    NotImplementedError before the generic branch was ported. Now every
    configuration but the condensed, simplex-eliminated one on the "fused"
    backend (with or without SQP) takes the generic branch through
    qp_batch.solve, never the lanes-last kernel K1a; backend="fused" there
    reaches K1b, which raised on the NMPC's shapes until (n, me) = (41, 28)
    and (17, 4) were built and now solves them (no_elide_simplex); the
    pure-JAX "lanes" backend is not ported and raises."""
    kw = dict(condensed=True, backend="fused")
    cfg = change.pop("cfg", MpcConfig(use_sqp=True, sqp_iters=2,
                                      elide_simplex=True,
                                      elide_box_rows=True))
    kw.update(change)
    calls = {"lanes_last": 0, "qp_batch": 0}
    depth = [0]

    def counting(name, fn):
        def wrapper(*a, **k):          # outermost calls only
            calls[name] += depth[0] == 0
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return wrapper

    k1a = qp_fused.solve_lanes_last
    monkeypatch.setattr(qp_fused, "solve_lanes_last",
                        counting("lanes_last", k1a))
    monkeypatch.setattr(qp_batch, "solve",
                        counting("qp_batch", qp_batch.solve))
    lanes_last = kw["condensed"] and kw["backend"] == "fused" and \
        cfg.elide_simplex
    solves = 1 + (cfg.sqp_iters if cfg.use_sqp else 0)
    if kw["backend"] == "lanes":
        with pytest.raises(NotImplementedError):
            mpc_batch.run_nmpc_batch(cfg, QpConfig(), *_cycle_inputs(), **kw)
        assert calls == {"lanes_last": 0, "qp_batch": 1}
        return
    out = mpc_batch.run_nmpc_batch(cfg, QpConfig(), *_cycle_inputs(), **kw)
    assert out.qp_converged.all() and torch.isfinite(out.states).all()
    assert calls == ({"lanes_last": solves, "qp_batch": 0} if lanes_last
                     else {"lanes_last": 0, "qp_batch": solves})
    assert k1a.launches == 0


def test_from_numpy_to_numpy_round_trip():
    rng = np.random.default_rng(0)
    jcarry = jmpc.MpcCarry(np.arange(3, dtype=np.int32), rng.normal(size=(3, 4)))
    jref = jrefplan.RefTraj(rng.normal(size=(4, 6)), rng.normal(size=(4, 6)))
    tree = {"carry": jcarry, "ref": jref, "pobs": rng.normal(size=(3, 2, 5)),
            "none": None}
    t = convert.from_numpy(tree, device="cpu", dtype=torch.float32)
    assert isinstance(t["carry"], mpc.MpcCarry)
    assert isinstance(t["ref"], refplan.RefTraj)
    assert t["carry"].gait_domain.dtype == torch.int32
    assert t["carry"].alpha_buffer.dtype == torch.float32
    assert t["none"] is None
    back = convert.to_numpy(convert.from_numpy(tree, device="cpu"))
    assert isinstance(back["carry"], mpc.MpcCarry)
    for a, b in ((back["carry"].gait_domain, jcarry.gait_domain),
                 (back["carry"].alpha_buffer, jcarry.alpha_buffer),
                 (back["ref"].pr, jref.pr), (back["pobs"], tree["pobs"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_campaign_result_round_trip():
    """The JAX package's CampaignResult in numpy form becomes the port's,
    with the same fields and values, and comes back."""
    rng = np.random.default_rng(2)
    res = jcampaign.CampaignResult(rng.random((3, 2)) > 0.5,
                                   rng.normal(size=(3, 2)),
                                   rng.normal(size=(3, 2)),
                                   rng.normal(size=(3, 2, 2)),
                                   rng.random(3), rng.normal(size=(3, 4, 2, 2)))
    got = convert.from_numpy(res, device="cpu")
    assert isinstance(got, campaign.CampaignResult)
    assert got._fields == res._fields and got.success.dtype == torch.bool
    for a, b in zip(convert.to_numpy(got), res):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _loop_args(bsz=2):
    return (MpcConfig(use_sqp=True, sqp_iters=1, condensed=True,
                      elide_box_rows=True, elide_simplex=True),
            config.LowLevelConfig(), config.MotionConfig(), QpConfig(),
            wb.SimConfig(), closedloop.LoopConfig(1, 1, 1), a1.model(),
            np.zeros((bsz, 2, 10)), np.zeros((bsz, 2, 10)),
            np.zeros((bsz, 2)), np.full((bsz, 2, 20), 100.0))


@pytest.mark.parametrize("change", [
    dict(backend="xla"), dict(ll_reduced=True),
    dict(est_cfg=pipeline.EstConfig()),
    dict(stiction=True), dict(push=(np.array([[30.0, 0.0, 0.0],
                                              [0.0, -60.0, 0.0]]),
                                    np.zeros(2, np.int32),
                                    np.ones(2, np.int32))),
    dict(mpc_cfg=MpcConfig(use_sqp=True, condensed=False)),
    dict(mpc_cfg=MpcConfig(use_sqp=True, condensed=False, horizon=5)),
], ids=["xla", "ll_reduced", "est_cfg", "stiction", "push", "uncondensed",
        "unbuilt_shape"])
def test_run_batch_unported_options_raise(change):
    """The options of the JAX package's run_batch that the port does not run
    raise NotImplementedError before any tick: on backend "fused" an NMPC
    whose QPs the fused kernels are not built for (a horizon of 5 makes
    (n, me) = (47, 35)). Backend "xla", the reduced LL build, the
    uncondensed NMPC on "fused" (K1b at n 41, me 28, built since),
    estimation in the loop, stick-slip contact and trunk pushes raised too
    until they were ported; they now run the loop (one stand and one trot
    tick) to finite states, with estimation an est_rmse of each lane, with
    stiction each toe's slip, with a push the lanes' pulses in the trot
    tick."""
    args = list(_loop_args())
    match = r"\(47, 35\)" if "mpc_cfg" in change else None
    ported = (set(change) <= {"backend", "ll_reduced", "mpc_cfg", "est_cfg",
                              "stiction", "push"}
              and change.get("mpc_cfg", MpcConfig()).horizon == 4)
    if "mpc_cfg" in change:
        args[0] = change.pop("mpc_cfg")
    if ported:
        res = closedloop.run_batch(*args, device="cpu", **change)
        assert res.com_hist.shape == (2, 1, 1, 3)
        assert torch.isfinite(res.sim.q).all() and res.qp_ok.min() == 1.0
        assert (res.est_rmse is None) == ("est_cfg" not in change)
        assert (res.sim.con is None) == ("stiction" not in change)
        if "est_cfg" in change:
            assert res.est_rmse.shape == (2, 2)
            assert torch.isfinite(res.est_rmse).all()
        if "stiction" in change:
            assert res.sim.con.slip.shape == (2, 4)
            assert res.sim.con.anchor.shape == (2, 4, 2)
        if "push" in change:
            calm = closedloop.run_batch(*args, device="cpu")
            dv = (res.sim.qd[:, 0:2] - calm.sim.qd[:, 0:2]).numpy()
            force = change["push"][0][:, 0:2]
            # the pulse accelerates each trunk along its own force
            assert ((dv * force).sum(1) > 0).all()
        return
    with pytest.raises(NotImplementedError, match=match):
        closedloop.run_batch(*args, device="cpu", **change)


@pytest.mark.parametrize("change", [
    dict(est_cfg=pipeline.EstConfig()), dict(backend="lanes"),
    dict(mpc_cfg=MpcConfig(use_sqp=True, condensed=True)),
    dict(mpc_cfg=MpcConfig(use_sqp=True, condensed=True, horizon=5)),
], ids=["est_cfg", "lanes", "condensed_not_elided", "unbuilt_shape"])
def test_run_team_batch_unported_options_raise(change):
    """run_team_batch raises on the JAX package's pure-JAX "lanes" backend
    and on backend "fused" for an NMPC whose QPs the fused kernels are not
    built for (condensed with a horizon of 5: (n, me) = (17, 5)). The
    condensed NMPC with its simplex rows (K1b at (17, 4), built since) and
    estimation in the loop raised too; they now run the team (one stand and
    one trot tick, 4 agents) to finite states, with estimation a 5th
    element, est_rmse (1, 4, 2)."""
    args = list(_loop_args())[:7] + [np.zeros((1, 4, 2, 10)),
                                      np.zeros((1, 4, 2, 10)),
                                      np.zeros((1, 4, 2)),
                                      np.full((1, 2, 20), 100.0)]
    match = r"\(17, 5\)" if "mpc_cfg" in change else None
    if "mpc_cfg" in change:
        args[0] = change.pop("mpc_cfg")
    if args[0].horizon == 4 and args[0].condensed and set(change) <= {
            "est_cfg"}:
        out = closedloop.run_team_batch(*args, device="cpu", **change)
        sims, com_ends, margins, llok = out[:4]
        assert com_ends.shape == (1, 1, 4, 3) and margins.shape == (1, 1, 4)
        assert torch.isfinite(sims.q).all() and llok.min() == 1.0
        assert len(out) == (5 if change else 4)
        if change:
            assert out[4].shape == (1, 4, 2)
            assert torch.isfinite(out[4]).all()
        return
    with pytest.raises(NotImplementedError, match=match):
        closedloop.run_team_batch(*args, device="cpu", **change)


@pytest.mark.parametrize("change", [
    dict(backend="lanes"), dict(backend="tpu"),
    dict(mpc_cfg=MpcConfig(use_sqp=True, condensed=False, horizon=5)),
], ids=["lanes", "unknown", "unbuilt_shape"])
def test_run_batch_event_unported_options_raise(change):
    """run_batch_event refuses what the other loops refuse, before any tick:
    the pure-JAX "lanes" backend (NotImplementedError), an unknown backend
    (ValueError), and on "fused" an NMPC shape no kernel is built for."""
    args = list(_loop_args())
    if "mpc_cfg" in change:
        args[0] = change.pop("mpc_cfg")
    error = ValueError if change.get("backend") == "tpu" else \
        NotImplementedError
    with pytest.raises(error):
        closedloop.run_batch_event(*args, 1, device="cpu", **change)


def test_whole_body_state_round_trip():
    """The JAX package's SimState, AgentState (with its PlannerState and
    ConState) and LoopResult in numpy form become the port's types with the
    same fields and values, and come back."""
    rng = np.random.default_rng(1)
    bsz = 3
    f = lambda *s: rng.normal(size=(bsz,) + s)            # noqa: E731
    i = lambda *s: rng.integers(0, 9, (bsz,) + s).astype(np.int32)  # noqa
    flag = lambda *s: rng.random((bsz,) + s) > 0.5        # noqa: E731
    planner = jmotion.PlannerState(f(12), f(3, 4), f(3, 4), f(3), f(), i(4),
                                   f(3), f(3), i())
    con = jcontact.ConState(i(4), flag(4), flag(4), flag(4), i(4), i(4),
                            i(4), flag(), i())
    ast = jagent.AgentState(f(), i(), planner, con, f(4, 5), f(4, 4), flag(),
                            f(18))
    sim = jwb.SimState(f(18), f(18))
    res = jclosedloop.LoopResult(sim, ast, f(1, 3, 3), f(), f(), f(1, 2))
    got = convert.from_numpy(res, device="cpu")
    assert isinstance(got, closedloop.LoopResult)
    assert isinstance(got.sim, wb.SimState) and got.sim.con is None
    assert isinstance(got.agent, agent.AgentState)
    assert isinstance(got.agent.planner, motion.PlannerState)
    assert isinstance(got.agent.con, contact.ConState)
    assert got.agent.con.hist.dtype == torch.int32
    assert got.agent.con.est.dtype == torch.bool
    back = convert.to_numpy(got)
    flat = []

    def walk(a, b):
        if hasattr(a, "_fields"):
            assert a._fields == b._fields
            for x, y in zip(a, b):
                walk(x, y)
        elif a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            flat.append(a)

    walk(back, res)
    assert len(flat) == 30
