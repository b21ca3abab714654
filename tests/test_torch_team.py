"""The team slice of srbx_torch against a fixture that the JAX package
computed, in float64 on the CPU.

The JAX package's loops cost minutes per call on a CPU (its "fused" forms
run the Pallas kernels in interpret mode), so the tier-1 tests compare the
port with `tests/data/torch_team_jax.npz`, which holds inputs made with
numpy from fixed seeds (and the port's own APF reference of four agents)
and what the JAX package computes from them:

* `lowlevel.ll_qp_build_reduced`, `expand_reduced_x` and
  `ll_qp_finish_reduced` on two standing and two trotting lanes with mixed
  contacts, a desired force and a given solution;
* the reduced LL QPs of those lanes (n 25, me 12, mi 45) solved by
  `qp_batch.solve(backend="xla")` and by the fused IPM `qp_fused.solve` in
  interpret mode, raw and after 5 Ruiz sweeps, and random well-conditioned
  QPs of that shape solved the same two ways;
* `closedloop._tick_batch` on backends "xla", "pallas" and "fused" (the
  Pallas kernels in interpret mode), with the full and the reduced LL build,
  from the trotting lanes;
* `closedloop.run_batch(backend="xla", ll_reduced=True)` over 3 stand and
  3 trot ticks with the uncondensed SCP NMPC of the `team` golden, 2 lanes;
* `closedloop.run_team_batch` on 1 scenario x 4 agents over 3 stand and 3
  trot ticks, in two forms: the `team` golden's configuration on "xla", and
  the production configuration (condensed lanes-last NMPC, relaxed solver,
  the LL QP after 5 Ruiz sweeps) on "fused".

Bounds, each the same arithmetic in another order, relative to max(1,
|value|): 1e-10 for the build and finish (D^-1's entries reach 1e2 and
aux_pen is 1e6); 1e-9 on the random QPs' solutions; 1e-8 on the ticks and
loops with the full build and with the LL QP after Ruiz, as
`test_torch_wholebody.py` holds run_batch; equal converged flags and
shares throughout. The reduced LL QP solved raw in float64 has a condition
near 1e10 (aux_pen A'^T A' against df_pen): its force directions and duals
are weakly determined, so rounding moves them far beyond 1e-9. Measured
on the fixture (`scripts/torch_reduced_qp_conditioning.py` prints each
figure): the JAX package's own two solvers disagree on its x by
1.4e-7 and on z by 1.0e-2, the port's plain solver moves x by 1.3e-7 when h
moves by 4 ulps, and the port meets JAX at 1.8e-7 (x) and 1.2e-2 (z). So
those solutions are held to three times the JAX package's own
disagreement on the same QPs (at least 1e-9), the reduced ticks, where the
port's build rounds the QP's entries differently before that amplification,
to 1e-6 (measured 4.6e-7), and the raw-reduced team loop to 1e-7 (measured
3.4e-8 on qd after six ticks).

`test_fixture_provenance` (slow) recomputes the fixture live and holds it
to the committed file at 1e-12; `JAX_PLATFORMS=cpu python
tests/test_torch_team.py` rewrites the file. The two slow golden tests run
the `team` and `wholebody_trajectory` goldens of `docs/golden/golden.json`
through the port on "xla" at the goldens' own bounds.
"""

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from srbx.config import QpConfig as JQpConfig
from srbx.sim import closedloop as jclosedloop
from srbx_torch import agent, lowlevel, refplan
from srbx_torch.config import (Gait, LowLevelConfig, MotionConfig, MpcConfig,
                               QpConfig)
from srbx_torch.models import a1
from srbx_torch.ops import qp_batch
from srbx_torch.sim import closedloop, wholebody as wb
from test_torch_wholebody import (SUB, _agent_state, _close, _standing, _t,
                                  flatten, unflatten)

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_team_jax.npz"
GOLDEN = Path(__file__).resolve().parent.parent / "docs" / "golden" / \
    "golden.json"
B = 2
LL = LowLevelConfig()
MOTION = MotionConfig()
SIM = wb.SimConfig()
QP = QpConfig()
RUIZ = QpConfig(ruiz_iters=5)
# the production operating point (scripts/run_team4_wholebody.py:38-57)
PROD_MPC = MpcConfig(use_sqp=True, sqp_iters=1, condensed=True,
                     elide_box_rows=True, elide_simplex=True)
PROD_QP = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6, reg_dual=1e-6,
                   max_iters=12)
# the team golden's NMPC (scripts/make_golden.py:214-238)
GOLD_MPC = MpcConfig(use_sqp=True, sqp_iters=1)
LOOP = closedloop.LoopConfig(stand_ticks=3, n_domains=1, ticks_per_domain=3)
P_START = [0.0, 1.5, 0.0, 0.5, 0.0, -0.5, 0.0, -1.5]
TOL = 1e-10
QP_TOL = 1e-9
LOOP_TOL = 1e-8
REDUCED_TICK_TOL = 1e-6     # the raw reduced QP's conditioning (docstring)
REDUCED_LOOP_TOL = 1e-7
TICK_FORMS = [(b, r) for b in ("xla", "pallas", "fused")
              for r in ("full", "reduced")]
TEAM_FORMS = ("golden_xla", "production_fused")


def _jcfg(cfg):
    """The JAX package's configuration of the same fields (nested ones
    too)."""
    import srbx.config as jconfig

    return getattr(jconfig, type(cfg).__name__)(**{
        f.name: (_jcfg(v) if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]})


# ------------------------------- the inputs ------------------------------- #

def _obstacles():
    return np.stack([np.linspace(3.0, 8.0, 20), np.linspace(-2.0, 2.0, 20)])


def fixture_inputs():
    """Every input of the fixture, from fixed numpy seeds; the four agents'
    APF reference is the port's own (loop 2000, float64, CPU)."""
    rng = np.random.default_rng(2026)
    inp = {}
    for case, gait in (("stand", Gait.STAND), ("trot", Gait.TROT)):
        q = _standing(rng, 0.001)
        for k, v in _agent_state(rng, q, gait).items():
            inp[f"{case}.state.{k}"] = v
        inp[f"{case}.q"] = q
        inp[f"{case}.qd"] = rng.normal(size=(B, 18)) * 0.1
        inp[f"{case}.force"] = rng.uniform(0.0, 60.0, (B, 4))
    inp["red.contact"] = np.array([[1.0, 1.0, 1.0, 0.0], [0.0, 1.0, 1.0, 1.0]])
    inp["red.f_des"] = rng.normal(size=(B, 12)) * 20.0
    inp["red.x"] = rng.normal(size=(B, 25))
    # well-conditioned QPs of the reduced shape: diagonal P in [0.1, 10], a
    # strictly feasible point
    n, me, mi, lanes = 25, 12, 45, 4
    p_rand = np.zeros((lanes, n, n))
    p_rand[:, np.arange(n), np.arange(n)] = rng.uniform(0.1, 10.0, (lanes, n))
    a_rand, g_rand = (rng.normal(size=(lanes, m, n)) for m in (me, mi))
    x_feas = rng.normal(size=(lanes, n))
    inp.update({
        "rand.P": p_rand, "rand.c": rng.normal(size=(lanes, n)),
        "rand.A": a_rand, "rand.b": np.einsum("bmn,bn->bm", a_rand, x_feas),
        "rand.G": g_rand,
        "rand.h": np.einsum("bmn,bn->bm", g_rand, x_feas)
        + rng.uniform(0.1, 1.0, (lanes, mi))})
    pobs = _obstacles()
    ref = refplan.generate(refplan.four_agent_config(loop_size=2_000),
                           torch.tensor(P_START, dtype=torch.float64),
                           torch.tensor(pobs), device="cpu")
    inp["team.pr"] = ref.pr.numpy().reshape(1, 4, 2, -1)
    inp["team.prd"] = ref.prd.numpy().reshape(1, 4, 2, -1)
    inp["team.a0"] = np.asarray(P_START).reshape(1, 4, 2)
    inp["team.pobs"] = pobs[None]
    # run_batch's two lanes: agents 0 and 2 of the team, its field each
    inp["loop.pr"] = inp["team.pr"][0, 0:3:2]
    inp["loop.prd"] = inp["team.prd"][0, 0:3:2]
    inp["loop.a0"] = inp["team.a0"][0, 0:3:2]
    inp["loop.pobs"] = np.repeat(pobs[None], B, 0)
    return inp


# --------------------------- the JAX fixture ------------------------------ #

@contextlib.contextmanager
def _interpreted():
    """The JAX package's Pallas kernels in interpret mode, as its own tests
    run them on the CPU (the fused IPM and the SPD kernels at tile 8)."""
    from srbx.ops import pallas_linalg, qp_fused, spd

    targets = [(qp_fused, "solve"), (qp_fused, "solve_lanes_last"),
               (spd, "solve"), (spd, "inverse"), (pallas_linalg, "cholesky"),
               (pallas_linalg, "cho_solve")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def forced(fn, tile):
        return lambda *a, **k: fn(*a, **{**k, "interpret": True, **tile})

    # the Cholesky kernels keep their caller's tile: qp_batch pads the lanes
    # to it (reference hazard F9 in ROADMAP.md: that padding falls short
    # when a batch has fewer lanes than it pads, so callers pass tile B)
    for mod, name, fn in saved:
        setattr(mod, name, forced(fn, {} if mod is pallas_linalg
                                  else {"tile": 8}))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def build_fixture():
    """The fixture's contents: its inputs and the JAX package's outputs."""
    import jax
    import jax.numpy as jnp

    from srbx import agent as jagent
    from srbx import lowlevel as jlowlevel
    from srbx import motion as jmotion
    from srbx.estimation import contact as jcontact
    from srbx.models import a1 as ja1
    from srbx.ops import qp_batch as jqp_batch
    from srbx.ops import qp_fused as jqp_fused
    from srbx.sim import wholebody as jwb

    jax.config.update("jax_enable_x64", True)
    jmodel = ja1.model()
    jll, jmotion_cfg, jsim = _jcfg(LL), _jcfg(MOTION), jwb.SimConfig()
    inp = fixture_inputs()
    out = dict(inp)
    arr = jnp.asarray
    jsub = {"planner": jmotion.PlannerState, "con": jcontact.ConState}

    # the tick builds of both gaits: their VcOut feeds the reduced build,
    # their reduced QPs the solver checks
    qps = []
    for case, gait in (("stand", Gait.STAND), ("trot", Gait.TROT)):
        st = unflatten(inp, f"{case}.state", jagent.AgentState, jsub, arr)
        q, qd = arr(inp[f"{case}.q"]), arr(inp[f"{case}.qd"])

        def build(st, q, qd, f, gait=gait):
            return jax.vmap(lambda s_, q_, qd_, f_: jagent.tick_build(
                jll, jmotion_cfg, jmodel, gait, s_, q_, qd_, f_,
                allow_contact_trigger=False, reduced=True))(st, q, qd, f)

        data, ctx = jax.jit(build)(st, q, qd, arr(inp[f"{case}.force"]))
        flatten(ctx.vc, f"{case}.vc", out)
        qps.append(data)

        def red(q, qd, ci, vc, f_des, x):
            data, ctx = jlowlevel.ll_qp_build_reduced(jll, jmodel, q, qd, ci,
                                                      vc, f_des)
            return (data, ctx, jlowlevel.expand_reduced_x(ctx, x),
                    jlowlevel.ll_qp_finish_reduced(jll, ctx, q, qd, vc, x,
                                                   True))

        data, rctx, x43, ll_out = jax.jit(jax.vmap(red))(
            q, qd, arr(inp["red.contact"]), ctx.vc, arr(inp["red.f_des"]),
            arr(inp["red.x"]))
        flatten(data, f"red.{case}.data", out)
        flatten(rctx, f"red.{case}.ctx", out)
        out[f"red.{case}.x43"] = np.asarray(x43)
        flatten(ll_out._replace(qp_converged=None), f"red.{case}.out", out)

    data = [np.concatenate([np.asarray(a), np.asarray(b)]) for a, b in
            zip(*qps)]
    for i, name in enumerate("PcAbGh"):
        out[f"qp.{name}"] = data[i]
    for cfg_name, cfg in (("raw", QP), ("ruiz", RUIZ)):
        for solver in ("xla", "fused"):
            with _interpreted():
                sol = jax.jit(lambda *d: jqp_batch.solve(
                    *d, _jcfg(cfg), backend=solver))(*map(arr, data))
            for f in ("x", "y", "z", "s", "converged"):
                out[f"qp.{cfg_name}.{solver}.{f}"] = np.asarray(
                    getattr(sol, f))
    with _interpreted():
        sol = jax.jit(lambda *d: jqp_fused.solve(*d, _jcfg(QP)))(
            *map(arr, data))
    out["qp.raw.kernel.x"] = np.asarray(sol.x)
    for solver in ("xla", "fused"):
        with _interpreted():
            sol = jax.jit(lambda *d: jqp_batch.solve(
                *d, _jcfg(QP), backend=solver))(
                *(arr(inp[f"rand.{name}"]) for name in "PcAbGh"))
        for f in ("x", "y", "z", "s", "converged"):
            out[f"rand.{solver}.{f}"] = np.asarray(getattr(sol, f))

    st = unflatten(inp, "trot.state", jagent.AgentState, jsub, arr)
    q, qd, force = (arr(inp[f"trot.{k}"]) for k in ("q", "qd", "force"))
    for backend, build_name in TICK_FORMS:
        def tick(st, q, qd, f, backend=backend, reduced=build_name ==
                 "reduced"):
            return jclosedloop._tick_batch(
                jll, jmotion_cfg, _jcfg(QP), jmodel, Gait.TROT, st, q, qd, f,
                backend, B, allow_contact_trigger=False, reduced=reduced)

        with _interpreted():
            ll_out, new_st, _ = jax.jit(tick)(st, q, qd, force)
        flatten(ll_out, f"tick.{backend}.{build_name}.out", out)
        flatten(new_st, f"tick.{backend}.{build_name}.state", out)

    def loop(pr, prd, a0, pobs):
        return jclosedloop.run_batch(
            _jcfg(GOLD_MPC), jll, jmotion_cfg, _jcfg(QP), jsim,
            jclosedloop.LoopConfig(*LOOP), jmodel, pr, prd, a0, pobs,
            backend="xla", ll_reduced=True)

    res = jax.jit(loop)(*(arr(inp[f"loop.{k}"])
                          for k in ("pr", "prd", "a0", "pobs")))
    for k in ("com_hist", "qp_ok", "mpc_ok", "tau_hist"):
        out[f"loop.{k}"] = np.asarray(getattr(res, k))
    out["loop.q"] = np.asarray(res.sim.q)

    for form in TEAM_FORMS:
        kw = team_kwargs(form)
        with _interpreted():
            sims, com_ends, margins, llok = jax.jit(
                lambda *a, kw=kw: jclosedloop.run_team_batch(
                    *(_jcfg(c) if dataclasses.is_dataclass(c) else c
                      for c in kw["cfgs"]), jsim,
                    jclosedloop.LoopConfig(*LOOP), jmodel, *a,
                    backend=kw["backend"], tile=8, ll_reduced=True,
                    ll_qp_cfg=None if kw["ll_qp_cfg"] is None
                    else _jcfg(kw["ll_qp_cfg"])))(
                *(arr(inp[f"team.{k}"]) for k in ("pr", "prd", "a0",
                                                   "pobs")))
        for k, v in (("q", sims.q), ("qd", sims.qd), ("com_ends", com_ends),
                     ("margins", margins), ("llok", llok)):
            out[f"team.{form}.{k}"] = np.asarray(v)
    return out


# ------------------------------- the tests -------------------------------- #

def team_kwargs(form):
    """run_team_batch's configurations in each form: the team golden's on
    "xla" (QpConfig() everywhere, the LL QP raw in float64), the production
    point on "fused" (its relaxed solver; the LL QP after 5 Ruiz sweeps, as
    float32 runs it)."""
    if form == "golden_xla":
        return {"cfgs": (GOLD_MPC, LL, MOTION, QP), "backend": "xla",
                "ll_qp_cfg": None}
    return {"cfgs": (PROD_MPC, LL, MOTION, PROD_QP), "backend": "fused",
            "ll_qp_cfg": dataclasses.replace(PROD_QP, ruiz_iters=5)}


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return dict(f)


def _close_tree(got: dict, fx, prefix, tol=TOL, relative=True):
    keys = [k for k in fx if k.startswith(prefix + ".")]
    assert keys and set(keys) <= set(got), (prefix, sorted(set(keys) -
                                                           set(got)))
    for k in keys:
        if fx[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], fx[k], err_msg=k)
        else:
            _close(got[k], fx[k], tol, relative=relative, what=k)


def test_fixture_matches_inputs(fx):
    """The committed inputs are the ones the seeds (and the port's planner)
    make."""
    for k, v in fixture_inputs().items():
        np.testing.assert_allclose(fx[k], v, rtol=0, atol=0, err_msg=k)


@pytest.mark.parametrize("case", ["stand", "trot"])
def test_reduced_build_and_finish_match_jax(fx, case):
    vc = unflatten(fx, f"{case}.vc", lowlevel.VcOut, {}, _t)
    q, qd = _t(fx[f"{case}.q"]), _t(fx[f"{case}.qd"])
    data, ctx = lowlevel.ll_qp_build_reduced(
        LL, a1.model(), q, qd, _t(fx["red.contact"]), vc,
        _t(fx["red.f_des"]))
    x = _t(fx["red.x"])
    out = lowlevel.ll_qp_finish_reduced(LL, ctx, q, qd, vc, x,
                                        torch.ones(B, dtype=torch.bool))
    got = {f"red.{case}.x43": lowlevel.expand_reduced_x(ctx, x).numpy()}
    flatten(data, f"red.{case}.data", got)
    flatten(ctx, f"red.{case}.ctx", got)
    flatten(out._replace(qp_converged=None), f"red.{case}.out", got)
    for part in ("data", "ctx", "x43", "out"):
        if part == "x43":
            _close(got[f"red.{case}.x43"], fx[f"red.{case}.x43"], TOL,
                   relative=True, what="x43")
        else:
            _close_tree(got, fx, f"red.{case}.{part}")
    assert data.P.shape == (B, 25, 25) and data.A.shape == (B, 12, 25)
    assert data.G.shape == (B, 45, 25)


def test_reduced_build_is_exact_condensation(fx):
    """The reduced QP is the full one with aux eliminated: its solution,
    mapped back, meets the full build's equality rows and reaches the full
    QP's optimal objective (the JAX package's own check,
    tests/test_lowlevel_alt.py:93, on the port alone: 1e-6 and 1e-5)."""
    vc = unflatten(fx, "trot.vc", lowlevel.VcOut, {}, _t)
    q, qd = _t(fx["trot.q"]), _t(fx["trot.qd"])
    ci, f_des = _t(fx["red.contact"]), _t(fx["red.f_des"])
    full, _ = lowlevel.ll_qp_build(LL, a1.model(), q, qd, ci, vc, f_des)
    red, ctx = lowlevel.ll_qp_build_reduced(LL, a1.model(), q, qd, ci, vc,
                                            f_des)
    s1 = qp_batch.solve(*full, QP, backend="xla")
    s2 = qp_batch.solve(*red, QP, backend="xla")
    assert s1.converged.all() and s2.converged.all()
    x2 = lowlevel.expand_reduced_x(ctx, s2.x)
    r = (torch.einsum("bmn,bn->bm", full.A, x2) - full.b).abs().amax()
    assert r < 1e-6, r

    def obj(x):
        return (0.5 * torch.einsum("bn,bnm,bm->b", x, full.P, x)
                + (full.c * x).sum(1))

    o1, o2 = obj(s1.x), obj(x2)
    assert ((o1 - o2).abs() / o1.abs().clamp(min=1.0)).max() < 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs(a - b) / np.maximum(1.0, np.abs(b))).max()


def test_reduced_shape_random_qps_match_jax(fx):
    """K1b's plain version at (25, 12) (`qp_batch.solve(backend="fused")`
    on CPU tensors) on well-conditioned random QPs of the reduced shape
    against JAX's `qp_batch.solve` on "xla" and on "fused" in interpret
    mode: 1e-9, equal flags."""
    data = [_t(fx[f"rand.{name}"]) for name in "PcAbGh"]
    sol = qp_batch.solve(*data, QP, backend="fused")
    for solver in ("xla", "fused"):
        np.testing.assert_array_equal(sol.converged.numpy(),
                                      fx[f"rand.{solver}.converged"])
        for f in ("x", "y", "z", "s"):
            _close(getattr(sol, f), fx[f"rand.{solver}.{f}"], QP_TOL,
                   relative=True, what=f"rand.{solver}.{f}")
    assert sol.converged.all()


@pytest.mark.parametrize("cfg_name", ["raw", "ruiz"])
def test_reduced_qp_matches_jax(fx, cfg_name):
    """K1b's plain version at (25, 12) on the fixture's reduced LL QPs,
    raw and after 5 Ruiz sweeps, against JAX's `qp_batch.solve` on "xla"
    and on "fused" in interpret mode: equal flags, and each of x, y, z, s
    within three times the JAX package's own xla-against-fused difference
    on the same QPs (at least 1e-9; the module docstring says why)."""
    cfg = QP if cfg_name == "raw" else RUIZ
    data = [_t(fx[f"qp.{name}"]) for name in "PcAbGh"]
    assert tuple(data[0].shape) == (4, 25, 25) and data[2].shape[1] == 12
    sol = qp_batch.solve(*data, cfg, backend="fused")
    pre = f"qp.{cfg_name}"
    for solver in ("xla", "fused"):
        np.testing.assert_array_equal(sol.converged.numpy(),
                                      fx[f"{pre}.{solver}.converged"])
        for f in ("x", "y", "z", "s"):
            own = _rel(fx[f"{pre}.xla.{f}"], fx[f"{pre}.fused.{f}"])
            _close(getattr(sol, f), fx[f"{pre}.{solver}.{f}"],
                   max(QP_TOL, 3.0 * own), relative=True,
                   what=f"{pre}.{solver}.{f}")
    if cfg_name == "raw":
        own = _rel(fx["qp.raw.xla.x"], fx["qp.raw.kernel.x"])
        _close(sol.x, fx["qp.raw.kernel.x"], max(QP_TOL, 3.0 * own),
               relative=True, what="qp_fused.solve")


@pytest.mark.parametrize("backend,build", TICK_FORMS,
                         ids=[f"{b}-{r}" for b, r in TICK_FORMS])
def test_tick_forms_match_jax(fx, backend, build):
    st = unflatten(fx, "trot.state", agent.AgentState, SUB, _t)
    q, qd, force = (_t(fx[f"trot.{k}"]) for k in ("q", "qd", "force"))
    with qp_batch.full_f32_products():
        ll_out, new_st, _, d_b = closedloop._tick_batch(
            LL, MOTION, QP, a1.model(), Gait.TROT, st, q, qd, force,
            backend, allow_contact_trigger=False,
            reduced=build == "reduced", return_d=True)
    assert (d_b is None) == (backend == "xla")
    got = {}
    pre = f"tick.{backend}.{build}"
    flatten(ll_out, f"{pre}.out", got)
    flatten(new_st, f"{pre}.state", got)
    tol = REDUCED_TICK_TOL if build == "reduced" else LOOP_TOL
    _close_tree(got, fx, f"{pre}.out", tol)
    _close_tree(got, fx, f"{pre}.state", tol)
    assert ll_out.qp_converged.all()


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_step_batch_forms_match_jax(backend):
    """Both forms of the physics tick against the JAX package's
    `step_batch(backend="xla")`, that is vmap(step), on the whole-body
    fixture's tick (1e-10)."""
    with np.load(FIXTURE.with_name("torch_wholebody_jax.npz")) as f:
        w = dict(f)
    state = wb.SimState(_t(w["step.q"]), _t(w["step.qd"]))
    d0 = None
    if backend == "fused":
        from srbx_torch.models import rbd

        d0 = rbd.mass_matrix(a1.model(), state.q)
    s = wb.step_batch(SIM, a1.model(), state, _t(w["step.tau"]),
                      backend=backend, d0=d0)
    _close(s.q, w["step.out.q"], what="q")
    _close(s.qd, w["step.out.qd"], what="qd")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_resolve_ll_qp_cfg_matches_jax(dtype, reduced):
    import jax.numpy as jnp

    cfg = QpConfig(abstol=2e-3, ruiz_iters=2)
    ours = closedloop._resolve_ll_qp_cfg(cfg, reduced, None,
                                         getattr(torch, dtype))
    theirs = jclosedloop._resolve_ll_qp_cfg(_jcfg(cfg), reduced, None,
                                            getattr(jnp, dtype))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    given = QpConfig(max_iters=7)
    assert closedloop._resolve_ll_qp_cfg(cfg, reduced, given,
                                         torch.float32) is given
    assert isinstance(theirs, JQpConfig)


def test_run_batch_reduced_xla_matches_jax(fx):
    res = closedloop.run_batch(
        GOLD_MPC, LL, MOTION, QP, SIM, LOOP, a1.model(), fx["loop.pr"],
        fx["loop.prd"], fx["loop.a0"], fx["loop.pobs"], backend="xla",
        ll_reduced=True, device="cpu")
    _close(res.sim.q, fx["loop.q"], LOOP_TOL, what="sim.q")
    _close(res.com_hist, fx["loop.com_hist"], LOOP_TOL, what="com_hist")
    _close(res.tau_hist[..., 0], fx["loop.tau_hist"][..., 0], LOOP_TOL,
           relative=True, what="max |tau|")
    np.testing.assert_array_equal(res.qp_ok.numpy(), fx["loop.qp_ok"])
    np.testing.assert_array_equal(res.mpc_ok.numpy(), fx["loop.mpc_ok"])


@pytest.mark.parametrize("form", TEAM_FORMS)
def test_run_team_batch_matches_jax(fx, form):
    kw = team_kwargs(form)
    sims, com_ends, margins, llok = closedloop.run_team_batch(
        *kw["cfgs"], SIM, LOOP, a1.model(),
        *(fx[f"team.{k}"] for k in ("pr", "prd", "a0", "pobs")),
        backend=kw["backend"], ll_reduced=True, ll_qp_cfg=kw["ll_qp_cfg"],
        device="cpu")
    assert com_ends.shape == (1, 1, 4, 3) and margins.shape == (1, 1, 4)
    assert llok.shape == (1, 1)
    pre = f"team.{form}"
    # the golden's form solves the reduced LL QP raw (the docstring's bound)
    tol = REDUCED_LOOP_TOL if kw["ll_qp_cfg"] is None else LOOP_TOL
    for name, got in (("q", sims.q), ("qd", sims.qd), ("com_ends", com_ends),
                      ("margins", margins)):
        _close(got, fx[f"{pre}.{name}"], tol, relative=True,
               what=f"{pre}.{name}")
    np.testing.assert_array_equal(llok.numpy(), fx[f"{pre}.llok"])


@pytest.mark.slow
def test_fixture_provenance(fx):
    """The committed fixture is what the JAX package computes from the
    seeds."""
    live = build_fixture()
    assert set(live) == set(fx)
    for k, v in live.items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(fx[k], v, err_msg=k)
        else:
            _close(fx[k], v, 1e-12, relative=True, what=k)


# ------------------------------ the goldens ------------------------------- #

def _golden(name):
    with open(GOLDEN) as f:
        return json.load(f)[name]


@pytest.mark.slow
def test_golden_team_through_the_port():
    """The `team` golden (scripts/make_golden.py:214-238): 1 scenario x 4
    agents, the uncondensed SCP NMPC, QpConfig(), the reduced LL build,
    float64, 300 stand ticks and 2 domains, backend "xla"; at the golden's
    bounds (com_ends, margins, final_q 1e-5; llok 1e-9)."""
    gold = _golden("team")
    p_start = torch.tensor(P_START, dtype=torch.float64)
    pobs = torch.tensor(_obstacles())
    ref = refplan.generate(refplan.four_agent_config(loop_size=20_000),
                           p_start, pobs, device="cpu")
    sims, com_ends, margins, llok = closedloop.run_team_batch(
        GOLD_MPC, LL, MOTION, QP, SIM,
        closedloop.LoopConfig(stand_ticks=300, n_domains=2,
                              ticks_per_domain=172), a1.model(),
        ref.pr.reshape(1, 4, 2, -1), ref.prd.reshape(1, 4, 2, -1),
        p_start.reshape(1, 4, 2), pobs[None], backend="xla",
        ll_reduced=True, device="cpu")
    for name, got, tol in (("com_ends", com_ends, 1e-5),
                           ("margins", margins, 1e-5),
                           ("final_q", sims.q, 1e-5), ("llok", llok, 1e-9)):
        np.testing.assert_allclose(got.numpy(), np.asarray(gold[name]),
                                   rtol=0, atol=tol, err_msg=name)


@pytest.mark.slow
def test_golden_wholebody_trajectory_through_the_port():
    """The `wholebody_trajectory` golden (tests/test_golden.py:69-104): 2
    lanes, MpcConfig(use_sqp=False), the full LL build, float64, 300 stand
    ticks and 4 domains, backend "xla"; at the golden's bounds (COM every
    20 ticks and final_q 1e-5; qp_ok 1e-9)."""
    gold = _golden("wholebody_trajectory")
    ref = refplan.generate(refplan.two_agent_config(loop_size=20_000),
                           torch.tensor([0.0, 0.0, 0.0, -1.0],
                                        dtype=torch.float64),
                           torch.full((2, 20), 100.0, dtype=torch.float64),
                           device="cpu")
    res = closedloop.run_batch(
        MpcConfig(use_sqp=False), LL, MOTION, QP, SIM,
        closedloop.LoopConfig(stand_ticks=300, n_domains=4,
                              ticks_per_domain=172), a1.model(),
        ref.pr[0:2].expand(2, -1, -1), ref.prd[0:2].expand(2, -1, -1),
        torch.tensor([[0.0, 0.0], [0.0, -1.0]], dtype=torch.float64),
        torch.full((2, 2, 20), 100.0, dtype=torch.float64), backend="xla",
        device="cpu")
    np.testing.assert_allclose(res.com_hist[:, :, ::20].numpy(),
                               np.asarray(gold["com_subsampled"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(res.sim.q.numpy(), np.asarray(gold["final_q"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.qp_ok.numpy(), np.asarray(gold["qp_ok"]),
                               rtol=0, atol=1e-9)


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(f"wrote {FIXTURE}")
