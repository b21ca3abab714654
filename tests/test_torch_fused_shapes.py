"""The fused IPM at the NMPC's own shapes, and the NMPC on backend "fused"
for every MpcConfig, against a fixture that the JAX package computed in
float64 on the CPU.

On the CPU the port's fused IPM is its plain version (`qp_fused.solve_plain`
and `solve_lanes_last_plain`); the kernels K1a and K1b are held to those on
the card by `chip_smoke.py`. The JAX package runs its fused Pallas kernel in
interpret mode, tile 8, which costs minutes per loop on a CPU, so the tier-1
tests read `tests/data/torch_fused_shapes_jax.npz`. It holds inputs made
with numpy from fixed seeds (and, for the cycle's own QPs, the port's own
assembly of those inputs) and what the JAX package computes from them:

* `qp_fused.solve` on random well-conditioned QPs, B 8, at (n, me) =
  (41, 28) with mi 112 and (17, 4) with mi 48;
* `qp_fused.solve` on the NMPC's own QPs at (41, 28) (the uncondensed cycle:
  cold mi 92, SCP mi 112, and SCP mi 116 with a neighbour circle) and at
  (17, 4) (the condensed cycle with its simplex rows: SCP mi 52), and at
  (13, 0) (the inequality-only kernel: the condensed, simplex-eliminated
  cycle with its box rows kept, SCP mi 112);
* `qp_fused.solve_lanes_last` at n 13 on that cycle's QPs (cold mi 92, SCP
  mi 112);
* `mpc_batch.run_nmpc_batch(backend="fused")` at B 8: uncondensed (n 41,
  me 28) on the benchmark's inputs, relaxed, and on mixed lanes (gait
  domains, contacts, a neighbour circle, x0_warm and one NaN-foothold
  lane), strict; condensed with the simplex rows (n 17, me 4) on the mixed
  lanes; condensed, simplex-eliminated and box rows kept (K1a at mi 92 /
  112) on the benchmark's inputs;
* `closedloop.run_batch(backend="fused")` with `bench_wholebody.py`'s
  default (uncondensed) MpcConfig, 2 lanes, and `run_team_batch(backend=
  "fused")` with the team golden's (uncondensed) MpcConfig, 1 scenario x 4
  agents, each over 3 stand and 3 trot ticks, on the inputs of
  `tests/data/torch_team_jax.npz`;
* the campaign core (`eval/campaign.py`, JAX `_run_campaign_batch_core`)
  on "fused" with `scripts/exp_campaign_fused.py`'s two configurations
  (uncondensed: K1b (41, 28); condensed with the simplex rows and the box
  rows elided: K1b (17, 4)), S 2 x 2 agents, 3 domains, on the inputs of
  `tests/data/torch_campaign_jax.npz`.

Bounds. 1e-9 on the random QPs' x, y, z and s, equal converged flags and
equal maximum iteration counts (F4: the port counts per lane, the TPU per
tile). On the NMPC's QPs and cycles the bounds of the generic cycle in
`tests/test_torch_mpc_batch.py`: 1e-9 on states, alpha_com and cbf_margin
(on the QPs: on x, relative to max(1, |x|)), equal converged flags and
qp_iters; a lane whose QP does not converge within max_iters (F8) at the
JAX package's own 3e-2 (tests/test_campaign.py:99-129). The loops at
1e-8 relative, as `tests/test_torch_team.py` holds the full-build loops;
the campaigns at `tests/test_torch_campaign.py`'s bounds: success and
qp_ok_frac exactly, every other output to 1e-9.

`test_fixture_provenance` (slow) recomputes the fixture live and holds it
to the committed file at 1e-12; `JAX_PLATFORMS=cpu python
tests/test_torch_fused_shapes.py` (with `tests/` on PYTHONPATH) rewrites it.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from srbx_torch import convert, mpc, mpc_batch, refplan
from srbx_torch.config import LowLevelConfig, MotionConfig, MpcConfig, QpConfig
from srbx_torch.eval import campaign, run_campaign_ab
from srbx_torch.models import a1
from srbx_torch.ops import qp_batch, qp_fused
from srbx_torch.sim import closedloop, wholebody as wb
from test_torch_campaign import LOOP as CAMP_LOOP
from test_torch_campaign import OUTPUTS as CAMP_OUT
from test_torch_mpc_batch import (RELAXED, STRICT, _bench_inputs,
                                  _mixed_inputs)

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
FIXTURE = HERE / "data" / "torch_fused_shapes_jax.npz"
TEAM_FIXTURE = HERE / "data" / "torch_team_jax.npz"
CAMP_FIXTURE = HERE / "data" / "torch_campaign_jax.npz"
QP = QpConfig()
QP_TOL = 1e-9
CYCLE_TOL = 1e-9
F8_TOL = 3e-2
LOOP_TOL = 1e-8
# bench_wholebody.py's default batch configuration and solver
WB_MPC = MpcConfig(use_sqp=True, sqp_iters=1, condensed=False,
                   elide_box_rows=False, elide_simplex=False)
WB_QP = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6, reg_dual=1e-6,
                 max_iters=12)
# the team golden's NMPC (scripts/make_golden.py:214-238)
TEAM_MPC = MpcConfig(use_sqp=True, sqp_iters=1)
LOOP = closedloop.LoopConfig(stand_ticks=3, n_domains=1, ticks_per_domain=3)

# cycle form -> (MpcConfig, condensed, solver, inputs)
CYCLES = {
    "uncondensed_bench": (MpcConfig(use_sqp=True, sqp_iters=2), False,
                          RELAXED, "bench"),
    "uncondensed_mixed": (MpcConfig(use_sqp=True, sqp_iters=2), False,
                          STRICT, "mixed"),
    "condensed_17_4": (MpcConfig(use_sqp=True, sqp_iters=2, condensed=True,
                                 elide_box_rows=True), True, STRICT,
                       "mixed"),
    "lanes_last_box_rows": (MpcConfig(use_sqp=True, sqp_iters=2,
                                      condensed=True, elide_simplex=True),
                            True, RELAXED, "bench"),
}
CYCLE_OUT = ("states", "alpha_com", "cbf_margin", "qp_converged",
             "qp_iters")
# QP form -> (the cycle it is captured from, which solve, batch-leading)
QP_FORMS = {
    "nmpc41_cold": ("uncondensed_bench", 0, True),
    "nmpc41_scp": ("uncondensed_bench", 1, True),
    "nmpc41_neighbour": ("uncondensed_mixed", 1, True),
    "nmpc17_scp": ("condensed_17_4", 1, True),
    "noeq13_scp": ("lanes_last_box_rows", 1, True),
    "lanes13_cold": ("lanes_last_box_rows", 0, False),
    "lanes13_scp": ("lanes_last_box_rows", 1, False),
}
RANDOM = {"rand41": (41, 28, 112), "rand17": (17, 4, 48)}
# scripts/exp_campaign_fused.py:46-57, c = False and c = True
CAMPAIGNS = {
    "campaign_uncondensed": dict(use_sqp=True, sqp_iters=2, condensed=False,
                                 elide_box_rows=False),
    "campaign_condensed_17_4": dict(use_sqp=True, sqp_iters=2,
                                    condensed=True, elide_box_rows=True),
}
CAMP_DOMAINS = 3


# ------------------------------- the inputs ------------------------------- #

def _random_qps(n, me, mi, seed, bsz=8):
    """Well-conditioned QPs (diagonal P in [0.1, 10], a strictly feasible
    point) from a numpy seed: P, c, A, b, G, h batch-leading."""
    rng = np.random.default_rng(seed)
    p = np.zeros((bsz, n, n))
    p[:, np.arange(n), np.arange(n)] = rng.uniform(0.1, 10.0, (bsz, n))
    a, g = rng.normal(size=(bsz, me, n)), rng.normal(size=(bsz, mi, n))
    x = rng.normal(size=(bsz, n))
    return {"P": p, "c": rng.normal(size=(bsz, n)), "A": a,
            "b": np.einsum("bmn,bn->bm", a, x), "G": g,
            "h": np.einsum("bmn,bn->bm", g, x)
            + rng.uniform(0.1, 1.0, (bsz, mi))}


def _cycle_inputs(form):
    return _bench_inputs() if CYCLES[form][3] == "bench" else _mixed_inputs()


def _port_cycle(form, inp):
    cfg, condensed, qp_cfg, _ = CYCLES[form]
    t = convert.from_numpy(inp, device="cpu")
    carry = mpc.MpcCarry(*t.pop("carry"))
    eps = float(t.pop("agent_circle_eps", 0.0))
    return mpc_batch.run_nmpc_batch(cfg, qp_cfg, carry, backend="fused",
                                    condensed=condensed,
                                    agent_circle_eps=eps, **t)


def _captured_qps(form):
    """The QPs the port's cycle `form` solves, in order, as numpy:
    batch-leading (P, c, A, b, G, h, x0) from `qp_batch.solve`, lanes-last
    (P, c, G, h, x0) from `qp_fused.solve_lanes_last`."""
    seen = []
    real_batch, real_ll = qp_batch.solve, qp_fused.solve_lanes_last

    def batch(P, c, A, b, G, h, cfg, backend, x0=None):
        seen.append(dict(zip("PcAbGh", (P, c, A, b, G, h)), x0=x0))
        return real_batch(P, c, A, b, G, h, cfg, backend=backend, x0=x0)

    def lanes(P, c, G, h, cfg, x0=None):
        seen.append(dict(P=P, c=c, G=G, h=h, x0=x0))
        return real_ll(P, c, G, h, cfg, x0=x0)

    qp_batch.solve, qp_fused.solve_lanes_last = batch, lanes
    try:
        _port_cycle(form, _cycle_inputs(form))
    finally:
        qp_batch.solve, qp_fused.solve_lanes_last = real_batch, real_ll
    return [{k: v.numpy() for k, v in qp.items() if v is not None}
            for qp in seen]


def fixture_inputs():
    """Every input of the fixture: numpy seeds, and the QPs the port's
    cycles assemble from them."""
    out = {}
    for form, (n, me, mi) in RANDOM.items():
        for k, v in _random_qps(n, me, mi, seed=n).items():
            out[f"{form}.in.{k}"] = v
    captured = {}
    for form, (cycle, idx, leading) in QP_FORMS.items():
        if cycle not in captured:
            captured[cycle] = _captured_qps(cycle)
        qp = dict(captured[cycle][idx])
        if form.startswith("noeq"):       # the lanes-last QP batch-leading
            qp = {k: np.ascontiguousarray(np.moveaxis(v, -1, 0))
                  for k, v in qp.items()}
            qp["A"] = np.zeros(qp["c"].shape[:1] + (0,) + qp["c"].shape[1:])
            qp["b"] = np.zeros(qp["c"].shape[:1] + (0,))
        for k, v in qp.items():
            out[f"{form}.in.{k}"] = v
    for form in CYCLES:
        inp = _cycle_inputs(form)
        flat = {k: v for k, v in inp.items() if k != "carry"}
        flat["gait_domain"], flat["alpha_buffer"] = inp["carry"]
        for k, v in flat.items():
            out[f"{form}.in.{k}"] = np.asarray(v)
    return out


def _qp_in(fx, form):
    pre = f"{form}.in."
    return {k[len(pre):]: fx[k] for k in fx if k.startswith(pre)}


def _cycle_in(fx, form):
    flat = _qp_in(fx, form)
    inp = {k: v for k, v in flat.items()
           if k not in ("gait_domain", "alpha_buffer")}
    inp["carry"] = (flat["gait_domain"], flat["alpha_buffer"])
    if "agent_circle_eps" in inp:
        inp["agent_circle_eps"] = float(inp["agent_circle_eps"])
    return inp


def _campaign_inputs():
    with np.load(CAMP_FIXTURE) as f:
        return {k: f[f"in.{k}"] for k in ("p_start", "pobs", "pobs_real")}


def _camp():
    return campaign.CampaignConfig(n_agents=2, n_domains=CAMP_DOMAINS)


def _team_inputs():
    with np.load(TEAM_FIXTURE) as f:
        return {k: f[k] for k in f if k.startswith(("loop.", "team."))
                and k.split(".")[1] in ("pr", "prd", "a0", "pobs")}


# --------------------------- the JAX fixture ------------------------------ #

def build_fixture():
    """The fixture's contents: its inputs and the JAX package's outputs."""
    import jax
    import jax.numpy as jnp

    from srbx import mpc as jmpc
    from srbx import mpc_batch as jmpc_batch
    from srbx.models import a1 as ja1
    from srbx.ops import qp_fused as jqp_fused
    from srbx.sim import closedloop as jclosedloop
    from srbx.sim import wholebody as jwb
    from test_torch_team import _interpreted, _jcfg

    jax.config.update("jax_enable_x64", True)
    out = fixture_inputs()
    arr = jnp.asarray

    def qp_cfg_of(form):
        return QP if form in RANDOM else CYCLES[QP_FORMS[form][0]][2]

    for form in list(RANDOM) + list(QP_FORMS):
        qp = _qp_in(out, form)
        cfg = _jcfg(qp_cfg_of(form))
        x0 = arr(qp["x0"]) if "x0" in qp else None
        if form in RANDOM or QP_FORMS[form][2]:
            sol = jax.jit(lambda *d, x0=x0: jqp_fused.solve(
                *d, cfg, tile=8, interpret=True, x0=x0))(
                *(arr(qp[k]) for k in "PcAbGh"))
            res = {f: getattr(sol, f) for f in ("x", "y", "z", "s",
                                                 "converged", "iters")}
        else:
            x, z, s, stat = jax.jit(lambda *d, x0=x0: jqp_fused.
                                    solve_lanes_last(*d, cfg, tile=8,
                                                     interpret=True, x0=x0))(
                *(arr(qp[k]) for k in "PcGh"))
            res = {"x": x, "z": z, "s": s, "converged": stat[2] > 0.5,
                   "iters": stat[3].max()}
        for k, v in res.items():
            out[f"{form}.out.{k}"] = np.asarray(v)

    for form, (cfg, condensed, qp_cfg, _) in CYCLES.items():
        inp = _cycle_in(out, form)
        names = [k for k in inp if k not in ("carry", "agent_circle_eps")]
        eps = inp.get("agent_circle_eps", 0.0)

        def fn(dom, alpha, *arrays, cfg=cfg, condensed=condensed,
               qp_cfg=qp_cfg, names=names, eps=eps):
            return jmpc_batch.run_nmpc_batch(
                _jcfg(cfg), _jcfg(qp_cfg), jmpc.MpcCarry(dom, alpha),
                backend="fused", tile=8, interpret=True, condensed=condensed,
                agent_circle_eps=eps, **dict(zip(names, arrays)))

        res = jax.jit(fn)(*(arr(a) for a in [*inp["carry"]]
                            + [inp[k] for k in names]))
        for k in CYCLE_OUT + ("x",):
            out[f"{form}.out.{k}"] = np.asarray(getattr(res, k))

    team = _team_inputs()
    jmodel = ja1.model()
    jcfgs = (_jcfg(LowLevelConfig()), _jcfg(MotionConfig()))
    with _interpreted():
        res = jax.jit(lambda *a: jclosedloop.run_batch(
            _jcfg(WB_MPC), *jcfgs, _jcfg(WB_QP), jwb.SimConfig(),
            jclosedloop.LoopConfig(*LOOP), jmodel, *a, backend="fused",
            tile=8))(*(arr(team[f"loop.{k}"])
                       for k in ("pr", "prd", "a0", "pobs")))
    for k in ("com_hist", "qp_ok", "mpc_ok", "tau_hist"):
        out[f"loop.out.{k}"] = np.asarray(getattr(res, k))
    out["loop.out.q"] = np.asarray(res.sim.q)
    with _interpreted():
        sims, com_ends, margins, llok = jax.jit(
            lambda *a: jclosedloop.run_team_batch(
                _jcfg(TEAM_MPC), *jcfgs, _jcfg(QP), jwb.SimConfig(),
                jclosedloop.LoopConfig(*LOOP), jmodel, *a, backend="fused",
                tile=8))(*(arr(team[f"team.{k}"])
                           for k in ("pr", "prd", "a0", "pobs")))
    for k, v in (("q", sims.q), ("qd", sims.qd), ("com_ends", com_ends),
                 ("margins", margins), ("llok", llok)):
        out[f"team.out.{k}"] = np.asarray(v)
    out.update(_jax_campaigns())
    return out


def _jax_campaigns():
    """The JAX package's campaign core on "fused" (the kernel interpreted)
    for each of CAMPAIGNS."""
    import jax
    import jax.numpy as jnp

    from srbx import refplan as jrefplan
    from srbx.eval import campaign as jcampaign
    from test_torch_team import _interpreted, _jcfg

    jax.config.update("jax_enable_x64", True)
    inp = _campaign_inputs()
    out = {}
    for form, kw in CAMPAIGNS.items():
        with _interpreted():
            res = jax.jit(lambda p, o, r, kw=kw: jcampaign.
                          _run_campaign_batch_core(
                              _jcfg(MpcConfig(**kw)),
                              _jcfg(run_campaign_ab.QP_CFG),
                              jcampaign.CampaignConfig(
                                  n_agents=2, n_domains=CAMP_DOMAINS),
                              jrefplan.two_agent_config(loop_size=CAMP_LOOP),
                              p, o, r, jax.random.key(0), "fused", 8))(
                *(jnp.asarray(inp[k]) for k in ("p_start", "pobs",
                                                "pobs_real")))
        for k in CAMP_OUT:
            out[f"{form}.out.{k}"] = np.asarray(getattr(res, k))
    return out


# ------------------------------- the tests -------------------------------- #

@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return dict(f)


def _close(got, want, tol, what="", lanes=None):
    """max |got - want| / max(1, |want|) <= tol over `lanes` (all by
    default), NaN where the other is NaN."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if lanes is not None:
        got, want = got[lanes], want[lanes]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    err = np.where(np.isnan(want), 0.0, err)
    assert err.max(initial=0.0) <= tol, f"{what}: {err.max():.3e} > {tol:.0e}"


@pytest.mark.parametrize("form", list(RANDOM))
def test_random_qps_match_jax(fx, form):
    """K1b's plain version at (41, 28) and (17, 4) through `qp_batch.solve
    (backend="fused")` on random well-conditioned QPs against JAX's
    `qp_fused.solve` in interpret mode: 1e-9, equal flags and iterations."""
    n, me, mi = RANDOM[form]
    qp = {k: torch.as_tensor(v) for k, v in _qp_in(fx, form).items()}
    assert tuple(qp["A"].shape) == (8, me, n) and qp["G"].shape[1] == mi
    sol = qp_batch.solve(*(qp[k] for k in "PcAbGh"), QP, backend="fused")
    pre = f"{form}.out."
    for f in ("x", "y", "z", "s"):
        _close(getattr(sol, f), fx[pre + f], QP_TOL, f"{form}.{f}")
    np.testing.assert_array_equal(sol.converged.numpy(), fx[pre + "converged"])
    assert int(sol.iters) == int(fx[pre + "iters"])
    assert sol.converged.all() and qp_fused.solve.launches == 0


@pytest.mark.parametrize("form", list(QP_FORMS))
def test_nmpc_qps_match_jax(fx, form):
    """The NMPC's own QPs at (41, 28), (17, 4) and (13, 0), batch-leading
    through `qp_batch.solve(backend="fused")` (the plain versions of K1b
    and, at me = 0, of K1a), and at n 13 lanes-last through
    `qp_fused.solve_lanes_last`, against JAX's fused kernel in interpret
    mode: x to 1e-9 relative to max(1, |x|) on converged lanes and to 3e-2
    on the others (F8), equal flags and iterations."""
    cycle, _, leading = QP_FORMS[form]
    qp_cfg = CYCLES[cycle][2]
    qp = {k: torch.as_tensor(v) for k, v in _qp_in(fx, form).items()}
    x0 = qp.get("x0")
    if leading:
        sol = qp_batch.solve(*(qp[k] for k in "PcAbGh"), qp_cfg,
                             backend="fused", x0=x0)
        x, conv, iters = sol.x, sol.converged, int(sol.iters)
        assert sol.y.shape == qp["b"].shape
    else:
        x, _, _, stat = qp_fused.solve_lanes_last(
            *(qp[k] for k in "PcGh"), qp_cfg, x0=x0)
        conv, iters = stat[2] > 0.5, int(stat[3].max())
    pre = f"{form}.out."
    want_conv = fx[pre + "converged"]
    np.testing.assert_array_equal(conv.numpy(), want_conv)
    assert iters == int(fx[pre + "iters"])
    axis = 0 if leading else -1
    sel = (slice(None),) * (0 if leading else 1)
    _close(x, fx[pre + "x"], QP_TOL, f"{form}.x", sel + (want_conv,))
    _close(x, fx[pre + "x"], F8_TOL, f"{form}.x")
    assert want_conv.sum(axis=axis) >= 1
    assert qp_fused.solve.launches == qp_fused.solve_lanes_last.launches == 0


@pytest.mark.parametrize("form", list(CYCLES))
def test_cycle_matches_jax(fx, form):
    """run_nmpc_batch(backend="fused") in every configuration off the
    benchmark's own (K1b at (41, 28) and (17, 4); K1a at mi 92 / 112)
    against JAX's `run_nmpc_batch(backend="fused", interpret=True)`: states,
    alpha_com and cbf_margin to 1e-9, equal flags and qp_iters; the NaN
    lane holds position on both sides."""
    got = _port_cycle(form, _cycle_in(fx, form))
    pre = f"{form}.out."
    for name in ("states", "alpha_com", "cbf_margin"):
        _close(getattr(got, name), fx[pre + name], CYCLE_TOL,
               f"{form}.{name}")
    np.testing.assert_array_equal(got.qp_converged.numpy(),
                                  fx[pre + "qp_converged"])
    assert int(got.qp_iters) == int(fx[pre + "qp_iters"])
    assert torch.isfinite(got.states).all()
    n, me, _ = mpc_batch.fused_qp_shape(CYCLES[form][0], CYCLES[form][1])
    assert got.x.shape == (8, CYCLES[form][0].num_dec)
    assert (n, me) in qp_fused.GENERAL_SHAPES or (n, me) == (13, 0)


def test_run_batch_uncondensed_fused_matches_jax(fx):
    """bench_wholebody.py's default configuration (the uncondensed NMPC,
    K1b at (41, 28) once a domain and its SCP round; the full LL QP through
    K1b (43, 30)) on "fused", 2 lanes, 3 stand and 3 trot ticks, against
    JAX's run_batch(backend="fused") with the kernels interpreted: 1e-8."""
    team = _team_inputs()
    res = closedloop.run_batch(
        WB_MPC, LowLevelConfig(), MotionConfig(), WB_QP, wb.SimConfig(), LOOP,
        a1.model(), *(team[f"loop.{k}"] for k in ("pr", "prd", "a0", "pobs")),
        backend="fused", device="cpu")
    for name, got in (("q", res.sim.q), ("com_hist", res.com_hist),
                      ("tau_hist", res.tau_hist)):
        _close(got, fx[f"loop.out.{name}"], LOOP_TOL, name)
    np.testing.assert_array_equal(res.qp_ok.numpy(), fx["loop.out.qp_ok"])
    np.testing.assert_array_equal(res.mpc_ok.numpy(), fx["loop.out.mpc_ok"])


def test_run_team_batch_uncondensed_fused_matches_jax(fx):
    """The team golden's (uncondensed) NMPC with the neighbour circle on
    "fused" (K1b (41, 28) at mi 92 and 116), the full LL QP, S 1 x 4, 3
    stand and 3 trot ticks, against JAX's run_team_batch(backend="fused")
    with the kernels interpreted: 1e-8."""
    team = _team_inputs()
    sims, com_ends, margins, llok = closedloop.run_team_batch(
        TEAM_MPC, LowLevelConfig(), MotionConfig(), QP, wb.SimConfig(), LOOP,
        a1.model(), *(team[f"team.{k}"] for k in ("pr", "prd", "a0", "pobs")),
        backend="fused", device="cpu")
    for name, got in (("q", sims.q), ("qd", sims.qd), ("com_ends", com_ends),
                      ("margins", margins)):
        _close(got, fx[f"team.out.{name}"], LOOP_TOL, f"team.{name}")
    np.testing.assert_array_equal(llok.numpy(), fx["team.out.llok"])


@pytest.mark.parametrize("form", list(CAMPAIGNS))
def test_campaign_fused_matches_jax(fx, form):
    """The campaign core on "fused" with exp_campaign_fused.py's two
    configurations (K1b (41, 28) and (17, 4), three launches a domain)
    against JAX's on the same fields: success and qp_ok_frac exactly, the
    other outputs to 1e-9."""
    inp = _campaign_inputs()
    lanes_ref = campaign.plan_lanes(
        refplan.two_agent_config(loop_size=CAMP_LOOP),
        torch.tensor(inp["p_start"]), torch.tensor(inp["pobs"]), 2,
        torch.float64, "cpu")
    got = campaign.run_domains(
        MpcConfig(**CAMPAIGNS[form]), run_campaign_ab.QP_CFG, _camp(),
        torch.tensor(inp["p_start"]), *lanes_ref,
        torch.tensor(inp["pobs_real"]), None, "fused")
    for k in CAMP_OUT:
        want = fx[f"{form}.out.{k}"]
        if k in ("success", "qp_ok_frac"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), want,
                                          err_msg=k)
        else:
            _close(getattr(got, k), want, CYCLE_TOL, f"{form}.{k}")
    assert got.traj.shape == (2, CAMP_DOMAINS, 2, 2)


def test_fixture_inputs_have_the_expected_shapes(fx):
    """Each captured QP has the shape its form names (the shapes the
    kernels were built for)."""
    shapes = {"nmpc41_cold": (41, 28, 92), "nmpc41_scp": (41, 28, 112),
              "nmpc41_neighbour": (41, 28, 116), "nmpc17_scp": (17, 4, 52),
              "noeq13_scp": (13, 0, 112)}
    for form, (n, me, mi) in shapes.items():
        qp = _qp_in(fx, form)
        assert qp["A"].shape[1:] == (me, n) and qp["G"].shape[1] == mi, form
    for form, mi in (("lanes13_cold", 92), ("lanes13_scp", 112)):
        assert _qp_in(fx, form)["G"].shape[:2] == (mi, 13), form


@pytest.mark.slow
def test_fixture_provenance(fx):
    """The committed fixture is what the seeds, the port's assembly and the
    JAX package compute."""
    live = build_fixture()
    assert set(live) == set(fx)
    for k, v in live.items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(fx[k], v, err_msg=k)
        else:
            _close(fx[k], v, 1e-12, k)


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(f"wrote {FIXTURE}")
