"""Trunk pushes, stick-slip contact and the CLF row of srbx_torch against
the JAX package, in float64 on the CPU; with them the JAX package's own
random streams in the campaign and the team runner.

Live JAX oracles, each one jitted JAX function on inputs made with numpy
from a fixed seed, at 1e-12 relative to max(1, |value|):

* `wholebody.contact_forces` with a contact state, on 4 lanes whose toes
  mix inactive, sticking and slipping ones (forces, anchors, slip);
* `lowlevel._clf_terms`;
* `prng.randint` at the push campaign's shape and span and at others, and
  `prng.uniform` with minval and maxval at the campaign's and the team
  runner's, bitwise;
* `run_team.sample_fields(7)` against `scripts/run_team_batch_scale.py`'s
  draws, bitwise; `campaign.sample_obstacles` against the committed
  `tests/data/campaign_fields_jax.npz` within 2 ulps.

The loops are held to `tests/data/torch_disturb_jax.npz`, which the JAX
package computed from the same inputs (`JAX_PLATFORMS=cpu PYTHONPATH=.:tests
python tests/test_torch_disturbance.py` rewrites it), each at 2 lanes over
4 stand and 10 trot ticks on "xla": `run_batch` with pushes and
`use_clf` (the reduced build), with stiction and a push that saturates one
lane's friction cone (the full build), with `use_clf` (the full build);
and `run_campaign_batch`
with `disturbance > 0` at S 2 (the fields and every domain's kicks from one
key). Bounds, as `test_torch_estimation.py` holds its loops: 1e-8
relative, and as `test_torch_team.py` holds its raw-reduced loop 1e-7 on
the reduced forms (the reduced LL QP's condition near 1e10 in float64,
ROADMAP F10: measured up to 7.0e-8 on qd); LL and MPC converged
shares equal. The fixture also keeps, from the module inputs' seed, two
JAX functions whose compile is too long for a live oracle, both held at
1e-12: `step_batch` with `base_force` and the contact state over 3 ticks
(`steps.*`, 25-45 s), on "xla" and "fused" (on the CPU the plain version
of K2a); both LL builds with `use_clf` (row 44 and the relaxation's
weight) and their finishes on a given solution, with `dv_lyap` (`ll.*`,
about 6 s).

`tests/data/torch_push_jax.npz` is scripts/campaign_push.py's point
(160 lanes, 800 stand ticks and 10 domains) run by the JAX package on the
CPU in float64 and, under "f32.*", in float32 (`... python
tests/test_torch_disturbance.py push` rewrites it, about 20 minutes):
`scripts/torch_campaign_push.py` holds the port to it lane by lane in
either dtype; here its pulses are held to the port's.

Slow: `test_fixture_provenance` and `test_push_fixture_provenance`
recompute the fixtures at 1e-12; the 2000-tick creep and re-anchoring
scenarios of `tests/test_stiction.py` run through `step_batch` at B 1 to
the same claims.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from srbx_torch import convert, lowlevel, refplan
from srbx_torch.config import LowLevelConfig, MotionConfig, MpcConfig, QpConfig
from srbx_torch.eval import campaign, run_campaign_ab, run_team
from srbx_torch.models import a1, rbd
from srbx_torch.sim import closedloop, wholebody as wb
from srbx_torch.utils import prng
from test_torch_estimation import flatten
from test_torch_team import REDUCED_LOOP_TOL, _jcfg
from test_torch_wholebody import _close, _t, _toes

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
FIXTURE = DATA / "torch_disturb_jax.npz"
FIELDS = DATA / "campaign_fields_jax.npz"
PUSH_FIXTURE = DATA / "torch_push_jax.npz"
SEED = 2031
TOL = 1e-12
LOOP_TOL = 1e-8
SIM = wb.SimConfig()
CLF = LowLevelConfig(use_clf=True)
MOTION = MotionConfig()
QP = QpConfig()
# the push campaign's relaxed solver (scripts/campaign_push.py)
PUSH_QP = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6, reg_dual=1e-6,
                   max_iters=12)
QP_ONLY = MpcConfig(use_sqp=False, condensed=True, elide_box_rows=True,
                    elide_simplex=True)
LOOP = closedloop.LoopConfig(stand_ticks=4, n_domains=1, ticks_per_domain=10)
# name -> (LL build reduced, LowLevelConfig, stiction, push)
LOOP_FORMS = {
    "push_clf_reduced": (True, CLF, False, "push"),
    "stiction_full": (False, LowLevelConfig(), True, "saturating"),
    "clf_full": (False, CLF, False, None),
}
CAMP = campaign.CampaignConfig(n_agents=2, n_domains=4, disturbance=0.3)
CAMP_LOOP = 400
CAMP_KEY = 9
# prng.randint cases: (seed, shape, minval, maxval); the first is
# scripts/campaign_push.py's onsets
RANDINT = ((7, (160,), 2 * 172, 7 * 172), (3, (4, 5), 0, 7),
           (11, (33,), -5, 1_000_003), (5, (6,), 3, 3), (5, (6,), 10, 2),
           (2, (9,), -2 ** 31, 2 ** 31 - 1), (8, (2, 3), 0, 65_537))


# ------------------------------- the inputs ------------------------------- #

def module_inputs():
    """The modules' inputs, 4 lanes from numpy seed 2031: standing lanes
    whose toes are in contact (lane 3 lifted clear of the ground), anchors
    near the toes (sticking) or far from them (slipping)."""
    rng = np.random.default_rng(SEED)
    n = 4
    q = np.zeros((n, 18))
    q[:, 7::3] = 0.8 + rng.normal(size=(n, 4)) * 0.05
    q[:, 8::3] = -1.6 + rng.normal(size=(n, 4)) * 0.05
    q[:, 3:6] = rng.normal(size=(n, 3)) * 0.02
    q[:, 0:2] = rng.normal(size=(n, 2)) * 0.5 + 2.0
    q[:, 2] = -_toes(q)[:, :, 2].max(1) - 0.003
    q[3, 2] += 0.05                               # every toe in the air
    toes = _toes(q)
    # per toe: 0.1 mm (sticks), 5 cm (slips) from its anchor, alternating
    far = np.where(np.arange(4)[None, :, None] % 2 == 1, 5e-2, 1e-4)
    anchor = toes[:, :, 0:2] + far * rng.normal(size=(n, 4, 2))
    contact = np.array([[1.0, 0.0, 0.0, 1.0], [0.0, 1.0, 1.0, 0.0],
                        [1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 0.0]])
    out_mask = np.concatenate([np.ones((n, 6)),
                               np.repeat(1.0 - contact, 3, 1)], 1)
    d = rbd.mass_matrix(a1.model(), torch.as_tensor(q)).numpy()
    delta_a = rng.normal(size=(n, 12, 12))
    return {
        "q": q, "qd": rng.normal(size=(n, 18)) * 0.2,
        "con.anchor": anchor, "con.slip": rng.uniform(0.0, 0.01, (n, 4)),
        "tau": rng.normal(size=(n, 3, 12)) * 5.0,
        "base_force": rng.normal(size=(n, 3)) * 40.0,
        "contact": contact, "f_des": rng.normal(size=(n, 12)) * 20.0,
        "d_inv": np.linalg.inv(d),
        "vc.y": rng.normal(size=(n, 18)) * 0.02 * out_mask,
        "vc.dy": rng.normal(size=(n, 18)) * 0.1 * out_mask,
        "vc.h0_mat": rng.normal(size=(n, 18, 18)) * out_mask[:, :, None],
        "vc.dh0": rng.normal(size=(n, 18)) * out_mask,
        "vc.hd": rng.normal(size=(n, 18)) * 0.1,
        "vc.dhd": rng.normal(size=(n, 18)) * 0.1,
        "vc.ddhd": rng.normal(size=(n, 18)),
        "vc.out_mask": out_mask,
        "x43": rng.normal(size=(n, 43)), "x25": rng.normal(size=(n, 25)),
        "delta": delta_a @ delta_a.transpose(0, 2, 1) / 12 + np.eye(12),
    }


VC_FIELDS = ("y", "dy", "h0_mat", "dh0", "hd", "dhd", "ddhd", "out_mask")


def _vc(inp, cls, conv):
    return cls(*(conv(inp[f"vc.{f}"]) for f in VC_FIELDS))


# ------------------------------ the oracles ------------------------------- #

def jax_oracles(inp):
    """What the JAX package computes from `inp` in two jitted functions:
    the contact forces with the state and `_clf_terms`; and jax.random's
    draws."""
    import jax
    import jax.numpy as jnp

    from srbx import lowlevel as jll
    from srbx.models import a1 as ja1
    from srbx.sim import wholebody as jwb

    jax.config.update("jax_enable_x64", True)
    model = ja1.model()
    j = {k: jnp.asarray(v) for k, v in inp.items()}

    def modules(j):
        con = jwb.ContactState(j["con.anchor"], j["con.slip"])
        grf, con1 = jax.vmap(lambda q, qd, c: jwb.contact_forces(
            SIM, model, q, qd, c))(j["q"], j["qd"], con)
        terms = jax.vmap(lambda y, dy, m: jll._clf_terms(
            _jcfg(CLF), y, dy, m, jnp.float64))(j["vc.y"], j["vc.dy"],
                                                j["vc.out_mask"])
        return {"plant": {"grf": grf, "con": con1},
                "ll": {"clf_terms": terms}}

    def draws():
        out = {}
        for i, (seed, shape, lo, hi) in enumerate(RANDINT):
            out[f"randint{i}"] = jax.random.randint(
                jax.random.key(seed), shape, lo, hi, jnp.int32)
        k_az, _ = jax.random.split(jax.random.key(7))
        out["azimuth"] = jax.random.uniform(k_az, (160,), jnp.float32,
                                            0.0, 2 * np.pi)
        k1, k2 = jax.random.split(jax.random.key(7))
        out["team.x"] = jax.random.uniform(k1, (5, 20), jnp.float32, 3.0, 8.0)
        out["team.y"] = jax.random.uniform(k2, (5, 20), jnp.float32, -2.0,
                                           2.0)
        keys = jax.random.split(jax.random.key(4), 3)
        out["uniform64"] = jax.vmap(lambda k: jax.random.uniform(
            k, (7,), jnp.float64, -0.6, 0.6))(keys)
        return out

    res = flatten(jax.jit(modules)(j), "", {})
    flatten({"draws": jax.jit(draws)()}, "", res)
    return {k: np.asarray(v) for k, v in res.items()}


LL_INPUTS = ("q", "qd", "contact", "f_des", "d_inv", "x43", "x25",
             "delta") + tuple(f"vc.{f}" for f in VC_FIELDS)


def jax_ll(inp):
    """The JAX package's LL builds and finishes with use_clf from `inp`,
    per lane (vmapped), in one jitted function (its compile takes about 6 s
    on the CPU, so the fixture keeps it)."""
    import jax
    import jax.numpy as jnp

    from srbx import lowlevel as jll
    from srbx.models import a1 as ja1

    jax.config.update("jax_enable_x64", True)
    model = ja1.model()

    def ll(j):
        ll_cfg = _jcfg(CLF)
        vc = _vc(j, jll.VcOut, lambda a: a)
        out = {}
        for name, build, finish, x in (
                ("full", jll.ll_qp_build, jll.ll_qp_finish, "x43"),
                ("reduced", jll.ll_qp_build_reduced,
                 jll.ll_qp_finish_reduced, "x25")):
            def lane(q, qd, ci, vc, f_des, d_inv, sol_x, delta, build=build,
                     finish=finish):
                data, ctx = build(ll_cfg, model, q, qd, ci, vc, f_des,
                                  d_inv=d_inv)
                return data, ctx, finish(ll_cfg, ctx, q, qd, vc, sol_x,
                                         jnp.asarray(True), delta=delta)

            data, ctx, fin = jax.vmap(lane)(
                j["q"], j["qd"], j["contact"], vc, j["f_des"], j["d_inv"],
                j[x], j["delta"])
            base = ctx.base if name == "reduced" else ctx
            out[name] = {"data": data, "ctx": base, "finish": fin}
        return out

    out = {f"ll.in.{k}": inp[k] for k in LL_INPUTS}
    flatten({"ll": jax.jit(ll)({k: jnp.asarray(inp[k])
                                for k in LL_INPUTS})}, "", out)
    return out


STEP_INPUTS = ("q", "qd", "con.anchor", "con.slip", "tau", "base_force")


def jax_steps(inp):
    """The JAX package's `step_batch` on "xla" with base_force and the
    contact state over 3 ticks from `inp` (its compile takes 25-45 s on the
    CPU, so the fixture keeps it)."""
    import jax
    import jax.numpy as jnp

    from srbx.models import a1 as ja1
    from srbx.sim import wholebody as jwb

    jax.config.update("jax_enable_x64", True)
    model = ja1.model()

    def steps(j):
        s = jwb.SimState(j["q"], j["qd"],
                         jwb.ContactState(j["con.anchor"], j["con.slip"]))
        hist = []
        for k in range(3):
            s = jwb.step_batch(SIM, model, s, j["tau"][:, k], backend="xla",
                               base_force=j["base_force"])
            hist.append(s)
        return jax.tree.map(lambda *a: jnp.stack(a), *hist)

    out = {f"steps.in.{k}": inp[k] for k in STEP_INPUTS}
    flatten({"steps": jax.jit(steps)({k: jnp.asarray(inp[k])
                                      for k in STEP_INPUTS})}, "", out)
    return out


@pytest.fixture(scope="module")
def oracle():
    inp = module_inputs()
    return inp, jax_oracles(inp)


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

def test_contact_forces_with_state_match_jax(oracle):
    """The stick-slip forces, anchors and slip; the inputs mix every
    case."""
    inp, want = oracle
    con = wb.ContactState(_t(inp["con.anchor"]), _t(inp["con.slip"]))
    grf, con1 = wb.contact_forces(SIM, a1.model(), _t(inp["q"]),
                                  _t(inp["qd"]), con)
    got = flatten({"plant": {"grf": grf, "con": con1}}, "", {})
    _cmp(got, want, "plant.grf")
    _cmp(got, want, "plant.con")
    fz = want["plant.grf"][..., 2]
    moved = np.abs(want["plant.con.anchor"] - inp["con.anchor"]).max(-1)
    assert (fz[3] == 0).all() and (fz[:3] > 0).sum() >= 6  # inactive, active
    assert (moved[:3][fz[:3] > 0] > 0).any()                # slipping toes
    assert (moved[:3][fz[:3] > 0] == 0).any()               # sticking toes
    np.testing.assert_allclose(want["plant.con.anchor"][3],
                               _toes(inp["q"])[3, :, 0:2], rtol=0,
                               atol=1e-12)                # re-anchored


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_step_batch_with_force_and_state_matches_jax(fx, backend):
    """Three ticks under base_force with the contact state threaded through
    both substeps, against the JAX package's "xla" step_batch (the
    fixture's `steps.*`)."""
    inp = {k: fx[f"steps.in.{k}"] for k in STEP_INPUTS}
    s = wb.SimState(_t(inp["q"]), _t(inp["qd"]),
                    wb.ContactState(_t(inp["con.anchor"]),
                                    _t(inp["con.slip"])))
    hist = []
    for k in range(3):
        s = wb.step_batch(SIM, a1.model(), s, _t(inp["tau"][:, k]),
                          backend=backend, base_force=_t(inp["base_force"]))
        hist.append(s)
    got = {f"steps.{name}": torch.stack([f(h) for h in hist]).numpy()
           for name, f in (("q", lambda h: h.q), ("qd", lambda h: h.qd),
                           ("con.anchor", lambda h: h.con.anchor),
                           ("con.slip", lambda h: h.con.slip))}
    _cmp(got, fx, "steps.q")
    _cmp(got, fx, "steps.qd")
    _cmp(got, fx, "steps.con")
    # the force moves the trunk: without it the same ticks end elsewhere
    s0 = wb.SimState(_t(inp["q"]), _t(inp["qd"]))
    for k in range(3):
        s0 = wb.step_batch(SIM, a1.model(), s0, _t(inp["tau"][:, k]),
                           backend=backend)
    assert s0.con is None
    assert np.abs(s0.qd[:, 0:3].numpy()
                  - fx["steps.qd"][-1, :, 0:3]).max() > 1e-3


def test_clf_terms_match_jax(oracle):
    inp, want = oracle
    got = lowlevel._clf_terms(CLF, _t(inp["vc.y"]), _t(inp["vc.dy"]),
                              _t(inp["vc.out_mask"]))
    _cmp(flatten({"ll": {"clf_terms": got}}, "", {}), want, "ll.clf_terms")


@pytest.mark.parametrize("build", ["full", "reduced"])
def test_clf_row_of_both_builds_matches_jax(fx, build):
    """The whole build with use_clf (row 44, delta's weight clf_pen), the
    context's CLF terms, and the finish's torques and dv_lyap, against the
    JAX package's (the fixture's `ll.*`)."""
    inp, want = {k: fx[f"ll.in.{k}"] for k in LL_INPUTS}, fx
    vc = _vc(inp, lowlevel.VcOut, _t)
    q, qd = _t(inp["q"]), _t(inp["qd"])
    fn, finish, x = ((lowlevel.ll_qp_build, lowlevel.ll_qp_finish, "x43")
                     if build == "full" else
                     (lowlevel.ll_qp_build_reduced,
                      lowlevel.ll_qp_finish_reduced, "x25"))
    data, ctx = fn(CLF, a1.model(), q, qd, _t(inp["contact"]), vc,
                   _t(inp["f_des"]), d_inv=_t(inp["d_inv"]))
    fin = finish(CLF, ctx, q, qd, vc, _t(inp[x]), torch.ones(4, dtype=bool),
                 delta=_t(inp["delta"]))
    base = ctx.base if build == "reduced" else ctx
    got = flatten({"ll": {build: {"data": data, "ctx": base,
                                  "finish": fin}}}, "", {})
    _cmp(got, want, f"ll.{build}")
    n = data.P.shape[1]
    assert float(data.P[0, n - 1, n - 1]) == CLF.clf_pen
    assert (data.G[:, 44, n - 1] == -1.0).all()
    assert (fin.dv_lyap != 0).all()
    # without the CLF row 44 is inert, delta's weight 1 and dv zero
    plain_cfg = dataclasses.replace(CLF, use_clf=False)
    d0, c0 = fn(plain_cfg, a1.model(), q, qd, _t(inp["contact"]), vc,
                _t(inp["f_des"]), d_inv=_t(inp["d_inv"]))
    assert (d0.G[:, 44] == 0).all() and (d0.h[:, 44] == 1).all()
    assert float(d0.P[0, n - 1, n - 1]) == 1.0
    torch.testing.assert_close(d0.G[:, :44], data.G[:, :44], rtol=0, atol=0)
    f0 = finish(plain_cfg, c0, q, qd, vc, _t(inp[x]),
                torch.ones(4, dtype=bool), delta=_t(inp["delta"]))
    assert (f0.dv_lyap == 0).all() and (f0.v_lyap == 0).all()


def test_prng_randint_and_uniform_are_jax_bitwise(oracle):
    _, want = oracle
    for i, (seed, shape, lo, hi) in enumerate(RANDINT):
        got = prng.randint(prng.key(seed, "cpu"), shape, lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(),
                                      want[f"draws.randint{i}"],
                                      err_msg=str(RANDINT[i]))
    k_az, _ = prng.split(prng.key(7, "cpu")).unbind(-2)
    np.testing.assert_array_equal(
        prng.uniform(k_az, (160,), torch.float32, 0.0, 2 * np.pi).numpy(),
        want["draws.azimuth"])
    keys = prng.split(prng.key(4, "cpu"), 3)
    np.testing.assert_array_equal(
        prng.uniform(keys, (7,), torch.float64, -0.6, 0.6).numpy(),
        want["draws.uniform64"])
    with pytest.raises(TypeError):
        prng.randint(prng.key(0, "cpu"), (2,), 0, 5, torch.int64)


def test_team_fields_are_the_jax_scripts(oracle):
    """run_team's fields of seed 7 are scripts/run_team_batch_scale.py's
    (jax.random.key(7), x64 off), in the dtype asked for."""
    _, want = oracle
    got = run_team.sample_fields(5, 7, torch.float64, "cpu")
    assert got.shape == (5, 2, 20) and got.dtype == torch.float64
    np.testing.assert_array_equal(got[:, 0].numpy(), want["draws.team.x"])
    np.testing.assert_array_equal(got[:, 1].numpy(), want["draws.team.y"])


def test_sample_obstacles_are_the_jax_packages():
    """The A/B runner's fields (split(key(0))[0], float32, 1024) and the
    template_campaign golden's (split(key(1234))[0], float64, 32) within 2
    ulps of the committed JAX fields."""
    with np.load(FIELDS) as f:
        fields = dict(f)
    for seed, s, dtype in ((0, 1024, torch.float32), (1234, 32,
                                                      torch.float64)):
        k_obs = prng.split(prng.key(seed, "cpu"))[0]
        got = campaign.sample_obstacles(k_obs, s, 20, 0.6, dtype, "cpu")
        for part, name in zip(got, ("pobs", "pobs_real")):
            want = fields[f"key{seed}.{name}"]
            assert part.dtype == dtype and part.shape == want.shape
            np.testing.assert_array_max_ulp(part.numpy(), want, maxulp=2)


def test_run_campaign_chunked_splits_the_key():
    """batch_backend runs each chunk through run_campaign_batch on its key
    of split(key, n_chunks), concatenated; the per-agent path is M10."""
    ref_cfg = refplan.two_agent_config(loop_size=200)
    camp = dataclasses.replace(CAMP, n_domains=2)
    p = torch.tensor(run_campaign_ab.P_START, dtype=torch.float64)
    args = (QP_ONLY, run_campaign_ab.QP_CFG, camp, ref_cfg, p)
    whole = campaign.run_campaign_chunked(*args, prng.key(3, "cpu"), 2,
                                          max_chunk=1, batch_backend="xla",
                                          device="cpu")
    keys = prng.split(prng.key(3, "cpu"), 2)
    parts = [campaign.run_campaign_batch(*args, k, 1, backend="xla",
                                         device="cpu") for k in keys]
    for name, got in whole._asdict().items():
        want = torch.cat([getattr(r, name) for r in parts])
        assert torch.equal(got, want), name
    one = campaign.run_campaign_chunked(*args, prng.key(3, "cpu"), 2,
                                        batch_backend="xla", device="cpu")
    ref = campaign.run_campaign_batch(*args, prng.key(3, "cpu"), 2,
                                      backend="xla", device="cpu")
    assert torch.equal(one.traj, ref.traj)
    with pytest.raises(NotImplementedError, match="M10"):
        campaign.run_campaign_chunked(*args, prng.key(3, "cpu"), 2)
    with pytest.raises(ValueError, match="divisible"):
        campaign.run_campaign_chunked(*args, prng.key(3, "cpu"), 3,
                                      max_chunk=2, batch_backend="xla",
                                      device="cpu")


def test_contact_state_round_trip():
    """The JAX package's SimState with a ContactState (numpy form) becomes
    the port's, with the port's ContactState, and comes back."""
    from srbx.sim import wholebody as jwb

    rng = np.random.default_rng(3)
    sim = jwb.SimState(rng.normal(size=(2, 18)), rng.normal(size=(2, 18)),
                       jwb.ContactState(rng.normal(size=(2, 4, 2)),
                                        rng.random((2, 4))))
    got = convert.from_numpy(sim, device="cpu")
    assert isinstance(got, wb.SimState)
    assert isinstance(got.con, wb.ContactState)
    back = convert.to_numpy(got)
    for a, b in ((back.q, sim.q), (back.con.anchor, sim.con.anchor),
                 (back.con.slip, sim.con.slip)):
        np.testing.assert_array_equal(a, b)


# ------------------------------- the loops -------------------------------- #

def loop_inputs():
    """Two lanes of the push campaign's straight trot (obstacles 100 m
    away, the port's APF reference, loop 2000), their pushes from trot
    tick 2 for 6 ticks: 30 and 60 N at two azimuths; the saturating push
    1200 N on the second lane over the trot ticks, none on the first."""
    ref = refplan.generate(refplan.two_agent_config(loop_size=2_000),
                           torch.tensor([0.0, 0.0, 0.0, -1.0],
                                        dtype=torch.float64),
                           torch.full((2, 20), 100.0, dtype=torch.float64),
                           device="cpu")
    n = 2
    az = np.array([0.3, 2.0])
    mags = np.array([30.0, 60.0])
    return {
        "loop.pr": np.repeat(ref.pr.numpy()[None, 0:2], n, 0),
        "loop.prd": np.repeat(ref.prd.numpy()[None, 0:2], n, 0),
        "loop.a0": np.array([[0.0, 0.0], [0.005, 0.0]]),
        "loop.pobs": np.full((n, 2, 20), 100.0),
        "push.force": np.stack([mags * np.cos(az), mags * np.sin(az),
                                np.zeros(n)], 1),
        "push.start": np.full(n, 2, np.int32),
        "push.dur": np.full(n, 6, np.int32),
        "saturating.force": np.array([[0.0, 0.0, 0.0], [0.0, 1200.0, 0.0]]),
        "saturating.start": np.zeros(n, np.int32),
        "saturating.dur": np.full(n, 10, np.int32),
        "camp.p_start": np.asarray(run_campaign_ab.P_START),
    }


def _loop_call(form, inp, run_batch, cfg, loop_cls, extra):
    """The form's run_batch of either package; cfg maps a port
    configuration to that package's."""
    reduced, ll_cfg, stiction, push = LOOP_FORMS[form]
    kw = dict(backend="xla", ll_reduced=reduced, stiction=stiction, **extra)
    if push is not None:
        kw["push"] = tuple(inp[f"{push}.{k}"] for k in ("force", "start",
                                                        "dur"))
    return run_batch(cfg(QP_ONLY), cfg(ll_cfg), cfg(MOTION), cfg(PUSH_QP),
                     cfg(SIM), loop_cls(*LOOP), cfg.model(),
                     *(inp[f"loop.{k}"] for k in ("pr", "prd", "a0", "pobs")),
                     **kw)


def _loop_record(form, res, out):
    pre = f"loop.{form}"
    vals = {"q": res.sim.q, "qd": res.sim.qd, "com_hist": res.com_hist,
            "qp_ok": res.qp_ok, "mpc_ok": res.mpc_ok,
            "tau_max": res.tau_hist[..., 0]}
    if res.sim.con is not None:
        vals.update({"con.anchor": res.sim.con.anchor,
                     "con.slip": res.sim.con.slip})
    for name, v in vals.items():
        out[f"{pre}.{name}"] = np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _camp_record(res, out):
    for name, v in res._asdict().items():
        out[f"camp.{name}"] = np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def build_fixture():
    """The fixture: the loops' inputs and the JAX package's results."""
    import jax
    import jax.numpy as jnp

    from srbx import refplan as jrefplan
    from srbx.eval import campaign as jcampaign
    from srbx.models import a1 as ja1
    from srbx.sim import closedloop as jcl
    from srbx.sim import wholebody as jwb

    jax.config.update("jax_enable_x64", True)
    inp = loop_inputs()
    out = dict(inp)
    jinp = {k: jnp.asarray(v) for k, v in inp.items()}

    def jcfg(c):
        if isinstance(c, wb.SimConfig):
            return jwb.SimConfig(**dataclasses.asdict(c))
        return _jcfg(c)

    jcfg.model = ja1.model
    for form in LOOP_FORMS:
        # the inputs as the jitted function's arguments (ROADMAP F5)
        res = jax.jit(lambda j, form=form: _loop_call(
            form, j, jcl.run_batch, jcfg, jcl.LoopConfig, {}))(jinp)
        _loop_record(form, res, out)
    out.update(jax_steps(module_inputs()))
    out.update(jax_ll(module_inputs()))
    camp = jcampaign.CampaignConfig(**dataclasses.asdict(CAMP))
    res = jax.jit(lambda p: jcampaign.run_campaign_batch(
        _jcfg(QP_ONLY), _jcfg(run_campaign_ab.QP_CFG), camp,
        jrefplan.two_agent_config(loop_size=CAMP_LOOP), p,
        jax.random.key(CAMP_KEY), 2, backend="xla"))(jinp["camp.p_start"])
    return _camp_record(res, out)


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return dict(f)


def test_fixture_matches_inputs(fx):
    inp = module_inputs()
    for k, v in list(loop_inputs().items()) + [
            (f"steps.in.{k}", inp[k]) for k in STEP_INPUTS] + [
            (f"ll.in.{k}", inp[k]) for k in LL_INPUTS]:
        np.testing.assert_array_equal(fx[k], v, err_msg=k)


def _port_cfg(c):
    return c


_port_cfg.model = a1.model


@pytest.mark.parametrize("form", list(LOOP_FORMS))
def test_run_batch_matches_jax(fx, form):
    res = _loop_call(form, fx, closedloop.run_batch, _port_cfg,
                     closedloop.LoopConfig, {"device": "cpu"})
    got = _loop_record(form, res, {})
    pre = f"loop.{form}"
    keys = sorted(k for k in fx if k.startswith(pre + "."))
    assert keys == sorted(got), (keys, sorted(got))
    # the reduced LL QP solved raw in float64 (condition near 1e10, ROADMAP
    # F10) is held as tests/test_torch_team.py holds its raw-reduced loop
    tol = REDUCED_LOOP_TOL if LOOP_FORMS[form][0] else LOOP_TOL
    for k in keys:
        if k.endswith(("qp_ok", "mpc_ok")):
            np.testing.assert_array_equal(got[k], fx[k], err_msg=k)
        else:
            _close(got[k], fx[k], tol, relative=True, what=k)
    if form == "stiction_full":
        # both lanes slip as their toes land; the saturating push drags the
        # second lane's anchors further (a toe slips only on the cone)
        slip = fx[f"{pre}.con.slip"]
        assert slip[1].sum() > slip[0].sum() + 1e-4


def test_campaign_disturbance_matches_jax(fx):
    """run_campaign_batch with kicks: the fields and every domain's kicks
    from key 9, as the JAX package draws them."""
    res = campaign.run_campaign_batch(
        QP_ONLY, run_campaign_ab.QP_CFG, CAMP,
        refplan.two_agent_config(loop_size=CAMP_LOOP),
        torch.tensor(fx["camp.p_start"]), prng.key(CAMP_KEY, "cpu"), 2,
        backend="xla", device="cpu")
    got = _camp_record(res, {})
    assert sorted(got) == sorted(k for k in fx if k.startswith("camp.")
                                 and k != "camp.p_start")
    for k, v in got.items():
        if fx[k].dtype.kind in "biu" or k.endswith("qp_ok_frac"):
            np.testing.assert_array_equal(v, fx[k], err_msg=k)
        else:
            _close(v, fx[k], LOOP_TOL, relative=True, what=k)
    # without the kicks the run is another
    calm = campaign.run_campaign_batch(
        QP_ONLY, run_campaign_ab.QP_CFG,
        dataclasses.replace(CAMP, disturbance=0.0),
        refplan.two_agent_config(loop_size=CAMP_LOOP),
        torch.tensor(fx["camp.p_start"]), prng.key(CAMP_KEY, "cpu"), 2,
        backend="xla", device="cpu")
    assert np.abs(calm.traj.numpy() - fx["camp.traj"]).max() > 1e-3


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


# ------------------- tests/test_stiction.py's scenarios ------------------- #

def _hold_tau(q, qd, q0):
    """tests/test_stiction.py's joint PD holding the crouch."""
    return -100.0 * (q[:, 6:] - q0[:, 6:]) - 5.0 * qd[:, 6:]


def _settled(n=500):
    q0 = wb.default_crouch(a1.model(), device="cpu")[None]
    s = wb.SimState(q0, torch.zeros_like(q0))
    for _ in range(n):
        s = wb.step_batch(SIM, a1.model(), s, _hold_tau(s.q, s.qd, q0))
    return q0, s


@pytest.mark.slow
def test_static_lateral_push_creep_eliminated():
    """tests/test_stiction.py's 25 N lateral push for 2000 ticks at B 1:
    the viscous plant creeps over 1 cm and still moves, the stick-slip one
    deflects under 5 mm, comes to rest and records no slip."""
    q0, settled = _settled()
    force = torch.tensor([[0.0, 25.0, 0.0]], dtype=torch.float64)

    def drift(stiction):
        s = settled
        if stiction:
            s = s._replace(con=wb.init_contact_state(a1.model(), s.q))
        y0 = float(s.q[0, 1])
        for _ in range(2000):
            s = wb.step_batch(SIM, a1.model(), s, _hold_tau(s.q, s.qd, q0),
                              base_force=force)
        return float(s.q[0, 1]) - y0, s

    d_vis, s_vis = drift(False)
    d_stick, s_stick = drift(True)
    assert abs(d_vis) > 1e-2 and abs(d_stick) < 5e-3, (d_vis, d_stick)
    assert float(s_stick.qd.norm()) < 1e-3 < 5e-3 < float(s_vis.qd.norm())
    assert float(s_stick.con.slip.max()) < 1e-3


@pytest.mark.slow
def test_kinetic_slip_and_reanchor():
    """tests/test_stiction.py's 120 N push above the cone for 1000 ticks:
    centimetres of slip and of travel; lifted clear, every anchor snaps to
    its toe on the first step."""
    q0, settled = _settled()
    s = settled._replace(con=wb.init_contact_state(a1.model(), settled.q))
    force = torch.tensor([[120.0, 0.0, 0.0]], dtype=torch.float64)
    for _ in range(1000):
        s = wb.step_batch(SIM, a1.model(), s, _hold_tau(s.q, s.qd, q0),
                          base_force=force)
    assert float(s.con.slip.max()) > 1e-2
    assert float(s.q[0, 0] - settled.q[0, 0]) > 1e-2
    q_air = s.q.clone()
    q_air[:, 2] += 0.05
    s2 = wb.step_batch(SIM, a1.model(),
                       wb.SimState(q_air, torch.zeros_like(q_air), s.con),
                       torch.zeros((1, 12), dtype=torch.float64))
    toe_xy = rbd.site_positions(a1.model(), s2.q)[:, a1.TOE_SITES, 0:2]
    np.testing.assert_allclose(s2.con.anchor.numpy(), toe_xy.numpy(),
                               atol=5e-3)


# ------------------------ the push campaign in float64 -------------------- #

def build_push_fixture():
    """scripts/campaign_push.py's point in float64 through the JAX package
    on the CPU (backend "xla", as the script picks there): 160 lanes, 800
    stand ticks and 10 domains, the key(7) pulses; per lane the final q,
    the LL-QP converged share of the final domain and the script's
    success. The same in float32 as the script runs it (x64 off, the
    planner in float32), under "f32.*". scripts/torch_campaign_push.py
    holds the port to it lane by lane in either dtype."""
    import jax
    import jax.numpy as jnp

    from srbx import refplan as jrefplan
    from srbx.config import (LowLevelConfig as JLL, MotionConfig as JMO,
                             MpcConfig as JMpc, QpConfig as JQp)
    from srbx.models import a1 as ja1
    from srbx.sim import closedloop as jcl
    from srbx.sim import wholebody as jwb

    jax.config.update("jax_enable_x64", True)
    mags = [0.0, 10.0, 20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0, 90.0]
    reps, n_domains, dur = 16, 10, 300
    bsz = len(mags) * reps
    loop = jcl.LoopConfig(stand_ticks=800, n_domains=n_domains)
    p_start = jnp.asarray([0.0, 0.0, 0.0, -1.0])
    pobs = jnp.full((2, 20), 100.0)
    ref = jrefplan.generate(jrefplan.two_agent_config(loop_size=8_000),
                            p_start, pobs)
    # the script's draws (float32 azimuths, int32 onsets, x64 off)
    with jax.enable_x64(False):
        k_az, k_start = jax.random.split(jax.random.key(7))
        m32 = jnp.repeat(jnp.asarray(mags, jnp.float32), reps)
        az = jax.random.uniform(k_az, (bsz,), minval=0.0, maxval=2 * np.pi)
        force = np.asarray(jnp.stack([m32 * jnp.cos(az), m32 * jnp.sin(az),
                                      jnp.zeros((bsz,), jnp.float32)], 1))
        start = np.asarray(jax.random.randint(
            k_start, (bsz,), 2 * 172, (n_domains - 3) * 172))
    args = (jnp.broadcast_to(ref.pr[0:2], (bsz, 2, ref.pr.shape[1])),
            jnp.broadcast_to(ref.prd[0:2], (bsz, 2, ref.prd.shape[1])),
            jnp.broadcast_to(p_start[0:2], (bsz, 2)),
            jnp.broadcast_to(pobs, (bsz, 2, 20)),
            jnp.asarray(force, jnp.float64), jnp.asarray(start, jnp.int32))
    qp_cfg = JQp(**vars(PUSH_QP))
    mpc_cfg = JMpc(**{f.name: getattr(QP_ONLY, f.name)
                      for f in dataclasses.fields(QP_ONLY)})

    def run(pr, prd, a0, pobs_b, force, start):
        return jcl.run_batch(
            mpc_cfg, JLL(), JMO(), qp_cfg, jwb.SimConfig(), loop,
            ja1.model(), pr, prd, a0, pobs_b, dtype=jnp.float64,
            backend="xla", tile=128, ll_reduced=True,
            push=(force, start, jnp.full((bsz,), dur, jnp.int32)))

    def outcome(res):
        q = np.asarray(res.sim.q)
        com = np.asarray(res.com_hist).reshape(bsz, -1)
        llok = np.asarray(res.tau_hist)[:, -1, 1]
        finite = np.isfinite(com).all(1) & np.isfinite(q).all(1)
        success = ((q[:, 2] > 0.18) & (q[:, 2] < 0.40)
                   & (np.abs(q[:, 3]) < 0.5) & (np.abs(q[:, 4]) < 0.5)
                   & finite & (llok > 0.995))
        return {"q": q, "llok_final": llok, "finite": finite,
                "success": success, "qp_ok": np.asarray(res.qp_ok),
                "mpc_ok": np.asarray(res.mpc_ok)}

    out = {"push.force": force, "push.start": start,
           **outcome(jax.jit(run)(*args))}
    with jax.enable_x64(False):
        f32 = jnp.float32
        p32 = jnp.asarray([0.0, 0.0, 0.0, -1.0], f32)
        pobs32 = jnp.full((2, 20), 100.0, f32)
        ref32 = jrefplan.generate(jrefplan.two_agent_config(loop_size=8_000),
                                  p32, pobs32, dtype=f32)

        def run32(pr, prd, a0, pobs_b, force, start):
            return jcl.run_batch(
                mpc_cfg, JLL(), JMO(), qp_cfg, jwb.SimConfig(), loop,
                ja1.model(), pr, prd, a0, pobs_b, dtype=f32, backend="xla",
                tile=128, ll_reduced=True,
                push=(force, start, jnp.full((bsz,), dur, jnp.int32)))

        res32 = jax.jit(run32)(
            jnp.broadcast_to(ref32.pr[0:2], (bsz, 2, ref32.pr.shape[1])),
            jnp.broadcast_to(ref32.prd[0:2], (bsz, 2, ref32.prd.shape[1])),
            jnp.broadcast_to(p32[0:2], (bsz, 2)),
            jnp.broadcast_to(pobs32, (bsz, 2, 20)), jnp.asarray(force, f32),
            jnp.asarray(start, jnp.int32))
        out.update({"f32." + k: v for k, v in outcome(res32).items()})
    return out


def _push_script():
    import importlib.util

    path = DATA.parent.parent / "scripts" / "torch_campaign_push.py"
    spec = importlib.util.spec_from_file_location("torch_campaign_push",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_push_campaign_pulses_are_the_jax_scripts():
    """scripts/torch_campaign_push.py's pulses against the ones the JAX
    package drew for tests/data/torch_push_jax.npz (the JAX script's
    key(7) draws): onsets bitwise, forces within 2 ulps (jnp.cos / sin
    against torch's in float32)."""
    with np.load(PUSH_FIXTURE) as f:
        want_force, want_start = f["push.force"], f["push.start"]
    force, start, dur = _push_script().pushes(16, 10, 300, 172,
                                              torch.float32, "cpu")
    np.testing.assert_array_equal(start.numpy(), want_start)
    np.testing.assert_array_max_ulp(force.numpy(), want_force, maxulp=2)
    assert (dur == 300).all() and start.dtype == torch.int32


@pytest.mark.slow
def test_push_fixture_provenance():
    """The committed push campaign, float64 and float32, is what the JAX
    package computes (about 20 minutes on the CPU)."""
    live = build_push_fixture()
    with np.load(PUSH_FIXTURE) as f:
        fx = dict(f)
    assert set(live) == set(fx)
    for k, v in live.items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(fx[k], v, err_msg=k)
        else:
            _close(fx[k], v, TOL, relative=True, what=k)


if __name__ == "__main__":
    DATA.mkdir(exist_ok=True)
    if sys.argv[1:] == ["push"]:
        np.savez_compressed(PUSH_FIXTURE, **build_push_fixture())
        print(f"wrote {PUSH_FIXTURE}")
    else:
        np.savez_compressed(FIXTURE, **build_fixture())
        print(f"wrote {FIXTURE}")
