"""The template A/B campaign of srbx_torch (`srbx_torch.eval`) against the
JAX package's `srbx/eval/campaign.py`, in float64 on the CPU.

* gait tables (`srbx_torch.gait`) against `srbx.gait`, exactly;
* `sample_obstacles`: shapes, ranges, the clamp, and the same fields from
  the same key;
* the planner's scenario axis: 3 fields in one rollout against per-field
  `refplan.generate` (1e-12) and JAX `vmap(generate)` (1e-12, the bound of
  tests/test_torch_ocp.py::test_refplan_generate);
* the campaign against the committed fixture
  `tests/data/torch_campaign_jax.npz`: inputs and JAX
  `_run_campaign_batch_core(..., backend="xla")` in float64 at S 2, 2
  agents, 6 domains, `loop_size` 2000, the A/B runner's relaxed `QpConfig`,
  on fields from JAX `sample_obstacles(jax.random.key(7), 2, 20, 0.6)`, in
  four forms (CBF-SQP condensed+simplex+elided, QP-only,
  `inter_agent_cbf=True`, `warm_start_qp=True`), with backend "xla" (all
  four) and "fused" (the plain version of kernel K1a on the CPU; CBF-SQP
  and QP-only): `success` and `qp_ok_frac` exactly, the other outputs to
  1e-9, but for the lanes of one scenario whose SCP solve breaks down
  (BREAKDOWN below), held after the stand domains to the JAX package's own
  closed-loop bound.

The JAX package's obstacle fields are committed in
`tests/data/campaign_fields_jax.npz` (the port draws them too, through
`srbx_torch.utils.prng`: tests/test_torch_disturbance.py):
"key0.*", float32, `sample_obstacles(jax.random.split(jax.random.key(0))[0],
1024, 20, 0.6)` with x64 off (the A/B runner's); "key1234.*", float64,
`sample_obstacles(jax.random.split(jax.random.key(1234))[0], 32, 20, 0.6)`
with x64 on (the template_campaign golden's). `python
tests/test_torch_campaign.py` rewrites both files; the slow provenance tests
recompute them live (fields bitwise, results to 1e-12).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbx import gait as jgait
from srbx import refplan as jrefplan
from srbx.config import Gait as JGait
from srbx.config import MpcConfig as JMpcConfig
from srbx.config import QpConfig as JQpConfig
from srbx.eval import campaign as jcampaign
from srbx_torch import gait, refplan
from srbx_torch.config import Gait, MpcConfig
from srbx_torch.eval import campaign, run_campaign_ab
from srbx_torch.utils import prng

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
FIELDS = DATA / "campaign_fields_jax.npz"
FIXTURE = DATA / "torch_campaign_jax.npz"
P_START = np.array([0.0, 0.5, 0.0, -0.5])
LOOP = 2000
N_DOMAINS = 6
ELIDED = dict(condensed=True, elide_box_rows=True, elide_simplex=True)
# form -> (MpcConfig kwargs, CampaignConfig kwargs, warm_start_qp)
FORMS = {
    "cbf_sqp": (dict(use_sqp=True, sqp_iters=2, **ELIDED), {}, False),
    "qp_only": (dict(use_sqp=False, sqp_iters=2, **ELIDED), {}, False),
    "inter_agent": (dict(use_sqp=True, sqp_iters=2, **ELIDED),
                    dict(inter_agent_cbf=True), False),
    "warm_start": (dict(use_sqp=True, sqp_iters=2, **ELIDED), {}, True),
}
OUTPUTS = ("success", "fail_distance", "min_clearance", "final_xy",
           "qp_ok_frac", "traj")
# Scenario 1's agent 0 meets, in domain 2, SCP QPs whose IPM breaks down:
# its steps go non-finite and the NaN freeze ends the solve at an iteration
# that rounding decides (in the second round the JAX package's batched IPM
# stops at iteration 7, the port's at 8; the plain K1a, which stops each
# lane on its own (ROADMAP F4), at another; and on the CPU the iteration
# also moves with BLAS's summation order from one process to another).
# From there its track differs from the fixture's by up to 2.2e-5 ("xla")
# and 1.1e-2 ("fused", and "xla" in one process order), and in the
# inter-agent form its neighbour's by 1.6e-7 (measured). Fed the same
# inputs, the port's cycle and the JAX package's agree to 1e-13 on every
# other lane and domain. The JAX package bounds this effect of the SCP by
# 3e-2 (tests/test_campaign.py::test_batch_campaign_matches_per_agent):
# that scenario is held to it after the two stand domains, every other
# lane and the stand domains to 1e-9; success and qp_ok_frac exactly.
BREAKDOWN = 1
SCP_TOL = 3e-2
N_STAND = 2


def _camp(form):
    return jcampaign.CampaignConfig(n_agents=2, n_domains=N_DOMAINS,
                                    **FORMS[form][1])


# ------------------------------- gait tables ------------------------------- #

@pytest.mark.parametrize("g", list(Gait), ids=[g.name for g in Gait])
def test_gait_tables_match_jax(g):
    jg = JGait(int(g))
    np.testing.assert_array_equal(gait.one_cycle_index(g),
                                  jgait.one_cycle_index(jg))
    for m in (2, 4, 6, 10, 12, 14, 122):
        for mine, theirs in ((gait.total_cycle_index, jgait.total_cycle_index),
                             (gait.contact_schedule, jgait.contact_schedule)):
            got, want = mine(g, m), theirs(jg, m)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for m in (3, 5, 7, 13):
        with pytest.raises(ValueError):
            gait.total_cycle_index(g, m)
        with pytest.raises(ValueError):
            jgait.total_cycle_index(jg, m)
    assert gait.phase(43, 172) == jgait.phase(43, 172)


def test_contact_table_matches_jax():
    for n in (1, 6, 8, 120):
        got = campaign._contact_table(n, torch.float64, "cpu").numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jcampaign._contact_table(n, jnp.float64)))


# --------------------------- obstacle sampling ---------------------------- #

def test_sample_obstacles_distribution_and_clamp():
    """As tests/test_campaign.py::test_sample_obstacles_distribution_and_
    clamp: nominal in [0,9] x [-2,2], real within the uncertainty of it and
    clamped to [1,9] x [-3,3]; the same key gives the same fields, on the
    device asked for."""
    s, n, u = 64, 20, 0.6
    pobs, real = campaign.sample_obstacles(prng.key(3, "cpu"), s, n, u,
                                           device="cpu")
    assert pobs.shape == real.shape == (s, 2, n)
    assert pobs.dtype == real.dtype == torch.float64
    assert pobs.device.type == real.device.type == "cpu"
    p, r = pobs.numpy(), real.numpy()
    assert (p[:, 0] >= 0).all() and (p[:, 0] <= 9).all()
    assert (p[:, 1] >= -2).all() and (p[:, 1] <= 2).all()
    assert (r[:, 0] >= 1).all() and (r[:, 0] <= 9).all()
    assert (r[:, 1] >= -3).all() and (r[:, 1] <= 3).all()
    # noise bounded by the uncertainty, except where clamped
    inner = (r[:, 0] > 1) & (r[:, 0] < 9)
    assert (np.abs(r[:, 0] - p[:, 0])[inner] <= u + 1e-12).all()
    assert (np.abs(r[:, 1] - p[:, 1]) <= u + 1e-12).all()
    assert (r[:, 0] == 1.0).any()          # the clamp binds at x = 1
    # both coordinates spread over their ranges
    assert p[:, 0].min() < 1.0 and p[:, 0].max() > 8.0
    again = campaign.sample_obstacles(prng.key(3, "cpu"), s, n, u,
                                      device="cpu")
    other = campaign.sample_obstacles(prng.key(4, "cpu"), s, n, u,
                                      device="cpu")
    assert torch.equal(again[0], pobs) and torch.equal(again[1], real)
    assert not torch.equal(other[0], pobs)
    f32 = campaign.sample_obstacles(prng.key(3, "cpu"), 2, n,
                                    dtype=torch.float32, device="cpu")
    assert f32[0].dtype == f32[1].dtype == torch.float32


def test_committed_fields_are_jax_shaped():
    """The committed JAX fields have the runner's and the golden's shapes,
    types and ranges, and the port draws the key-0 ones from the JAX
    runner's own raw key."""
    with np.load(FIELDS) as f:
        fields = dict(f)
    for key, s, dtype in (("key0", 1024, np.float32),
                          ("key1234", 32, np.float64)):
        p, r = fields[f"{key}.pobs"], fields[f"{key}.pobs_real"]
        assert p.shape == r.shape == (s, 2, 20)
        assert p.dtype == r.dtype == dtype
        assert (r[:, 0] >= 1).all() and (r[:, 0] <= 9).all()
        assert (np.abs(r[:, 1] - p[:, 1]) <= 0.6 + 1e-6).all()
    raw = np.asarray(jax.random.split(jax.random.PRNGKey(0))[0])
    p, r = campaign.sample_obstacles(raw, 1024, 20, 0.6, torch.float32,
                                     "cpu")
    assert p.dtype == torch.float32
    np.testing.assert_array_equal(r.numpy(), fields["key0.pobs_real"])


# ------------------------- the planner's scenario axis -------------------- #

@pytest.mark.parametrize("agents", [2, 4])
def test_batched_planner_matches_per_field_and_jax_vmap(agents):
    """3 fields rolled at once equal 3 per-field rollouts (1e-12) and JAX
    vmap(generate) (1e-12); the four-agent planner ramps its forces."""
    if agents == 2:
        cfg = refplan.two_agent_config(loop_size=800)
        jcfg = jrefplan.two_agent_config(loop_size=800)
    else:
        cfg = refplan.four_agent_config(loop_size=800)
        jcfg = jrefplan.four_agent_config(loop_size=800)
    rng = np.random.default_rng(12)
    lanes_y = np.arange(agents) - (agents - 1) / 2
    p_start = np.stack([np.zeros(agents), lanes_y], 1).reshape(-1)
    pobs = np.stack([rng.uniform(1.0, 4.0, (3, 20)),
                     rng.uniform(-1.5, 1.5, (3, 20))], 1)
    p_t = torch.tensor(p_start)
    got = refplan.generate(cfg, p_t, torch.tensor(pobs), device="cpu")
    assert got.pr.shape == got.prd.shape == (3, 2 * agents, 20)
    assert torch.equal(p_t, torch.tensor(p_start))      # not written to
    for s in range(3):
        one = refplan.generate(cfg, p_t, torch.tensor(pobs[s]), device="cpu")
        np.testing.assert_allclose(got.pr[s].numpy(), one.pr.numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.prd[s].numpy(), one.prd.numpy(),
                                   rtol=0, atol=1e-12)
    want = jax.jit(jax.vmap(lambda o, p: jrefplan.generate(jcfg, p, o),
                            in_axes=(0, None)))(jnp.asarray(pobs),
                                                jnp.asarray(p_start))
    np.testing.assert_allclose(got.pr.numpy(), np.asarray(want.pr), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.prd.numpy(), np.asarray(want.prd),
                               rtol=0, atol=1e-12)


# ------------------------------- the campaign ------------------------------ #

def _jax_campaign(form, p_start, pobs, pobs_real):
    mpc_kw, _, warm = FORMS[form]
    qp_cfg = JQpConfig(**vars(run_campaign_ab.QP_CFG))
    ref_cfg = jrefplan.two_agent_config(loop_size=LOOP)
    res = jax.jit(lambda p, o, r: jcampaign._run_campaign_batch_core(
        JMpcConfig(**mpc_kw), qp_cfg, _camp(form), ref_cfg, p, o, r,
        jax.random.key(0), "xla", 256, warm_start_qp=warm))(
            jnp.asarray(p_start), jnp.asarray(pobs), jnp.asarray(pobs_real))
    return {k: np.asarray(getattr(res, k)) for k in OUTPUTS}


def build_fields():
    """The JAX package's fields of the A/B runner (key 0, x64 off) and of
    the template_campaign golden (key 1234, x64 on)."""
    out = {}
    with jax.enable_x64(False):
        k0 = jax.random.split(jax.random.key(0))[0]
        p, r = jcampaign.sample_obstacles(k0, 1024, 20, 0.6)
        out["key0.pobs"], out["key0.pobs_real"] = np.asarray(p), np.asarray(r)
    with jax.enable_x64(True):
        k1 = jax.random.split(jax.random.key(1234))[0]
        p, r = jcampaign.sample_obstacles(k1, 32, 20, 0.6)
        out["key1234.pobs"] = np.asarray(p)
        out["key1234.pobs_real"] = np.asarray(r)
    return out


def build_fixture():
    """The campaign fixture's inputs and the JAX package's outputs."""
    with jax.enable_x64(True):
        pobs, pobs_real = jcampaign.sample_obstacles(jax.random.key(7), 2,
                                                     20, 0.6)
        out = {"in.p_start": P_START, "in.pobs": np.asarray(pobs),
               "in.pobs_real": np.asarray(pobs_real)}
        for form in FORMS:
            for k, v in _jax_campaign(form, P_START, out["in.pobs"],
                                      out["in.pobs_real"]).items():
                out[f"{form}.{k}"] = v
    return out


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return dict(f)


@pytest.fixture(scope="module")
def lanes_ref(fx):
    """The fixture fields' references, planned once for every form (the
    core is `plan_lanes` then `run_domains`)."""
    return campaign.plan_lanes(refplan.two_agent_config(loop_size=LOOP),
                               torch.tensor(fx["in.p_start"]),
                               torch.tensor(fx["in.pobs"]), 2, torch.float64,
                               "cpu")


def _port_campaign(form, fx, backend, lanes_ref):
    mpc_kw, camp_kw, warm = FORMS[form]
    camp = campaign.CampaignConfig(n_agents=2, n_domains=N_DOMAINS,
                                   **camp_kw)
    return campaign.run_domains(
        MpcConfig(**mpc_kw), run_campaign_ab.QP_CFG, camp,
        torch.tensor(fx["in.p_start"]), *lanes_ref,
        torch.tensor(fx["in.pobs_real"]), None, backend, warm_start_qp=warm)


def _assert_matches(got, fx, form):
    shapes = {"success": (2, 2), "fail_distance": (2, 2),
              "min_clearance": (2, 2), "final_xy": (2, 2, 2),
              "qp_ok_frac": (2,), "traj": (2, N_DOMAINS, 2, 2)}
    scp = FORMS[form][0]["use_sqp"]
    for k in OUTPUTS:
        mine, want = getattr(got, k).numpy(), fx[f"{form}.{k}"]
        assert mine.shape == want.shape == shapes[k], k
        if k in ("success", "qp_ok_frac"):
            np.testing.assert_array_equal(mine, want, err_msg=k)
            continue
        others = np.arange(2) != BREAKDOWN if scp else slice(None)
        np.testing.assert_allclose(mine[others], want[others], rtol=0,
                                   atol=1e-9, err_msg=k)
        if k == "traj":
            np.testing.assert_allclose(mine[:, :N_STAND], want[:, :N_STAND],
                                       rtol=0, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(mine, want, rtol=0, atol=SCP_TOL,
                                   err_msg=k)
    assert got.success.dtype == torch.bool


@pytest.mark.parametrize("form", list(FORMS))
def test_campaign_xla_matches_jax_fixture(fx, lanes_ref, form):
    _assert_matches(_port_campaign(form, fx, "xla", lanes_ref), fx, form)


@pytest.mark.parametrize("form", ["cbf_sqp", "qp_only"])
def test_campaign_fused_matches_jax_fixture(fx, lanes_ref, form):
    _assert_matches(_port_campaign(form, fx, "fused", lanes_ref), fx, form)


def test_disturbance_draws_from_the_generator():
    """With disturbance > 0 the kicks come from the run's key (the JAX
    package's draws, held to its fixture in test_torch_disturbance.py): the
    same key gives the same run, another key another; without a key the
    core raises. (A torch.Generator drew them until the JAX package's
    streams were reproduced.)"""
    cfg = MpcConfig(use_sqp=False, **ELIDED)
    camp = campaign.CampaignConfig(n_agents=2, n_domains=2, disturbance=0.2)
    ref_cfg = refplan.two_agent_config(loop_size=400)
    p = torch.tensor(P_START)

    def run(seed):
        return campaign.run_campaign_batch(
            cfg, run_campaign_ab.QP_CFG, camp, ref_cfg, p,
            prng.key(seed, "cpu"), 1, device="cpu")

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a.traj, b.traj) and not torch.equal(a.traj, c.traj)
    assert a.traj.shape == (1, 2, 2, 2) and torch.isfinite(a.traj).all()
    pobs, real = campaign.sample_obstacles(prng.key(5, "cpu"), 1, 20,
                                           device="cpu")
    with pytest.raises(ValueError, match="key"):
        campaign._run_campaign_batch_core(cfg, run_campaign_ab.QP_CFG, camp,
                                          ref_cfg, p, pobs, real, None,
                                          "fused")


def test_runner_on_the_cpu(tmp_path):
    """The A/B runner at a tiny size on the CPU: both legs, its JSON, the
    timing keys, the fields' key; without a card and without device="cpu"
    it raises."""
    out = tmp_path / "ab.json"
    summ, res = run_campaign_ab.main(2, 2, seed=1, device="cpu",
                                     loop_size=200, out=out)
    assert out.is_file() and set(res) == {"qp_only", "cbf_sqp"}
    for leg in ("qp_only", "cbf_sqp"):
        assert summ["formulation"][leg] == "condensed+simplex+elided+fused"
        assert summ[leg]["nonfinite_lanes"] == 0
        assert summ[leg]["domains_per_s"] > 0
        assert summ[leg]["planner_s"] + summ[leg]["loop_s"] <= \
            summ[leg]["wall_s_steady"]
    assert summ["device"] == "cpu" and summ["dtype"] == "float32"
    # the fields are drawn as the JAX runner draws them, from key(seed)
    assert summ["fields"] == "campaign.sample_obstacles on split(jax key " \
        "1)[0]"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_campaign_ab.main(2, 2, seed=1, out=out)


@pytest.mark.slow
def test_fields_provenance():
    """The committed fields are the JAX package's, bitwise."""
    live = build_fields()
    with np.load(FIELDS) as f:
        fields = dict(f)
    assert set(live) == set(fields)
    for k, v in live.items():
        assert fields[k].dtype == v.dtype, k
        np.testing.assert_array_equal(fields[k], v, err_msg=k)


@pytest.mark.slow
def test_fixture_provenance(fx):
    """The committed campaign fixture is what the JAX package computes."""
    live = build_fixture()
    assert set(live) == set(fx)
    for k, v in live.items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(fx[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(fx[k], v, rtol=1e-12, atol=1e-12,
                                       err_msg=k)


if __name__ == "__main__":
    DATA.mkdir(exist_ok=True)
    np.savez_compressed(FIELDS, **build_fields())
    print(f"wrote {FIELDS}")
    np.savez_compressed(FIXTURE, **build_fixture())
    print(f"wrote {FIXTURE}")
