"""The whole NMPC cycle of srbx_torch against the JAX package's
`run_nmpc_batch`, in float64 on the CPU at B = 8.

The lanes-last branch (the port through the plain fused IPM) against JAX
`backend="fused", interpret=True, condensed=True, tile=8`, two live calls:
* the benchmark's inputs (bench.py) under its relaxed solver configuration;
* mixed lanes under the strict configuration: gait domains 0, 1, 3 and past
  the end of the reference, mixed contact masks, a neighbour circle
  (agent_circle_eps > 0, so the SCP QPs have mi = 52), a warm start x0_warm,
  and one lane whose foothold is NaN, which must fall back to holding
  position on both sides.
Tolerance 1e-9 on states, alpha_com, x and cbf_margin (the same iteration,
summed in another order); qp_converged and qp_iters must be equal.

The generic branch (the port with backend="pallas", through the plain
versions of kernels K3a and K3b) against JAX `backend="xla"` on the mixed
lanes:
* live: the uncondensed cycle (n 41, me 28, mi 92; SCP mi 112), strict, two
  SCP rounds;
* against the committed fixture `tests/data/torch_generic_cycle_jax.npz`,
  which holds the inputs and what the JAX package computes from them
  (`test_fixture_provenance`, slow, recomputes it live; `python
  tests/test_torch_mpc_batch.py` rewrites it): condensed (n 17, me 4),
  condensed and simplex-eliminated (n 13, me 0, solved with the inert row),
  use_sqp=False, the neighbour circle (SCP mi 116) and x0_warm.
Tolerance 1e-9 on states, alpha_com and cbf_margin; qp_converged and
qp_iters equal. x is not compared: with all four legs in stance the load
split between the legs does not enter the cost, and LAPACK's blocked
Cholesky and the column loop round it differently.
"""

from pathlib import Path

import pytest
import jax
import jax.numpy as jnp
import numpy as np
import torch

from srbx import mpc as jmpc
from srbx import mpc_batch as jmpc_batch
from srbx.config import MpcConfig, QpConfig
from srbx_torch import convert, mpc, mpc_batch, refplan
from srbx_torch.ocp import default_footholds

torch.set_num_threads(1)

B = 8
CFG = MpcConfig(use_sqp=True, sqp_iters=2, elide_box_rows=True,
                elide_simplex=True)
RELAXED = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6, reg_dual=1e-6,
                   max_iters=12, kkt_refine_iters=0)
STRICT = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6, reg_dual=1e-6,
                  max_iters=25)
P_START = np.array([0.0, 0.5, 0.0, -0.5])
POBS = np.stack([np.random.default_rng(0).uniform(2.0, 8.0, 20),
                 np.random.default_rng(1).uniform(-2.0, 2.0, 20)])


def _reference():
    ref = refplan.generate(refplan.two_agent_config(loop_size=4_000),
                           torch.tensor(P_START), torch.tensor(POBS),
                           device="cpu")
    return ref.pr[0:2].numpy(), ref.prd[0:2].numpy()


def _bench_inputs():
    pr, prd = _reference()
    agent0 = P_START[:2]
    q = agent0 + np.linspace(0, 0.01, B)[:, None]
    alpha = np.stack([q[:, 0], np.zeros(B), q[:, 1], np.zeros(B)], 1)
    toe = default_footholds(torch.tensor(agent0)).numpy()
    return dict(
        carry=(np.zeros(B, np.int32), alpha), q_xy=q, dq_xy=np.zeros((B, 2)),
        toe_xy=np.tile(toe, (B, 1, 1)),
        contact_ind=np.tile([0.0, 1.0, 1.0, 0.0], (B, 1)),
        pr_agent=np.tile(pr, (B, 1, 1)), prd_agent=np.tile(prd, (B, 1, 1)),
        agent_initial=np.tile(agent0, (B, 1)),
        pobs_real=np.tile(POBS, (B, 1, 1)),
    )


NAN_LANE = 6


def _mixed_inputs():
    inp = _bench_inputs()
    rng = np.random.default_rng(5)
    # the reference has 100 knots: domain 30 starts past its end
    dom = np.array([0, 1, 3, 3, 30, 2, 3, 4], np.int32)
    q = inp["q_xy"] + rng.normal(size=(B, 2)) * 0.05
    dq = rng.normal(size=(B, 2)) * 0.05
    alpha = np.stack([q[:, 0], dq[:, 0], q[:, 1], dq[:, 1]], 1)
    toe = inp["toe_xy"] + rng.normal(size=(B, 2, 4)) * 0.02
    toe[NAN_LANE, 0, 1] = np.nan
    contacts = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 0.0, 1.0],
                         [0.0, 1.0, 1.0, 0.0], [0.0, 1.0, 1.0, 1.0]])
    ci = contacts[np.arange(B) % 4]
    x0 = np.stack([q[:, 0], dq[:, 0], q[:, 1], dq[:, 1]], 1)
    hold = mpc.hold_position_x(CFG, torch.tensor(x0), torch.tensor(ci))
    inp.update(
        carry=(dom, alpha), q_xy=q, dq_xy=dq, toe_xy=toe, contact_ind=ci,
        state_other=np.concatenate(
            [q + np.array([0.3, -1.2]), np.zeros((B, 2))], 1),
        agent_circle_eps=0.5,
        x0_warm=hold.numpy() + rng.normal(size=(B, CFG.num_dec)) * 0.01,
    )
    return inp


def _jax_cycle(qp_cfg, inp):
    names = [k for k in inp if k not in ("carry", "agent_circle_eps")]
    eps = inp.get("agent_circle_eps", 0.0)

    def fn(dom, alpha, *arrays):
        kw = dict(zip(names, arrays))
        return jmpc_batch.run_nmpc_batch(
            CFG, qp_cfg, jmpc.MpcCarry(dom, alpha), backend="fused", tile=8,
            interpret=True, condensed=True, agent_circle_eps=eps, **kw)

    arrays = [inp["carry"][0], inp["carry"][1]] + [inp[k] for k in names]
    out = jax.jit(fn)(*[jnp.asarray(a) for a in arrays])
    return jax.tree_util.tree_map(np.asarray, out)


def _port_cycle(qp_cfg, inp):
    t = convert.from_numpy(inp, device="cpu")
    carry = mpc.MpcCarry(*t.pop("carry"))
    eps = inp.get("agent_circle_eps", 0.0)
    t.pop("agent_circle_eps", None)
    return convert.to_numpy(mpc_batch.run_nmpc_batch(
        CFG, qp_cfg, carry, backend="fused", condensed=True,
        agent_circle_eps=eps, **t))


def _assert_cycles_agree(got, want):
    for name in ("states", "alpha_com", "x", "cbf_margin", "inputs"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got.qp_converged, want.qp_converged)
    assert int(got.qp_iters) == int(want.qp_iters)
    np.testing.assert_array_equal(got.carry.gait_domain,
                                  want.carry.gait_domain)
    np.testing.assert_allclose(got.carry.alpha_buffer,
                               want.carry.alpha_buffer, rtol=0, atol=1e-9)


def test_cycle_matches_jax_at_bench_inputs():
    inp = _bench_inputs()
    want = _jax_cycle(RELAXED, inp)
    got = _port_cycle(RELAXED, inp)
    assert got.states.shape == (B, CFG.horizon, 4)
    assert got.alpha_com.shape == (B, 4, 5)
    assert got.qp_converged.all()
    _assert_cycles_agree(got, want)


def test_cycle_matches_jax_on_mixed_lanes():
    inp = _mixed_inputs()
    want = _jax_cycle(STRICT, inp)
    got = _port_cycle(STRICT, inp)
    _assert_cycles_agree(got, want)
    # the NaN-foothold lane holds position, in both packages
    x0 = np.stack([inp["q_xy"][:, 0], inp["dq_xy"][:, 0],
                   inp["q_xy"][:, 1], inp["dq_xy"][:, 1]], 1)
    hold = mpc.hold_position_x(CFG, torch.tensor(x0),
                               torch.tensor(inp["contact_ind"])).numpy()
    np.testing.assert_allclose(got.x[NAN_LANE], hold[NAN_LANE], atol=0)
    np.testing.assert_allclose(want.x[NAN_LANE], hold[NAN_LANE], atol=0)
    assert not got.qp_converged[NAN_LANE]
    others = np.arange(B) != NAN_LANE
    assert np.isfinite(got.x).all() and got.qp_converged[others].all()


# ----------------------------- generic branch ----------------------------- #

FIXTURE = Path(__file__).resolve().parent / "data" / \
    "torch_generic_cycle_jax.npz"
SCP = dict(use_sqp=True, sqp_iters=2)
# form -> (MpcConfig, condensed, solver, extra inputs)
GENERIC = {
    "uncondensed": (MpcConfig(**SCP), False, STRICT, ()),
    "condensed": (MpcConfig(**SCP, elide_box_rows=True), True, STRICT, ()),
    "condensed_elided": (CFG, True, STRICT, ()),
    "no_sqp": (MpcConfig(use_sqp=False), False, RELAXED, ()),
    "neighbour": (MpcConfig(**SCP), False, STRICT,
                  ("state_other", "agent_circle_eps")),
    "x0_warm": (MpcConfig(**SCP, elide_box_rows=True), True, STRICT,
                ("x0_warm",)),
}
OUTPUTS = ("states", "alpha_com", "cbf_margin", "qp_converged", "qp_iters")


def _generic_inputs(form):
    extra = GENERIC[form][3]
    inp = _mixed_inputs()
    for k in ("state_other", "agent_circle_eps", "x0_warm"):
        if k not in extra:
            inp.pop(k)
    if "x0_warm" in extra:
        cfg = GENERIC[form][0]
        x0 = np.stack([inp["q_xy"][:, 0], inp["dq_xy"][:, 0],
                       inp["q_xy"][:, 1], inp["dq_xy"][:, 1]], 1)
        inp["x0_warm"] = mpc.hold_position_x(
            cfg, torch.tensor(x0), torch.tensor(inp["contact_ind"])).numpy() \
            + np.random.default_rng(8).normal(size=(B, cfg.num_dec)) * 0.01
    return inp


def _flat_inputs(inp):
    out = {k: np.asarray(v) for k, v in inp.items() if k != "carry"}
    out["gait_domain"], out["alpha_buffer"] = inp["carry"]
    return out


def _unflat_inputs(flat):
    inp = {k: v for k, v in flat.items()
           if k not in ("gait_domain", "alpha_buffer")}
    inp["carry"] = (flat["gait_domain"], flat["alpha_buffer"])
    if "agent_circle_eps" in inp:
        inp["agent_circle_eps"] = float(inp["agent_circle_eps"])
    return inp


def _jax_generic(form, inp):
    cfg, condensed, qp_cfg, _ = GENERIC[form]
    names = [k for k in inp if k not in ("carry", "agent_circle_eps")]
    eps = inp.get("agent_circle_eps", 0.0)

    def fn(dom, alpha, *arrays):
        return jmpc_batch.run_nmpc_batch(
            cfg, qp_cfg, jmpc.MpcCarry(dom, alpha), backend="xla",
            condensed=condensed, agent_circle_eps=eps,
            **dict(zip(names, arrays)))

    arrays = [inp["carry"][0], inp["carry"][1]] + [inp[k] for k in names]
    out = jax.jit(fn)(*[jnp.asarray(a) for a in arrays])
    return {k: np.asarray(getattr(out, k)) for k in OUTPUTS}


def _port_generic(form, inp, backend="pallas"):
    cfg, condensed, qp_cfg, _ = GENERIC[form]
    t = convert.from_numpy(inp, device="cpu")
    carry = mpc.MpcCarry(*t.pop("carry"))
    eps = float(t.pop("agent_circle_eps", 0.0))
    return mpc_batch.run_nmpc_batch(cfg, qp_cfg, carry, backend=backend,
                                    condensed=condensed,
                                    agent_circle_eps=eps, **t)


def _assert_generic_agrees(got, want, form):
    for name in ("states", "alpha_com", "cbf_margin"):
        np.testing.assert_allclose(getattr(got, name).numpy(), want[name],
                                   rtol=0, atol=1e-9,
                                   err_msg=f"{form}: {name}")
    np.testing.assert_array_equal(got.qp_converged.numpy(),
                                  want["qp_converged"])
    assert int(got.qp_iters) == int(want["qp_iters"])


def build_fixture():
    """Inputs of every fixture form and the JAX package's outputs."""
    out = {}
    for form in GENERIC:
        if form == "uncondensed":          # the live test's form
            continue
        inp = _generic_inputs(form)
        for k, v in _flat_inputs(inp).items():
            out[f"{form}.in.{k}"] = v
        for k, v in _jax_generic(form, inp).items():
            out[f"{form}.out.{k}"] = v
    return out


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return dict(f)


def _fixture_part(fx, form, part):
    pre = f"{form}.{part}."
    return {k[len(pre):]: v for k, v in fx.items() if k.startswith(pre)}


def test_generic_uncondensed_cycle_matches_jax():
    """The reference-shape cycle, live: JAX backend="xla" against the
    port's "pallas"; the port's "xla" agrees too."""
    inp = _generic_inputs("uncondensed")
    want = _jax_generic("uncondensed", inp)
    got = _port_generic("uncondensed", inp)
    assert got.x.shape == (B, 41)
    _assert_generic_agrees(got, want, "uncondensed")
    _assert_generic_agrees(_port_generic("uncondensed", inp, "xla"), want,
                           "uncondensed, port xla")
    # the NaN-foothold lane holds position; the others converge
    assert not got.qp_converged[NAN_LANE]
    others = np.arange(B) != NAN_LANE
    assert got.qp_converged[others].all() and torch.isfinite(got.x).all()


@pytest.mark.parametrize("form", [f for f in GENERIC if f != "uncondensed"])
def test_generic_cycle_matches_jax_fixture(fx, form):
    inp = _unflat_inputs(_fixture_part(fx, form, "in"))
    got = _port_generic(form, inp)
    _assert_generic_agrees(got, _fixture_part(fx, form, "out"), form)
    assert torch.isfinite(got.states).all()


@pytest.mark.slow
def test_fixture_provenance(fx):
    """The committed fixture is what the JAX package computes from the
    seeds' inputs."""
    live = build_fixture()
    assert set(live) == set(fx)
    for k, v in live.items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(fx[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(fx[k], v, rtol=1e-12, atol=1e-12,
                                       err_msg=k)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(f"wrote {FIXTURE}")
