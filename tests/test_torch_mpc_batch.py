"""The whole NMPC cycle of srbx_torch (on the CPU, through the plain fused
IPM) against the JAX package's `run_nmpc_batch(backend="fused",
interpret=True, condensed=True, tile=8)`, in float64 at B = 8.

Two JAX cycle calls, one per test:
* the benchmark's inputs (bench.py) under its relaxed solver configuration;
* mixed lanes under the strict configuration: gait domains 0, 1, 3 and past
  the end of the reference, mixed contact masks, a neighbour circle
  (agent_circle_eps > 0, so the SCP QPs have mi = 52), a warm start x0_warm,
  and one lane whose foothold is NaN, which must fall back to holding
  position on both sides.

Tolerance 1e-9 on states, alpha_com, x and cbf_margin (the same iteration,
summed in another order); qp_converged and qp_iters must be equal.
"""

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
        CFG, qp_cfg, carry, condensed=True, agent_circle_eps=eps, **t))


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
