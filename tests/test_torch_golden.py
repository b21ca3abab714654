"""The `nmpc_cycle` and `template_campaign` goldens of
`docs/golden/golden.json`, reproduced by srbx_torch alone (no JAX import).

The golden is the JAX package's batched NMPC cycle on the CPU
(`__graft_entry__.entry()`): float32, the condensed and simplex-eliminated
configuration with the box rows elided and two SCP rounds, the relaxed
solver configuration, B = 256 lanes of the APF reference of two agents
(`loop_size` 4000) among 20 random obstacles. Off the TPU that cycle takes
the generic branch of `run_nmpc_batch` with backend "xla". The port runs it
through its generic branch with backend "pallas" (the plain versions of
kernels K3a and K3b on the CPU) and "xla" (torch.linalg), and its first 4
lanes must meet the golden's own bound, 1e-4 on states and alpha_com.

The template_campaign golden is the JAX package's `run_campaign_batch` with
backend "xla" in float64 on the CPU: 32 scenarios of key 1234 (the port
draws their fields from the same key: `campaign.sample_obstacles` on
`split(key(1234))[0]`), 2 agents, 8
domains, the reference-shape `MpcConfig(use_sqp=True, sqp_iters=2)`,
`QpConfig()` and `loop_size` 4000. The port runs it with backend "xla"
and "pallas" (slow: 10 and 30 s on the CPU; the chip smoke runs "pallas"
through K3a and K3b). Its bounds are the golden's own (success exact,
min_clearance and final_xy to 1e-6, qp_ok_frac to 1e-9), but for final_xy
on the lanes where some QP of the run does not converge: there the SCP
QP's IPM runs to max_iters on the same lanes in both packages (9 of 64 in
domain 2) and its last iterate is decided by rounding (LAPACK's Cholesky
against XLA's; fed the same inputs, the two packages' cycles agree to 1e-13
on every other lane). Those lanes are held to the JAX package's own bound
for this effect of the SCP, 3e-2
(tests/test_campaign.py::test_batch_campaign_matches_per_agent); the port
measured up to 2.2e-2 there.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from srbx_torch import mpc, mpc_batch, refplan
from srbx_torch.config import MpcConfig, QpConfig
from srbx_torch.eval import campaign
from srbx_torch.ocp import default_footholds
from srbx_torch.ops import qp_batch
from srbx_torch.utils import prng

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent.parent / "docs" / "golden" / \
    "golden.json"
B = 256
CFG = MpcConfig(use_sqp=True, sqp_iters=2, condensed=True,
                elide_box_rows=True, elide_simplex=True)
QP_CFG = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6, reg_dual=1e-6,
                  max_iters=12)


def make_entry_args():
    """The golden's inputs, as `__graft_entry__.entry()` makes them."""
    f32 = torch.float32
    p_start = torch.tensor([0.0, 0.5, 0.0, -0.5], dtype=f32)
    pobs = torch.tensor(np.stack([
        np.random.default_rng(0).uniform(2.0, 8.0, 20),
        np.random.default_rng(1).uniform(-2.0, 2.0, 20)]), dtype=f32)
    ref = refplan.generate(refplan.two_agent_config(loop_size=4_000),
                           p_start, pobs, dtype=f32, device="cpu")
    agent0 = p_start[:2]
    q = agent0 + torch.linspace(0, 0.01, B, dtype=f32)[:, None]
    zeros = torch.zeros(B, dtype=f32)
    carry = mpc.MpcCarry(torch.zeros(B, dtype=torch.int32),
                         torch.stack([q[:, 0], zeros, q[:, 1], zeros], 1))
    return (carry, q, torch.zeros(B, 2, dtype=f32),
            default_footholds(agent0).expand(B, -1, -1),
            torch.tensor([0.0, 1.0, 1.0, 0.0], dtype=f32).expand(B, -1),
            ref.pr[0:2].expand(B, -1, -1), ref.prd[0:2].expand(B, -1, -1),
            agent0.expand(B, -1), pobs.expand(B, -1, -1))


@pytest.fixture(scope="module")
def entry_args():
    return make_entry_args()


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_golden_nmpc_cycle(entry_args, backend):
    with open(GOLDEN) as f:
        gold = json.load(f)["nmpc_cycle"]
    out = mpc_batch.run_nmpc_batch(CFG, QP_CFG, *entry_args,
                                   backend=backend)
    assert out.states.dtype == torch.float32
    assert out.states.shape == (B, CFG.horizon, 4)
    assert torch.isfinite(out.alpha_com).all()
    np.testing.assert_allclose(out.states[:4].double().numpy(),
                               np.asarray(gold["states"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.alpha_com[:4].double().numpy(),
                               np.asarray(gold["alpha_com"]), rtol=0,
                               atol=1e-4)


SCP_TOL = 3e-2


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_golden_template_campaign(backend, monkeypatch):
    with open(GOLDEN) as f:
        gold = json.load(f)["template_campaign"]
    unconverged = torch.zeros(64, dtype=torch.bool)
    solve = qp_batch.solve

    def watched(*args, **kw):                # every QP of the run
        sol = solve(*args, **kw)
        unconverged.logical_or_(~sol.converged)
        return sol

    monkeypatch.setattr(qp_batch, "solve", watched)
    pobs, pobs_real = campaign.sample_obstacles(
        prng.split(prng.key(1234, "cpu"))[0], 32, 20, 0.6, torch.float64,
        "cpu")
    res = campaign._run_campaign_batch_core(
        MpcConfig(use_sqp=True, sqp_iters=2), QpConfig(),
        campaign.CampaignConfig(n_agents=2, n_domains=8),
        refplan.two_agent_config(loop_size=4_000),
        torch.tensor([0.0, 0.5, 0.0, -0.5], dtype=torch.float64), pobs,
        pobs_real, None, backend)
    np.testing.assert_array_equal(res.success.int().numpy(),
                                  np.asarray(gold["success"]))
    np.testing.assert_allclose(res.min_clearance.numpy(),
                               np.asarray(gold["min_clearance"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res.qp_ok_frac.numpy(),
                               np.asarray(gold["qp_ok_frac"]), rtol=0,
                               atol=1e-9)
    final, want = res.final_xy.numpy(), np.asarray(gold["final_xy"])
    ok = ~unconverged.reshape(32, 2).numpy()
    assert 0 < (~ok).sum() < 20
    np.testing.assert_allclose(final[ok], want[ok], rtol=0, atol=1e-6)
    np.testing.assert_allclose(final, want, rtol=0, atol=SCP_TOL)
