"""The plain PyTorch fused IPM (the CPU path of srbx_torch's kernel K1a)
against the JAX package's Pallas kernel run in interpret mode, in float64 on
the CPU, on the NMPC cycle's own QPs (n = 13).

Each case is one interpret-mode call (B = 16, tile 8): the cold first QP
(mi 28) under the relaxed configuration and a warm SCP QP (mi 48) under the
strict one. Tolerance 1e-9 on
x, z and s: the same iteration, summed in another order. The converged
flags and the maximum iteration count must be equal; per-lane iteration
counts are not compared, because the TPU kernel counts per tile.

With all four legs in stance (every lane before locomotion starts) the
condensed P is singular: how the stance legs share the load does not enter
the cost, and only the 1e-6 regularisation and the barrier pick a split.
Over the strict configuration's longer iteration that split picks up
1e-10 to 1e-8 of rounding (measured; 1e-14 where the minimiser is unique),
so the strict case is built from lanes in locomotion (two or three legs in
stance), whose QP has a unique minimiser.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbx.config import MpcConfig, QpConfig
from srbx.ops import qp_fused as jqp_fused
from srbx_torch import mpc, mpc_batch, refplan, sqp
from srbx_torch.ocp import contract, default_footholds
from srbx_torch.ops import qp_fused

torch.set_num_threads(1)

B = 16
CFG = MpcConfig(use_sqp=True, sqp_iters=2, elide_box_rows=True,
                elide_simplex=True)
CONFIGS = {
    "relaxed": QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                        reg_dual=1e-6, max_iters=12, kkt_refine_iters=0),
    "strict": QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                       reg_dual=1e-6, max_iters=25),
}


ALL_STANCE = [1.0, 1.0, 1.0, 1.0]
LOCOMOTION = [[1.0, 0.0, 0.0, 1.0], [0.0, 1.0, 1.0, 0.0],
              [0.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 0.0]]


def _nmpc_qps(seed, domains, patterns):
    """The cycle's cold QP (mi 28) and an SCP QP with one CBF circle
    (mi 48), warm-started from the cold solution."""
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    ref = refplan.generate(refplan.two_agent_config(loop_size=400),
                           torch.tensor([0.0, 0.5, 0.0, -0.5], dtype=f64),
                           torch.tensor([[3.0] * 20, [0.3] * 20], dtype=f64),
                           device="cpu")
    q = torch.tensor(rng.uniform(-0.1, 0.1, (B, 2)))
    dq = torch.tensor(rng.normal(size=(B, 2)) * 0.02)
    dom = torch.tensor(rng.integers(*domains, B), dtype=torch.int32)
    alpha = torch.stack([q[:, 0], dq[:, 0], q[:, 1], dq[:, 1]], 1)
    ci = torch.tensor(patterns, dtype=f64)[torch.arange(B) % len(patterns)]
    toe = default_footholds(q) + torch.tensor(
        rng.normal(size=(B, 2, 4)) * 0.02)
    carry = mpc.MpcCarry(dom, alpha)
    ci_eff = mpc_batch.effective_contacts(carry, ci)
    qp = mpc_batch.condensed_qp(
        CFG, carry, q, dq, toe, ci_eff, ref.pr[0:2].repeat(B, 1, 1),
        ref.prd[0:2].repeat(B, 1, 1), q)
    x_ll = qp_fused.solve_lanes_last_plain(qp.P, qp.c, qp.G, qp.h,
                                           CONFIGS["strict"])[0]
    x = mpc_batch.expand_ll(qp, x_ll)
    circles = torch.tensor(rng.uniform(1.0, 1.4, (B, 1, 2)))
    vel_g, vel_h = sqp._vel_rows(CFG, f64)
    cbf_g, cbf_h = sqp._cbf_rows(CFG, x, circles, torch.ones(B, 1, dtype=f64),
                                 f64)
    g48, h48 = mpc_batch.project_rows(
        qp, torch.cat([vel_g.expand(B, -1, -1), cbf_g], 1),
        torch.cat([vel_h.expand(B, -1), cbf_h], 1))
    x0 = contract(CFG, x, ci_eff).T.contiguous()
    return {"cold_mi28": (qp.P, qp.c, qp.G, qp.h, None),
            "warm_mi48": (qp.P, qp.c, g48, h48, x0)}


@pytest.fixture(scope="module")
def nmpc_qps():
    return {
        # domains 0-5: lanes before locomotion (all legs in stance) and after
        "mixed": _nmpc_qps(21, (0, 6), [ALL_STANCE] + LOCOMOTION[:3]),
        "locomotion": _nmpc_qps(22, (2, 6), LOCOMOTION),
    }


def _jax_solve(cfg, P, c, G, h, x0):
    if x0 is None:
        fn = lambda P, c, G, h: jqp_fused.solve_lanes_last(  # noqa: E731
            P, c, G, h, cfg, tile=8, interpret=True)
        args = (P, c, G, h)
    else:
        fn = lambda P, c, G, h, x0: jqp_fused.solve_lanes_last(  # noqa: E731
            P, c, G, h, cfg, tile=8, interpret=True, x0=x0)
        args = (P, c, G, h, x0)
    out = jax.jit(fn)(*[jnp.asarray(a.numpy()) for a in args])
    return [np.asarray(o) for o in out]


# (warm mi 48 under the relaxed configuration runs in the whole-cycle test
# at the benchmark's inputs, tests/test_torch_mpc_batch.py)
@pytest.mark.parametrize("lanes,case,config", [
    ("mixed", "cold_mi28", "relaxed"), ("locomotion", "warm_mi48", "strict"),
])
def test_plain_ipm_matches_pallas_interpret(nmpc_qps, lanes, case, config):
    P, c, G, h, x0 = nmpc_qps[lanes][case]
    assert G.shape[:2] == (28 if case == "cold_mi28" else 48, 13)
    cfg = CONFIGS[config]
    launches = qp_fused.solve_lanes_last.launches
    x, z, s, stat = qp_fused.solve_lanes_last(P, c, G, h, cfg, x0=x0)
    # a CPU call runs the plain version and launches nothing
    assert qp_fused.solve_lanes_last.launches == launches == 0
    jx, jz, js, jstat = _jax_solve(cfg, P, c, G, h, x0)
    for got, want in ((x, jx), (z, jz), (s, js)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(stat[2].numpy(), jstat[2])
    assert stat[3].max().item() == jstat[3].max()
    assert stat[2].sum().item() > B // 2          # the cases do converge


# ---- the wrapper's checks (no JAX) ---- #

def _ll_qp(bsz, mi, dtype=torch.float64, seed=5):
    """Random strictly feasible lanes-last QPs (n 13) made with numpy."""
    rng = np.random.default_rng(seed)
    n = qp_fused.N_COND
    p = np.zeros((n, n, bsz))
    p[np.arange(n), np.arange(n)] = rng.uniform(0.5, 2.0, (n, bsz))
    g = rng.normal(size=(mi, n, bsz))
    x_feas = rng.normal(size=(n, bsz))
    h = np.einsum("mnb,nb->mb", g, x_feas) + rng.uniform(0.1, 1.0, (mi, bsz))
    return [torch.tensor(a, dtype=dtype) for a in
            (p, rng.normal(size=(n, bsz)), g, h)]


@pytest.mark.parametrize("bad,error,match", [
    (lambda o: (o[0], o[1], torch.zeros(65, 13, 3, dtype=o[1].dtype),
                torch.zeros(65, 3, dtype=o[1].dtype)), ValueError, "mi"),
    (lambda o: tuple(t.half() for t in o), TypeError, "dtype"),
    (lambda o: (o[0].float(),) + tuple(o[1:]), TypeError, "P is"),
    (lambda o: (o[0], o[1], o[2].transpose(1, 2).contiguous()
                .transpose(1, 2), o[3]), ValueError, "contiguous"),
    (lambda o: (o[0][:12, :12], o[1][:12], o[2][:, :12], o[3]), ValueError,
     "n=13"),
    (lambda o: tuple(t.to("meta") for t in o), ValueError, "device"),
    (lambda o: (o[0], o[1][:, 0], o[2], o[3]), ValueError, "c must be"),
    (lambda o: (o[0], o[1], o[2][:, :, 0], o[3]), ValueError, "G must be"),
    (lambda o: (o[0][..., :2], o[1], o[2], o[3]), ValueError, "P must be"),
    (lambda o: (o[0], o[1], o[2], o[3][:3]), ValueError, "h must be"),
    (lambda o: (*o, o[1][:, :2].contiguous()), ValueError, "x0 must be"),
], ids=["mi65", "dtype", "mixed", "strided", "n", "device", "c", "G", "P",
        "h", "x0"])
def test_lanes_last_wrapper_rejects_what_the_kernel_does_not_take(
        bad, error, match):
    ops = bad(_ll_qp(3, 4))
    with pytest.raises(error, match=match):
        qp_fused.solve_lanes_last(*ops[:4], CONFIGS["strict"], *ops[4:])
    assert qp_fused.solve_lanes_last.launches == 0
