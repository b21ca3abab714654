"""srbx_torch's assembly, rows, helpers and reference planner against the
JAX package, function by function, in float64 on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Every JAX
call goes through jax.jit with its inputs as arguments (never as closure
constants). Tolerance 1e-12: the same arithmetic, summed in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbx import mpc as jmpc
from srbx import ocp as jocp
from srbx import refplan as jrefplan
from srbx import sqp as jsqp
from srbx.config import MpcConfig
from srbx.models import lip as jlip
from srbx.ops import bezier as jbezier
from srbx_torch import mpc, ocp, refplan, sqp
from srbx_torch.models import lip
from srbx_torch.ops import bezier

torch.set_num_threads(1)

TOL = 1e-12
CFG = MpcConfig(use_sqp=True, sqp_iters=2, elide_box_rows=True,
                elide_simplex=True)
# all-stance, the two trot pairs, and a walk pattern whose first stance leg
# is not leg 0
CONTACTS = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 0.0, 1.0],
                     [0.0, 1.0, 1.0, 0.0], [0.0, 1.0, 1.0, 1.0]])
B = CONTACTS.shape[0]
RNG = np.random.default_rng(11)
X0 = RNG.normal(size=(B, 4)) * 0.2
REF = RNG.normal(size=(B, 4, CFG.horizon))
FOOT = RNG.normal(size=(B, 2, 4)) * 0.2
XFULL = RNG.normal(size=(B, CFG.num_dec))


def jcall(fn, *arrays):
    out = jax.jit(fn)(*[jnp.asarray(a) for a in arrays])
    return jax.tree_util.tree_map(np.asarray, out)


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("order", [3, 5])
def test_lip_discrete(order):
    ad, bd = lip.discrete(CFG.lip, order)
    jad, jbd = jlip.discrete(CFG.lip, order)
    close(ad, jad)
    close(bd, jbd)


def test_reference_window_clamps_past_the_end():
    t_len = 20
    rng = np.random.default_rng(1)
    pr = rng.normal(size=(5, 2, t_len))
    prd = rng.normal(size=(5, 2, t_len))
    # domain 7 starts at column 28 > T - N = 16: clamped, as dynamic_slice
    dom = np.array([0, 1, 3, 4, 7], np.int32)
    want = jcall(jax.vmap(lambda p, v, d: jocp.reference_window(
        p, v, 0, d, CFG.horizon)), pr, prd, dom)
    got = ocp.reference_window(t(pr), t(prd), 0, t(dom), CFG.horizon)
    close(got, want)
    for lane in (-2, -1):            # both read the table's last N columns
        close(got[lane, 0], pr[lane, 0, -CFG.horizon:])


def test_assemble_and_diagonal_cost():
    want = jcall(jax.vmap(lambda x, r, f, c: jocp.assemble(CFG, x, r, f, c)),
                 X0, REF, FOOT, CONTACTS)
    got = ocp.assemble(CFG, t(X0), t(REF), t(FOOT), t(CONTACTS))
    for name, a, b in zip(ocp.OcpData._fields, got, want):
        assert a.shape == b.shape, name
        close(a, b)
    # the lanes-last cycle reads only diag(P): P must be diagonal
    off = got.P - torch.diag_embed(torch.diagonal(got.P, dim1=-2, dim2=-1))
    assert float(off.abs().max()) == 0.0
    p_diag, c = ocp.cost(CFG, t(REF), t(CONTACTS))
    close(p_diag, np.diagonal(want[0], axis1=-2, axis2=-1))
    close(c, want[1])


@pytest.mark.parametrize("elide_simplex", [False, True])
def test_expansion(elide_simplex):
    cfg = MpcConfig(elide_box_rows=True, elide_simplex=elide_simplex)
    want = jcall(jax.vmap(lambda x, f, c: jocp.expansion(cfg, x, f, c)),
                 X0, FOOT, CONTACTS)
    got = ocp.expansion(cfg, t(X0), t(FOOT), t(CONTACTS))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        close(a, b)


def test_contract_expand_unpack():
    want = jcall(jax.vmap(lambda x, c: jocp.contract(CFG, x, c)),
                 XFULL, CONTACTS)
    got = ocp.contract(CFG, t(XFULL), t(CONTACTS))
    close(got, want)
    e, e0 = ocp.expansion(CFG, t(X0), t(FOOT), t(CONTACTS))
    close(ocp.expand(e, e0, got),
          jcall(jax.vmap(jocp.expand), e.numpy(), e0.numpy(), want))
    for a, b in zip(ocp.unpack(CFG, t(XFULL)),
                    jcall(lambda x: jocp.unpack(CFG, x), XFULL)):
        close(a, b)


def test_default_footholds():
    a0 = np.random.default_rng(2).normal(size=(3, 2))
    close(ocp.default_footholds(t(a0)),
          jcall(jax.vmap(jocp.default_footholds), a0))


def test_vel_rows():
    g, h = sqp._vel_rows(CFG, torch.float64)
    jg, jh = jcall(lambda: jsqp._vel_rows(CFG, jnp.float64))
    close(g, jg)
    close(h, jh)


@pytest.mark.parametrize("mask", [[1.0], [1.0, 0.0], [1.0, 1.0]],
                         ids=["one", "two_masked", "two"])
def test_cbf_rows_and_margins(mask):
    mask = np.tile(np.asarray(mask), (B, 1))
    circles = np.random.default_rng(3).normal(size=(B, mask.shape[1], 2))
    want = jcall(jax.vmap(lambda x, c, m: jsqp._cbf_rows(
        CFG, x, c, m, jnp.float64)), XFULL, circles, mask)
    got = sqp._cbf_rows(CFG, t(XFULL), t(circles), t(mask), torch.float64)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        close(a, b)
    close(sqp.cbf_margins(CFG, t(XFULL), t(circles)),
          jcall(jax.vmap(lambda x, c: jsqp.cbf_margins(CFG, x, c)),
                XFULL, circles))


def test_hold_position_and_closest_obstacle():
    close(mpc.hold_position_x(CFG, t(X0), t(CONTACTS)),
          jcall(jax.vmap(lambda x, c: jmpc.hold_position_x(CFG, x, c)),
                X0, CONTACTS))
    rng = np.random.default_rng(4)
    q = rng.normal(size=(B, 2))
    pobs = rng.normal(size=(B, 2, 7))
    pobs[0, :, 5] = pobs[0, :, 2]           # a tie goes to the first
    pos, dist = mpc.closest_obstacle(t(q), t(pobs))
    jpos, jdist = jcall(jax.vmap(jmpc.closest_obstacle), q, pobs)
    close(pos, jpos)
    close(dist, jdist)
    carry = mpc.init_carry(t(q))
    assert carry.gait_domain.dtype == torch.int32
    close(carry.alpha_buffer,
          jcall(jax.vmap(lambda a: jmpc.init_carry(a).alpha_buffer), q))


def test_fit_domain_bezier():
    knots = np.random.default_rng(5).normal(size=(B, 4, 5))
    close(bezier.fit_domain_bezier(t(knots)),
          jcall(jbezier.fit_domain_bezier, knots))


@pytest.mark.parametrize("agents", [2, 4])
def test_refplan_generate(agents):
    if agents == 2:
        cfg = refplan.two_agent_config(loop_size=800)
        jcfg = jrefplan.two_agent_config(loop_size=800)
    else:   # the 4-agent planner ramps its forces up over 1000 steps
        cfg = refplan.four_agent_config(loop_size=800)
        jcfg = jrefplan.four_agent_config(loop_size=800)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(6)
    # agents side by side 1 m apart, as the reference's start poses
    lanes_y = np.arange(agents) - (agents - 1) / 2
    p_start = np.stack([np.zeros(agents), lanes_y], 1).reshape(-1)
    p_start = p_start + rng.normal(size=2 * agents) * 0.05
    pobs = np.stack([rng.uniform(1.0, 4.0, 20), rng.uniform(-1.5, 1.5, 20)])
    want = jcall(lambda p, o: jrefplan.generate(jcfg, p, o), p_start, pobs)
    got = refplan.generate(cfg, t(p_start), t(pobs), device="cpu")
    assert got.pr.shape == want[0].shape == (2 * agents, 20)
    close(got.pr, want[0])
    close(got.prd, want[1])
