"""The whole-body slice of srbx_torch against a fixture that the JAX package
computed, in float64 on the CPU at B = 2.

The JAX oracles of this slice cost 56 s to 186 s each on a CPU, so the
tier-1 tests compare the port with `tests/data/torch_wholebody_jax.npz`,
which holds inputs made with numpy from fixed seeds and what the JAX package
computes from them:

* `wholebody.step_batch(backend="xla")` over one 1 ms tick (two substeps);
* `agent.tick_build`, the LL QP's solution by `qp_batch.solve(backend=
  "xla")`, and `agent.tick_finish`, from a stand state (gait STAND) and a
  trot state (gait TROT, one lane past its phase overrun);
* `lowlevel.ll_qp_build` and `ll_qp_finish` with a desired force and mixed
  contacts;
* `closedloop.run_batch(backend="xla")` over 3 stand and 3 trot ticks with
  the condensed NMPC.

Bounds: 1e-10 per function (the same arithmetic in another order; the LL
build and finish go through D^-1, whose entries reach 1e2, and the QP
operands through aux_pen = 1e6, so they are relative to max(1, |value|));
1e-8 for run_batch's sim.q and com_hist, because the JAX `xla` path's IPM
and its LU inverses differ from the fused kernels' arithmetic at rounding
level and six ticks of contact dynamics amplify that. The loop's qp_ok and
mpc_ok must be equal.

`test_fixture_provenance` (slow) recomputes the fixture live with the JAX
package from the same seeds and holds it to the committed file at 1e-12;
`python tests/test_torch_wholebody.py` rewrites the file.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from srbx_torch import agent, lowlevel, refplan
from srbx_torch.config import (Gait, LowLevelConfig, MotionConfig, MpcConfig,
                               QpConfig)
from srbx_torch.estimation import contact
from srbx_torch.models import a1, rbd
from srbx_torch.motion import PlannerState
from srbx_torch.sim import closedloop, wholebody as wb

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_wholebody_jax.npz"
B = 2
LL = LowLevelConfig()
MOTION = MotionConfig()
SIM = wb.SimConfig()
QP = QpConfig()
MPC = MpcConfig(use_sqp=True, sqp_iters=1, condensed=True,
                elide_box_rows=True, elide_simplex=True)
LOOP = closedloop.LoopConfig(stand_ticks=3, n_domains=1, ticks_per_domain=3)
TOL = 1e-10
LOOP_TOL = 1e-8
SUB = {"planner": PlannerState, "con": contact.ConState}


# ------------------------------- the inputs ------------------------------- #

def _toes(q):
    return rbd.site_positions(a1.model(), torch.as_tensor(q))[
        :, a1.TOE_SITES].numpy()


def _standing(rng, height_noise):
    """Two standing configurations, toes at or just below the ground."""
    q = np.zeros((B, 18))
    q[:, 7::3] = 0.8 + rng.normal(size=(B, 4)) * 0.05
    q[:, 8::3] = -1.6 + rng.normal(size=(B, 4)) * 0.05
    q[:, 3:6] = rng.normal(size=(B, 3)) * 0.02
    q[:, 0:2] = rng.normal(size=(B, 2)) * 0.1
    q[:, 2] = -_toes(q)[:, :, 2].min(1) - height_noise
    return q


def _agent_state(rng, q, gait):
    """An AgentState in numpy form (field path -> array)."""
    toe_t = _toes(q).transpose(0, 2, 1)
    trot = gait == Gait.TROT
    des = (np.array([[0, 1, 1, 0], [1, 0, 0, 1]], np.int32) if trot
           else np.ones((B, 4), np.int32))
    com = np.zeros((B, 12))
    com[:, 0:3] = q[:, 0:3] + rng.normal(size=(B, 3)) * 0.01
    com[:, 3:5] = rng.normal(size=(B, 2)) * 0.05
    alpha = np.zeros((B, 4, 5))
    alpha[:, 0] = q[:, 0:1] + np.linspace(0, 0.05, 5)
    alpha[:, 1] = 0.2 + rng.normal(size=(B, 5)) * 0.02
    alpha[:, 2] = q[:, 1:2] + rng.normal(size=(B, 5)) * 0.01
    alpha[:, 3] = rng.normal(size=(B, 5)) * 0.02
    return {
        "loco_tick": np.array([0.0, 37.0]) if not trot else
        np.array([57.0, 190.0]),
        "gait_domain": np.array([0, 0] if not trot else [2, 3], np.int32),
        "planner.com_des": com,
        "planner.toe_init": toe_t + rng.normal(size=(B, 3, 4)) * 0.005,
        "planner.toe_final": toe_t,
        "planner.step_len": rng.normal(size=(B, 3)) * 0.02 * trot,
        "planner.dom_ticks": np.full(B, 172.0 if trot else 800.0),
        "planner.des_domain": des,
        "planner.stand_from": q[:, 0:3] - np.array([0.0, 0.0, 0.1]),
        "planner.des_vel": np.zeros((B, 3)),
        "planner.cycle_idx": np.array([0, 0] if not trot else [2, 3],
                                      np.int32),
        "con.hist": rng.integers(0, 1024, (B, 4)).astype(np.int32),
        "con.est": rng.random((B, 4)) > 0.3,
        "con.rise": rng.random((B, 4)) > 0.5,
        "con.stance": des > 0,
        "con.ind": des,
        "con.ind_prev": des,
        "con.des": des,
        "con.change_domain": np.zeros(B, bool),
        "con.cnt": des.sum(1).astype(np.int32),
        "mpc_alpha": alpha,
        "mpc_states": rng.normal(size=(B, 4, 4)) * 0.1,
        "mpc_available": np.array([True, False]) if trot else
        np.zeros(B, bool),
        "prev_ddq": rng.normal(size=(B, 18)) * 0.5,
    }


def fixture_inputs():
    """Every input of the fixture, from fixed numpy seeds."""
    rng = np.random.default_rng(2024)
    inp = {}
    q = _standing(rng, 0.002)
    inp["step.q"] = q
    inp["step.qd"] = rng.normal(size=(B, 18)) * 0.2
    inp["step.tau"] = rng.normal(size=(B, 12)) * 5.0
    for case, gait in (("stand", Gait.STAND), ("trot", Gait.TROT)):
        q = _standing(rng, 0.001)
        for k, v in _agent_state(rng, q, gait).items():
            inp[f"{case}.state.{k}"] = v
        inp[f"{case}.q"] = q
        inp[f"{case}.qd"] = rng.normal(size=(B, 18)) * 0.1
        inp[f"{case}.force"] = rng.uniform(0.0, 60.0, (B, 4))
    inp["ll.contact"] = np.array([[1.0, 1.0, 1.0, 0.0], [0.0, 1.0, 1.0, 0.0]])
    inp["ll.f_des"] = rng.normal(size=(B, 12)) * 20.0
    inp["ll.x"] = rng.normal(size=(B, 43))
    ref = refplan.generate(refplan.two_agent_config(loop_size=4_000),
                           torch.tensor([0.0, 0.5, 0.0, -0.5]),
                           torch.tensor([[100.0] * 20, [100.0] * 20]),
                           device="cpu")
    inp["loop.pr"] = np.tile(ref.pr[0:2].numpy(), (B, 1, 1))
    inp["loop.prd"] = np.tile(ref.prd[0:2].numpy(), (B, 1, 1))
    inp["loop.a0"] = np.array([[0.0, 0.5], [0.005, 0.5]])
    inp["loop.pobs"] = np.full((B, 2, 20), 100.0)
    return inp


# ------------------------------- tree helpers ----------------------------- #

def flatten(tree, prefix, out):
    """NamedTuple tree -> {prefix.field...: numpy array}; None is left out."""
    if tree is None:
        return out
    if hasattr(tree, "_fields"):
        for name, value in zip(tree._fields, tree):
            flatten(value, f"{prefix}.{name}", out)
    else:
        out[prefix] = np.asarray(tree.detach().cpu() if isinstance(
            tree, torch.Tensor) else tree)
    return out


def unflatten(arrays, prefix, cls, sub, leaf):
    """{prefix.field...: array} -> cls, with nested NamedTuple fields of the
    classes in `sub` and leaves made by `leaf`."""
    return cls(*(unflatten(arrays, f"{prefix}.{f}", sub[f], {}, leaf)
                 if f in sub else leaf(arrays[f"{prefix}.{f}"])
                 for f in cls._fields))


# --------------------------- the JAX fixture ------------------------------ #

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
    from srbx.sim import closedloop as jclosedloop
    from srbx.sim import wholebody as jwb

    jax.config.update("jax_enable_x64", True)
    jmodel = ja1.model()
    jsim = jwb.SimConfig()
    inp = fixture_inputs()
    out = dict(inp)
    arr = jnp.asarray

    step = jax.jit(lambda q, qd, tau: jwb.step_batch(
        jsim, jmodel, jwb.SimState(q, qd), tau, backend="xla"))
    s = step(arr(inp["step.q"]), arr(inp["step.qd"]), arr(inp["step.tau"]))
    out["step.out.q"], out["step.out.qd"] = np.asarray(s.q), np.asarray(s.qd)

    jsub = {"planner": jmotion.PlannerState, "con": jcontact.ConState}
    for case, gait in (("stand", Gait.STAND), ("trot", Gait.TROT)):
        st = unflatten(inp, f"{case}.state", jagent.AgentState, jsub, arr)

        def build(st, q, qd, f, gait=gait):
            return jax.vmap(lambda s_, q_, qd_, f_: jagent.tick_build(
                LL, MOTION, jmodel, gait, s_, q_, qd_, f_,
                allow_contact_trigger=False))(st, q, qd, f)

        q, qd = arr(inp[f"{case}.q"]), arr(inp[f"{case}.qd"])
        data, ctx = jax.jit(build)(st, q, qd, arr(inp[f"{case}.force"]))
        sol = jax.jit(lambda *d: jqp_batch.solve(*d, QP, backend="xla"))(
            *data)
        ll_out, new_st, run_mpc = jax.jit(jax.vmap(
            lambda c, q_, qd_, x, cv: jagent.tick_finish(LL, c, q_, qd_, x,
                                                         cv)))(
            ctx, q, qd, sol.x, sol.converged)
        flatten(data, f"{case}.data", out)
        flatten(ctx.vc, f"{case}.vc", out)
        flatten(ctx.ll_ctx, f"{case}.ll_ctx", out)
        flatten(ctx.state_pre, f"{case}.state_pre", out)
        out[f"{case}.run_mpc"] = np.asarray(run_mpc)
        out[f"{case}.ll_x"] = np.asarray(sol.x)
        out[f"{case}.ll_converged"] = np.asarray(sol.converged)
        flatten(ll_out, f"{case}.ll_out", out)
        flatten(new_st, f"{case}.new_state", out)

    vc = unflatten(out, "trot.vc", jlowlevel.VcOut, {}, arr)
    q, qd = arr(inp["trot.q"]), arr(inp["trot.qd"])

    def ll(q, qd, ci, vc, f_des, x):
        data, ctx = jlowlevel.ll_qp_build(LL, jmodel, q, qd, ci, vc, f_des)
        return data, jlowlevel.ll_qp_finish(LL, ctx, q, qd, vc, x, True)

    data, ll_out = jax.jit(jax.vmap(ll))(
        q, qd, arr(inp["ll.contact"]), vc, arr(inp["ll.f_des"]),
        arr(inp["ll.x"]))
    flatten(data, "ll.data", out)
    flatten(ll_out._replace(qp_converged=None), "ll.out", out)

    def loop(pr, prd, a0, pobs):
        return jclosedloop.run_batch(
            MPC, LL, MOTION, QP, jsim, jclosedloop.LoopConfig(*LOOP), jmodel,
            pr, prd, a0, pobs, backend="xla")

    res = jax.jit(loop)(*(arr(inp[f"loop.{k}"])
                          for k in ("pr", "prd", "a0", "pobs")))
    for k in ("com_hist", "qp_ok", "mpc_ok"):
        out[f"loop.{k}"] = np.asarray(getattr(res, k))
    out["loop.q"] = np.asarray(res.sim.q)
    return out


# ------------------------------- the tests -------------------------------- #

@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return dict(f)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol=TOL, relative=False, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.maximum(1.0, np.abs(want)) if relative else 1.0
    err = np.abs(got - want) / scale
    assert np.isfinite(got).all() == np.isfinite(want).all(), what
    assert err.max() <= tol, f"{what}: {err.max():.3e} > {tol:.0e}"


def _close_tree(got: dict, fx, prefix, relative=False):
    keys = [k for k in fx if k.startswith(prefix + ".")]
    assert keys and set(keys) <= set(got), (prefix, sorted(set(keys) -
                                                           set(got)))
    for k in keys:
        if fx[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], fx[k], err_msg=k)
        else:
            _close(got[k], fx[k], relative=relative, what=k)


def test_fixture_matches_inputs(fx):
    """The committed inputs are the ones the seeds make."""
    for k, v in fixture_inputs().items():
        np.testing.assert_array_equal(fx[k], v, err_msg=k)


def test_step_batch_matches_jax(fx):
    s = wb.step_batch(SIM, a1.model(), wb.SimState(_t(fx["step.q"]),
                                                   _t(fx["step.qd"])),
                      _t(fx["step.tau"]))
    _close(s.q, fx["step.out.q"], what="q")
    _close(s.qd, fx["step.out.qd"], what="qd")


@pytest.mark.parametrize("case", ["stand", "trot"])
def test_tick_matches_jax(fx, case):
    gait = Gait.STAND if case == "stand" else Gait.TROT
    st = unflatten(fx, f"{case}.state", agent.AgentState, SUB, _t)
    q, qd = _t(fx[f"{case}.q"]), _t(fx[f"{case}.qd"])
    data, ctx = agent.tick_build(LL, MOTION, a1.model(), gait, st, q, qd,
                                 _t(fx[f"{case}.force"]),
                                 allow_contact_trigger=False)
    got = {}
    flatten(data, f"{case}.data", got)
    flatten(ctx.vc, f"{case}.vc", got)
    flatten(ctx.ll_ctx, f"{case}.ll_ctx", got)
    flatten(ctx.state_pre, f"{case}.state_pre", got)
    got[f"{case}.run_mpc"] = ctx.run_mpc.numpy()
    ll_out, new_st, _ = agent.tick_finish(
        LL, ctx, q, qd, _t(fx[f"{case}.ll_x"]),
        _t(fx[f"{case}.ll_converged"]))
    flatten(ll_out, f"{case}.ll_out", got)
    flatten(new_st, f"{case}.new_state", got)
    for part in ("data", "vc", "ll_ctx", "state_pre", "run_mpc", "ll_out",
                 "new_state"):
        _close_tree(got, fx, f"{case}.{part}", relative=True) \
            if part != "run_mpc" else np.testing.assert_array_equal(
                got[f"{case}.run_mpc"], fx[f"{case}.run_mpc"])
    if case == "trot":     # lane 1 is past its phase overrun: a new domain
        np.testing.assert_array_equal(fx["trot.run_mpc"], [False, True])


def test_ll_build_and_finish_match_jax(fx):
    vc = unflatten(fx, "trot.vc", lowlevel.VcOut, {}, _t)
    q, qd = _t(fx["trot.q"]), _t(fx["trot.qd"])
    data, ctx = lowlevel.ll_qp_build(LL, a1.model(), q, qd,
                                     _t(fx["ll.contact"]), vc,
                                     _t(fx["ll.f_des"]))
    out = lowlevel.ll_qp_finish(LL, ctx, q, qd, vc, _t(fx["ll.x"]),
                                torch.ones(B, dtype=torch.bool))
    got = {}
    flatten(data, "ll.data", got)
    flatten(out._replace(qp_converged=None), "ll.out", got)
    _close_tree(got, fx, "ll.data", relative=True)
    _close_tree(got, fx, "ll.out", relative=True)


def test_run_batch_matches_jax(fx):
    res = closedloop.run_batch(
        MPC, LL, MOTION, QP, SIM, LOOP, a1.model(), fx["loop.pr"],
        fx["loop.prd"], fx["loop.a0"], fx["loop.pobs"], device="cpu")
    assert res.com_hist.shape == (B, LOOP.n_domains, LOOP.ticks_per_domain, 3)
    _close(res.sim.q, fx["loop.q"], LOOP_TOL, what="sim.q")
    _close(res.com_hist, fx["loop.com_hist"], LOOP_TOL, what="com_hist")
    np.testing.assert_array_equal(res.qp_ok.numpy(), fx["loop.qp_ok"])
    np.testing.assert_array_equal(res.mpc_ok.numpy(), fx["loop.mpc_ok"])


@pytest.mark.slow
def test_fixture_provenance(fx):
    """The committed fixture is what the JAX package computes from the
    seeds (about six minutes on a CPU)."""
    live = build_fixture()
    assert set(live) == set(fx)
    for k, v in live.items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(fx[k], v, err_msg=k)
        else:
            _close(fx[k], v, 1e-12, relative=True, what=k)


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(f"wrote {FIXTURE}")
