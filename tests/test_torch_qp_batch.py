"""The batched IPM of srbx_torch (`ops/qp_batch.solve` with the step-fused
backends "pallas", through the plain versions of kernels K3a and K3b on the
CPU, and "xla", through torch.linalg) against the JAX package's
`qp_batch.solve(backend="xla")`, in float64 on the CPU.

The same numpy inputs go to both packages:
* random batches (the patterns of tests/test_qp_batch.py) with a lane with
  a NaN in h and a lane whose P makes M indefinite, which must freeze
  without poisoning the others;
* the uncondensed NMPC QP of mixed lanes at the reference shape (n 41,
  me 28, mi 92), built by the port's `ocp.assemble`;
* Ruiz equilibration, with ruiz_clip 0 and 10: the JAX package's batched
  solve does not pass ruiz_clip on (fault F7), and the port mirrors that;
  `ops/qp.ruiz_equilibrate` itself, with and without its clip, against the
  JAX package's `qp.ruiz_equilibrate` mapped over the lanes;
* the condensed, simplex-eliminated QP (n 13, me 0), solved through the
  inert equality row;
* a warm start x0.

Bound: x, y, z and s within 1e-9 (NaN where JAX has NaN); iters and
converged equal.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbx.config import QpConfig as JQpConfig
from srbx.ops import qp as jqp
from srbx.ops import qp_batch as jqp_batch
from srbx_torch import mpc, mpc_batch
from srbx_torch.config import MpcConfig, QpConfig
from srbx_torch.ocp import assemble, condense, expansion
from srbx_torch.ops import pallas_linalg, qp, qp_batch

torch.set_num_threads(1)

B = 8
BACKENDS = ["pallas", "xla"]
TOL = 1e-9


def _random_batch(seed, n=20, me=5, mi=30, bsz=B):
    """Feasible random QPs, but lane 5 has a NaN in h and lane 6 a P that
    makes M = P + G'G indefinite."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(bsz, n, n))
    P = m @ m.transpose(0, 2, 1) + n * np.eye(n)
    c = rng.normal(size=(bsz, n))
    A = rng.normal(size=(bsz, me, n))
    xf = rng.normal(size=(bsz, n)) * 0.3
    b = np.einsum("bmn,bn->bm", A, xf)
    G = rng.normal(size=(bsz, mi, n))
    h = np.einsum("bmn,bn->bm", G, xf) + rng.uniform(0.1, 1.0, (bsz, mi))
    h[5, 3] = np.nan
    P[6] = -1e3 * np.eye(n)
    return [P, c, A, b, G, h]


def _nmpc_qps(condensed):
    """The NMPC QPs of 8 mixed lanes: domains 0-3, mixed contacts, start
    states and footholds spread by numpy noise."""
    rng = np.random.default_rng(3)
    cfg = MpcConfig(condensed=condensed, elide_simplex=condensed,
                    elide_box_rows=condensed)
    dom = np.array([0, 1, 2, 3, 0, 1, 2, 3])
    x0 = rng.normal(size=(B, 4)) * 0.02
    t = np.arange(cfg.horizon)
    ref = np.stack([0.05 + 0.02 * t, 0.4 * np.ones(4), -0.01 * np.ones(4),
                    np.zeros(4)])[None] + rng.normal(size=(B, 4, 4)) * 0.01
    foot = np.array([[0.2188, 0.2188, -0.1472, -0.1472],
                     [-0.1320, 0.1320, -0.1320, 0.1320]]) \
        + rng.normal(size=(B, 2, 4)) * 0.02
    contacts = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 0.0, 1.0],
                         [0.0, 1.0, 1.0, 0.0], [0.0, 1.0, 1.0, 1.0]])
    carry = mpc.MpcCarry(torch.tensor(dom), torch.zeros(B, 4))
    ci = mpc_batch.effective_contacts(carry, torch.tensor(contacts[dom]))
    x0, ref, foot = (torch.tensor(a) for a in (x0, ref, foot))
    data = assemble(cfg, x0, ref, foot, ci)
    if condensed:
        data = condense(cfg, data, *expansion(cfg, x0, foot, ci))
    return [t.contiguous().numpy() for t in data]


def _warm_batch():
    ops = _random_batch(4)
    x0 = np.random.default_rng(9).normal(size=(B, 20)) * 0.1
    return ops, x0


# the NMPC cycle's regularization (bench.py's solver configurations)
NMPC_REG = dict(reg_primal=1e-6, reg_dual=1e-6)
CASES = {
    "random": (lambda: (_random_batch(1), None), {}),
    "nmpc": (lambda: (_nmpc_qps(False), None), NMPC_REG),
    "ruiz": (lambda: (_random_batch(5, n=10, me=3, mi=16), None),
             dict(ruiz_iters=3, ruiz_clip=10.0)),
    "noeq": (lambda: (_nmpc_qps(True), None), NMPC_REG),
    "warm": (_warm_batch, {}),
}


@functools.lru_cache(maxsize=None)
def _jax(case):
    make, kw = CASES[case]
    ops, x0 = make()
    cfg = JQpConfig(**kw)
    args = [jnp.asarray(a) for a in ops]
    if x0 is None:
        sol = jax.jit(lambda *a: jqp_batch.solve(*a, cfg, backend="xla"))(
            *args)
    else:
        sol = jax.jit(lambda x, *a: jqp_batch.solve(*a, cfg, backend="xla",
                                                    x0=x))(
            jnp.asarray(x0), *args)
    return jax.tree_util.tree_map(np.asarray, sol)


def _port(case, backend, **override):
    make, kw = CASES[case]
    ops, x0 = make()
    cfg = QpConfig(**{**kw, **override})
    return qp_batch.solve(*(torch.tensor(a) for a in ops), cfg,
                          backend=backend,
                          x0=None if x0 is None else torch.tensor(x0))


def _assert_matches(got, want):
    for name in ("x", "y", "z", "s"):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)
    assert int(got.iters) == int(want.iters)
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)


@pytest.mark.parametrize("backend", BACKENDS)
def test_random_batch_matches_jax(backend):
    want = _jax("random")
    got = _port("random", backend)
    _assert_matches(got, want)
    # the bad lanes freeze without poisoning the others
    good = [0, 1, 2, 3, 4, 7]
    assert got.converged[good].all() and torch.isfinite(got.x[good]).all()
    assert got.x[[5, 6]].isnan().all() and not got.converged[[5, 6]].any()
    assert pallas_linalg.batch_cholesky.launches == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_nmpc_problem_matches_jax(backend):
    got = _port("nmpc", backend)
    assert got.x.shape == (B, 41) and got.y.shape == (B, 28)
    assert got.z.shape == (B, 92)
    _assert_matches(got, _jax("nmpc"))
    assert got.converged.all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_inequality_only_matches_jax(backend):
    got = _port("noeq", backend)
    assert got.x.shape == (B, 13) and got.y.shape == (B, 0)
    _assert_matches(got, _jax("noeq"))
    assert got.converged.all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_start_matches_jax(backend):
    _assert_matches(_port("warm", backend), _jax("warm"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_ruiz_mirrors_jax_and_ignores_clip(backend, caplog):
    """Ruiz with ruiz_clip = 10: the port's result is the JAX package's,
    which does not pass the clip on (F7), and bitwise the port's without
    the clip; a warning names the fault."""
    with caplog.at_level(logging.WARNING, logger="srbx_torch.ops.qp_batch"):
        got = _port("ruiz", backend)
    assert any("F7" in r.getMessage() for r in caplog.records)
    _assert_matches(got, _jax("ruiz"))
    unclipped = _port("ruiz", backend, ruiz_clip=0.0)
    for a, b in zip(got[:4], unclipped[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert got.converged[[0, 1, 2, 3, 4, 7]].all()


@pytest.mark.parametrize("clip", [0.0, 2.0])
def test_ruiz_equilibrate_matches_jax(clip):
    """The port's batched `ruiz_equilibrate` against the JAX package's
    single-QP one mapped over the lanes, without and with a clip that binds
    (clip 2 changes the scalings), to 1e-12 relative."""
    P, c, A, b, G, h = _random_batch(5, n=10, me=3, mi=16)
    h[5, 3] = 0.0
    ops = (P, c, A, G, h, b)
    want = jax.jit(jax.vmap(
        lambda *a: jqp.ruiz_equilibrate(*a, iters=3, clip=clip)))(
        *(jnp.asarray(a) for a in ops))
    got = qp.ruiz_equilibrate(*(torch.tensor(a) for a in ops), iters=3,
                              clip=clip)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=0)
    free = qp.ruiz_equilibrate(*(torch.tensor(a) for a in ops), iters=3)
    assert torch.equal(free[1][0], got[1][0]) == (clip == 0)


def test_backends_agree_and_restore_matmul_precision():
    """"pallas" and "xla" give the same solution, and the solve leaves the
    caller's float32 matmul precision as it found it."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        a = _port("warm", "pallas")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    b = _port("warm", "xla")
    torch.testing.assert_close(a.x, b.x, rtol=0, atol=TOL)


@pytest.mark.parametrize("backend", ["lanes", "cusolver"])
def test_unported_backends_raise(backend):
    ops, _ = _warm_batch()
    error = NotImplementedError if backend == "lanes" else ValueError
    with pytest.raises(error):
        qp_batch.solve(*(torch.tensor(a) for a in ops), QpConfig(),
                       backend=backend)
