"""The dense per-problem IPM of srbx_torch (`srbx_torch.ops.qp.solve`)
against the JAX package's `srbx.ops.qp.solve`, in float64 on the CPU.

Each case solves a few random QPs made with numpy from a seed, in the port
over a leading lane axis and in the JAX package through `jax.vmap` of its
single-problem function, jitted: without equality rows (me = 0), with 3
Ruiz sweeps under a clip, cut at max_iters, and a batch with equality rows
warm from an x0 whose lanes stop at different iterations, one of them at a
non-finite step; Ruiz without equality rows raises in both. x, y, z and s
agree within 1e-10 relative to max(1, |value|), and every lane's `iters`
and `converged` are equal. The JAX package's own claims of
tests/test_qp.py (padding rows are inert, a warm start converges to the
cold solution) run through the port.
"""

import numpy as np
import pytest
import torch

from srbx_torch.config import QpConfig
from srbx_torch.ops import qp

torch.set_num_threads(1)

TOL = 1e-10
CFG = QpConfig()


def _random_qp(rng, n, me, mi, scale=1.0):
    """A random strictly convex, strictly feasible QP (tests/test_qp.py's
    construction), its cost scaled by `scale`."""
    m = rng.normal(size=(n, n))
    P = (m @ m.T + n * np.eye(n)) * scale
    c = rng.normal(size=n) * scale
    A = rng.normal(size=(me, n))
    x_feas = rng.normal(size=n) * 0.3
    b = A @ x_feas
    G = rng.normal(size=(mi, n))
    h = G @ x_feas + rng.uniform(0.1, 1.0, size=mi)
    return P, c, A, b, G, h


def _lanes(seed, count, n, me, mi, scales=None):
    rng = np.random.default_rng(seed)
    probs = [_random_qp(rng, n, me, mi, 1.0 if scales is None else scales[i])
             for i in range(count)]
    return [np.stack(t) for t in zip(*probs)]


def _badly_scaled(seed, count):
    """QPs whose rows and columns span about 1e6, which Ruiz's clip
    bounds."""
    ops = _lanes(seed, count, 10, 3, 12)
    rng = np.random.default_rng(seed + 1)
    col = 10.0 ** rng.uniform(-3, 3, size=(count, 10))
    P, c, A, b, G, h = ops
    return [P * col[:, :, None] * col[:, None, :], c * col, A * col[:, None],
            b, G * col[:, None], h]


def _jcfg(cfg):
    from srbx.config import QpConfig as JQpConfig

    return JQpConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _jax_solve(ops, cfg, x0=None):
    import jax
    import jax.numpy as jnp

    from srbx.ops import qp as jqp

    jcfg = _jcfg(cfg)
    ops = [jnp.asarray(o) for o in ops]
    if x0 is None:
        sol = jax.jit(jax.vmap(lambda *o: jqp.solve(*o, jcfg)))(*ops)
    else:
        sol = jax.jit(jax.vmap(lambda x, *o: jqp.solve(*o, jcfg, x0=x)))(
            jnp.asarray(x0), *ops)
    return {f: np.asarray(getattr(sol, f)) for f in sol._fields}


def _hold(got, want):
    for f in ("x", "y", "z", "s", "res", "gap"):
        g, w = getattr(got, f).numpy(), want[f]
        assert g.shape == w.shape, f
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
        assert err.size == 0 or err.max() <= TOL, (f, err.max())
    np.testing.assert_array_equal(got.iters.numpy(), want["iters"])
    np.testing.assert_array_equal(got.converged.numpy(), want["converged"])


CASES = {
    # name: (operands, QpConfig)
    "noeq": (lambda: _lanes(2, 3, 10, 0, 16), CFG),
    "ruiz_clip": (lambda: _badly_scaled(3, 3),
                  QpConfig(ruiz_iters=3, ruiz_clip=1e2)),
    "max_iters": (lambda: _lanes(6, 3, 12, 4, 20), QpConfig(max_iters=3)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_jax(name):
    make, cfg = CASES[name]
    ops = make()
    got = qp.solve(*[torch.as_tensor(o) for o in ops], cfg)
    _hold(got, _jax_solve(ops, cfg))
    if name == "max_iters":
        assert (got.iters.numpy() == 3).all() and not got.converged.any()
    else:
        assert got.converged.all()


def test_lanes_stop_at_their_own_iteration():
    """Lanes warm from an x0 whose problems need different iteration counts
    (costs scaled over 1e-4 to 1e4) and a lane whose data are NaN (a
    non-finite first step: it stops after one iteration, unconverged) keep
    each lane's own count and flags, as jax.vmap(qp.solve) does."""
    ops = _lanes(7, 5, 12, 4, 20, scales=(1e-4, 1.0, 1e2, 1e4, 1.0))
    ops[4][4, 0] = np.nan                    # h of the last lane
    x0 = np.random.default_rng(9).normal(size=ops[1].shape) * 0.1
    got = qp.solve(*[torch.as_tensor(o) for o in ops], CFG,
                   x0=torch.as_tensor(x0))
    want = _jax_solve(ops, CFG, x0)
    for f in ("x", "z", "s"):
        assert np.isnan(want[f][4]).any() == np.isnan(getattr(
            got, f)[4].numpy()).any()
    _hold(type(got)(*(t[:4] for t in got)), {k: v[:4]
                                             for k, v in want.items()})
    np.testing.assert_array_equal(got.iters.numpy(), want["iters"])
    np.testing.assert_array_equal(got.converged.numpy(), want["converged"])
    assert len(set(want["iters"][:4].tolist())) > 1
    assert not got.converged[4]


def test_ruiz_without_equality_rows_raises():
    """me = 0 under Ruiz raises ValueError in both packages."""
    from srbx.ops import qp as jqp

    cfg = QpConfig(ruiz_iters=2)
    ops = _lanes(4, 1, 6, 0, 8)
    with pytest.raises(ValueError):
        jqp.solve(*[o[0] for o in ops], _jcfg(cfg))
    with pytest.raises(ValueError):
        qp.solve(*[torch.as_tensor(o) for o in ops], cfg)


def test_solve_batch_is_solve():
    ops = [torch.as_tensor(o) for o in _lanes(8, 2, 9, 3, 14)]
    a, b = qp.solve_batch(*ops, CFG), qp.solve(*ops, CFG)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_padded_rows_are_inert():
    """tests/test_qp.py::test_padded_rows_are_inert through the port: zero
    inequality rows with h = 1 and zero equality rows with b = 0 leave the
    solution where it was (1e-5)."""
    P, c, A, b, G, h = (torch.as_tensor(o) for o in _lanes(5, 1, 10, 3, 12))
    sol = qp.solve(P, c, A, b, G, h, CFG)
    z = torch.zeros
    pad = qp.solve(P, c, torch.cat([A, z(1, 2, 10, dtype=A.dtype)], 1),
                   torch.cat([b, z(1, 2, dtype=b.dtype)], 1),
                   torch.cat([G, z(1, 6, 10, dtype=G.dtype)], 1),
                   torch.cat([h, torch.ones(1, 6, dtype=h.dtype)], 1), CFG)
    assert bool(pad.converged)
    np.testing.assert_allclose(pad.x.numpy(), sol.x.numpy(), atol=1e-5)


def test_warm_start_converges():
    """tests/test_qp.py::test_warm_start_converges through the port: warm
    from the cold solution, the solve converges to it (1e-5)."""
    ops = [torch.as_tensor(o) for o in _lanes(12, 1, 10, 4, 16)]
    cold = qp.solve(*ops, CFG)
    warm = qp.solve(*ops, CFG, x0=cold.x)
    assert bool(warm.converged)
    np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(), atol=1e-5)
