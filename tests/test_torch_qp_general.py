"""The plain PyTorch general fused IPM (the CPU path of srbx_torch's kernel
K1b, equality and inequality rows) against the JAX package, in float64 on
the CPU.

* Against the Pallas kernel itself in interpret mode (`qp_fused.solve(...,
  interpret=True)`) at one small shape (n 6, me 2, mi 5; B 8, tile 8),
  from the cold start the low-level QP takes: the same iteration, summed in
  another order, so 1e-9 on x, y, z and s with equal converged flags and
  iteration counts. Interpret mode at
  the low-level QP's own shape takes over two minutes on a CPU.
* Against `qp_batch.solve(backend="xla")` at that shape (n 43, me 30,
  mi 45) on the low-level QPs of the whole-body fixture
  (tests/data/torch_wholebody_jax.npz: stand and trot lanes) under the
  strict configuration. The `xla` path runs the same Mehrotra iteration
  with XLA's Cholesky, divisions where the fused form multiplies by 1/s,
  and a global iteration count (ROADMAP F4), so bitwise agreement is not
  expected: x to 1e-9 relative to max(1, |x|) on the lanes that converge
  (three of the four), 1e-5 on the one that stops at max_iters in both;
  equal converged flags and iteration counts.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbx.config import QpConfig
from srbx.ops import qp_batch as jqp_batch
from srbx.ops import qp_fused as jqp_fused
from srbx_torch.ops import qp_batch, qp_fused

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_wholebody_jax.npz"


def _small_qps(seed=1, bsz=8, n=6, me=2, mi=5):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(bsz, n, n))
    P = lo @ lo.transpose(0, 2, 1) / n + np.eye(n) * 0.1
    c = rng.normal(size=(bsz, n))
    A = rng.normal(size=(bsz, me, n))
    xf = rng.normal(size=(bsz, n))
    b = np.einsum("bmn,bn->bm", A, xf)
    G = rng.normal(size=(bsz, mi, n))
    h = np.einsum("bmn,bn->bm", G, xf) + rng.uniform(0.1, 1.0, (bsz, mi))
    x0 = xf + rng.normal(size=(bsz, n)) * 0.1
    return (P, c, A, b, G, h), x0


def test_plain_general_ipm_matches_pallas_interpret():
    ops, _ = _small_qps()
    cfg = QpConfig()
    want = jax.jit(lambda *o: jqp_fused.solve(*o, cfg, tile=8,
                                              interpret=True))(
        *(jnp.asarray(a) for a in ops))
    got = qp_fused.solve_plain(*(torch.as_tensor(a) for a in ops), cfg)
    for name in ("x", "y", "z", "s"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert got.converged.all()
    assert int(got.iters) == int(want.iters)


def test_plain_general_ipm_warm_start():
    """With x0 the start still factors and solves for y, then takes x0 as
    x (the TPU kernel's order): the same optimum from another start, within
    what the stopping test (1e-6 on scaled residuals) lets x move here
    (2e-5 measured)."""
    ops, x0 = _small_qps()
    t = [torch.as_tensor(a) for a in ops]
    cold = qp_fused.solve_plain(*t, QpConfig())
    warm = qp_fused.solve_plain(*t, QpConfig(), x0=torch.as_tensor(x0))
    assert warm.converged.all()
    np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(), atol=1e-4)
    assert not torch.equal(warm.x, cold.x)


def test_plain_general_ipm_matches_xla_on_ll_qps():
    with np.load(FIXTURE) as f:
        ops = [np.concatenate([f[f"stand.data.{k}"], f[f"trot.data.{k}"]])
               for k in ("P", "c", "A", "b", "G", "h")]
    assert ops[0].shape[1:] == (43, 43) and ops[2].shape[1] == 30
    assert ops[4].shape[1] == 45
    cfg = QpConfig()
    want = jax.jit(lambda *o: jqp_batch.solve(*o, cfg, backend="xla"))(
        *(jnp.asarray(a) for a in ops))
    got = qp_batch.solve(*(torch.as_tensor(a) for a in ops), cfg)
    assert qp_fused.solve.launches == 0     # the CPU path launches nothing
    wx = np.asarray(want.x)
    err = (np.abs(got.x.numpy() - wx) / np.maximum(1.0, np.abs(wx))).max(1)
    conv = np.asarray(want.converged)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    assert int(got.iters) == int(want.iters)
    assert conv.sum() >= 3, conv
    # converged lanes: the same optimum to rounding
    assert err[conv].max() <= 1e-9, err
    # a lane that stops at max_iters (one stand lane: res 1.7e-4 in both)
    # is where the two paths' roundings have taken the iterates apart
    assert err[~conv].max(initial=0.0) <= 1e-5, err


def _ll_shaped(dtype=torch.float64, bsz=3, mi=45):
    n, me = 43, 30
    return (torch.eye(n, dtype=dtype).expand(bsz, n, n).contiguous(),
            torch.zeros(bsz, n, dtype=dtype),
            torch.eye(me, n, dtype=dtype).expand(bsz, me, n).contiguous(),
            torch.zeros(bsz, me, dtype=dtype),
            torch.zeros(bsz, mi, n, dtype=dtype),
            torch.ones(bsz, mi, dtype=dtype))


@pytest.mark.parametrize("bad,error", [
    (lambda o: _small_qps()[0], ValueError),                       # n 6
    (lambda o: (o[0], o[1], o[2][:, :29].contiguous(), o[3][:, :29]) + o[4:],
     ValueError),                                                  # me 29
    (lambda o: _ll_shaped(mi=65), ValueError),                     # mi > 64
    (lambda o: tuple(t.half() for t in o), TypeError),
    (lambda o: o[:4] + (o[4].transpose(0, 1).contiguous()
                        .transpose(0, 1), o[5]), ValueError),      # strided
    (lambda o: (o[0], o[1].float()) + o[2:], TypeError),           # mixed
    (lambda o: (o[0][:2],) + o[1:], ValueError),                   # shapes
    (lambda o: tuple(t.to("meta") for t in o), ValueError),        # device
    (lambda o: o + (o[1][:, :42].contiguous(),), ValueError),      # x0
], ids=["n", "me", "mi", "dtype", "contiguous", "mixed", "shape", "device",
        "x0"])
def test_general_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    ops = bad(_ll_shaped())
    ops = tuple(torch.as_tensor(a) for a in ops)
    with pytest.raises(error):
        qp_fused.solve(*ops[:6], QpConfig(), *ops[6:])
    assert qp_fused.solve.launches == 0


def test_general_wrapper_cpu_path_is_the_plain_version():
    P, c, A, b, G, h = _ll_shaped()
    G[:, 0, 40] = 1.0                  # x_40 <= 1 binds: c pulls it to 2
    c[:, 40] = -2.0
    got = qp_fused.solve(P, c, A, b, G, h, QpConfig())
    want = qp_fused.solve_plain(P, c, A, b, G, h, QpConfig())
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    np.testing.assert_allclose(got.x[:, 40].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(got.x[:, :30].numpy(), 0.0, atol=1e-9)
    assert got.converged.all() and qp_fused.solve.launches == 0


@pytest.mark.parametrize("change", [
    dict(backend="xla"), dict(backend="pallas"),
    dict(cfg=QpConfig(ruiz_iters=5)), dict(me=0),
], ids=["xla", "pallas", "ruiz", "noeq"])
def test_qp_batch_unported_options_raise(change, monkeypatch):
    """Where qp_batch.solve sends the low-level QP's shape. These options
    raised NotImplementedError before the step-fused IPM was ported: "xla"
    and "pallas" now run the step-fused IPM without calling K1b, and Ruiz
    equilibrates and then calls K1b, each solving the QP (x = 0). An
    inequality-only QP on the "fused" backend still reaches K1b, which is
    built for me 30 only, and raises there."""
    calls = []
    fused = qp_fused.solve
    monkeypatch.setattr(qp_fused, "solve",
                        lambda *a, **k: calls.append(a) or fused(*a, **k))
    ops = list(_ll_shaped())
    noeq = change.pop("me", None) == 0
    if noeq:
        ops[2], ops[3] = ops[2][:, :0], ops[3][:, :0]
    cfg = change.pop("cfg", QpConfig())
    if noeq:
        with pytest.raises(ValueError, match="me=30"):
            qp_batch.solve(*ops, cfg, **change)
        assert len(calls) == 1
        return
    sol = qp_batch.solve(*ops, cfg, **change)
    assert len(calls) == (1 if cfg.ruiz_iters else 0)
    assert sol.converged.all() and sol.y.shape == (3, 30)
    np.testing.assert_allclose(sol.x.numpy(), 0.0, atol=1e-9)
    assert fused.launches == 0
