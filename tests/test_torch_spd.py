"""srbx_torch's SPD solve and inverse (the CPU path of kernels K2a and K2b)
against the JAX package's Pallas kernels run in interpret mode, in float64 on
the CPU, at the whole-body loop's shapes: k = 18 (the mass matrix; a
one-column solve and the inverse) and k = 12 (the swing operational-space
inverse).

The matrices are mass matrices of the A1 at random configurations and the
swing operational-space matrices built from them, as the loop forms them.
Tolerance 1e-12 relative to max |value|: the same Cholesky column steps and
divisions, so only the order of the products in each update differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbx.ops import spd as jspd
from srbx_torch.lowlevel import LLCtx, swing_delta_inv
from srbx_torch.models import a1, rbd
from srbx_torch.ops import spd

torch.set_num_threads(1)

B = 9
RNG = np.random.default_rng(3)


def _matrices():
    q = torch.as_tensor(RNG.normal(size=(B, 18)) * 0.4)
    d = rbd.mass_matrix(a1.model(), q)
    toe_jac = rbd.site_jacobians(a1.model(), q)[:, a1.TOE_SITES]
    con = torch.as_tensor(RNG.integers(0, 2, (B, 4)).astype(np.float64))
    z = torch.zeros(B, dtype=torch.float64)
    ctx = LLCtx(torch.linalg.inv(d), None, None, None, toe_jac, None, con,
                z, z, None, z)
    return {18: d, 12: swing_delta_inv(ctx)}


MATS = _matrices()
RHS = torch.as_tensor(RNG.normal(size=(B, 18)) * 10.0)


@pytest.mark.parametrize("op,k", [("solve", 18), ("inverse", 18),
                                  ("inverse", 12)])
def test_plain_spd_matches_pallas_interpret(op, k):
    d = MATS[k]
    if op == "solve":
        got = spd.solve(d, RHS)
        fn = lambda d_, r_: jspd.solve(d_, r_, backend="fused",  # noqa: E731
                                       tile=8, interpret=True)
        want = jax.jit(fn)(jnp.asarray(d.numpy()), jnp.asarray(RHS.numpy()))
    else:
        got = spd.inverse(d)
        fn = lambda d_: jspd.inverse(d_, backend="fused", tile=8,  # noqa: E731
                                     interpret=True)
        want = jax.jit(fn)(jnp.asarray(d.numpy()))
    # a CPU call runs the plain version and launches nothing
    assert spd.solve.launches == spd.inverse.launches == 0
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-12, err


@pytest.mark.parametrize("r", [1, 3])
def test_plain_spd_solves_the_system(r):
    """The plain versions against the defining identities, in a shape the
    loop does not use (several right-hand sides)."""
    d = MATS[18]
    rhs = torch.as_tensor(RNG.normal(size=(B, 18, r)))
    x = spd.solve(d, rhs)
    np.testing.assert_allclose((d @ x).numpy(), rhs.numpy(), atol=1e-9)
    inv = spd.inverse(d)
    np.testing.assert_allclose((d @ inv).numpy(),
                               np.broadcast_to(np.eye(18), (B, 18, 18)),
                               atol=1e-10)


@pytest.mark.parametrize("bad,error", [
    (lambda d: (d[:, :, :17], None), ValueError),                # not square
    (lambda d: (torch.eye(33, dtype=d.dtype).expand(2, 33, 33), None),
     ValueError),                                                # k > 32
    (lambda d: (d.half(), None), TypeError),
    (lambda d: (d.transpose(1, 2), None), ValueError),           # strided
    (lambda d: (d, RHS[:, :12]), ValueError),                    # rhs shape
    (lambda d: (d, RHS.float()), TypeError),                     # mixed dtype
    (lambda d: (d.to("meta"), None), ValueError),                # device
], ids=["square", "k", "dtype", "contiguous", "rhs", "mixed", "device"])
def test_spd_wrappers_reject_what_the_kernels_do_not_take(bad, error):
    d, rhs = bad(MATS[18])
    with pytest.raises(error):
        if rhs is None:
            spd.inverse(d)
        else:
            spd.solve(d, rhs)
    assert spd.solve.launches == spd.inverse.launches == 0
