"""Kernels K3a and K3b of srbx_torch (`ops/pallas_linalg.py`: batched
Cholesky and Cholesky solve) against the JAX package's Pallas kernels
`pallas_linalg.cholesky` and `cho_solve` run with interpret=True, in float64
on the CPU, where the port's wrappers take their plain PyTorch versions.

Shapes: k 41 (the uncondensed NMPC QP's M) with r 28 (M^-1 A') and r 1,
B 8, random SPD matrices made with numpy from a seed, one lane indefinite;
the solves take the same factor on both sides (the port's), so each test
makes one JAX call.
Bound: 1e-12 relative to the largest entry (the same column loop; the two
differ only where a compiler fuses a multiply-add). The strict upper
triangle of L must be exactly zero, and the indefinite lane's NaN must stay
in its lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbx.ops import pallas_linalg as jpl
from srbx_torch.ops import pallas_linalg

torch.set_num_threads(1)

K, B = 41, 8
BAD_LANE = 5
TOL = 1e-12


def _spd(k=K, bsz=B, seed=0):
    """Well-conditioned SPD matrices (B, k, k); lane BAD_LANE indefinite."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(bsz, k, k))
    m = a @ a.transpose(0, 2, 1) / k + np.eye(k)
    m[BAD_LANE, k // 2, k // 2] = -1.0
    return m


def _rhs(r, k=K, bsz=B, seed=1):
    return np.random.default_rng(seed).normal(size=(bsz, k, r))


def _lanes_last(a):
    return np.ascontiguousarray(np.moveaxis(a, 0, -1))


def _jax_cholesky():
    return np.asarray(jpl.cholesky(jnp.asarray(_lanes_last(_spd())), tile=B,
                                   interpret=True))


def _jax_cho_solve(l, r):
    return np.asarray(jpl.cho_solve(jnp.asarray(l),
                                    jnp.asarray(_lanes_last(_rhs(r))),
                                    tile=B, interpret=True))


def _assert_close(got, want):
    good = np.arange(B) != BAD_LANE
    got, want = got[..., good], want[..., good]
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.abs(got - want).max() <= TOL * scale


def _nan_only_in_bad_lane(a):
    finite = np.isfinite(a).reshape(-1, a.shape[-1]).all(0)
    assert not finite[BAD_LANE]
    assert finite[np.arange(B) != BAD_LANE].all()


def test_cholesky_matches_jax():
    want = _jax_cholesky()
    got = pallas_linalg.cholesky(torch.tensor(_lanes_last(_spd()))).numpy()
    assert got.shape == (K, K, B)
    _assert_close(got, want)
    upper = np.triu(np.ones((K, K), bool), 1)
    assert (got[upper] == 0).all() and (want[upper] == 0).all()
    _nan_only_in_bad_lane(got)
    _nan_only_in_bad_lane(want)
    # the oracle is a correct Cholesky: it reproduces M in the good lanes
    m = _spd()
    for lane in np.flatnonzero(np.arange(B) != BAD_LANE):
        np.testing.assert_allclose(want[..., lane] @ want[..., lane].T,
                                   m[lane], atol=1e-12)
    assert pallas_linalg.batch_cholesky.launches == 0


@pytest.mark.parametrize("r", [28, 1])
def test_cho_solve_matches_jax(r):
    # both packages substitute with the same factor (the port's), so each
    # test makes one JAX call of its own
    l = pallas_linalg.cholesky(torch.tensor(_lanes_last(_spd()))).numpy()
    want = _jax_cho_solve(l, r)
    got = pallas_linalg.cho_solve(torch.tensor(l),
                                  torch.tensor(_lanes_last(_rhs(r)))).numpy()
    assert got.shape == (K, r, B)
    _assert_close(got, want)
    _nan_only_in_bad_lane(got)
    _nan_only_in_bad_lane(want)
    # and it solves the system, in the lanes that factor
    m = _spd()
    for lane in np.flatnonzero(np.arange(B) != BAD_LANE):
        np.testing.assert_allclose(m[lane] @ got[..., lane],
                                   _rhs(r)[lane], atol=1e-10)
    assert pallas_linalg.batch_cho_solve.launches == 0


@pytest.mark.parametrize("k,r", [(41, 28), (28, 1), (17, 4), (13, 1),
                                 (1, 1)])
def test_batch_entries_are_the_lanes_last_ones(k, r):
    """The batch-leading entries the IPM calls give the lanes-last
    entries' results, bitwise, for every (k, r) of the generic cycle."""
    m = torch.tensor(_spd(k))
    rhs = torch.tensor(_rhs(r, k))
    l = pallas_linalg.batch_cholesky(m)
    x = pallas_linalg.batch_cho_solve(l, rhs)
    l_ll = pallas_linalg.cholesky(m.permute(1, 2, 0).contiguous())
    x_ll = pallas_linalg.cho_solve(l_ll, rhs.permute(1, 2, 0).contiguous())
    torch.testing.assert_close(l, l_ll.permute(2, 0, 1), rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(x, x_ll.permute(2, 0, 1), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("k,r", [(41, 28), (13, 1)])
def test_upper_triangles_are_not_read(k, r):
    """Only the lower triangles of M and L are read: NaN above their
    diagonals leaves L and X as they were, bitwise."""
    m = torch.tensor(_spd(k))
    rhs = torch.tensor(_rhs(r, k))
    upper = torch.ones(k, k, dtype=torch.bool).triu(1)
    l = pallas_linalg.batch_cholesky(m)
    x = pallas_linalg.batch_cho_solve(l, rhs)
    l_nan = pallas_linalg.batch_cholesky(m.masked_fill(upper, float("nan")))
    x_nan = pallas_linalg.batch_cho_solve(l.masked_fill(upper, float("nan")),
                                          rhs)
    torch.testing.assert_close(l_nan, l, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(x_nan, x, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("bad,error", [
    (lambda m, r: (m[:, :, :5], r), ValueError),               # not square
    (lambda m, r: (torch.zeros(2, 65, 65, dtype=m.dtype),
                   torch.zeros(2, 65, 1, dtype=m.dtype)), ValueError),
    (lambda m, r: (m, torch.zeros(B, K, 65, dtype=m.dtype)), ValueError),
    (lambda m, r: (m.half(), r.half()), TypeError),
    (lambda m, r: (m, r.float()), TypeError),                  # mixed dtype
    (lambda m, r: (m.transpose(1, 2), r), ValueError),         # strided
    (lambda m, r: (m, r[:, :-1]), ValueError),                 # rhs rows
], ids=["square", "k", "r", "dtype", "mixed", "contiguous", "rows"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad, error):
    m, r = bad(torch.tensor(_spd()), torch.tensor(_rhs(2)))
    with pytest.raises(error):
        pallas_linalg.batch_cho_solve(m, r)
    assert pallas_linalg.batch_cho_solve.launches == 0
