"""Counter-based random numbers that reproduce the JAX package's streams.

The JAX package draws its sensor noise from `jax.random` keys (threefry2x32,
with jax's partitionable layout, `jax_threefry_partitionable=True`, the
default of jax 0.9.0). This module computes the same numbers in PyTorch, so
that a run of the port can be held to the JAX package lane by lane and not
only in distribution:

* a key is an int64 tensor `(..., 2)` holding two uint32 words, as the
  JAX package's raw `PRNGKey` holds them; every function takes leading
  lane axes;
* `split(key, n)` hashes the counters 0 .. n-1 (64-bit counters as a high
  and a low word) under the key: the subkeys are the hash's two output
  words (`jax._src.prng._threefry_split_foldlike`);
* random bits hash the counters of the flat index of each element under
  the key; a 32-bit word is the XOR of the two output words, a 64-bit word
  the first word shifted up by 32, ORed with the second
  (`_threefry_random_bits_partitionable`);
* `uniform` keeps the top mantissa bits of the word, ORs them into the
  bits of 1.0 and subtracts 1 (`jax._src.random._uniform`); `normal` is
  sqrt(2) erfinv(u) with u uniform on [nextafter(-1, 0), 1)
  (`_normal_real`); `randint` folds two 32-bit words into its range by
  uint32 arithmetic (`_randint`).

The uint32 words are held in int64 and masked to 32 bits after every
addition. `split`, the random bits and `randint` are bitwise jax's, on any
device. `uniform` and `normal` follow XLA's arithmetic: the scaling of a
uniform draw as one fused multiply-add, and XLA's own erf_inv and log1p
(`erfinv`, `log1p` here), so that they stay within a few ulps of jax's
(the rounding of `torch.log` against XLA's log remains); `uniform` is
bitwise jax's. Those fused multiply-adds are `torch.addcmul`, which the
CPU evaluates as jax's CPU build does; CUDA's own contraction of it is not
promised to. So `uniform` and `normal` (set-up draws: fields, pulses,
kicks) hash and scale on the CPU and return on the key's device, whatever
that is. `normals`, the sensors' noise of every tick, runs on its keys'
device: on the card within a few ulps of jax's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's erf_inv (the chlo legalization, Giles' approximation): per region
# of w = -log1p(-x^2), a polynomial in a shifted w; shorter ones padded with
# leading zeros (a Horner step with p = 0 adds its coefficient exactly)
_ERFINV64 = (
    (-3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
     1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
     6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
     2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
     1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
     4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
     0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
     0.24015818242558962, 1.6536545626831027),
    (0.0, 0.0, 0.0, 0.0,
     2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
     1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
     2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
     6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
     0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
     -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
     3.0838856104922208),
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
     -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
     -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
     2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
     -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
     7.599527703001776e-05, -0.00021503011930044477,
     -0.00013871931833623122, 1.0103004648645344, 4.849906401408584),
)
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
# XLA's log1p below sqrt(2) - 1: Cephes' rational approximation
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def key(seed: int, device=None) -> torch.Tensor:
    """The raw key of an integer seed (`jax.random.PRNGKey(seed)`): the
    seed's high and low 32-bit words. device=None means the CUDA card."""
    device = "cuda" if device is None else device
    seed = int(seed) % (1 << 64)
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64,
                        device=device)


def as_key(k, device=None) -> torch.Tensor:
    """A key as this module holds it: a key tensor is moved to `device`;
    anything else (the JAX package's raw key, a uint32 array) becomes an
    int64 tensor of its words. device=None means the CUDA card."""
    device = "cuda" if device is None else device
    if isinstance(k, torch.Tensor):
        return k.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(k).astype(np.int64)).to(device)


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2), all int64 tensors of uint32 values that
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _counters(n: int, device):
    """The 64-bit counters 0 .. n-1 as (high, low) words."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def split(key, n: int = 2) -> torch.Tensor:
    """(..., 2) keys -> (..., n, 2): `jax.random.split(key, n)` for every
    leading index."""
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack([b1, b2], -1)


def _bits(k1, k2, counts, dtype):
    """Random words for per-element key words (k1, k2) and counters, as
    the integer bits of a float in [1, 2) of `dtype`, viewed as `dtype`."""
    hi, lo = counts
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    if dtype == torch.float64:
        # the top 52 bits of (b1 << 32) | b2
        mant = (b1 << 20) | (b2 >> 12)
        return (mant | 0x3FF0000000000000).view(torch.float64)
    if dtype == torch.float32:
        mant = (b1 ^ b2) >> 9
        return (mant | 0x3F800000).to(torch.int32).view(torch.float32)
    raise TypeError(f"float32 or float64, not {dtype}")


def _np_dtype(dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def _scale(one_two, dtype, lo, hi):
    """u in [1, 2) -> jax's uniform on [lo, hi): lo, hi and hi - lo rounded
    to `dtype` as jax rounds them, then (u - 1) (hi - lo) + lo as one fused
    multiply-add (XLA contracts it), at least lo."""
    t = _np_dtype(dtype)
    lo_d, hi_d = t(lo), t(hi)
    scaled = torch.addcmul(torch.full_like(one_two, float(lo_d)),
                           one_two - 1.0,
                           torch.full_like(one_two, float(hi_d - lo_d)))
    return torch.clamp(scaled, min=float(lo_d))


@functools.lru_cache(maxsize=8)
def _erfinv_table(dtype, device):
    rows = _ERFINV64 if dtype == torch.float64 else _ERFINV32
    return torch.tensor(rows, dtype=dtype, device=device)


def _horner(coeffs, x):
    """sum c_i x^(n-1-i) by Horner's rule with fused multiply-adds, as
    XLA evaluates its polynomials."""
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = torch.addcmul(torch.full_like(x, c), p, x)
    return p


def log1p(x):
    """XLA's log1p: the Cephes rational approximation for |x| below
    sqrt(2) - 1, log(1 + x) above."""
    x2 = x * x
    small = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + torch.addcmul((x * x2) * small, x2, torch.full_like(x, -0.5))
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(1.0 + x))


def erfinv(x):
    """XLA's erf_inv (the chlo legalization of jax.lax.erf_inv): Giles'
    approximation in float32 (two regions) and float64 (three), inf at
    |x| = 1. Within 2 ulps of jax's on a million uniform draws in either
    dtype; torch.special.erfinv differs by up to 64 (float32) and 13,635
    (float64) there."""
    dtype = x.dtype
    w = -log1p(x * -x)
    if dtype == torch.float64:
        region = torch.where(w < 6.25, 0, torch.where(w < 16.0, 1, 2))
        w = torch.where(w < 6.25, w - 3.125,
                        torch.sqrt(w) - torch.where(w < 16.0, 3.25, 5.0))
    else:
        region = torch.where(w < 5.0, 0, 1)
        w = torch.where(w < 5.0, w - 2.5, torch.sqrt(w) - 3.0)
    coeffs = _erfinv_table(dtype, x.device)[region]
    p = coeffs[..., 0]
    for i in range(1, coeffs.shape[-1]):
        p = torch.addcmul(coeffs[..., i], p, w)
    return torch.where(x.abs() == 1.0, torch.inf * x, p * x)


def _normal_from(one_two, dtype):
    t = _np_dtype(dtype)
    u = _scale(one_two, dtype, np.nextafter(t(-1.0), t(0.0)), 1.0)
    return erfinv(u) * float(t(math.sqrt(2.0)))


def _drawn_on_the_cpu(draw):
    """A float draw computed from the key's CPU copy and returned on the
    key's device (see the module's docstring)."""
    @functools.wraps(draw)
    def on_cpu(key, *args, **kw):
        return draw(key.cpu(), *args, **kw).to(key.device)
    return on_cpu


@functools.lru_cache(maxsize=64)
def _layout(sizes, device):
    """Which draw each element belongs to, and its counter within it."""
    which = np.repeat(np.arange(len(sizes)), sizes)
    idx = np.concatenate([np.arange(s) for s in sizes])
    return (torch.from_numpy(which).to(device),
            torch.from_numpy(idx).to(torch.int64).to(device))


@_drawn_on_the_cpu
def uniform(key, shape=(), dtype=torch.float64, lo=0.0, hi=1.0):
    """(..., 2) keys -> (..., *shape): `jax.random.uniform(key, shape,
    dtype, lo, hi)` for every leading index."""
    shape = tuple(shape)
    n = math.prod(shape)
    hi_c, lo_c = _counters(n, key.device)
    one_two = _bits(key[..., 0:1], key[..., 1:2], (hi_c, lo_c), dtype)
    return _scale(one_two, dtype, lo, hi).reshape(key.shape[:-1] + shape)


def _wrap32(x):
    """int64 holding any integer -> the int32 with its low 32 bits."""
    x = x & _MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def randint(key, shape, minval, maxval, dtype=torch.int32):
    """(..., 2) keys -> (..., *shape) int32: `jax.random.randint(key, shape,
    minval, maxval, jnp.int32)` for every leading index, bitwise.

    jax splits the key in two, draws a high and a low 32-bit word per
    element (one from each subkey) and folds them into [minval, maxval) by
    uint32 arithmetic, every product and sum wrapped to 32 bits as there:
    ((hi % span) m + lo % span) % span with m = (2^16 % span)^2 % span
    (which wraps for spans above 2^16, so that m is not 2^32 % span then).
    A span of 0 or less gives minval. minval and maxval are ints or int
    tensors that broadcast against shape, within int32."""
    if dtype != torch.int32:
        raise TypeError(f"randint draws int32 (jax's default without x64), "
                        f"not {dtype}")
    shape = tuple(shape)
    lo_v = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    hi_v = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    for v in (lo_v, hi_v):
        if bool(((v < -(1 << 31)) | (v >= 1 << 31)).any()):
            raise ValueError("randint's bounds must lie within int32")
    k1, k2 = split(key).unbind(-2)
    n = math.prod(shape)
    counts = _counters(n, key.device)

    def word(k):
        b1, b2 = threefry2x32(k[..., 0:1], k[..., 1:2], *counts)
        return (b1 ^ b2).reshape(key.shape[:-1] + shape)

    higher, lower = word(k1), word(k2)
    span = torch.where(hi_v <= lo_v, 1, (hi_v - lo_v) & _MASK)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    offset = ((higher % span) * mult) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    return _wrap32(lo_v + _wrap32(offset).to(torch.int64))


@_drawn_on_the_cpu
def normal(key, shape=(), dtype=torch.float64):
    """(..., 2) keys -> (..., *shape): `jax.random.normal(key, shape,
    dtype)` for every leading index."""
    return normals(key[..., None, :], [shape], dtype)[0]


def normals(keys, shapes, dtype=torch.float64):
    """Several normal draws in one hash: keys (..., m, 2), one subkey per
    draw, and m shapes; returns the m tensors (..., *shape_j), each
    `jax.random.normal(keys[..., j, :], shape_j, dtype)`. One threefry
    evaluation over all the draws' elements, each draw's key broadcast
    over its own."""
    shapes = [tuple(s) for s in shapes]
    sizes = [math.prod(s) for s in shapes]
    which, idx = _layout(tuple(sizes), keys.device)
    k = keys.index_select(-2, which)
    z = _normal_from(_bits(k[..., 0], k[..., 1], (idx >> 32, idx & _MASK),
                           dtype), dtype)
    lead = keys.shape[:-2]
    return [part.reshape(lead + s)
            for part, s in zip(torch.split(z, sizes, -1), shapes)]
