"""The `rand` generator: JAX's threefry2x32 draws, bit for bit, in torch.

The reference draws `rand` with `jax.random` (threefry2x32 keys, jax's
partitionable counter layout). The port computes the same bits with
plain torch integer ops on whatever device the runtime uses, so a seed
gives the same matrix in both packages and on the CPU and the card:

  * key — `PRNGKey(seed)` of a 64-bit seed: the high and the low 32-bit
    words of its two's complement (`prng_key`);
  * counters — element i of a draw of n elements (row-major) hashes the
    64-bit counter i, split into its high and low words, so an element's
    bits depend on its index alone and any row range can be drawn by
    itself (`row_range`);
  * bits — the 20-round threefry2x32 of (key, counter); a 64-bit draw
    takes the first output word as its high half (`random_bits64`);
  * uniform — float64 in [0, 1): the top 52 bits as the mantissa of a
    number in [1, 2), minus 1 (`uniform`);
  * normal — sqrt(2) · erfinv(u), u uniform on [nextafter(-1, 0), 1)
    (`normal`). erfinv is XLA's float64 form (Giles' polynomial in
    w = -log1p(-u²), three ranges of w); XLA's CPU code contracts the
    polynomial's steps into fused multiply-adds, so they are emulated
    here exactly from IEEE products and sums (`_fma`); its log (glibc's)
    is correctly rounded in all but ~0.04 % of cases, so `_log` computes
    a log accurate to ~2^-60 before its last rounding; and the square
    root is corrected to the correctly rounded one (`_sqrt`: torch's
    float64 sqrt is not, on the CPU). Every op is one correctly rounded
    IEEE add, multiply or divide (or exact bit work), so the CPU and the
    card give the same bits. Against jax the draws agree bit for bit but
    where glibc's log or ours misrounds (~0.002 % of normals, by at most
    a few ulp; tests/test_torch_rand.py states the limit);
  * sparsity mask — a second uniform draw from key `seed + 0x9E3779B9`
    keeps an element where it is below the density.

torch has few unsigned 32-bit ops, so the words live in int64 tensors
and every sum is masked back to 32 bits.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SPARSITY_KEY_OFFSET = 0x9E3779B9  # the mask's key: seed + this
_KS_PARITY = 0x1BD11BDA           # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3FF0000000000000    # float64 1.0


def prng_key(seed: int) -> tuple[int, int]:
    """jax's `PRNGKey(seed)` for an int64 seed: (high word, low word)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32) & MASK32, s & MASK32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of the counter words (x0, x1),
    int64 tensors holding 32-bit values; returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK32
    return x0, x1


def row_range(shape: tuple[int, ...], rows: Optional[tuple[int, int]]
              ) -> tuple[tuple[int, ...], int]:
    """(shape of the drawn block, index of its first element) for rows
    [r0, r1) of `shape` (all of it when `rows` is None)."""
    shape = tuple(int(d) for d in shape)
    if rows is None:
        return shape, 0
    r0, r1 = (int(r) for r in rows)
    if not shape or not 0 <= r0 <= r1 <= shape[0]:
        raise ValueError(f"rows {rows} outside shape {shape}")
    inner = int(np.prod(shape[1:], dtype=np.int64))
    return (r1 - r0,) + shape[1:], r0 * inner


def random_bits64(key: tuple[int, int], shape, device,
                  rows: Optional[tuple[int, int]] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """64-bit draws of `shape` (rows [r0, r1) of it when given), as
    their (high, low) 32-bit words in int64 tensors."""
    block, first = row_range(shape, rows)
    n = int(np.prod(block, dtype=np.int64))
    idx = torch.arange(first, first + n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32(key, idx >> 32, idx & MASK32)
    return hi.reshape(block), lo.reshape(block)


def _unit(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """float64 in [0, 1) from 64 random bits: the top 52 as a mantissa."""
    fb = (hi << 20) | (lo >> 12) | _ONE_BITS
    return fb.view(torch.float64) - 1.0


def uniform(seed: int, shape, device, minval: float = 0.0,
            maxval: float = 1.0, rows: Optional[tuple[int, int]] = None
            ) -> torch.Tensor:
    """jax.random.uniform(PRNGKey(seed), shape, float64, minval, maxval)."""
    u = _unit(*random_bits64(prng_key(seed), shape, device, rows))
    lo, hi = np.float64(minval), np.float64(maxval)
    return torch.clamp_min(u * float(hi - lo) + float(lo), float(lo))


# -- erfinv: XLA's float64 form ------------------------------------------

_SPLIT = 134217729.0  # 2^27 + 1: Dekker's split of a float64


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    t = _SPLIT * x
    hi = t - (t - x)
    return hi, x - hi


def _two_prod(a: torch.Tensor, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(p, e) with p = fl(a * b) and p + e = a * b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b if isinstance(b, torch.Tensor) else torch.full_like(
        a, b))
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a: torch.Tensor, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, e) with s = fl(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c with one rounding, from IEEE products and sums: the
    product's and the sum's errors added back before the last rounding.
    Exact for the operands of this module (no overflow, no underflow of
    the split)."""
    p, e = _two_prod(a, b)
    s, err = _two_sum(p, c)
    return s + (err + e)


def _sqrt(w: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of non-negative float64 values:
    the library's square root (which is not correctly rounded on every
    device: torch's on the CPU is not) corrected by one Newton step on
    its exact residual, so the CPU and the card round alike (and as
    XLA's sqrt does)."""
    s0 = torch.sqrt(w)
    p, e = _two_prod(s0, s0)
    return torch.where(w > 0.0, s0 + ((w - p) - e) / (2.0 * s0), s0)


# log: x = 2^k m, sqrt(2)/2 < m < sqrt(2) (fdlibm's reduction); ln 2 in two
# parts, k ln2_hi exact for |k| < 2^20
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_TWO_THIRDS_HI = 2.0 / 3.0
_TWO_THIRDS_LO = 3.700743415417188e-17   # 2/3 - fl(2/3), exactly rounded
# 2/(2j+1) for j = 2..14: the atanh series past its s³ term
_ATANH_TAIL = tuple(2.0 / (2 * j + 1) for j in range(14, 1, -1))


def _log(x: torch.Tensor) -> torch.Tensor:
    """The natural log of positive normal float64 values, to ~2^-60 of
    the result before its last rounding, so correctly rounded but for
    values within ~1e-4 ulp of a rounding boundary (glibc's log, which
    XLA's CPU code calls, is correctly rounded in all but ~0.04 % of
    cases). log m = 2 atanh(s), s = f / (2 + f), f = m - 1: s in double-
    double, its series' s³ term in double-double and the rest in double,
    summed with k ln 2 by exact two-sums. IEEE ops and bit work only."""
    bits = x.view(torch.int64)
    hx = bits >> 32                              # high word
    k = (hx >> 20) - 1023
    hm = hx & 0x000FFFFF
    i = (hm + 0x95F64) & 0x100000
    k = k + (i >> 20)
    # x or x/2 scaled into [sqrt(2)/2, sqrt(2)): f = m - 1 exactly
    m = (((hm | (i ^ 0x3FF00000)) << 32) | (bits & MASK32)).view(
        torch.float64)
    f = m - 1.0
    dk = k.to(torch.float64)
    # s = f / (2 + f) in double-double
    d_hi = 2.0 + f
    d_lo = f - (d_hi - 2.0)
    s_hi = f / d_hi
    p, e = _two_prod(s_hi, d_hi)
    s_lo = (((f - p) - e) - s_hi * d_lo) / d_hi
    # (2/3) s³ in double-double
    z_hi, z_lo = _two_prod(s_hi, s_hi)
    c_hi, c_lo = _two_prod(s_hi, z_hi)
    c_lo = c_lo + (s_hi * z_lo + 3.0 * z_hi * s_lo)
    l_hi, l_lo = _two_prod(c_hi, _TWO_THIRDS_HI)
    l_lo = l_lo + (c_lo * _TWO_THIRDS_HI + c_hi * _TWO_THIRDS_LO)
    # the rest of the series, (2/5) s⁵ + (2/7) s⁷ + ..., in double
    q = torch.full_like(z_hi, _ATANH_TAIL[0])
    for cf in _ATANH_TAIL[1:]:
        q = q * z_hi + cf
    tail = c_hi * z_hi * q
    # k ln2 + 2 s + (2/3) s³ + tail
    h, lo = _two_sum(dk * _LN2_HI, 2.0 * s_hi)
    h, lo2 = _two_sum(h, l_hi)
    lo = lo + lo2 + 2.0 * s_lo + (l_lo + tail + dk * _LN2_LO)
    return h + lo


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


# XLA's log1p (Cephes' rational below sqrt(2) - 1, log(1 + y) above)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(y: torch.Tensor) -> torch.Tensor:
    x2 = y * y
    small = _horner(y, _LOG1P_NUM) / _horner(y, _LOG1P_DEN)
    small = y + ((-0.5 * x2) + (y * x2) * small)
    large = _log(torch.clamp_min(y + 1.0, np.finfo(np.float64).tiny))
    return torch.where(y.abs() < 0.41421356237309504880, small, large)


# Giles' double-precision erfinv, in w < 6.25, w < 16 and beyond
_ERFINV_A = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV_B = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV_C = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 erf_inv (±inf at ±1)."""
    w = -_log1p(-(x * x))
    lt625, lt16 = w < 6.25, w < 16.0
    t = torch.where(lt625, w - 3.125,
                    _sqrt(w) - torch.where(lt16, 3.25, 5.0))

    def coeff(i):
        c = torch.full_like(x, _ERFINV_A[i])
        if i < 19:
            c = torch.where(lt625, c, _ERFINV_B[i])
        if i < 17:
            c = torch.where(lt16, c, _ERFINV_C[i])
        return c

    p = coeff(0)
    for i in range(1, 23):
        step = _fma(p, t, coeff(i))
        if i >= 19:
            step = torch.where(lt625, step, p)
        elif i >= 17:
            step = torch.where(lt16, step, p)
        p = step
    return torch.where(x.abs() == 1.0, x * np.finfo(np.float64).max, p * x)


def normal(seed: int, shape, device,
           rows: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """jax.random.normal(PRNGKey(seed), shape, float64)."""
    lo = np.nextafter(np.float64(-1.0), np.float64(0.0))
    u = uniform(seed, shape, device, float(lo), 1.0, rows)
    return float(np.sqrt(np.float64(2.0))) * erfinv(u)


def rand(shape, seed: int, dist: str = "uniform", sparsity: float = 1.0,
         device="cpu", rows: Optional[tuple[int, int]] = None
         ) -> torch.Tensor:
    """The reference's `rand` kernel: a float64 uniform or normal draw,
    zeroed where the sparsity mask (key seed + 0x9E3779B9) is not below
    `sparsity`. `rows` draws only rows [r0, r1) of it."""
    draw = normal if dist == "normal" else uniform
    out = draw(seed, shape, device, rows=rows)
    if sparsity < 1.0:
        keep = uniform(int(seed) + SPARSITY_KEY_OFFSET, shape, device,
                       rows=rows) < sparsity
        out = torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))
    return out
