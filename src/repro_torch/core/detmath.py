"""Float64 arithmetic that rounds the same on the CPU and on the card.

The BDF step-size controller amplifies last-bit differences into different
step sequences (ROADMAP §3), so the CPU run and the card run of the port
agree only if every operation of the step rounds identically on both.
Plain PyTorch does not give that:

* ``torch.sum``/``mean`` reduce in a device-specific order;
* ``exp``, ``expm1``, ``log`` and ``pow`` come from different math
  libraries (vectorised CPU code vs CUDA's libdevice), each within an ulp
  or two of the true value but not the same ulp, and even float64
  ``sqrt`` differs in the last bit for about 1% of inputs;
* on CUDA ``tensor / python_float`` is computed as a multiplication by the
  reciprocal, on the CPU as a true division.

This module supplies the replacements the neuron core uses: sums in one
fixed pairwise order, a fused multiply-add where the JAX reference's
compiled code contracts one (``fma``), and exp/expm1/log/pow/sqrt built
from IEEE adds,
multiplies, divisions, rounding and bit moves only (Cody-Waite reduction
plus Taylor polynomials in Horner form; Newton's iteration for sqrt).
``csrc/hh_rhs.cu`` repeats ``exp`` and ``expm1`` operation for operation
(built with ``-fmad=false``), so the HH-RHS kernel and its plain version
agree bit for bit.  Division by a constant is written as multiplication
by its reciprocal everywhere in the core.  The functions are within two
ulp of the correctly rounded values over the ranges the model visits.
"""
from __future__ import annotations

import torch

LN2_HI = 0.6931471803691238          # high bits of ln 2 (k * LN2_HI exact)
LN2_LO = 1.9082149292705877e-10
INV_LN2 = 1.4426950408889634
EXP_CLAMP = 708.0                    # keeps 2**k a normal double
# 1/k!, k = 0..13: exp(r) for |r| <= ln2/2 to below one ulp
EXP_C = (1.0, 1.0, 0.5, 0.16666666666666666, 0.041666666666666664,
         0.008333333333333333, 0.001388888888888889, 0.0001984126984126984,
         2.48015873015873e-05, 2.7557319223985893e-06, 2.755731922398589e-07,
         2.505210838544172e-08, 2.08767569878681e-09, 1.6059043836821613e-10)
# 1/(k+1)!, k = 0..16: expm1(x) = x * q(x) for |x| < 0.5
EXPM1_C = EXP_C[1:] + (1.1470745597729725e-11, 7.647163731819816e-13,
                       4.779477332387385e-14, 2.8114572543455206e-15)
EXPM1_SMALL = 0.5
# 1/(2k+1), k = 0..11: log(m) = 2 s (1 + s^2/3 + ...), s = (m-1)/(m+1)
LOG_C = tuple(1.0 / (2 * k + 1) for k in range(12))
SQRT2 = 1.4142135623730951
_MANT = (1 << 52) - 1
_ONE_BITS = 1023 << 52


def fixed_sum(x):
    """Sum over the last axis in a device-independent pairwise order: pad
    to a power of two with zeros, then add the upper half onto the lower
    half until one column is left."""
    n = x.shape[-1]
    width = 1
    while width < n:
        width *= 2
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def fixed_mean(x):
    return fixed_sum(x) * (1.0 / x.shape[-1])


SPLIT = 134217729.0                  # 2**27 + 1, Veltkamp's splitter


def _split(a):
    """a = hi + lo exactly, each half with at most 26 significant bits."""
    c = SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def fma(a, b, c):
    """a * b + c rounded once, as XLA's CPU backend computes a contracted
    multiply-add: the product's exact error (Dekker's two-product) and the
    sum's (two-sum) are added back before the final rounding.  Exact but
    for double-rounding ties of the error terms (relative size 2**-106).
    ``b`` and ``c`` may be Python floats."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = al * bl - (((p - ah * bh) - al * bh) - ah * bl)
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _horner(coeffs, x):
    p = torch.full_like(x, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        p = p * x + c
    return p


def _pow2(k):
    """2**k for integral float64 k in the normal range, by building the
    exponent bits."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def exp(x):
    x = torch.clamp(x, -EXP_CLAMP, EXP_CLAMP)
    k = torch.round(x * INV_LN2)
    r = (x - k * LN2_HI) - k * LN2_LO
    return _horner(EXP_C, r) * _pow2(k)


def expm1(x):
    small = torch.abs(x) < EXPM1_SMALL
    return torch.where(small, x * _horner(EXPM1_C, x), exp(x) - 1.0)


def log(x):
    """Natural log of positive normal x (0 maps to about -709)."""
    bits = x.view(torch.int64)
    e = ((bits >> 52) & 0x7FF) - 1023
    m = ((bits & _MANT) | _ONE_BITS).view(torch.float64)     # [1, 2)
    big = m > SQRT2
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int64)).to(torch.float64)
    s = (m - 1.0) / (m + 1.0)
    log_m = (2.0 * s) * _horner(LOG_C, s * s)
    return e * LN2_HI + (log_m + e * LN2_LO)


def sqrt(x):
    """Square root of x >= 0: Newton's iteration from an exponent-halving
    bit estimate (within 6%), five steps to the last bit."""
    y = ((x.view(torch.int64) >> 1) + (1023 << 51)).view(torch.float64)
    for _ in range(5):
        y = 0.5 * (y + x / y)
    return torch.where(x == 0.0, 0.0, y)


def pow(x, y):
    """x ** y for x >= 0 (x = 0 gives a tiny positive value for y > 0)."""
    return exp(y * log(x))
