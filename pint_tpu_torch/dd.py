"""Double-word arithmetic as backend-generic error-free transforms.

Port of :mod:`pint_tpu.dd`.  The algorithms (Dekker 1971; Knuth TAOCP v2;
Hida, Li & Bailey's QD algorithms) use only ``+ - *`` plus a dtype-aware
Dekker split constant, so the same code runs on numpy float64 arrays (host
precompute, ~106-bit DD) and on torch tensors of either float width.

No guard primitive: :mod:`pint_tpu.dd` pins every transform's output words
against XLA's value-changing simplifier rewrites; eager PyTorch executes
one operation per call, exactly as written, so nothing rewrites them here.
A fused form of these transforms (a CUDA kernel, see
``pint_tpu_torch/csrc/qs_phase.cu``) must be compiled without FMA
contraction or reassociation instead; ``torch.compile`` is never used on
them for the same reason.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

Arrayish = Union[float, np.ndarray, torch.Tensor]

# Dekker splitting constants: 2^ceil(p/2) + 1 for p-bit significands.
_SPLIT_F64 = 134217729.0  # 2^27 + 1
_SPLIT_F32 = 4097.0  # 2^12 + 1

#: the same kernel registries as :mod:`pint_tpu.dd`: pair-preserving
#: transfer functions vs functions that discard the compensation word
PAIR_KERNELS = frozenset({
    "two_sum", "quick_two_sum", "split", "two_prod", "from_float",
    "from_two", "normalize", "add", "add_f", "sub", "mul", "mul_f",
    "prod_ff", "sum_ff", "div", "neg", "sq", "scale_pow2",
    "round_nearest", "floor", "horner", "horner_plain", "where",
    "weighted_mean", "mean", "from_string", "self_check",
})
COLLAPSE_KERNELS = frozenset({"to_float", "astype_float"})


def _split_const(a):
    dt = getattr(a, "dtype", None)
    if dt is not None and dt in (np.float32, torch.float32):
        return _SPLIT_F32
    return _SPLIT_F64


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b) and a+b = s+e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|: (s, e) with a+b = s+e exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split into high/low half-width parts (exact)."""
    t = _split_const(a) * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free product: (p, e) with p = fl(a*b) and a*b = p+e exactly."""
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


class DD(NamedTuple):
    """A double-word number: value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: Arrayish
    lo: Arrayish

    def __add__(self, other):
        return add(self, _coerce(other, self))

    def __radd__(self, other):
        return add(_coerce(other, self), self)

    def __sub__(self, other):
        return sub(self, _coerce(other, self))

    def __rsub__(self, other):
        return sub(_coerce(other, self), self)

    def __mul__(self, other):
        return mul(self, _coerce(other, self))

    def __rmul__(self, other):
        return mul(_coerce(other, self), self)

    def __truediv__(self, other):
        return div(self, _coerce(other, self))

    def __neg__(self):
        return DD(-self.hi, -self.lo)

    @property
    def shape(self):
        return tuple(self.hi.shape) if isinstance(self.hi, torch.Tensor) \
            else np.shape(self.hi)

    def astype_float(self):
        return self.hi + self.lo


def _coerce(x, like: DD) -> DD:
    if isinstance(x, DD):
        return x
    z = like.hi * 0
    return DD(z + x, z)


def from_float(x) -> DD:
    """Promote a float array/scalar to DD exactly (lo = 0)."""
    return DD(x, x * 0)


def from_two(hi, lo) -> DD:
    """Build a normalized DD from an unnormalized two-float sum hi+lo."""
    s, e = two_sum(hi, lo)
    return DD(s, e)


def from_string(s: str):
    """Host-side: parse a decimal string to an exact (hi, lo) float64 pair."""
    from decimal import Decimal, getcontext

    getcontext().prec = 50
    d = Decimal(s)
    hi = float(d)
    lo = float(d - Decimal(hi))
    return DD(np.float64(hi), np.float64(lo))


def to_float(x: DD):
    return x.hi + x.lo


def normalize(x: DD) -> DD:
    s, e = quick_two_sum(x.hi, x.lo)
    return DD(s, e)


def add(x: DD, y: DD) -> DD:
    """DD + DD (QD 'ieee_add' accurate variant)."""
    s1, s2 = two_sum(x.hi, y.hi)
    t1, t2 = two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    s1, s2 = quick_two_sum(s1, s2)
    return DD(s1, s2)


def add_f(x: DD, f) -> DD:
    """DD + float."""
    s1, s2 = two_sum(x.hi, f)
    s2 = s2 + x.lo
    s1, s2 = quick_two_sum(s1, s2)
    return DD(s1, s2)


def sub(x: DD, y: DD) -> DD:
    return add(x, DD(-y.hi, -y.lo))


def mul(x: DD, y: DD) -> DD:
    """DD * DD."""
    p1, p2 = two_prod(x.hi, y.hi)
    p2 = p2 + (x.hi * y.lo + x.lo * y.hi)
    p1, p2 = quick_two_sum(p1, p2)
    return DD(p1, p2)


def mul_f(x: DD, f) -> DD:
    """DD * float."""
    p1, p2 = two_prod(x.hi, f)
    p2 = p2 + x.lo * f
    p1, p2 = quick_two_sum(p1, p2)
    return DD(p1, p2)


def prod_ff(a, b) -> DD:
    """float * float -> exact DD."""
    p, e = two_prod(a, b)
    return DD(p, e)


def sum_ff(a, b) -> DD:
    """float + float -> exact DD."""
    s, e = two_sum(a, b)
    return DD(s, e)


def div(x: DD, y: DD) -> DD:
    """DD / DD via Newton-corrected long division (QD algorithm)."""
    q1 = x.hi / y.hi
    r = add(x, -mul_f(y, q1))
    q2 = r.hi / y.hi
    r = add(r, -mul_f(y, q2))
    q3 = r.hi / y.hi
    q1_, q2_ = quick_two_sum(q1, q2)
    return add_f(DD(q1_, q2_), q3)


def neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def sq(x: DD) -> DD:
    return mul(x, x)


def scale_pow2(x: DD, k) -> DD:
    """Exact multiply by a power of two."""
    return DD(x.hi * k, x.lo * k)


def _xp(x):
    """numpy-or-torch dispatch for the few non-arithmetic ops."""
    return torch if isinstance(x, torch.Tensor) else np


def round_nearest(x: DD):
    """Round-to-nearest-integer of a DD; returns (n: exact-int float, frac: DD).

    n is the nearest integer to hi+lo and frac = x - n (|frac| <= 0.5).
    ``round`` is round-half-to-even in both numpy and torch, as in
    :func:`pint_tpu.dd.round_nearest`.
    """
    xp = _xp(x.hi)
    n = xp.round(x.hi)
    r = add_f(x, -n)
    adj = xp.round(r.hi + r.lo)
    n = n + adj
    r = add_f(r, -adj)
    return n, r


def floor(x: DD):
    """Floor of a DD; returns (n: exact-int float, frac: DD in [0,1))."""
    xp = _xp(x.hi)
    n = xp.floor(x.hi)
    r = add_f(x, -n)
    adj = xp.floor(r.hi + r.lo)
    n = n + adj
    r = add_f(r, -adj)
    return n, r


def horner(dt: DD, coeffs) -> DD:
    """Evaluate sum_k coeffs[k] * dt^k / k!  in DD (Taylor-Horner).

    ``coeffs`` is a sequence of scalars / arrays (float or DD), lowest
    order first, WITHOUT factorial division."""
    n = len(coeffs)
    if n == 0:
        return from_float(dt.hi * 0)
    fact = 1.0
    facts = []
    for k in range(n):
        facts.append(fact)
        fact *= k + 1
    acc = _as_dd(coeffs[-1], dt)
    if facts[n - 1] != 1.0:
        acc = mul_f(acc, 1.0 / facts[n - 1])
    for k in range(n - 2, -1, -1):
        ck = _as_dd(coeffs[k], dt)
        if facts[k] != 1.0:
            ck = mul_f(ck, 1.0 / facts[k])
        acc = add(mul(acc, dt), ck)
    return acc


def horner_plain(dt: DD, coeffs) -> DD:
    """Plain Horner: c0 + c1 dt + c2 dt^2 + ... in DD."""
    n = len(coeffs)
    if n == 0:
        return from_float(dt.hi * 0)
    acc = _as_dd(coeffs[-1], dt)
    for k in range(n - 2, -1, -1):
        acc = add(mul(acc, dt), _as_dd(coeffs[k], dt))
    return acc


def _as_dd(x, like: DD) -> DD:
    return x if isinstance(x, DD) else _coerce(x, like)


def where(cond, x: DD, y: DD) -> DD:
    xp = _xp(x.hi)
    return DD(xp.where(cond, x.hi, y.hi), xp.where(cond, x.lo, y.lo))


def weighted_mean(x: DD, w) -> DD:
    """Weighted mean of a DD vector, as a DD (compensated reduction): the
    hi and lo words are reduced separately and renormalized into a pair."""
    xp = _xp(x.hi)
    sw = xp.sum(w)
    return from_two(xp.sum(x.hi * w) / sw, xp.sum(x.lo * w) / sw)


def mean(x: DD) -> DD:
    """Unweighted mean of a DD vector, as a DD (compensated reduction)."""
    xp = _xp(x.hi)
    n = x.hi * 0 + 1
    return from_two(xp.sum(x.hi) / xp.sum(n), xp.sum(x.lo) / xp.sum(n))


def self_check() -> bool:
    """Verify error-free transforms hold on host numpy (true IEEE f64)."""
    a = np.float64(999999999999999.0)
    b = np.float64(-878345505234691.4)
    s, e = two_sum(a, b)
    ok = float(s) + float(e) == float(a) + float(b) and float(s) == float(a + b)
    p, ep = two_prod(np.float64(1.0 + 2.0**-30), np.float64(1.0 + 2.0**-31))
    ok &= ep != 0.0 or p == (1.0 + 2.0**-30) * (1.0 + 2.0**-31)
    return bool(ok)
