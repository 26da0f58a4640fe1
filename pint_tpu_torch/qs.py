"""Quad-single arithmetic: ~90-bit extended precision from float32 words.

Port of :mod:`pint_tpu.qs`.  Absolute pulse phase needs ~70+ significant
bits (1e12 cycles tracked to <1e-9 cycles); a quadruple-f32 expansion
(four non-overlapping words) carries it.  The algorithms are the classic
QD/CAMPARY expansion operations (Hida-Li-Bailey 2001;
Joldes-Muller-Popescu 2016) with the branch-free three-pass distillation
renormalization of :func:`pint_tpu.qs._distill`, in the same operation
order, so the words come out bit-identical to :mod:`pint_tpu.qs` on
IEEE float32 (``tests/test_torch_qs.py``).

Here these functions are the *plain* version of the phase kernel
(``pint_tpu_torch/csrc/qs_phase.cu``): eager PyTorch, one operation per
launch.  Autodiff flows through the words exactly as it does in JAX.

Magnitude contract: all intermediate words must stay above the f32
subnormal cutoff (~1e-38) or below it only when exactly zero.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from pint_tpu_torch.dd import two_prod, two_sum

_NW = 4  # words

#: the same kernel registries as :mod:`pint_tpu.qs`
PAIR_KERNELS = frozenset({
    "zeros_like", "from_words", "from_f64_host", "from_dd_host",
    "from_f64_device", "to_dd", "from_dd_device", "add_w", "add",
    "neg", "sub", "mul_w", "mul", "horner_taylor", "round_nearest",
})
COLLAPSE_KERNELS = frozenset({"to_f64"})


class QS(NamedTuple):
    """A quad-single value = w0 + w1 + w2 + w3 (decreasing, non-overlapping)."""

    w0: object
    w1: object
    w2: object
    w3: object

    @property
    def words(self):
        return (self.w0, self.w1, self.w2, self.w3)

    def __add__(self, other):
        return add(self, other) if isinstance(other, QS) else add_w(self, other)

    def __sub__(self, other):
        return self + (-other)

    def __neg__(self):
        return QS(-self.w0, -self.w1, -self.w2, -self.w3)

    def __mul__(self, other):
        return mul(self, other) if isinstance(other, QS) else mul_w(self, other)


def _is_host(x) -> bool:
    return not isinstance(x, torch.Tensor)


def _distill(words: Sequence, passes: int = 3):
    """Branch-free renormalization: repeated bottom-up error-free summation
    (same order as :func:`pint_tpu.qs._distill`)."""
    ws = list(words)
    n = len(ws)
    for _ in range(passes):
        s = ws[n - 1]
        out = [None] * n
        for i in range(n - 2, -1, -1):
            s, e = two_sum(ws[i], s)
            out[i + 1] = e
        out[0] = s
        ws = out
    return ws


def _renorm(words: Sequence, passes: int = 3) -> QS:
    ws = _distill(words, passes=passes)
    return QS(*ws[:_NW])


def zeros_like(x) -> QS:
    z = x * np.float32(0.0) if _is_host(x) else x * 0
    return QS(z, z, z, z)


def from_words(w0, w1=None, w2=None, w3=None) -> QS:
    z = w0 * 0
    return _renorm([w0, w1 if w1 is not None else z, w2 if w2 is not None else z,
                    w3 if w3 is not None else z])


def from_f64_host(x) -> QS:
    """Exact conversion from true-IEEE float64 (HOST numpy only): a f64
    significand fits in three f32 words exactly; the fourth word is zero."""
    x = np.asarray(x, np.float64)
    w0 = x.astype(np.float32)
    r = x - w0.astype(np.float64)
    w1 = r.astype(np.float32)
    r2 = r - w1.astype(np.float64)
    w2 = r2.astype(np.float32)
    w3 = np.zeros_like(w2)
    return QS(w0, w1, w2, w3)


def from_dd_host(hi, lo) -> QS:
    """Conversion from a host double-double (numpy f64 pair): the top ~96
    bits of the 106-bit DD."""
    a = from_f64_host(np.asarray(hi, np.float64))
    b = from_f64_host(np.asarray(lo, np.float64))
    return add(a, b)


def from_f64_device(x: torch.Tensor) -> QS:
    """Conversion from a float64 tensor: the exact three-word split of
    :func:`from_f64_host`, then a renormalization (as in
    :func:`pint_tpu.qs.from_f64_device`)."""
    w0 = x.to(torch.float32)
    r = x - w0.to(x.dtype)
    w1 = r.to(torch.float32)
    r2 = r - w1.to(x.dtype)
    w2 = r2.to(torch.float32)
    return _renorm([w0, w1, w2, torch.zeros_like(w2)])


def to_dd(q: QS):
    """Compensated collapse to a two-float pair (:class:`pint_tpu_torch.dd.DD`
    of f32 words): hi = fl(w0+w1), lo carries the remaining words."""
    from pint_tpu_torch import dd as ddm

    s, e = two_sum(q.w0, q.w1)
    lo = e + (q.w2 + q.w3)
    s, e = two_sum(s, lo)
    return ddm.DD(s, e)


def from_dd_device(d) -> QS:
    """QS from a two-float pair of f32 words (inverse of :func:`to_dd`)."""
    return from_words(d.hi, d.lo)


def to_f64(q: QS):
    """Collapse to float64: ((w0 + w1) + w2) + w3, summed in float64."""
    if _is_host(q.w0):
        return (
            np.asarray(q.w0, np.float64)
            + np.asarray(q.w1, np.float64)
            + np.asarray(q.w2, np.float64)
            + np.asarray(q.w3, np.float64)
        )
    f64 = torch.float64
    return q.w0.to(f64) + q.w1.to(f64) + q.w2.to(f64) + q.w3.to(f64)


def add_w(q: QS, w) -> QS:
    """QS + single f32 word."""
    s0, e = two_sum(q.w0, w)
    s1, e = two_sum(q.w1, e)
    s2, e = two_sum(q.w2, e)
    s3, e = two_sum(q.w3, e)
    return _renorm([s0, s1, s2, s3, e])


def add(a: QS, b: QS) -> QS:
    """QS + QS: accumulate words (graded), then renormalize."""
    s0, e0 = two_sum(a.w0, b.w0)
    s1, e1 = two_sum(a.w1, b.w1)
    s2, e2 = two_sum(a.w2, b.w2)
    s3 = a.w3 + b.w3
    return _renorm([s0, s1, e0, s2, e1, s3, e2], passes=3)


def neg(q: QS) -> QS:
    return QS(-q.w0, -q.w1, -q.w2, -q.w3)


def sub(a: QS, b: QS) -> QS:
    return add(a, neg(b))


def mul_w(q: QS, w) -> QS:
    """QS * single f32 word."""
    p0, e0 = two_prod(q.w0, w)
    p1, e1 = two_prod(q.w1, w)
    p2, e2 = two_prod(q.w2, w)
    p3 = q.w3 * w
    return _renorm([p0, p1, e0, p2, e1, p3, e2], passes=3)


def mul(a: QS, b: QS) -> QS:
    """QS * QS, accurate to ~2^-90 relative."""
    p00, e00 = two_prod(a.w0, b.w0)
    p01, e01 = two_prod(a.w0, b.w1)
    p10, e10 = two_prod(a.w1, b.w0)
    p02, e02 = two_prod(a.w0, b.w2)
    p11, e11 = two_prod(a.w1, b.w1)
    p20, e20 = two_prod(a.w2, b.w0)
    # order-3 terms: plain products (errors are below 2^-96)
    t3 = (a.w0 * b.w3 + a.w3 * b.w0) + (a.w1 * b.w2 + a.w2 * b.w1)
    # order-4: below target precision but nearly free
    t4 = a.w1 * b.w3 + a.w2 * b.w2 + a.w3 * b.w1
    return _renorm(
        [p00, p01, p10, e00, p02, p11, p20, e01, e10, t3, e02, e11, e20, t4],
        passes=3,
    )


def horner_taylor(dt: QS, coeffs: Sequence[QS]) -> QS:
    """sum_k coeffs[k] dt^k / k! in QS (Taylor-Horner)."""
    n = len(coeffs)
    if n == 0:
        return zeros_like(dt.w0)
    fact = 1.0
    facts = []
    for k in range(n):
        facts.append(fact)
        fact *= k + 1
    acc = coeffs[-1]
    if facts[n - 1] != 1.0:
        acc = mul_w(acc, f32(1.0 / facts[n - 1], dt.w0))
    for k in range(n - 2, -1, -1):
        ck = coeffs[k]
        if facts[k] != 1.0:
            ck = mul_w(ck, f32(1.0 / facts[k], dt.w0))
        acc = add(mul(acc, dt), ck)
    return acc


def f32(v: float, like):
    """``v`` as a float32 scalar of ``like``'s kind (numpy scalar, or a
    0-dim tensor on ``like``'s device).  A word operand must carry the f32
    dtype itself: :func:`pint_tpu_torch.dd.split` picks the Dekker constant
    from it, and a bare Python float would be split at f64 width."""
    if _is_host(like):
        return np.float32(v)
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _round(x):
    return np.round(x) if _is_host(x) else torch.round(x)


def round_nearest(q: QS):
    """Split into (n, frac): n = nearest integer (an f64-exact sum of f32
    words), frac = q - n with |frac| <= 0.5 as a QS.  Round half to even
    (``torch.round``/``np.round``), as :func:`pint_tpu.qs.round_nearest`."""
    n_total = None
    r = q
    for _ in range(3):
        nk = _round(r.w0)
        r = add_w(r, -nk)
        n_total = nk if n_total is None else n_total + _to64(nk)
        n_total = _to64(n_total)
    # final adjustment from the collapsed remainder
    adj = _round(to_f64(r))
    r = add_w(r, -_to32(adj))
    n_total = n_total + adj
    return n_total, r


def _to64(x):
    if _is_host(x):
        return np.asarray(x, np.float64)
    return x.to(torch.float64)


def _to32(x):
    # integer-valued adjustment < 2^24: the cast is exact
    if _is_host(x):
        return np.asarray(x, np.float32)
    return x.to(torch.float32)
