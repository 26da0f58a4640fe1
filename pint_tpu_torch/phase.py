"""Exact pulse phase as (integer, fractional) pairs.

The port of :mod:`pint_tpu.phase` (the reference's ``Phase`` namedtuple,
`src/pint/phase.py:7`): the integer part is an exact-integer-valued
float64 tensor (exact up to 2^53 cycles; pulsar phases are below ~1e12)
and the fractional part a float64 tensor in [-0.5, 0.5].  Arithmetic
renormalizes so that the fraction never loses precision to the large
integer part.  Plain PyTorch on the inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pint_tpu_torch import dd as ddm
from pint_tpu_torch.dd import DD

F64 = torch.float64


class Phase(NamedTuple):
    """Pulse phase split as int + frac, frac in [-0.5, 0.5]."""

    int: torch.Tensor
    frac: torch.Tensor

    def __add__(self, other):
        other = _as_phase(other)
        return _normalize(self.int + other.int, self.frac + other.frac)

    def __sub__(self, other):
        other = _as_phase(other)
        return _normalize(self.int - other.int, self.frac - other.frac)

    def __neg__(self):
        return Phase(-self.int, -self.frac)

    @property
    def quantity(self):
        return self.int + self.frac

    def to_dd(self) -> DD:
        return ddm.sum_ff(self.int, self.frac)


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64)


def _as_phase(x) -> Phase:
    if isinstance(x, Phase):
        return x
    return from_float(x)


def _normalize(i, f) -> Phase:
    i, f = _f64(i), _f64(f)
    k = torch.round(f)
    return Phase(i + k, f - k)


def from_float(x) -> Phase:
    """Split a float64 phase into (int, frac)."""
    x = _f64(x)
    i = torch.round(x)
    return Phase(i, x - i)


def from_dd(x: DD) -> Phase:
    """Split a double-double phase into (int, frac) with frac error
    ~1e-32."""
    n, r = ddm.round_nearest(x)
    return Phase(n, ddm.to_float(r))


def zeros(shape=()) -> Phase:
    z = torch.zeros(shape, dtype=F64)
    return Phase(z, z)
