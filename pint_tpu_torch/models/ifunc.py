"""IFUNC: tabulated, interpolated phase offsets (tempo2's ifunc).

Port of :mod:`pint_tpu.models.ifunc` (reference `IFunc`,
`src/pint/models/ifunc.py:11`).  SIFUNC selects the interpolation: 0
takes the nearest preceding point (TOAs before the first point take the
first), 2 is linear, clamped at both ends.  IFUNC<i> are (MJD, seconds)
pairs, and the phase is interp(t) * F0, t the TOA's TDB MJD less the
delay.  As in the reference, the abscissa is barycentric TDB (tempo2
uses sidereal time).

On CUDA this phase is a term of the ``phase_chain`` kernel's row function
(``csrc/phase_chain.cuh`` ``phase_family_row``: a binary search over the
points, kept in a small device buffer); :meth:`IFunc.phase_f64` is its
plain version, in the kernel's operation order.
"""

from __future__ import annotations

import torch

from pint_tpu_torch import qs
from pint_tpu_torch.models.parameter import (
    FloatParam,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import PhaseComponent, pv, zeros_rows
from pint_tpu_torch.toabatch import TOABatch

SECS_PER_DAY = 86400.0


class IFunc(PhaseComponent):
    register = True
    category = "ifunc"

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam("SIFUNC", units="",
                                  description="Interpolation type (0|2)"))

    def ifunc_names(self):
        return [p.name for p in self.prefix_params("IFUNC")]

    def add_ifunc_point(self, index: int, mjd: float, dt_sec: float,
                        frozen=True):
        return self.add_param(prefixParameter(
            "pair", f"IFUNC{index}", units="s", value=(mjd, dt_sec),
            frozen=frozen))

    def prefix_families(self):
        return ["IFUNC"]

    def make_param(self, name):
        try:
            prefix, _ = split_prefix(name)
        except ValueError:
            return None
        if prefix == "IFUNC":
            return prefixParameter("pair", name, units="s")
        return None

    def validate(self):
        if self.ifunc_names():
            if self.SIFUNC.value is None:
                raise ValueError("IFUNC points require SIFUNC")
            if int(self.SIFUNC.value) not in (0, 2):
                raise ValueError(
                    f"SIFUNC {self.SIFUNC.value} not supported (0|2; sinc "
                    "interpolation is unsupported, as in the reference)")
            mjds = [self.params[n].value[0] for n in self.ifunc_names()]
            if sorted(mjds) != mjds:
                raise ValueError("IFUNC control points must be MJD-sorted")

    def linear_params(self):
        # interp(y; t) * F0 is linear in the pair-valued points' ordinates,
        # which TimingModel.linear_param_names leaves out (a pair does not
        # ride the flat fit vector; the abscissae are not linear)
        return self.ifunc_names()

    def points(self, p: dict):
        """The (k, 2) control points (MJD, seconds)."""
        return torch.stack([pv(p, n) for n in self.ifunc_names()])

    def phase_f64(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        names = self.ifunc_names()
        if not names:
            return None
        pts = self.points(p)
        x, y = pts[:, 0].contiguous(), pts[:, 1]
        ts = batch.tdb_day + batch.tdb_frac - delay / SECS_PER_DAY
        last = len(names) - 1
        if int(self.SIFUNC.value) == 0:
            # the nearest preceding point; TOAs before the first take y[0]
            idx = torch.clamp(torch.searchsorted(
                x, ts.detach().contiguous(), right=True) - 1, 0, last)
            times = y[idx]
        else:
            # linear, clamped at the ends
            idx = torch.clamp(torch.searchsorted(
                x, ts.detach().contiguous()), 1, last)
            x0, x1 = x[idx - 1], x[idx]
            y0, y1 = y[idx - 1], y[idx]
            w = torch.clamp((ts - x0) / (x1 - x0), 0.0, 1.0)
            times = y0 * (1.0 - w) + y1 * w
        return times * pv(p, "F0")

    def phase(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        ph = self.phase_f64(p, batch, delay, is_tzr)
        return qs.from_f64_device(zeros_rows(batch) if ph is None else ph)
