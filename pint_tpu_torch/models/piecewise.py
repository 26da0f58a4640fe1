"""PiecewiseSpindown: interval-local spin-parameter corrections.

Port of :mod:`pint_tpu.models.piecewise` (reference `PiecewiseSpindown`,
`src/pint/models/piecewise.py:12`).  Each group i has an epoch PWEP_i, a
window [PWSTART_i, PWSTOP_i] (inclusive at both ends, over the TOAs' UTC
MJDs) and local corrections PWPH_i/PWF0_i/PWF1_i/PWF2_i; inside its
window:

    dphase = PWPH + dt*(PWF0 + dt/2*(PWF1 + dt/3*PWF2)),

dt the delay-corrected seconds since PWEP.  Windows may overlap: each
group adds its own sum.  The windows' masks are built on the host; a
batch without them (a TOA set whose masks were not built) gets nothing
from the group.

On CUDA this phase is a term of the ``phase_chain`` kernel's row function
(``csrc/phase_chain.cuh`` ``phase_family_row``), which reads each TOA's
groups as one bit word (``__pwbits__``, bit i for the i-th group);
:meth:`PiecewiseSpindown.phase_f64` is its plain version, in the kernel's
operation order.
"""

from __future__ import annotations

from typing import List

import numpy as np

from pint_tpu_torch import qs
from pint_tpu_torch.models.parameter import prefixParameter, split_prefix
from pint_tpu_torch.models.timing_model import (
    PhaseComponent,
    epoch_days,
    pv,
    zeros_rows,
)
from pint_tpu_torch.toabatch import TOABatch

SECS_PER_DAY = 86400.0

#: the most groups one int32 bit word per TOA carries (the kernel's
#: ``__pwbits__``)
MAX_GROUPS = 31
#: the mask entry of the groups' bits
PW_BITS = "__pwbits__"

PW_FAMILIES = {
    "PWEP_": ("mjd", "d"),
    "PWSTART_": ("mjd", "d"),
    "PWSTOP_": ("mjd", "d"),
    "PWPH_": ("float", "cycles"),
    "PWF0_": ("float", "Hz"),
    "PWF1_": ("float", "Hz/s"),
    "PWF2_": ("float", "Hz/s^2"),
}


class PiecewiseSpindown(PhaseComponent):
    register = True
    category = "piecewise_spindown"

    def group_indices(self) -> List[int]:
        return sorted(p.index for p in self.prefix_params("PWEP_"))

    def add_group(self, index: int, ep, start, stop, pwph=0.0, pwf0=0.0,
                  pwf1=0.0, pwf2=0.0, frozen=True):
        self.add_param(prefixParameter("mjd", f"PWEP_{index}", value=ep))
        self.add_param(prefixParameter("mjd", f"PWSTART_{index}", value=start))
        self.add_param(prefixParameter("mjd", f"PWSTOP_{index}", value=stop))
        for stem, v in (("PWPH_", pwph), ("PWF0_", pwf0), ("PWF1_", pwf1),
                        ("PWF2_", pwf2)):
            kind, units = PW_FAMILIES[stem]
            self.add_param(prefixParameter(kind, f"{stem}{index}",
                                           units=units, value=v,
                                           frozen=frozen))
        self.setup()

    def prefix_families(self):
        return list(PW_FAMILIES)

    def make_param(self, name):
        try:
            prefix, _ = split_prefix(name)
        except ValueError:
            return None
        fam = PW_FAMILIES.get(prefix)
        if fam is None:
            return None
        kind, units = fam
        return prefixParameter(kind, name, units=units)

    def setup(self):
        for idx in self.group_indices():
            for stem in ("PWPH_", "PWF0_", "PWF1_", "PWF2_"):
                nm = f"{stem}{idx}"
                if nm not in self.params:
                    kind, units = PW_FAMILIES[stem]
                    self.add_param(prefixParameter(kind, nm, units=units,
                                                   value=0.0))

    def validate(self):
        for idx in self.group_indices():
            for stem in ("PWSTART_", "PWSTOP_"):
                par = self.params.get(f"{stem}{idx}")
                if par is None or par.value is None:
                    raise ValueError(f"PWEP_{idx} needs {stem}{idx}")

    def mask_entries(self, toas):
        """Each group's window mask over the TOAs' UTC MJDs (inclusive),
        and the groups' bits per TOA (bit i for the i-th group) that the
        phase kernel reads, up to :data:`MAX_GROUPS` groups."""
        out = super().mask_entries(toas)
        m = toas.utc.mjd_float
        groups = self.group_indices()
        bits = np.zeros(len(m), np.int32)
        for j, idx in enumerate(groups):
            r1 = self.params[f"PWSTART_{idx}"].mjd_float
            r2 = self.params[f"PWSTOP_{idx}"].mjd_float
            sel = (m >= r1) & (m <= r2)
            out[f"PWEP_{idx}__rangemask"] = sel.astype(np.float64)
            if j < MAX_GROUPS:
                bits |= sel.astype(np.int32) << j
        if groups and len(groups) <= MAX_GROUPS:
            out[PW_BITS] = bits
        return out

    def phase_f64(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        idx = self.group_indices()
        if not idx:
            return None
        t = batch.tdb_day + batch.tdb_frac
        total = zeros_rows(batch)
        for i in idx:
            mask = p["mask"].get(f"PWEP_{i}__rangemask")
            if mask is None:
                continue
            dt = (t - epoch_days(p, f"PWEP_{i}")) * SECS_PER_DAY - delay
            dph = pv(p, f"PWPH_{i}") + dt * (
                pv(p, f"PWF0_{i}") + dt / 2.0 * (
                    pv(p, f"PWF1_{i}") + dt / 3.0 * pv(p, f"PWF2_{i}")))
            total = total + mask * dph
        return total

    def phase(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        ph = self.phase_f64(p, batch, delay, is_tzr)
        return qs.from_f64_device(zeros_rows(batch) if ph is None else ph)
