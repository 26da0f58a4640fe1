"""Glitches: step changes in the spin parameters with exponential recovery.

Port of :mod:`pint_tpu.models.glitch` (reference `Glitch`,
`src/pint/models/glitch.py:12`).  For each glitch index i with epoch
GLEP_i, on the TOAs after the epoch:

    dphase = GLPH_i + dt*(GLF0_i + dt/2*(GLF1_i + dt/3*GLF2_i))
             + GLF0D_i * tau_i * (1 - exp(-dt / tau_i)),  tau_i = GLTD_i 86400

with dt the delay-corrected seconds since the glitch epoch.  The ``dt >
0`` gate is a ``torch.where``, and so is the recovery's: a safe tau where
GLTD is 0, so that the value and the tangent of a TOA before the epoch,
or of a glitch without recovery, are exactly 0, as in the reference.

On CUDA this phase is a term of the ``phase_chain`` kernel's row function
(``csrc/phase_chain.cuh`` ``phase_family_row``), which forms the delay
inside its launch; :meth:`Glitch.phase_f64` is its plain version, in the
kernel's operation order.
"""

from __future__ import annotations

from typing import List

import torch

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

#: per-glitch parameter stems and their units, in the kernel's slot order
GLITCH_FAMILIES = {
    "GLEP_": ("mjd", "d"),
    "GLPH_": ("float", "cycles"),
    "GLF0_": ("float", "Hz"),
    "GLF1_": ("float", "Hz/s"),
    "GLF2_": ("float", "Hz/s^2"),
    "GLF0D_": ("float", "Hz"),
    "GLTD_": ("float", "d"),
}


class Glitch(PhaseComponent):
    register = True
    category = "glitch"

    def glitch_indices(self) -> List[int]:
        return sorted(p.index for p in self.prefix_params("GLEP_"))

    def add_glitch(self, index: int, glep, glph=0.0, glf0=0.0, glf1=0.0,
                   glf2=0.0, glf0d=0.0, gltd=0.0, frozen=True):
        """Programmatic construction of a full glitch entry."""
        self.add_param(prefixParameter("mjd", f"GLEP_{index}", value=glep))
        for stem, v in (("GLPH_", glph), ("GLF0_", glf0), ("GLF1_", glf1),
                        ("GLF2_", glf2), ("GLF0D_", glf0d), ("GLTD_", gltd)):
            kind, units = GLITCH_FAMILIES[stem]
            self.add_param(prefixParameter(
                kind, f"{stem}{index}", units=units, value=v, frozen=frozen))
        self.setup()

    def prefix_families(self):
        return list(GLITCH_FAMILIES)

    def make_param(self, name):
        try:
            prefix, _ = split_prefix(name)
        except ValueError:
            return None
        fam = GLITCH_FAMILIES.get(prefix)
        if fam is None:
            return None
        kind, units = fam
        return prefixParameter(kind, name, units=units)

    def setup(self):
        # every glitch gets the full parameter set, defaulted to 0, so that
        # the phase is uniform (reference `Glitch.setup`)
        for idx in self.glitch_indices():
            for stem, (kind, units) in GLITCH_FAMILIES.items():
                nm = f"{stem}{idx}"
                if stem != "GLEP_" and nm not in self.params:
                    self.add_param(prefixParameter(kind, nm, units=units,
                                                   value=0.0))

    def validate(self):
        for idx in self.glitch_indices():
            glf0d = self.params.get(f"GLF0D_{idx}")
            gltd = self.params.get(f"GLTD_{idx}")
            if glf0d is not None and glf0d.value not in (None, 0.0):
                if gltd is None or not gltd.value:
                    raise ValueError(
                        f"GLF0D_{idx} set but GLTD_{idx} is zero")
        for p in self.params.values():
            if p.prefix == "GLEP_" and p.value is None:
                raise ValueError(f"{p.name} needs a value")

    def phase_f64(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        idx = self.glitch_indices()
        if not idx:
            return None
        t = batch.tdb_day + batch.tdb_frac
        total = zeros_rows(batch)
        for i in idx:
            dt = (t - epoch_days(p, f"GLEP_{i}")) * SECS_PER_DAY - delay
            on = dt > 0.0
            dts = torch.where(on, dt, 0.0)
            dph = pv(p, f"GLPH_{i}") + dts * (
                pv(p, f"GLF0_{i}") + dts / 2.0 * (
                    pv(p, f"GLF1_{i}") + dts / 3.0 * pv(p, f"GLF2_{i}")))
            tau = pv(p, f"GLTD_{i}") * SECS_PER_DAY
            pos = tau > 0.0
            safe_tau = torch.where(pos, tau, 1.0)
            decay = torch.where(
                pos, pv(p, f"GLF0D_{i}") * safe_tau
                * (1.0 - torch.exp(-dts / safe_tau)), 0.0)
            total = total + torch.where(on, dph + decay, 0.0)
        return total

    def phase(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        ph = self.phase_f64(p, batch, delay, is_tzr)
        return qs.from_f64_device(zeros_rows(batch) if ph is None else ph)
