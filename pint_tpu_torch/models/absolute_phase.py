"""Absolute phase reference: the TZR (zero-phase) TOA.

Port of :mod:`pint_tpu.models.absolute_phase`.

Reference: `AbsPhase` (`src/pint/models/absolute_phase.py:12`).
TZRMJD/TZRSITE/TZRFRQ define a fiducial arrival time at which the pulse phase
is zero; `TimingModel.phase` subtracts the model phase of this synthetic TOA.
Host-side, the TZR TOA runs through the same clock/TDB/posvel pipeline as any
other TOA and is cached as a 1-row TOABatch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pint_tpu_torch.exceptions import MissingParameter
from pint_tpu_torch.models.parameter import FloatParam, MJDParam, StrParam
from pint_tpu_torch.models.timing_model import PhaseComponent


class AbsPhase(PhaseComponent):
    register = True
    category = "absolute_phase"
    phase_f64_reads_delay = False

    def __init__(self):
        super().__init__()
        self.add_param(MJDParam("TZRMJD",
                                description="Epoch of the zero-phase TOA"))
        self.add_param(StrParam("TZRSITE",
                                description="Observatory of the zero-phase TOA"))
        self.add_param(FloatParam("TZRFRQ", units="MHz",
                                  description="Frequency of the zero-phase TOA"))
        self._cache: Optional[Tuple[tuple, object, object]] = None

    def validate(self):
        if self.TZRMJD.value is None:
            raise MissingParameter(
                "TZRMJD is required to compute absolute phase")
        if self.TZRSITE.value is None:
            self.TZRSITE.value = "@"
        if self.TZRFRQ.value in (None, 0.0):
            self.TZRFRQ.value = float("inf")

    def make_tzr_toas(self, ephem="DE421", planets=False):
        """The TZR TOA as a prepared 1-row host TOAs object."""
        from pint_tpu_torch.toa import get_TOAs_array

        self.validate()
        key = (self.TZRMJD.value_as_string(), self.TZRSITE.value,
               self.TZRFRQ.value, ephem, planets)
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        t = get_TOAs_array(self.TZRMJD.value, obs=self.TZRSITE.value,
                           errors_us=0.0,
                           freqs_mhz=self.TZRFRQ.value, ephem=ephem,
                           planets=planets)
        self._cache = (key, t)
        return t

    def make_tzr_batch(self, ephem="DE421", planets=False, toas=None,
                       device=None):
        # policy="off": the TZR reference TOA carries a deliberate zero
        # uncertainty (it is a phase reference, never whitened), which
        # the user-facing validation policies would reject
        return self.make_tzr_toas(ephem=ephem, planets=planets).to_batch(
            policy="off", device=device)

    def phase(self, p, batch, delay, is_tzr=False):
        """AbsPhase defines the reference TOA; it adds no phase itself."""
        import torch

        from pint_tpu_torch import qs

        return qs.zeros_like(torch.zeros(batch.ntoas, dtype=torch.float32,
                                         device=batch.device))

    def phase_f64(self, p, batch, delay, is_tzr=False):
        return None

    def set_tzr_from_toas(self, toas):
        """Default the TZR to the first TOA (what the reference does when a
        model lacks AbsPhase, `src/pint/models/timing_model.py:1689`)."""
        i = int(np.argmin(toas.utc.mjd_float))
        self.TZRMJD.set_value(toas.utc.mjd_float[i])
        self.TZRSITE.value = str(toas.obs[i])
        self.TZRFRQ.value = float(toas.freq_mhz[i])
