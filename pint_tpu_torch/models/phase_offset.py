"""An explicit overall phase offset (PHOFF).

Port of :mod:`pint_tpu.models.phase_offset` (reference `PhaseOffset`,
`src/pint/models/phase_offset.py:10`): the TOAs get ``-PHOFF`` cycles,
the TZR TOA none (the offset would cancel in the TZR subtraction).  A
model with PHOFF has no residual mean subtraction and no offset column in
its fits (:class:`pint_tpu_torch.residuals.Residuals`, the fitters).  Its
phase does not read the delay, so the ``phase_chain`` kernel takes it in
its ``other`` input, as the phase JUMPs.
"""

from __future__ import annotations

import torch

from pint_tpu_torch import qs
from pint_tpu_torch.models.parameter import FloatParam
from pint_tpu_torch.models.timing_model import PhaseComponent, pv, zeros_rows
from pint_tpu_torch.toabatch import TOABatch


class PhaseOffset(PhaseComponent):
    register = True
    category = "phase_offset"
    phase_f64_reads_delay = False

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam("PHOFF", value=0.0, units="",
                                  description="Overall phase offset"))

    def phase_f64(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        if is_tzr:
            return None
        return -pv(p, "PHOFF") * torch.ones(
            batch.ntoas, dtype=torch.float64, device=batch.device)

    def phase(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        ph = self.phase_f64(p, batch, delay, is_tzr)
        return qs.from_f64_device(zeros_rows(batch) if ph is None else ph)
