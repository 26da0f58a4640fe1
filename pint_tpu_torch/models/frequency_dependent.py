"""Frequency-dependent (FD) profile-evolution delays.

Port of the ``FD`` component of :mod:`pint_tpu.models.frequency_dependent`
(reference `FD`, `src/pint/models/frequency_dependent.py:13`):

    delay = sum_k FDk * ln(f / 1 GHz)^k        k = 1..n

(Zhu et al. 2015 eq. 2).  ``FDJump`` is not ported yet.
"""

from __future__ import annotations

from typing import List

import torch

from pint_tpu_torch.models.parameter import prefixParameter, split_prefix
from pint_tpu_torch.models.timing_model import DelayComponent, pv, zeros_rows
from pint_tpu_torch.toabatch import TOABatch


def _log_freq_ghz(batch: TOABatch):
    """ln(f/1 GHz) with infinite-frequency rows masked to 0 contribution."""
    finite = torch.isfinite(batch.freq_mhz)
    f = torch.where(finite, batch.freq_mhz, 1000.0)
    return torch.where(finite, torch.log(f / 1000.0), 0.0), finite


class FD(DelayComponent):
    """FD polynomial in log observing frequency."""

    register = True
    category = "frequency_dependent"

    def fd_names(self) -> List[str]:
        return [p.name for p in self.prefix_params("FD")]

    def add_fd_term(self, index: int, value=0.0, frozen=True):
        return self.add_param(prefixParameter(
            "float", f"FD{index}", units="s", value=value, frozen=frozen))

    def prefix_families(self):
        return ["FD"]

    def make_param(self, name):
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "FD" and index >= 1:
            return prefixParameter("float", name, units="s")
        return None

    def validate(self):
        names = self.fd_names()
        for i, n in enumerate(names):
            if n != f"FD{i + 1}":
                raise ValueError(f"non-contiguous FD sequence at {n}")

    def linear_params(self):
        # delay = sum FDk * ln(f/1GHz)^k: exactly linear per coefficient
        return self.fd_names()

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        names = self.fd_names()
        if not names:
            return zeros_rows(batch)
        lf, finite = _log_freq_ghz(batch)
        out = zeros_rows(batch)
        term = torch.ones_like(lf)
        for n in names:
            term = term * lf
            out = out + pv(p, n) * term
        return torch.where(finite, out, 0.0)
