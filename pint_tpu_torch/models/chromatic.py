"""Chromatic (variable frequency-index) delays: the CM polynomial and CMX.

Port of :mod:`pint_tpu.models.chromatic` (reference `ChromaticCM` /
`ChromaticCMX`, `src/pint/models/chromatic_model.py:118,313`):

    delay = DMconst * CM(t) * (f/MHz)^(-TNCHROMIDX)

the generalization of dispersion (TNCHROMIDX 2 is DM) that models
scattering-like chromatic variations (typical index 4).  CM carries
Taylor derivatives about CMEPOCH; CMX are piecewise-constant offsets over
inclusive MJD ranges, built as DMX's are (host range masks, and the two
ranges of each TOA that the delay kernel reads).

On CUDA these delays are terms of the ``delay_chain`` kernel's row
function (``csrc/delay_chain.cuh``); the functions here are its plain
version, written in the kernel's operation order.
"""

from __future__ import annotations

import torch

from pint_tpu_torch import DMconst
from pint_tpu_torch.models.parameter import (
    FloatParam,
    MJDParam,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import (
    DelayComponent,
    epoch_days,
    pv,
    range_entries,
    zeros_rows,
)
from pint_tpu_torch.toabatch import TOABatch
from pint_tpu_torch.utils import taylor_horner

SECS_PER_YEAR = 365.25 * 86400.0
#: the delay kernel's CMX range index of each TOA
#: (kernels/delay_chain.py CMX_INDEX)
CMX_INDEX = "__cmxidx__"


def chromatic_delay(cm, alpha, freq_mhz):
    """DMconst * cm * f^-alpha [s] with infinite-frequency rows zeroed."""
    finite = torch.isfinite(freq_mhz)
    f = torch.where(finite, freq_mhz, 1.0)
    return torch.where(finite, DMconst * cm * f**(-alpha), 0.0)


class ChromaticCM(DelayComponent):
    """Chromatic-measure Taylor polynomial (CM, CM1, ... about CMEPOCH)."""

    register = True
    category = "chromatic_constant"

    def __init__(self):
        super().__init__()
        cm = FloatParam("CM", value=0.0, units="pc cm^-3 MHz^(alpha-2)",
                        description="Chromatic measure")
        cm.prefix, cm.index = "CM", 0
        self.add_param(cm)
        self.add_param(FloatParam("TNCHROMIDX", value=4.0, units="",
                                  description="Chromatic index alpha"))
        self.add_param(MJDParam("CMEPOCH", description="CM reference epoch"))

    def cm_names(self):
        return [p.name for p in self.prefix_params("CM")]

    def epoch_name(self) -> str:
        return "CMEPOCH" if self.CMEPOCH.value is not None else "PEPOCH"

    def make_param(self, name):
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "CM" and index >= 1:
            return prefixParameter(
                "float", name, units=f"pc cm^-3 MHz^(alpha-2) yr^-{index}",
                par2dev=SECS_PER_YEAR ** -index)
        return None

    def validate(self):
        if len(self.cm_names()) > 1 and self.CMEPOCH.value is None:
            if self._parent is None or self._parent.PEPOCH.value is None:
                raise ValueError("CMEPOCH required for CM derivatives")

    def cm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        names = self.cm_names()
        coeffs = [pv(p, n) for n in names]
        if len(names) == 1:
            return torch.broadcast_to(coeffs[0], (batch.ntoas,))
        day0 = epoch_days(p, self.epoch_name())
        dt_sec = (batch.tdb_day + batch.tdb_frac - day0) * 86400.0
        return taylor_horner(dt_sec, coeffs)

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return chromatic_delay(self.cm_value(p, batch), pv(p, "TNCHROMIDX"),
                               batch.freq_mhz)


class ChromaticCMX(DelayComponent):
    """Piecewise-constant CM offsets over MJD ranges (CMX_####, CMXR1_####,
    CMXR2_####)."""

    register = True
    category = "chromatic_cmx"

    def add_cmx_range(self, index: int, r1_mjd, r2_mjd, value=0.0,
                      frozen=True):
        self.add_param(prefixParameter(
            "float", f"CMX_{index:04d}", units="pc cm^-3 MHz^(alpha-2)",
            value=value, frozen=frozen))
        self.add_param(prefixParameter("mjd", f"CMXR1_{index:04d}",
                                       value=r1_mjd))
        self.add_param(prefixParameter("mjd", f"CMXR2_{index:04d}",
                                       value=r2_mjd))

    def cmx_names(self):
        return [p.name for p in self.prefix_params("CMX_")]

    def prefix_families(self):
        return ["CMX_", "CMXR1_", "CMXR2_"]

    def make_param(self, name):
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "CMX_":
            return prefixParameter("float", name,
                                   units="pc cm^-3 MHz^(alpha-2)")
        if prefix in ("CMXR1_", "CMXR2_"):
            return prefixParameter("mjd", name)
        return None

    def validate(self):
        if self.cmx_names() and (
                self._parent is None or "TNCHROMIDX" not in self._parent):
            raise ValueError(
                "ChromaticCMX needs a ChromaticCM component (TNCHROMIDX)")
        for n in self.cmx_names():
            idx = n.split("_")[1]
            if f"CMXR1_{idx}" not in self.params or \
                    f"CMXR2_{idx}" not in self.params:
                raise ValueError(f"{n} needs CMXR1_{idx} and CMXR2_{idx}")

    def mask_entries(self, toas):
        """Each range's TOA mask (UTC MJDs, inclusive at both ends) and the
        (N, 2) ranges of each TOA that the delay kernel reads,
        ``__cmxidx__`` (:func:`~pint_tpu_torch.models.timing_model.
        range_entries`)."""
        out = super().mask_entries(toas)
        names = self.cmx_names()
        masks, index = range_entries(names, [
            (self.params[f"CMXR1_{n[4:]}"].mjd_float,
             self.params[f"CMXR2_{n[4:]}"].mjd_float) for n in names],
            toas.utc.mjd_float)
        out.update(masks)
        if index is not None:
            out[CMX_INDEX] = index
        return out

    def cm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        names = self.cmx_names()
        if not names:
            return zeros_rows(batch)
        masks = torch.stack([p["mask"][f"{n}__rangemask"] for n in names])
        vals = torch.stack([torch.as_tensor(pv(p, n)) for n in names])
        return vals @ masks

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return chromatic_delay(self.cm_value(p, batch), pv(p, "TNCHROMIDX"),
                               batch.freq_mhz)
