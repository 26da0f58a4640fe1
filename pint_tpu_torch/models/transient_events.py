"""Transient chromatic events: exponential dips and Gaussian bumps.

Port of :mod:`pint_tpu.models.transient_events` (reference
`SimpleExponentialDip` / `ChromaticGaussianEvent`,
`src/pint/models/transient_events.py:12,308`), the J1713+0747-style
localized delay features:

* exponential dip i:  -A_i (f/fref)^gamma_i S(t; tau_i, eps) with S a
  smoothed one-sided exponential (logistic turn-on of width EXPDIPEPS,
  peak normalized to 1);
* Gaussian event i:  sign_i 10^logA_i exp(-dt^2 / 2 sigma_i^2)
  (f/fref)^(-idx_i), sigma_i = 10^logsig_i.

The quantities of the parameters alone (the dip's peak normalization,
the event's 10^LOGAMP and 10^LOGSIG) are :meth:`peak_norm` and
:meth:`amp_sigma`; the delay kernel takes them as θ slots formed by these
methods.  On CUDA these delays are terms of the ``delay_chain`` kernel's
row function (``csrc/delay_chain.cuh``); the functions here are its
plain version, written in the kernel's operation order.
"""

from __future__ import annotations

from typing import List

import torch

from pint_tpu_torch.models.parameter import (
    FloatParam,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import (
    DelayComponent,
    epoch_days,
    pv,
    zeros_rows,
)
from pint_tpu_torch.toabatch import TOABatch

_DIP_FAMILIES = {
    "EXPDIPEP_": ("mjd", "d"),
    "EXPDIPAMP_": ("float", "s"),
    "EXPDIPIDX_": ("float", ""),
    "EXPDIPTAU_": ("float", "d"),
}

_GAUSS_FAMILIES = {
    "CHROMGAUSS_EPOCH_": ("mjd", "d"),
    "CHROMGAUSS_LOGAMP_": ("float", "log10(s)"),
    "CHROMGAUSS_LOGSIG_": ("float", "log10(d)"),
    "CHROMGAUSS_CHROMIDX_": ("float", ""),
    "CHROMGAUSS_SIGN_": ("float", ""),
}


def _ffac(batch: TOABatch, fref_mhz):
    """f / fref per TOA, 1 on infinite-frequency rows (the TZR TOA among
    them: a dip reaches the TZR phase at its reference amplitude)."""
    finite = torch.isfinite(batch.freq_mhz)
    f = torch.where(finite, batch.freq_mhz, fref_mhz)
    return torch.where(finite, f / fref_mhz, 1.0)


def _family_param(families, name):
    try:
        prefix, _ = split_prefix(name)
    except ValueError:
        return None
    fam = families.get(prefix)
    if fam is None:
        return None
    return prefixParameter(fam[0], name, units=fam[1])


class SimpleExponentialDip(DelayComponent):
    """Chromatic exponential dip(s) in the residuals."""

    register = True
    category = "expdip"

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam(
            "EXPDIPEPS", value=0.01, units="d",
            description="dip turn-on smoothing timescale"))
        self.add_param(FloatParam(
            "EXPDIPFREF", value=1400.0, units="MHz",
            description="reference frequency for dip amplitudes"))

    def prefix_families(self):
        return list(_DIP_FAMILIES)

    def dip_indices(self) -> List[int]:
        return sorted(p.index for p in self.prefix_params("EXPDIPEP_"))

    def add_dip(self, index: int, epoch, amp=0.0, idx=2.0, tau=10.0,
                frozen=True):
        self.add_param(prefixParameter("mjd", f"EXPDIPEP_{index}",
                                       value=epoch))
        for stem, v in (("EXPDIPAMP_", amp), ("EXPDIPIDX_", idx),
                        ("EXPDIPTAU_", tau)):
            kind, units = _DIP_FAMILIES[stem]
            self.add_param(prefixParameter(kind, f"{stem}{index}",
                                           units=units, value=v,
                                           frozen=frozen))

    def make_param(self, name):
        return _family_param(_DIP_FAMILIES, name)

    def validate(self):
        for i in self.dip_indices():
            for stem in ("EXPDIPAMP_", "EXPDIPTAU_"):
                par = self.params.get(f"{stem}{i}")
                if par is None or par.value is None:
                    raise ValueError(f"EXPDIPEP_{i} needs {stem}{i}")

    def peak_norm(self, p: dict, i: int):
        """The normalization that puts dip i's peak at 1."""
        tau, eps = pv(p, f"EXPDIPTAU_{i}"), pv(p, "EXPDIPEPS")
        return (tau / eps) ** (eps / tau) * \
            (tau / (tau - eps)) ** ((tau - eps) / tau)

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        total = zeros_rows(batch)
        idx = self.dip_indices()
        if not idx:
            return total
        ffac = _ffac(batch, pv(p, "EXPDIPFREF"))
        eps = pv(p, "EXPDIPEPS")
        t = batch.tdb_day + batch.tdb_frac
        for i in idx:
            dt = t - epoch_days(p, f"EXPDIPEP_{i}")
            tau = pv(p, f"EXPDIPTAU_{i}")
            # the overflow-safe smoothed one-sided exponential (reference
            # transient_events.py:229-235); the kernel takes one branch
            pos = dt >= 0.0
            dtp = torch.where(pos, dt, 0.0)
            dtn = torch.where(pos, 0.0, dt)
            expfac = torch.where(
                pos,
                torch.exp(-dtp / tau) / (1.0 + torch.exp(-dtp / eps)),
                torch.exp(dtn * (tau - eps) / (tau * eps))
                / (1.0 + torch.exp(dtn / eps)))
            total = total - pv(p, f"EXPDIPAMP_{i}") * \
                ffac ** pv(p, f"EXPDIPIDX_{i}") * self.peak_norm(p, i) * \
                expfac
        return total


class ChromaticGaussianEvent(DelayComponent):
    """Chromatic Gaussian bump(s) in the residuals."""

    register = True
    category = "chromgauss"

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam(
            "CHROMGAUSSFREF", value=1400.0, units="MHz",
            description="reference frequency for event amplitudes"))

    def prefix_families(self):
        return list(_GAUSS_FAMILIES)

    def event_indices(self) -> List[int]:
        return sorted(p.index
                      for p in self.prefix_params("CHROMGAUSS_EPOCH_"))

    def add_event(self, index: int, epoch, log10_amp=-6.0, log10_sig=1.0,
                  chromidx=2.0, sign=1.0, frozen=True):
        self.add_param(prefixParameter("mjd", f"CHROMGAUSS_EPOCH_{index}",
                                       value=epoch))
        for stem, v in (("CHROMGAUSS_LOGAMP_", log10_amp),
                        ("CHROMGAUSS_LOGSIG_", log10_sig),
                        ("CHROMGAUSS_CHROMIDX_", chromidx),
                        ("CHROMGAUSS_SIGN_", sign)):
            kind, units = _GAUSS_FAMILIES[stem]
            self.add_param(prefixParameter(kind, f"{stem}{index}",
                                           units=units, value=v,
                                           frozen=frozen))

    def make_param(self, name):
        return _family_param(_GAUSS_FAMILIES, name)

    def validate(self):
        for i in self.event_indices():
            for stem in ("CHROMGAUSS_LOGAMP_", "CHROMGAUSS_LOGSIG_"):
                par = self.params.get(f"{stem}{i}")
                if par is None or par.value is None:
                    raise ValueError(
                        f"CHROMGAUSS_EPOCH_{i} needs {stem}{i}")

    def amp_sigma(self, p: dict, i: int):
        """(10^LOGAMP [s], 10^LOGSIG [d]) of event i."""
        return (10.0 ** pv(p, f"CHROMGAUSS_LOGAMP_{i}"),
                10.0 ** pv(p, f"CHROMGAUSS_LOGSIG_{i}"))

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        total = zeros_rows(batch)
        idx = self.event_indices()
        if not idx:
            return total
        ffac = _ffac(batch, pv(p, "CHROMGAUSSFREF"))
        t = batch.tdb_day + batch.tdb_frac
        for i in idx:
            dt = t - epoch_days(p, f"CHROMGAUSS_EPOCH_{i}")
            amp, sigma = self.amp_sigma(p, i)
            q = dt / sigma
            total = total + pv(p, f"CHROMGAUSS_SIGN_{i}") * amp * \
                torch.exp(-0.5 * (q * q)) * \
                ffac ** (-pv(p, f"CHROMGAUSS_CHROMIDX_{i}"))
        return total
