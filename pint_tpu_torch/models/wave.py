"""Sinusoidal timing noise: Wave, WaveX, DMWaveX, CMWaveX.

Port of :mod:`pint_tpu.models.wave`.  ``Wave`` (reference `Wave`,
`src/pint/models/wave.py:11`) is tempo's harmonically related sinusoids
as a phase,

    F0 * sum_k [A_k sin(k WAVE_OM dt) + B_k cos(k WAVE_OM dt)],

dt [days] from WAVEEPOCH (or PEPOCH) less the delay, the (A_k, B_k) pairs
WAVE1, WAVE2, ... [s].  On CUDA it is a term of the ``phase_chain``
kernel's row function (``csrc/phase_chain.cuh`` ``phase_family_row``,
the pairs in a small device buffer); :meth:`Wave.phase_f64` is its plain
version, in the kernel's operation order.

``WaveX`` / ``DMWaveX`` / ``CMWaveX`` (reference
`src/pint/models/wavex.py:14`, `dmwavex.py:15`, `cmwavex.py:15`) are
unevenly spaced sinusoids

    sum_i [SIN_i sin(2 pi f_i dt) + COS_i cos(2 pi f_i dt)]

with f_i [1/day] about the component's epoch, as a delay [s] (WaveX), a
DM [pc cm^-3] (DMWaveX) or a CM (CMWaveX, through ChromaticCM's
TNCHROMIDX).  WaveX is the last delay term (category ``wavex`` sorts
after ``fdjump``), so its dt is shifted by the whole delay before it.
The SIN/COS amplitudes are exactly linear.

On CUDA these delays are terms of the ``delay_chain`` kernel's row
function (``csrc/delay_chain.cuh``); the functions here are its plain
version, written in the kernel's operation order (a sum over modes in
mode order, sines then cosines).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from pint_tpu_torch import qs
from pint_tpu_torch.models.chromatic import chromatic_delay
from pint_tpu_torch.models.dispersion import dispersion_delay
from pint_tpu_torch.models.parameter import (
    FloatParam,
    MJDParam,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import (
    DelayComponent,
    PhaseComponent,
    epoch_days,
    pv,
    zeros_rows,
)
from pint_tpu_torch.toabatch import TOABatch

SECS_PER_DAY = 86400.0


class Wave(PhaseComponent):
    """Tempo WAVE sinusoids (pre-WaveX red-noise whitening)."""

    register = True
    category = "wave"

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam("WAVE_OM", units="rad/d", aliases=["WAVEOM"],
                                  description="Wave fundamental frequency"))
        self.add_param(MJDParam("WAVEEPOCH", description="Wave epoch"))

    def wave_names(self) -> List[str]:
        return [p.name for p in self.prefix_params("WAVE")
                if p.name != "WAVE_OM"]

    def add_wave_component(self, index: int, a=0.0, b=0.0, frozen=True):
        return self.add_param(prefixParameter(
            "pair", f"WAVE{index}", units="s", value=(a, b), frozen=frozen))

    def prefix_families(self):
        return ["WAVE"]

    def make_param(self, name):
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "WAVE" and index >= 1:
            return prefixParameter("pair", name, units="s")
        return None

    def validate(self):
        names = self.wave_names()
        for i, n in enumerate(names):
            if n != f"WAVE{i + 1}":
                raise ValueError(f"non-contiguous WAVE sequence at {n}")
        if names and self.WAVE_OM.value is None:
            raise ValueError("WAVE terms require WAVE_OM")
        if self.WAVE_OM.value is not None and self.WAVEEPOCH.value is None:
            if self._parent is None or self._parent.PEPOCH.value is None:
                raise ValueError("WAVEEPOCH or PEPOCH required with WAVE_OM")

    def linear_params(self):
        # F0 sum_k [A_k sin + B_k cos] is linear in the pair-valued
        # amplitudes, which TimingModel.linear_param_names leaves out (a
        # pair does not ride the flat fit vector)
        return self.wave_names()

    def epoch_name(self) -> str:
        return "WAVEEPOCH" if self.WAVEEPOCH.value is not None else "PEPOCH"

    def phase_f64(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        names = self.wave_names()
        if not names:
            return None
        dt_day = (batch.tdb_day + batch.tdb_frac
                  - epoch_days(p, self.epoch_name())) - delay / SECS_PER_DAY
        base = pv(p, "WAVE_OM") * dt_day
        times = zeros_rows(batch)
        for k, n in enumerate(names):
            ab = pv(p, n)
            arg = (k + 1) * base
            times = times + ab[..., 0] * torch.sin(arg) \
                + ab[..., 1] * torch.cos(arg)
        return times * pv(p, "F0")

    def phase(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        ph = self.phase_f64(p, batch, delay, is_tzr)
        return qs.from_f64_device(zeros_rows(batch) if ph is None else ph)


class _WaveXBasis:
    """Shared SIN/COS machinery of the WaveX family."""

    #: (freq, sin, cos) prefix spellings and the value units
    stems = ("WXFREQ_", "WXSIN_", "WXCOS_")
    epoch = "WXEPOCH"
    units = "s"

    def wavex_indices(self) -> List[int]:
        return sorted(p.index for p in self.prefix_params(self.stems[0]))

    def mode_names(self):
        """(freq, sin, cos) parameter names per mode, in index order."""
        return [tuple(f"{s}{i:04d}" for s in self.stems)
                for i in self.wavex_indices()]

    def add_wavex_component(self, freq_per_day: float, index=None,
                            sin=0.0, cos=0.0, frozen=True):
        if index is None:
            index = 1 + max(self.wavex_indices(), default=0)
        fs, ss, cs = self.stems
        self.add_param(prefixParameter("float", f"{fs}{index:04d}",
                                       units="1/d", value=freq_per_day))
        self.add_param(prefixParameter("float", f"{ss}{index:04d}",
                                       units=self.units, value=sin,
                                       frozen=frozen))
        self.add_param(prefixParameter("float", f"{cs}{index:04d}",
                                       units=self.units, value=cos,
                                       frozen=frozen))
        return index

    def prefix_families(self):
        return list(self.stems)

    def make_param(self, name):
        try:
            prefix, _ = split_prefix(name)
        except ValueError:
            return None
        if prefix == self.stems[0]:
            return prefixParameter("float", name, units="1/d")
        if prefix in self.stems[1:]:
            return prefixParameter("float", name, units=self.units)
        return None

    def validate(self):
        idx = self.wavex_indices()
        for i in idx:
            for stem in self.stems[1:]:
                if f"{stem}{i:04d}" not in self.params:
                    raise ValueError(f"{self.stems[0]}{i:04d} needs "
                                     f"{stem}{i:04d}")
        if idx and self.params[self.epoch].value is None:
            if self._parent is None or self._parent.PEPOCH.value is None:
                raise ValueError(f"{self.epoch} or PEPOCH required")

    def epoch_name(self) -> str:
        return self.epoch if self.params[self.epoch].value is not None \
            else "PEPOCH"

    def linear_params(self):
        # the SIN/COS amplitudes are exactly linear (the frequencies and
        # the epoch are not, and stay in the nonlinear block)
        _, ss, cs = self.stems
        return [f"{ss}{i:04d}" for i in self.wavex_indices()] + \
            [f"{cs}{i:04d}" for i in self.wavex_indices()]

    def basis_sum(self, p: dict, batch: TOABatch, dt_shift_day=None):
        """sum_i [SIN_i sin(2 pi f_i dt) + COS_i cos(2 pi f_i dt)], dt
        [days] from the epoch, less ``dt_shift_day`` where given."""
        modes = self.mode_names()
        if not modes:
            return zeros_rows(batch)
        dt = batch.tdb_day + batch.tdb_frac - epoch_days(p, self.epoch_name())
        if dt_shift_day is not None:
            dt = dt - dt_shift_day
        s = zeros_rows(batch)
        c = zeros_rows(batch)
        for fn, sn, cn in modes:
            arg = 2.0 * math.pi * dt * pv(p, fn)
            s = s + torch.sin(arg) * pv(p, sn)
            c = c + torch.cos(arg) * pv(p, cn)
        return s + c


class WaveX(_WaveXBasis, DelayComponent):
    """Unevenly sampled sinusoidal achromatic delays."""

    register = True
    category = "wavex"
    stems = ("WXFREQ_", "WXSIN_", "WXCOS_")
    epoch = "WXEPOCH"
    units = "s"

    def __init__(self):
        super().__init__()
        self.add_param(MJDParam("WXEPOCH", description="WaveX epoch"))

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return self.basis_sum(p, batch, delay / SECS_PER_DAY)


class DMWaveX(_WaveXBasis, DelayComponent):
    """Sinusoidal DM variations (reference `DMWaveX`, `dmwavex.py:15`)."""

    register = True
    category = "dmwavex"
    stems = ("DMWXFREQ_", "DMWXSIN_", "DMWXCOS_")
    epoch = "DMWXEPOCH"
    units = "pc cm^-3"

    def __init__(self):
        super().__init__()
        self.add_param(MJDParam("DMWXEPOCH", description="DMWaveX epoch"))

    def dm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        return self.basis_sum(p, batch)

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return dispersion_delay(self.dm_value(p, batch), batch.freq_mhz)


class CMWaveX(_WaveXBasis, DelayComponent):
    """Sinusoidal chromatic-measure variations (reference `CMWaveX`,
    `cmwavex.py:15`); needs a ChromaticCM component for TNCHROMIDX."""

    register = True
    category = "cmwavex"
    stems = ("CMWXFREQ_", "CMWXSIN_", "CMWXCOS_")
    epoch = "CMWXEPOCH"
    units = "pc cm^-3 MHz^(alpha-2)"

    def __init__(self):
        super().__init__()
        self.add_param(MJDParam("CMWXEPOCH", description="CMWaveX epoch"))

    def cm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        return self.basis_sum(p, batch)

    def validate(self):
        super().validate()
        if self.wavex_indices() and (
                self._parent is None or "TNCHROMIDX" not in self._parent):
            raise ValueError(
                "CMWaveX needs a ChromaticCM component (TNCHROMIDX)")

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return chromatic_delay(self.cm_value(p, batch),
                               pv(p, "TNCHROMIDX"), batch.freq_mhz)


def _wavex_setup(model, cls, T_span_day, freqs=None, n_freqs=None,
                 freeze_params=False):
    if (freqs is None) == (n_freqs is None):
        raise ValueError("give exactly one of freqs or n_freqs")
    name = cls.__name__
    if name in model.components:
        raise ValueError(
            f"model already has a {name} component; use its "
            "add_wavex_component method to extend it")
    comp = cls()
    model.add_component(comp)
    if freqs is None:
        freqs = np.arange(1, n_freqs + 1) / float(T_span_day)
    indices = []
    for f in np.atleast_1d(np.asarray(freqs, np.float64)):
        indices.append(comp.add_wavex_component(float(f),
                                                frozen=freeze_params))
    model.validate()
    return indices


def wavex_setup(model, T_span_day, freqs=None, n_freqs=None,
                freeze_params=False):
    """Add a WaveX component with harmonic frequencies k/T_span (or the
    explicit ``freqs``, in 1/day), amplitudes zero and free unless
    ``freeze_params`` (reference `wavex_setup`, `src/pint/utils.py:1461`)."""
    return _wavex_setup(model, WaveX, T_span_day, freqs=freqs,
                        n_freqs=n_freqs, freeze_params=freeze_params)


def dmwavex_setup(model, T_span_day, freqs=None, n_freqs=None,
                  freeze_params=False):
    """DMWaveX analogue of :func:`wavex_setup` (reference `dmwavex_setup`,
    `src/pint/utils.py:1555`)."""
    return _wavex_setup(model, DMWaveX, T_span_day, freqs=freqs,
                        n_freqs=n_freqs, freeze_params=freeze_params)


def cmwavex_setup(model, T_span_day, freqs=None, n_freqs=None,
                  freeze_params=False):
    """CMWaveX analogue of :func:`wavex_setup` (reference `cmwavex_setup`,
    `src/pint/utils.py:1649`)."""
    return _wavex_setup(model, CMWaveX, T_span_day, freqs=freqs,
                        n_freqs=n_freqs, freeze_params=freeze_params)
