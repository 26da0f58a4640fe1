"""White-noise rescaling and correlated-noise bases (ECORR, red noise).

Port of :mod:`pint_tpu.models.noise_model` (reference `ScaleToaError`,
`EcorrNoise`, `PLRedNoise`, `PLDMNoise`,
`src/pint/models/noise_model.py:79,367,1004,441`).  ``ScaleToaError``
rescales TOA uncertainties as

    sigma' = EFAC * sqrt(sigma^2 + EQUAD^2)

over mask-selected TOA subsets, with TNEQ the tempo2-convention
log10(EQUAD/s).  The correlated components expose a basis matrix and
prior weights for the GLS fitter: the basis is built on the host (numpy)
and rides in the params dict's ``const`` group; the weights are
differentiable functions of the params dict.  ``ScaleDmError`` rescales
the wideband DM uncertainties (DMEFAC/DMEQUAD).  ``PLChromNoise`` and
``PLSWNoise`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from pint_tpu_torch.models.parameter import (
    FloatParam,
    IntParam,
    MaskParam,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import Component, pv
from pint_tpu_torch.toabatch import TOABatch

SECS_PER_DAY = 86400.0
FYR = 1.0 / (365.25 * SECS_PER_DAY)  # 1/yr in Hz


class NoiseComponent(Component):
    """Base for noise components (:class:`pint_tpu.models.noise_model.
    NoiseComponent`): ``introduces_correlated_errors`` is False for pure
    sigma rescaling (EFAC/EQUAD) and True for basis components (ECORR,
    red noise) that the GLS fitter marginalizes over."""

    introduces_correlated_errors = False
    is_noise = True
    category = "noise"

    def scaled_sigma_us(self, p: dict, batch: TOABatch,
                        sigma_us: torch.Tensor) -> torch.Tensor:
        """Transform per-TOA uncertainties [us]; identity by default."""
        return sigma_us

    # the basis/weight protocol of correlated components: host-built basis
    # data in p["const"], and prior variances [s^2] per column derived
    # from p alone (so a params dict stays self-consistent)
    def basis_entries(self, toas) -> dict:
        """{const name: numpy array}: the (ntoas, k) basis plus what
        :meth:`noise_weights` needs (frequencies, column -> parameter
        maps)."""
        raise NotImplementedError

    def noise_weights(self, p: dict) -> torch.Tensor:
        """Prior variance per basis column [s^2], shape (k,)."""
        raise NotImplementedError

    @property
    def basis_pytree_name(self) -> str:
        return f"__noisebasis_{type(self).__name__}__"


class ScaleToaError(NoiseComponent):
    """EFAC/EQUAD/TNEQ white-noise rescaling (reference
    `src/pint/models/noise_model.py:79-263`)."""

    register = True
    category = "scale_toa_error"

    def mask_families(self) -> List[str]:
        return ["EFAC", "EQUAD", "TNEQ", "T2EFAC", "T2EQUAD"]

    def _family(self, stem: str) -> List[MaskParam]:
        return self.prefix_params(stem)

    def _next_index(self, stem: str) -> int:
        return 1 + max([par.index or 0 for par in self._family(stem)],
                       default=0)

    def make_param(self, name: str):
        # tempo2 spellings map onto the canonical families
        name = {"T2EFAC": "EFAC", "T2EQUAD": "EQUAD"}.get(name, name)
        if name in ("EFAC", "EQUAD", "TNEQ"):
            stem, index = name, self._next_index(name)
        else:
            try:
                stem, index = split_prefix(name)
            except ValueError:
                return None
            stem = {"T2EFAC": "EFAC", "T2EQUAD": "EQUAD"}.get(stem, stem)
        if stem == "EFAC":
            return MaskParam("EFAC", index=index, units="",
                             description="error scale factor")
        if stem == "EQUAD":
            return MaskParam("EQUAD", index=index, units="us",
                             description="error added in quadrature")
        if stem == "TNEQ":
            return MaskParam("TNEQ", index=index, units="log10(s)",
                             description="tempo2 EQUAD, log10 seconds")
        return None

    def add_noise_param(self, stem: str, key=None, key_value=(),
                        value=None, index=None, frozen=True) -> MaskParam:
        """Programmatic construction of an EFAC/EQUAD/TNEQ member."""
        par = self.make_param(stem if index is None else f"{stem}{index}")
        if par is None:
            raise ValueError(f"unknown white-noise family {stem!r}")
        par.key, par.key_value = key, list(key_value)
        par.value, par.frozen = value, frozen
        return self.add_param(par)

    def scaled_sigma_us(self, p: dict, batch: TOABatch,
                        sigma_us: torch.Tensor) -> torch.Tensor:
        var = sigma_us ** 2
        quad = torch.zeros_like(var)
        for par in self._family("EQUAD"):
            m = p["mask"].get(par.mask_pytree_name)
            if m is None:
                continue
            quad = quad + m * pv(p, par.name) ** 2
        for par in self._family("TNEQ"):
            m = p["mask"].get(par.mask_pytree_name)
            if m is None:
                continue
            eq_us = 10.0 ** pv(p, par.name) * 1e6
            quad = quad + m * eq_us ** 2
        var = var + quad
        scale = torch.ones_like(var)
        for par in self._family("EFAC"):
            m = p["mask"].get(par.mask_pytree_name)
            if m is None:
                continue
            scale = scale * (1.0 + m * (pv(p, par.name) - 1.0))
        return scale * torch.sqrt(var)


class ScaleDmError(NoiseComponent):
    """DMEFAC/DMEQUAD rescaling of wideband DM measurement uncertainties
    (:class:`pint_tpu.models.noise_model.ScaleDmError`, reference
    `ScaleDmError`, `src/pint/models/noise_model.py:270-379`):

        sigma_dm' = DMEFAC * sqrt(sigma_dm^2 + DMEQUAD^2)

    over mask-selected TOA subsets.  It affects only the DM block of
    wideband residuals and fits, never the TOA uncertainties."""

    register = True
    category = "scale_dm_error"

    def mask_families(self) -> List[str]:
        return ["DMEFAC", "DMEQUAD"]

    def _family(self, stem: str) -> List[MaskParam]:
        return self.prefix_params(stem)

    def _next_index(self, stem: str) -> int:
        return 1 + max([par.index or 0 for par in self._family(stem)],
                       default=0)

    def make_param(self, name: str):
        if name in ("DMEFAC", "DMEQUAD"):
            stem, index = name, self._next_index(name)
        else:
            try:
                stem, index = split_prefix(name)
            except ValueError:
                return None
        if stem == "DMEFAC":
            return MaskParam("DMEFAC", index=index, units="",
                             description="DM error scale factor")
        if stem == "DMEQUAD":
            return MaskParam("DMEQUAD", index=index, units="pc cm^-3",
                             description="DM error added in quadrature")
        return None

    def add_noise_param(self, stem: str, key=None, key_value=(),
                        value=None, index=None, frozen=True) -> MaskParam:
        par = self.make_param(stem if index is None else f"{stem}{index}")
        if par is None:
            raise ValueError(f"unknown DM-noise family {stem!r}")
        par.key, par.key_value = key, list(key_value)
        par.value, par.frozen = value, frozen
        return self.add_param(par)

    def scaled_dm_sigma(self, p: dict, batch: TOABatch,
                        sigma_dm: torch.Tensor) -> torch.Tensor:
        """Per-TOA DM uncertainties [pc cm^-3] rescaled; the masks are
        per TOA (full batch length), so callers gather the wideband rows
        afterwards."""
        var = sigma_dm ** 2
        quad = torch.zeros_like(var)
        for par in self._family("DMEQUAD"):
            m = p["mask"].get(par.mask_pytree_name)
            if m is None:
                continue
            quad = quad + m * pv(p, par.name) ** 2
        var = var + quad
        scale = torch.ones_like(var)
        for par in self._family("DMEFAC"):
            m = p["mask"].get(par.mask_pytree_name)
            if m is None:
                continue
            scale = scale * (1.0 + m * (pv(p, par.name) - 1.0))
        return scale * torch.sqrt(var)


def ecorr_epochs(t_sec: np.ndarray, dt: float = 1.0,
                 nmin: int = 2) -> List[np.ndarray]:
    """Group TOAs into observing epochs: sorted times bucketed within
    ``dt`` seconds of each bucket's first, keeping buckets of >= nmin
    TOAs (reference `get_ecorr_epochs`, `noise_model.py:1196`)."""
    if len(t_sec) == 0:
        return []
    isort = np.argsort(t_sec)
    ref = t_sec[isort[0]]
    buckets = [[isort[0]]]
    for i in isort[1:]:
        if t_sec[i] - ref < dt:
            buckets[-1].append(i)
        else:
            ref = t_sec[i]
            buckets.append([i])
    return [np.array(b) for b in buckets if len(b) >= nmin]


class EcorrNoise(NoiseComponent):
    """Epoch-correlated white noise (jitter): a block basis over observing
    epochs, weight ECORR^2 per epoch (reference `EcorrNoise`,
    `noise_model.py:367`)."""

    register = True
    category = "ecorr_noise"
    introduces_correlated_errors = True
    #: the quantization basis has disjoint 0/1 columns, so its Gram matrix
    #: is exactly diagonal: the GLS solve eliminates the block in closed
    #: form (fitter.gls_solve) and chi2 uses the per-epoch
    #: Sherman-Morrison (utils.woodbury_dot_split)
    diag_gram = True

    def __init__(self):
        super().__init__()
        self._basis_cache: Tuple = ()

    def mask_families(self) -> List[str]:
        return ["ECORR", "TNECORR"]

    def make_param(self, name: str):
        name = {"TNECORR": "ECORR"}.get(name, name)
        if name == "ECORR":
            stem, index = "ECORR", 1 + max(
                [q.index or 0 for q in self.prefix_params("ECORR")],
                default=0)
        else:
            try:
                stem, index = split_prefix(name)
            except ValueError:
                return None
        if stem in ("ECORR", "TNECORR"):
            return MaskParam("ECORR", index=index, units="us",
                             description="epoch-correlated error")
        return None

    def ecorr_params(self) -> List[MaskParam]:
        """The ECORR members with a nonzero value (a zero ECORR would be
        a zero prior variance, so its columns are not built)."""
        return [q for q in self.prefix_params("ECORR")
                if q.value is not None and q.value != 0.0]

    @property
    def colmap_pytree_name(self) -> str:
        return f"__noisecolmap_{type(self).__name__}__"

    def basis_entries(self, toas) -> dict:
        """Quantization matrix + a column -> ECORR parameter index map
        (reference `get_noise_basis`, `noise_model.py:430`), cached on
        the TDB content (TOAs are mutated in place, e.g. by
        `zero_residuals`)."""
        t = np.asarray(toas.tdb.mjd_float) * SECS_PER_DAY
        params = self.ecorr_params()
        key = (toas.ntoas, hash(t.tobytes()),
               tuple((q.name, q.key, tuple(q.key_value)) for q in params))
        if self._basis_cache and self._basis_cache[0] == key:
            return self._basis_cache[1]
        n = toas.ntoas
        blocks = []
        col_idx = []
        for j, par in enumerate(params):
            idx = np.flatnonzero(par.select_mask(toas))
            for epoch in ecorr_epochs(t[idx]):
                blocks.append(idx[epoch])
                col_idx.append(j)
        U = np.zeros((n, len(blocks)))
        for k, rows in enumerate(blocks):
            U[rows, k] = 1.0
        out = {self.basis_pytree_name: U,
               self.colmap_pytree_name: np.asarray(col_idx, np.int32)}
        self._basis_cache = (key, out)
        return out

    def noise_weights(self, p: dict) -> torch.Tensor:
        col_idx = p["const"].get(self.colmap_pytree_name)
        if col_idx is None or len(col_idx) == 0:
            return torch.zeros(0, dtype=torch.float64)
        vals = torch.stack([torch.as_tensor(pv(p, q.name), dtype=torch.float64)
                            for q in self.ecorr_params()])
        return (vals[col_idx.to(vals.device).long()] * 1e-6) ** 2


def powerlaw_psd(f, amp, gamma):
    """Power-law PSD in timing-residual units (reference `powerlaw`,
    `noise_model.py:1370`): P(f) = A^2/(12 pi^2) fyr^(gamma-3) f^(-gamma),
    evaluated in log space as :func:`pint_tpu.models.noise_model.
    powerlaw_psd` does (its direct form's ``f**-gamma`` overflowed the
    TPU's float64 range; the log form is kept so the two agree)."""
    log_psd = (2.0 * torch.log(amp) - math.log(12.0 * math.pi**2)
               + (gamma - 3.0) * math.log(FYR) - gamma * torch.log(f))
    return torch.exp(log_psd)


class PLRedNoise(NoiseComponent):
    """Power-law achromatic red noise via a Fourier basis (reference
    `PLRedNoise`, `noise_model.py:1004`): alternating sin/cos columns at
    f_k = k/Tspan, k = 1..TNREDC (host-built); weights P(f_k) df,
    differentiable in TNREDAMP/TNREDGAM (or tempo RNAMP/RNIDX)."""

    register = True
    category = "pl_red_noise"
    introduces_correlated_errors = True
    is_time_correlated = True
    _TSPAN = "TNREDTSPAN"

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam("TNREDAMP", units="",
                                  description="log10 red-noise amplitude"))
        self.add_param(FloatParam("TNREDGAM", units="",
                                  description="red-noise spectral index"))
        self.add_param(IntParam("TNREDC", value=30, units="",
                                description="number of Fourier modes"))
        self.add_param(FloatParam("RNAMP", units="",
                                  description="tempo-format red amplitude"))
        self.add_param(FloatParam("RNIDX", units="",
                                  description="tempo-format red index"))
        self.add_param(FloatParam("TNREDTSPAN", units="yr",
                                  description="fundamental-period override"))
        self._basis_cache: Tuple = ()

    def validate(self):
        has_tn = self.TNREDAMP.value is not None and \
            self.TNREDGAM.value is not None
        has_rn = self.RNAMP.value is not None and self.RNIDX.value is not None
        if not (has_tn or has_rn):
            from pint_tpu_torch.exceptions import MissingParameter

            raise MissingParameter(
                "PLRedNoise needs TNREDAMP+TNREDGAM or RNAMP+RNIDX")

    def nmodes(self) -> int:
        return int(self.TNREDC.value) if self.TNREDC.value is not None else 30

    def amp_gamma(self, p: dict):
        """(amplitude, gamma); RNAMP/RNIDX use the tempo conversion
        (reference `get_plc_vals`, `noise_model.py:1130-1135`)."""
        if self.TNREDAMP.value is not None and \
                self.TNREDGAM.value is not None:
            return 10.0 ** pv(p, "TNREDAMP"), pv(p, "TNREDGAM")
        fac = (86400.0 * 365.24 * 1e6) / (2.0 * math.pi * math.sqrt(3.0))
        return pv(p, "RNAMP") / fac, -pv(p, "RNIDX")

    def _freqs(self, toas) -> np.ndarray:
        t = np.asarray(toas.tdb.mjd_float) * SECS_PER_DAY
        tspan = self.params[self._TSPAN].value
        if tspan is not None:
            T = tspan * 365.25 * SECS_PER_DAY
        else:
            T = t.max() - t.min()
        return np.arange(1, self.nmodes() + 1) / T

    @property
    def freqs_pytree_name(self) -> str:
        return f"__noisefreqs_{type(self).__name__}__"

    def chromatic_scale(self, toas) -> np.ndarray:
        """Per-TOA basis scaling: 1 for achromatic red noise."""
        return np.ones(toas.ntoas)

    def basis_entries(self, toas) -> dict:
        """Fourier design matrix (sin/cos alternating, reference
        `create_fourier_design_matrix`, `noise_model.py:1339`) plus its
        frequencies, cached on the TDB content."""
        t = np.asarray(toas.tdb.mjd_float) * SECS_PER_DAY
        scale = self.chromatic_scale(toas)
        key = (toas.ntoas, hash(t.tobytes()), self.nmodes(),
               self.params[self._TSPAN].value, hash(scale.tobytes()))
        if self._basis_cache and self._basis_cache[0] == key:
            return self._basis_cache[1]
        f = self._freqs(toas)
        F = np.zeros((toas.ntoas, 2 * len(f)))
        F[:, 0::2] = np.sin(2.0 * math.pi * t[:, None] * f)
        F[:, 1::2] = np.cos(2.0 * math.pi * t[:, None] * f)
        F *= scale[:, None]
        out = {self.basis_pytree_name: F, self.freqs_pytree_name: f}
        self._basis_cache = (key, out)
        return out

    def noise_weights(self, p: dict) -> torch.Tensor:
        f = p["const"].get(self.freqs_pytree_name)
        if f is None:
            return torch.zeros(0, dtype=torch.float64)
        amp, gam = self.amp_gamma(p)
        df = torch.diff(torch.cat([torch.zeros(1, dtype=f.dtype,
                                               device=f.device), f]))
        psd = powerlaw_psd(torch.repeat_interleave(f, 2), amp, gam)
        return psd * torch.repeat_interleave(df, 2)


class _PLChromaticBase(PLRedNoise):
    """Shared machinery of DM/chromatic power-law noise: the same Fourier
    time basis with columns scaled per TOA by (1400 MHz / f)^alpha
    (reference `PLDMNoise`/`PLChromNoise`, `noise_model.py:441,590`)."""

    register = False
    _AMP = "TNDMAMP"
    _GAM = "TNDMGAM"
    _C = "TNDMC"
    _TSPAN = "TNDMTSPAN"

    def __init__(self):
        Component.__init__(self)
        self.add_param(FloatParam(self._AMP, units="",
                                  description="log10 GP amplitude"))
        self.add_param(FloatParam(self._GAM, units="",
                                  description="GP spectral index"))
        self.add_param(IntParam(self._C, value=30, units="",
                                description="number of Fourier modes"))
        self.add_param(FloatParam(self._TSPAN, units="yr",
                                  description="fundamental-period override"))
        self._basis_cache = ()

    def validate(self):
        if self.params[self._AMP].value is None or \
                self.params[self._GAM].value is None:
            from pint_tpu_torch.exceptions import MissingParameter

            raise MissingParameter(
                f"{type(self).__name__} needs {self._AMP} and {self._GAM}")

    def nmodes(self) -> int:
        v = self.params[self._C].value
        return int(v) if v is not None else 30

    def amp_gamma(self, p: dict):
        return 10.0 ** pv(p, self._AMP), pv(p, self._GAM)

    def chromatic_alpha(self) -> float:
        return 2.0

    def chromatic_scale(self, toas) -> np.ndarray:
        f = np.asarray(toas.freq_mhz, np.float64)
        finite = np.isfinite(f)
        out = np.zeros(toas.ntoas)
        out[finite] = (1400.0 / f[finite]) ** self.chromatic_alpha()
        return out


class PLDMNoise(_PLChromaticBase):
    """Power-law DM noise, amplitude referenced to 1400 MHz (reference
    `PLDMNoise`, `noise_model.py:441`)."""

    register = True
    category = "pl_dm_noise"
    _AMP, _GAM, _C = "TNDMAMP", "TNDMGAM", "TNDMC"
    _TSPAN = "TNDMTSPAN"
