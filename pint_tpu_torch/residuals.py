"""Phase/time residuals.

Port of :mod:`pint_tpu.residuals` (reference `Residuals`,
`src/pint/residuals.py:43`): residual = model phase -
observed phase, with either "nearest"-integer tracking or explicit
pulse-number tracking, then optional weighted-mean subtraction.

The heavy part (:func:`raw_phase_resids`) is a pure function of
(params dict, batch) on the batch's device; its phase chain is the
``qs_phase_frac`` kernel (:meth:`PhaseCalc.phase_frac`).  The
:class:`Residuals` class is a thin host wrapper.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pint_tpu_torch.models.timing_model import PhaseCalc, TimingModel
from pint_tpu_torch.toabatch import TOABatch

__all__ = ["Residuals", "raw_phase_resids", "build_resid_fn"]


def raw_phase_resids(model_calc: PhaseCalc, p: dict, batch: TOABatch,
                     track_mode: str, subtract_mean: bool,
                     use_weights: bool, sigma_us=None):
    """Phase residuals [cycles] (float64 policy of
    :func:`pint_tpu.residuals.raw_phase_resids`).

    ``track_mode``: "nearest" drops the integer pulse number per TOA (the
    rounding carries no derivative); "use_pulse_numbers" subtracts the
    batch's tracked pulse_number column.  The TZR reference phase is
    subtracted as data (``p["const"]["__tzrphase__"]``)."""
    if track_mode not in ("nearest", "use_pulse_numbers"):
        raise ValueError(f"unknown track_mode {track_mode!r}")
    out = model_calc.phase_frac(p, batch, track_mode)
    if subtract_mean:
        if use_weights:
            # weights use the scaled uncertainties so the subtracted mean
            # minimizes the same chi2 that calc_chi2 reports
            s = batch.error_us if sigma_us is None else sigma_us
            w = 1.0 / (s ** 2)
            out = out - torch.sum(out * w) / torch.sum(w)
        else:
            out = out - torch.mean(out)
    return out


def build_resid_fn(model: TimingModel, batch: TOABatch,
                   track_mode: str, subtract_mean: bool, use_weights: bool):
    """``(pdict) -> phase residuals [cycles]`` over the static model
    structure and TOA data."""
    calc = model.calc
    noise = bool(model.noise_components)

    def fn(p):
        sigma = model.scaled_toa_uncertainty(p, batch) if noise else None
        return raw_phase_resids(calc, p, batch, track_mode, subtract_mean,
                                use_weights, sigma_us=sigma)

    return fn


class Residuals:
    """Host-side residuals wrapper (reference `Residuals`,
    `src/pint/residuals.py:43`).  ``device`` (default
    ``"cuda"``) is where the batch and the params dict live."""

    def __init__(self, toas, model: TimingModel, track_mode: Optional[str] = None,
                 subtract_mean: bool = True, use_weighted_mean: bool = True,
                 policy: Optional[str] = None, device=None):
        self.toas = toas
        self.model = model
        self.policy = policy
        if track_mode is None:
            tm = getattr(model, "TRACK", None)
            track_mode = "use_pulse_numbers" if (
                tm is not None and tm.value == "-2"
                and toas.get_pulse_numbers() is not None) else "nearest"
        if track_mode == "use_pulse_numbers" and \
                toas.get_pulse_numbers() is None:
            raise ValueError("track_mode use_pulse_numbers needs pulse numbers")
        self.track_mode = track_mode
        if "PhaseOffset" in model.components:
            raise NotImplementedError("PhaseOffset is not ported")
        self.subtract_mean = subtract_mean
        self.use_weighted_mean = use_weighted_mean
        self.batch = toas.to_batch(policy=policy, device=device)
        self.device = self.batch.device
        if "AbsPhase" in model.components and (
                model.tzr_batch is None
                or model.tzr_batch.device != self.device):
            model.attach_tzr(toas, device=self.device)
        self._fn = build_resid_fn(model, self.batch, self.track_mode,
                                  self.subtract_mean, self.use_weighted_mean)
        self.pdict = model.build_pdict(
            toas, tzr_toas=model.make_tzr_toas_or_none(), device=self.device)
        self._phase_resids: Optional[np.ndarray] = None
        self._chi2_cache: Optional[float] = None

    # -- computed quantities ---------------------------------------------
    @property
    def phase_resids(self) -> np.ndarray:
        """Residuals in cycles."""
        if self._phase_resids is None:
            with torch.no_grad():
                out = self._fn(self.pdict)
            self._phase_resids = out.cpu().numpy()
        return self._phase_resids

    @property
    def time_resids(self) -> np.ndarray:
        """Residuals in seconds."""
        return self.phase_resids / float(self.model.F0.value)

    def update(self):
        """Re-evaluate after model changes: a fresh params dict on the
        residuals' device, and the residual and chi2 caches dropped."""
        self.pdict = self.model.build_pdict(
            self.toas, tzr_toas=self.model.make_tzr_toas_or_none(),
            device=self.device)
        self._phase_resids = None
        self._chi2_cache = None

    def rms_weighted(self) -> float:
        w = 1.0 / (self.get_data_error() * 1e-6) ** 2
        r = self.time_resids
        mean = np.sum(r * w) / np.sum(w)
        return float(np.sqrt(np.sum(w * (r - mean) ** 2) / np.sum(w)))

    def _noise_basis_filtered(self):
        """(U, phi) on the residuals' device with zero-prior-variance
        columns dropped: the single source for every correlated-noise
        consumer here (:meth:`pint_tpu.residuals.Residuals.
        _noise_basis_filtered`)."""
        with torch.no_grad():
            U = self.model.noise_basis(self.pdict)
            phi = self.model.noise_weights(self.pdict)
        keep = phi > 0  # zero prior variance = column not present
        return U[:, keep], phi[keep]

    def _gaussian_quadratic(self, r: np.ndarray):
        """(r^T C^-1 r, logdet C) under the full noise model: the white
        diagonal, or the Woodbury form over the noise basis when
        correlated components are present (reference `calc_chi2`
        dispatch, `src/pint/residuals.py:646-748`), on the residuals'
        device."""
        sigma_s = np.asarray(self.get_data_error(), np.float64) * 1e-6
        if self.model.has_correlated_errors:
            from pint_tpu_torch.utils import woodbury_dot

            U, phi = self._noise_basis_filtered()
            rt = torch.as_tensor(np.asarray(r, np.float64), device=U.device)
            st = torch.as_tensor(sigma_s, device=U.device)
            with torch.no_grad():
                dot, logdet = woodbury_dot(st**2, U, phi, rt, rt)
            return float(dot), float(logdet)
        return (float(np.sum((r / sigma_s) ** 2)),
                float(2.0 * np.sum(np.log(sigma_s))))

    def calc_chi2(self) -> float:
        """Weighted chi2 (the Woodbury form r^T C^-1 r with correlated
        noise), cached until the next :meth:`update`."""
        if self._chi2_cache is None:
            self._chi2_cache = self._gaussian_quadratic(self.time_resids)[0]
        return self._chi2_cache

    def get_data_error(self) -> np.ndarray:
        """Scaled uncertainties [us] (EFAC/EQUAD applied)."""
        with torch.no_grad():
            return self.model.scaled_toa_uncertainty(
                self.pdict, self.batch).cpu().numpy()

    def lnlikelihood(self) -> float:
        """Gaussian log-likelihood of the residuals under the full noise
        model, -(chi2 + logdet C + N ln 2pi)/2 (reference `lnlikelihood`,
        `src/pint/residuals.py:792`)."""
        r = self.time_resids
        dot, logdet = self._gaussian_quadratic(r)
        return float(-0.5 * (dot + logdet + len(r) * np.log(2.0 * np.pi)))

    @property
    def dof(self) -> int:
        return self.toas.ntoas - len(self.model.free_params) - \
            int(self.subtract_mean)
