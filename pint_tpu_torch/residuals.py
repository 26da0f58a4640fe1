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

__all__ = ["Residuals", "WidebandTOAResiduals", "raw_phase_resids",
           "build_resid_fn", "scaled_dm_sigma_rows"]


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
        self._values_key = model.values_key()
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
        self._values_key = self.model.values_key()
        self._phase_resids = None
        self._chi2_cache = None

    @property
    def stale(self) -> bool:
        """Whether the model's values moved since the params dict was
        built (:meth:`update` brings it up to date)."""
        return self._values_key != self.model.values_key()

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

    def calc_whitened_resids(self) -> np.ndarray:
        """Dimensionless whitened residuals (reference
        `calc_whitened_resids`, `src/pint/residuals.py:571`;
        :meth:`pint_tpu.residuals.Residuals.calc_whitened_resids`), host
        numpy: the conditional-mean realization of the correlated noise
        subtracted and the result scaled by the white uncertainties;
        ~N(0, 1) when the noise model is adequate."""
        r = np.asarray(self.time_resids, np.float64)
        sigma = np.asarray(self.get_data_error(), np.float64) * 1e-6
        if not self.model.has_correlated_errors:
            return r / sigma
        U, phi = (t.cpu().numpy() for t in self._noise_basis_filtered())
        # conditional-mean amplitudes a_hat = Phi U^T C^-1 r by the
        # Woodbury identity: a_hat = Phi (I + G Phi)^-1 b with
        # G = U^T N^-1 U, b = U^T N^-1 r
        b = U.T @ (r / sigma**2)
        G = U.T @ (U / sigma[:, None]**2)
        a_hat = phi * np.linalg.solve(
            np.eye(len(phi)) + G * phi[None, :], b)
        return (r - U @ a_hat) / sigma

    def normality(self, test: str = "ks"):
        """Normality statistic of the whitened residuals
        (:meth:`pint_tpu.residuals.Residuals.normality`): "ks" gives the
        Kolmogorov-Smirnov (statistic, p-value) against N(0, 1); "ad" the
        Anderson-Darling statistic and its critical values (or p-value,
        as the installed scipy reports it)."""
        import warnings

        from scipy import stats

        w = self.calc_whitened_resids()
        if test == "ks":
            res = stats.kstest(w, "norm")
            return float(res.statistic), float(res.pvalue)
        if test == "ad":
            with warnings.catch_warnings():
                # scipy >= 1.17 deprecates the method-less call
                warnings.simplefilter("ignore", FutureWarning)
                res = stats.anderson(w, "norm")
            crit = getattr(res, "critical_values", None)
            if crit is None:
                return float(res.statistic), float(res.pvalue)
            return float(res.statistic), np.asarray(crit)
        raise ValueError(f"unknown normality test {test!r}")

    @property
    def dof(self) -> int:
        return self.toas.ntoas - len(self.model.free_params) - \
            int(self.subtract_mean)

    @property
    def reduced_chi2(self) -> float:
        return self.calc_chi2() / self.dof


def scaled_dm_sigma_rows(model: TimingModel, p: dict, batch: TOABatch,
                         dm_index, dm_error) -> torch.Tensor:
    """DMEFAC/DMEQUAD-scaled DM uncertainties [pc cm^-3] on the wideband
    rows (:func:`pint_tpu.residuals.scaled_dm_sigma_rows`): the measured
    errors scattered to full batch length (the noise masks are per TOA),
    scaled, gathered back.  Shared by the residuals, the wideband
    assembly and the noise likelihood."""
    dev = batch.device
    idx = torch.as_tensor(dm_index, dtype=torch.int64, device=dev)
    full = torch.zeros(batch.ntoas, dtype=torch.float64, device=dev)
    full = full.index_put((idx,), torch.as_tensor(
        dm_error, dtype=torch.float64, device=dev))
    return model.scaled_dm_uncertainty(p, batch, full)[idx]


class WidebandTOAResiduals:
    """Combined TOA + wideband-DM residuals
    (:class:`pint_tpu.residuals.WidebandTOAResiduals`, reference
    `WidebandTOAResiduals` / `WidebandDMResiduals`,
    `src/pint/residuals.py:1232,987`).

    The TOA block is an ordinary :class:`Residuals` on ``device``; the DM
    block is ``measured - model`` over the TOAs carrying ``-pp_dm`` flags,
    with DMEFAC/DMEQUAD-scaled uncertainties.  chi2 and dof are the sums
    of the two blocks (reference `CombinedResiduals.chi2`,
    `src/pint/residuals.py:1218`).  Non-finite or nonpositive ``-pp_dme``
    raise under the "raise" and "mask" policies and are downweighted
    under "warn", as pint_tpu judges them."""

    def __init__(self, toas, model: TimingModel,
                 track_mode: Optional[str] = None,
                 policy: Optional[str] = None, device=None):
        dmdata = toas.get_dm_data()
        if dmdata is None:
            raise ValueError(
                "wideband residuals need TOAs with -pp_dm/-pp_dme flags")
        self.dm_index, self.dm_data, self.dm_error = dmdata
        from pint_tpu_torch.toabatch import (ValidationWarning,
                                             resolve_validate_policy)

        pol = resolve_validate_policy(policy)
        # the DM rows ride the same whitened solve as the TOA rows: judge
        # their uncertainties under the same policy ("mask" is not
        # row-consistent across the two blocks, so invalid DM errors
        # raise under both "raise" and "mask")
        dme = np.asarray(self.dm_error, np.float64)
        bad = ~np.isfinite(dme) | (dme <= 0.0)
        if bad.any():
            if pol != "warn":
                from pint_tpu_torch.exceptions import InvalidTOAs

                raise InvalidTOAs(
                    f"{int(bad.sum())} non-finite/nonpositive wideband "
                    'DM uncertainties (-pp_dme); policy="warn" to '
                    "downweight")
            import warnings as _warnings

            _warnings.warn(
                f"downweighting {int(bad.sum())} wideband DM row(s) "
                "with non-finite/nonpositive -pp_dme",
                ValidationWarning)
            self.dm_error = np.where(bad, 1e12, dme)
        self.toa = Residuals(toas, model, track_mode=track_mode,
                             policy=policy, device=device)
        self.toas = toas
        self.model = model
        self._dm_resids_cache: Optional[np.ndarray] = None

    # the attributes the fitters rely on delegate to the TOA block
    @property
    def batch(self):
        return self.toa.batch

    @property
    def pdict(self):
        return self.toa.pdict

    @property
    def device(self):
        return self.toa.device

    @property
    def track_mode(self):
        return self.toa.track_mode

    @property
    def subtract_mean(self):
        return self.toa.subtract_mean

    @property
    def use_weighted_mean(self):
        return self.toa.use_weighted_mean

    @property
    def stale(self) -> bool:
        return self.toa.stale

    def update(self):
        self.toa.update()
        self._dm_resids_cache = None

    # -- TOA block --------------------------------------------------------
    @property
    def time_resids(self) -> np.ndarray:
        return self.toa.time_resids

    def rms_weighted(self) -> float:
        return self.toa.rms_weighted()

    def get_data_error(self) -> np.ndarray:
        return self.toa.get_data_error()

    # -- DM block ---------------------------------------------------------
    def calc_dm_resids(self) -> np.ndarray:
        """measured DM - model DM [pc cm^-3] over the wideband TOAs
        (reference `WidebandDMResiduals.calc_resids`,
        `src/pint/residuals.py:1077`), cached until the next
        :meth:`update`."""
        if self._dm_resids_cache is None:
            with torch.no_grad():
                model_dm = self.model.total_dm(
                    self.toa.pdict, self.toa.batch).cpu().numpy()
            self._dm_resids_cache = self.dm_data - model_dm[self.dm_index]
        return self._dm_resids_cache

    @property
    def dm_resids(self) -> np.ndarray:
        return self.calc_dm_resids()

    def get_dm_error(self) -> np.ndarray:
        """DMEFAC/DMEQUAD-scaled DM uncertainties [pc cm^-3] on the
        wideband rows."""
        with torch.no_grad():
            return scaled_dm_sigma_rows(
                self.model, self.toa.pdict, self.toa.batch, self.dm_index,
                self.dm_error).cpu().numpy()

    def calc_dm_chi2(self) -> float:
        return float(np.sum((self.calc_dm_resids() /
                             self.get_dm_error()) ** 2))

    # -- combined ---------------------------------------------------------
    def calc_chi2(self) -> float:
        return self.toa.calc_chi2() + self.calc_dm_chi2()

    def lnlikelihood(self) -> float:
        r, e = self.calc_dm_resids(), self.get_dm_error()
        dm_ll = -0.5 * (np.sum((r / e) ** 2) + 2.0 * np.sum(np.log(e)) +
                        len(e) * np.log(2.0 * np.pi))
        return self.toa.lnlikelihood() + float(dm_ll)

    @property
    def dof(self) -> int:
        return self.toa.dof + len(self.dm_data)

    @property
    def reduced_chi2(self) -> float:
        return self.calc_chi2() / self.dof
