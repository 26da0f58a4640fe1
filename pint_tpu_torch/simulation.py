"""Simulation of fake TOAs.

Port of the first part of :mod:`pint_tpu.simulation` (reference
`src/pint/simulation.py`): :func:`make_fake_toas_uniform` synthesizes
arrival times from a model by the reference's `zero_residuals` iteration
(start from a uniform grid, evaluate model residuals with "nearest"
tracking and no mean subtraction, shift the TOAs by -residual, repeat
until |residual| < tol), so the arrival times sit on integer model
phases; optional white measurement noise (EFAC/EQUAD-scaled when the
model has white-noise components) is then added;
:func:`make_fake_toas_fromtim` does the same on the TOAs of a tim file,
:func:`add_correlated_noise` adds one realization of the correlated noise,
:func:`add_wideband_dm_data` attaches simulated wideband DMs,
:func:`update_fake_toa_errors` sets the TOAs' errors, and
:func:`calculate_random_models` evaluates parameter vectors drawn from a
fit's covariance.  The residuals run on ``device`` (default ``"cuda"``),
the TOA bookkeeping on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import mjd as mjdmod
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.residuals import build_resid_fn
from pint_tpu_torch.toa import TOAs, get_TOAs_array
from pint_tpu_torch.utils import resolve_device

__all__ = ["zero_residuals", "make_fake_toas_uniform", "make_fake_toas_fromtim",
           "update_fake_toa_errors", "add_wideband_dm_data",
           "add_correlated_noise", "calculate_random_models"]


def zero_residuals(toas: TOAs, model: TimingModel, maxiter: int = 10,
                   tol_us: float = 1e-4, device=None) -> TOAs:
    """Iteratively shift TOAs onto integer model phases (reference
    `zero_residuals`, `src/pint/simulation.py:30`).  The number of
    residual evaluations it took is left in
    ``toas.zero_residuals_iterations``."""
    dev = resolve_device(device)
    f0 = float(model.F0.value)
    if "AbsPhase" in model.components and (
            model.tzr_batch is None or model.tzr_batch.device != dev):
        model.attach_tzr(toas, device=dev)
    for it in range(maxiter):
        batch = toas.to_batch(device=dev)
        fn = build_resid_fn(model, batch, "nearest", False, False)
        p = model.build_pdict(toas, tzr_toas=model.make_tzr_toas_or_none(),
                              device=dev)
        with torch.no_grad():
            r_sec = fn(p).cpu().numpy() / f0
        if np.max(np.abs(r_sec)) < tol_us * 1e-6:
            toas.zero_residuals_iterations = it + 1
            return toas
        toas.utc = mjdmod.add_sec(toas.utc, -r_sec)
        toas.compute_TDBs(ephem=toas.ephem)
        toas.compute_posvels(ephem=toas.ephem, planets=toas.planets)
    raise RuntimeError(
        f"zero_residuals did not converge below {tol_us} us in {maxiter} "
        f"iterations (last max {np.max(np.abs(r_sec))*1e6:.3g} us)")


def make_fake_toas_uniform(startMJD: float, endMJD: float, ntoas: int,
                           model: TimingModel, obs: str = "gbt",
                           error_us: float = 1.0, freq_mhz=1400.0,
                           fuzz_days: float = 0.0,
                           add_noise: bool = False,
                           ephem: Optional[str] = None,
                           planets: Optional[bool] = None,
                           seed: Optional[int] = None,
                           device=None) -> TOAs:
    """Uniformly spaced synthetic TOAs that the model predicts perfectly
    (reference `make_fake_toas_uniform`, `src/pint/simulation.py:208`).
    The random numbers are numpy's (``default_rng(seed)``), so a seed
    gives the same TOAs as :func:`pint_tpu.simulation.make_fake_toas_uniform`."""
    rng = np.random.default_rng(seed)
    times = np.linspace(startMJD, endMJD, ntoas)
    if fuzz_days:
        times = times + rng.uniform(-fuzz_days, fuzz_days, ntoas)
    ephem = ephem or (model.EPHEM.value or "DE421")
    if planets is None:
        planets = bool(model.PLANET_SHAPIRO.value) \
            if "PLANET_SHAPIRO" in model else False
    freqs = np.broadcast_to(np.asarray(freq_mhz, np.float64), (ntoas,))
    toas = get_TOAs_array(times, obs=obs, errors_us=error_us,
                          freqs_mhz=freqs, ephem=ephem, planets=planets)
    toas = zero_residuals(toas, model, device=device)
    if add_noise:
        sigma_us = np.asarray(toas.error_us)
        if model.noise_components:
            # EFAC/EQUAD-scaled white noise, as the reference simulates
            # (`simulation.py:126` uses scaled_toa_uncertainty)
            from pint_tpu_torch.residuals import Residuals

            sigma_us = Residuals(toas, model,
                                 device=device).get_data_error()
        noise = rng.standard_normal(ntoas) * sigma_us * 1e-6
        toas.utc = mjdmod.add_sec(toas.utc, noise)
        toas.compute_TDBs(ephem=ephem)
        toas.compute_posvels(ephem=ephem, planets=planets)
    for f in toas.flags:
        f.setdefault("simulated", "1")
    return toas


def make_fake_toas_fromtim(timfile, model: TimingModel,
                           add_noise: bool = False,
                           seed: Optional[int] = None,
                           device=None) -> TOAs:
    """Replace the TOAs of an existing tim file with model-perfect ones
    (reference `make_fake_toas_fromtim`, `src/pint/simulation.py:477`;
    :func:`pint_tpu.simulation.make_fake_toas_fromtim`), with white noise
    of the TOAs' own errors from numpy's ``default_rng(seed)`` when
    ``add_noise``.  The residuals run on ``device`` (default
    ``"cuda"``)."""
    from pint_tpu_torch.toa import get_TOAs

    rng = np.random.default_rng(seed)
    toas = get_TOAs(timfile, model=model)
    toas = zero_residuals(toas, model, device=device)
    if add_noise:
        noise = rng.standard_normal(toas.ntoas) * toas.error_us * 1e-6
        toas.utc = mjdmod.add_sec(toas.utc, noise)
        toas.compute_TDBs(ephem=toas.ephem)
        toas.compute_posvels(ephem=toas.ephem, planets=toas.planets)
    return toas


def add_correlated_noise(toas: TOAs, model: TimingModel,
                         seed: Optional[int] = None, device=None) -> TOAs:
    """Shift TOAs by one realization of the model's correlated noise
    (ECORR epochs, red-noise Fourier modes): delay = U @ (sqrt(phi) z)
    with z ~ N(0, I) from numpy's ``default_rng(seed)``, so a seed gives
    the realization of :func:`pint_tpu.simulation.add_correlated_noise`
    (reference `make_fake_toas(..., add_correlated_noise=True)`,
    `src/pint/simulation.py:126-170`).  The product runs on ``device``
    (default ``"cuda"``), where the residuals' basis lives."""
    from pint_tpu_torch.residuals import Residuals

    if not model.has_correlated_errors:
        raise ValueError("model has no correlated noise components")
    rng = np.random.default_rng(seed)
    r = Residuals(toas, model, device=device)
    with torch.no_grad():
        U = model.noise_basis(r.pdict)
        phi = model.noise_weights(r.pdict)
        z = torch.as_tensor(rng.standard_normal(U.shape[1]), device=U.device)
        delay_sec = (U @ (torch.sqrt(torch.clamp(phi, min=0.0)) * z)).cpu()
    toas.utc = mjdmod.add_sec(toas.utc, delay_sec.numpy())
    toas.compute_TDBs(ephem=toas.ephem)
    toas.compute_posvels(ephem=toas.ephem, planets=toas.planets)
    return toas


def add_wideband_dm_data(toas: TOAs, model: TimingModel,
                         dm_error: float = 1e-4,
                         add_noise: bool = False,
                         seed: Optional[int] = None, device=None) -> TOAs:
    """Attach simulated wideband DM measurements (``-pp_dm``/``-pp_dme``
    flags) drawn from the model's ``total_dm``
    (:func:`pint_tpu.simulation.add_wideband_dm_data`, reference
    `update_fake_dms`, `src/pint/simulation.py:125`); with ``add_noise``
    white noise of ``dm_error`` from numpy's ``default_rng(seed)``.  The
    model DM runs on ``device`` (default ``"cuda"``)."""
    rng = np.random.default_rng(seed)
    batch = toas.to_batch(device=resolve_device(device))
    p = model.build_pdict(toas, tzr_toas=model.make_tzr_toas_or_none(),
                          device=batch.device)
    with torch.no_grad():
        dm = model.total_dm(p, batch).cpu().numpy()
    if add_noise:
        dm = dm + rng.standard_normal(toas.ntoas) * dm_error
    for i, f in enumerate(toas.flags):
        f["pp_dm"] = repr(float(dm[i]))
        f["pp_dme"] = repr(float(dm_error))
    return toas


def update_fake_toa_errors(toas: TOAs, error_us) -> TOAs:
    """Set every TOA's error [us] (a scalar or one per TOA), as
    :func:`pint_tpu.simulation.update_fake_toa_errors`."""
    toas.error_us = np.broadcast_to(np.asarray(error_us, np.float64),
                                    (toas.ntoas,)).copy()
    return toas


def calculate_random_models(fitter, toas: TOAs, Nmodels: int = 100,
                            seed: Optional[int] = None,
                            return_time: bool = False):
    """Phase (or time) deviations of ``Nmodels`` parameter vectors drawn
    from the fit's covariance, evaluated at ``toas`` (reference
    `calculate_random_models`, `src/pint/simulation.py:524`, a loop over
    copies of the model; :func:`pint_tpu.simulation.
    calculate_random_models`, one ``jax.vmap``).

    The draws are made on the host as pint_tpu makes them (the Cholesky
    factor of the correlation with 1e-12 on its diagonal, then the
    columns scaled; numpy's ``default_rng(seed)``), so a seed and a
    covariance give the same draws.  They are evaluated by one
    ``torch.func.vmap`` of the residual function over the base (all
    offsets 0) and the draws on the fitter's device: on CUDA one
    ``phase_chain`` primal launch over ``Nmodels + 1`` θ sets.  On the
    fit's own TOAs the fitter's residuals are reused, their params dict
    rebuilt first (one more launch, the TZR phase) only if the model's
    values moved since it was built; on other TOAs residuals are built
    from the model as it stands.  The weighted mean of each draw's
    deviation is taken out, as the fit's offset is.

    Returns ``(dphase, draws)``: dphase (Nmodels, ntoas) in cycles
    (seconds if ``return_time``); draws (Nmodels, nfree) the sampled
    parameter offsets in device units."""
    from pint_tpu_torch.fitter import build_resid_sec_fn
    from pint_tpu_torch.residuals import Residuals

    model = fitter.model
    names = fitter.covariance_params or fitter.fit_params
    C = np.asarray(fitter.parameter_covariance_matrix)[
        :len(names), :len(names)]
    s = np.sqrt(np.diag(C))
    L = np.linalg.cholesky(C / np.outer(s, s) +
                           1e-12 * np.eye(len(names)))
    rng = np.random.default_rng(seed)
    draws = (rng.standard_normal((Nmodels, len(names))) @ L.T) * s[None, :]

    if toas is fitter.toas:
        r = fitter.resids
        if r.stale:
            r.update()
    else:
        r = Residuals(toas, model, track_mode=fitter.track_mode,
                      device=fitter.device)
    resid_sec = build_resid_sec_fn(model, r.batch, names, r.track_mode)
    p = r.pdict
    dev = r.device
    w = 1.0 / torch.as_tensor(np.asarray(toas.error_us, np.float64),
                              device=dev) ** 2

    def one(x):
        return resid_sec(x, p)

    with torch.no_grad():
        x = torch.cat([torch.zeros((1, len(names)), dtype=torch.float64,
                                   device=dev),
                       torch.as_tensor(draws, device=dev)])
        out = torch.func.vmap(one)(x)
        d = out[1:] - out[0]
        # take out the weighted offset, as the fit does: the covariance
        # describes the scatter with the offset marginalized
        d = d - (torch.sum(d * w, dim=-1) / torch.sum(w))[:, None]
        dt_sec = d.cpu().numpy()
    if return_time:
        return dt_sec, draws
    return dt_sec * float(model.F0.value), draws
