"""Simulation of fake TOAs.

Port of the first part of :mod:`pint_tpu.simulation` (reference
`src/pint/simulation.py`): :func:`make_fake_toas_uniform` synthesizes
arrival times from a model by the reference's `zero_residuals` iteration
(start from a uniform grid, evaluate model residuals with "nearest"
tracking and no mean subtraction, shift the TOAs by -residual, repeat
until |residual| < tol), so the arrival times sit on integer model
phases; optional white measurement noise (EFAC/EQUAD-scaled when the
model has white-noise components) is then added, and
:func:`add_correlated_noise` adds one realization of the correlated noise.
The residuals run on ``device`` (default ``"cuda"``), the TOA bookkeeping
on the host.  The rest of pint_tpu's simulation module is not ported
yet.
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

__all__ = ["zero_residuals", "make_fake_toas_uniform", "add_correlated_noise"]


def zero_residuals(toas: TOAs, model: TimingModel, maxiter: int = 10,
                   tol_us: float = 1e-4, device=None) -> TOAs:
    """Iteratively shift TOAs onto integer model phases (reference
    `zero_residuals`, `src/pint/simulation.py:30`)."""
    dev = resolve_device(device)
    f0 = float(model.F0.value)
    if "AbsPhase" in model.components and (
            model.tzr_batch is None or model.tzr_batch.device != dev):
        model.attach_tzr(toas, device=dev)
    for _ in range(maxiter):
        batch = toas.to_batch(device=dev)
        fn = build_resid_fn(model, batch, "nearest", False, False)
        p = model.build_pdict(toas, tzr_toas=model.make_tzr_toas_or_none(),
                              device=dev)
        with torch.no_grad():
            r_sec = fn(p).cpu().numpy() / f0
        if np.max(np.abs(r_sec)) < tol_us * 1e-6:
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
