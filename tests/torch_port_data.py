"""Shared inputs of the ``test_torch_*`` parity tests: small simulated
data sets, written once as tim files that both :mod:`pint_tpu` and
:mod:`pint_tpu_torch` load, and the pint_tpu objects built from them (one
JAX build per test module).  Three sets: the J0740-class ELL1 set below;
a DD set (``dd_realistic_par(dmx_bins=8)``, the same receivers and
sub-bands) with pint_tpu's eager ``fit_toas(maxiter=3)`` from a
perturbed start stored beside it; and a GLS set
(``dd_noise_realistic_par(dmx_bins=8)``: EFAC/EQUAD/ECORR per receiver
and power-law red noise, 50 epochs of four TOAs) with pint_tpu's
``GLSFitter.fit_toas(maxiter=3)`` from the same start beside it.

The set follows ``pint_tpu.examples.simulate_j0740_realistic`` at small
size: ``j0740_realistic_par(dmx_bins=8)`` (spin, astrometry, DM + 8 DMX
bins, ELL1 with M2/SINI, FD1-4, two receiver JUMPs) and three receivers
carrying the ``-fe`` flags the JUMPs select on.  Unlike the bench tim
(one frequency per receiver), each receiver here observes in four
sub-bands: with only three distinct frequencies FD1-4 are degenerate
with the offset and the two JUMPs up to the F1*dt/F0 ~ 1e-9 time
variation of the spin frequency, the fit keeps two directions at ~1e-11
relative singular value, and chi2 at maxiter=2 then depends on
1e-10-relative rounding of the design matrix (ROADMAP.md, queue C).
"""

from __future__ import annotations

import json
import os
import sys
import warnings

import numpy as np

NTOAS = 200
SPAN_DAYS = 4550.0
CENTER_MJD = 54975.0
DMX_BINS = 8
#: channel offsets [MHz] within each receiver band
SUBBANDS_MHZ = np.array([-37.5, -12.5, 12.5, 37.5])

#: the committed copy of the set and pint_tpu's grid chi2 on it (written,
#: with the DD pair below, by ``python tests/torch_port_data.py``);
#: ``chip_smoke.py`` holds the card's grid and fit against them
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REF_TIM = os.path.join(DATA_DIR, "j0740_sim_200.tim")
REF_JSON = os.path.join(DATA_DIR, "j0740_sim_200_grid_chi2.json")

#: the committed DD set and pint_tpu's eager fit on it
DD_REF_TIM = os.path.join(DATA_DIR, "dd_sim_200.tim")
DD_REF_JSON = os.path.join(DATA_DIR, "dd_sim_200_fit.json")
DD_MAXITER = 3
#: the start of the DD fit: offsets [par units] from the simulated truth,
#: as pint_tpu's DD round trip perturbs it (tests/test_binary_dd.py)
DD_PERTURB = {"PB": 1e-7, "A1": 3e-6, "ECC": 1e-6, "OM": 3e-4,
              "F0": 1e-10}

#: the bench's 3x3 M2/SINI grid (bench.py:bench_headline_grid)
GRID = {
    "M2": np.repeat(np.array([0.23, 0.25, 0.27]), 3),
    "SINI": np.tile(np.array([0.97, 0.99, 0.995]), 3),
}


def par_lines():
    from pint_tpu.examples import j0740_realistic_par

    return j0740_realistic_par(dmx_bins=DMX_BINS, span_days=SPAN_DAYS,
                               center_mjd=CENTER_MJD).splitlines()


def write_sim_tim(path: str, ntoas: int = NTOAS, seed: int = 0) -> str:
    """Simulate the set with pint_tpu and write it to ``path``."""
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_uniform
    from pint_tpu.toa import write_tim

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(par_lines())
        band = np.tile([1400.0, 800.0, 1420.0], (ntoas + 2) // 3)[:ntoas]
        freqs = band + np.resize(SUBBANDS_MHZ, (ntoas + 3) // 3).repeat(
            3)[:ntoas]
        toas = make_fake_toas_uniform(
            CENTER_MJD - SPAN_DAYS / 2, CENTER_MJD + SPAN_DAYS / 2, ntoas,
            model, obs="gbt", error_us=1.0, freq_mhz=freqs,
            add_noise=True, seed=seed)
    fe = {800.0: "RCVR800", 1400.0: "RCVR1400", 1420.0: "RCVR1400L"}
    for b_mhz, fl in zip(band, toas.flags):
        fl["fe"] = fe[float(b_mhz)]
    write_tim(path, toas)
    return path


def dd_par_lines():
    from pint_tpu_torch.examples import dd_realistic_par

    return dd_realistic_par(dmx_bins=DMX_BINS, span_days=SPAN_DAYS,
                            center_mjd=CENTER_MJD).splitlines()


def write_dd_sim_tim(path: str, ntoas: int = NTOAS, seed: int = 0) -> str:
    """Simulate the DD set with pint_tpu and write it to ``path``."""
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_uniform
    from pint_tpu.toa import write_tim
    from pint_tpu_torch.examples import RECEIVERS, receiver_freqs

    band, freqs = receiver_freqs(ntoas)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(dd_par_lines())
        toas = make_fake_toas_uniform(
            CENTER_MJD - SPAN_DAYS / 2, CENTER_MJD + SPAN_DAYS / 2, ntoas,
            model, obs="gbt", error_us=1.0, freq_mhz=freqs,
            add_noise=True, seed=seed)
    for b_mhz, fl in zip(band, toas.flags):
        fl["fe"] = RECEIVERS[float(b_mhz)]
    write_tim(path, toas)
    return path


def perturb_dd(model):
    """Move the model to the DD fit's start (:data:`DD_PERTURB`)."""
    for name, d in DD_PERTURB.items():
        model[name].value += d


def device_values(model, names) -> dict:
    """Device values of ``names`` (an MJD parameter's as [day, frac]), as
    plain floats for JSON."""
    def val(n):
        v = model[n].device_value
        return [float(x) for x in v] if np.ndim(v) else float(v)

    return {n: val(n) for n in names}


def fit_record(model, names) -> dict:
    """Device values and uncertainties of ``names`` after a fit."""
    return {"values": device_values(model, names),
            "uncertainties": {n: float(model[n].device_uncertainty)
                              for n in names}}


def jax_dd_fit(timfile: str) -> dict:
    """pint_tpu's eager WLS fit (JAX on the CPU) of the DD set from the
    perturbed start: the record that DD_REF_JSON holds."""
    from pint_tpu.fitter import WLSFitter

    model, toas = load_jax(timfile, par=dd_par_lines())
    perturb_dd(model)
    fitter = WLSFitter(toas, model)
    start = device_values(model, fitter.fit_params)
    chi2 = fitter.fit_toas(maxiter=DD_MAXITER)
    fr = fitter.fitresult
    return {"what": "pint_tpu WLSFitter.fit_toas(maxiter=3), eager, JAX on "
                    "the CPU, on dd_sim_200.tim (dd_realistic_par("
                    "dmx_bins=8)) from the perturbed start",
            "ntoas": toas.ntoas, "maxiter": DD_MAXITER,
            "perturb": DD_PERTURB, "fit_params": fitter.fit_params,
            "start": start, **fit_record(model, fitter.fit_params),
            "chi2": float(chi2), "status": fr.status.name,
            "iterations": fr.iterations, "rung": fr.rung}


#: the committed GLS set (``dd_noise_realistic_par(dmx_bins=8)``, 50
#: epochs of four sub-band TOAs) and pint_tpu's eager GLS fit on it
GLS_REF_TIM = os.path.join(DATA_DIR, "dd_gls_sim_200.tim")
GLS_REF_JSON = os.path.join(DATA_DIR, "dd_gls_sim_200_gls_fit.json")


def dd_gls_par_lines():
    from pint_tpu_torch.examples import dd_noise_realistic_par

    return dd_noise_realistic_par(dmx_bins=DMX_BINS, span_days=SPAN_DAYS,
                                  center_mjd=CENTER_MJD).splitlines()


def write_dd_gls_sim_tim(path: str, ntoas: int = NTOAS, seed: int = 0) -> str:
    """Simulate the GLS set with pint_tpu, as
    ``pint_tpu_torch.examples.simulate_dd_noise_realistic`` does with the
    port (the epochs of ``epoch_toas``; EFAC/EQUAD-scaled white noise from
    ``default_rng(seed + 1)``; one realization of ECORR and red noise with
    ``seed``), and write it to ``path``."""
    from pint_tpu import mjd as mjdmod
    from pint_tpu.models import get_model
    from pint_tpu.residuals import Residuals
    from pint_tpu.simulation import add_correlated_noise, zero_residuals
    from pint_tpu.toa import get_TOAs_array, write_tim
    from pint_tpu_torch.examples import RECEIVERS, epoch_toas

    mjds, band, freqs = epoch_toas(ntoas, SPAN_DAYS, CENTER_MJD)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(dd_gls_par_lines())
        toas = get_TOAs_array(mjds, obs="gbt", errors_us=1.0,
                              freqs_mhz=freqs, ephem="DE421", planets=False)
        for b_mhz, fl in zip(band, toas.flags):
            fl["fe"] = RECEIVERS[float(b_mhz)]
        toas = zero_residuals(toas, model)
        sigma_us = np.asarray(Residuals(toas, model).get_data_error())
        rng = np.random.default_rng(seed + 1)
        toas.utc = mjdmod.add_sec(
            toas.utc, rng.standard_normal(ntoas) * sigma_us * 1e-6)
        toas.compute_TDBs(ephem="DE421")
        toas.compute_posvels(ephem="DE421", planets=False)
        toas = add_correlated_noise(toas, model, seed=seed)
    for f in toas.flags:
        f.setdefault("simulated", "1")
    write_tim(path, toas)
    return path


def jax_gls_fit(timfile: str) -> dict:
    """pint_tpu's eager GLS fit (JAX on the CPU) of the GLS set from the
    perturbed DD start: the record that GLS_REF_JSON holds, with the
    per-component noise realizations."""
    from pint_tpu.fitter import GLSFitter

    model, toas = load_jax(timfile, par=dd_gls_par_lines())
    perturb_dd(model)
    fitter = GLSFitter(toas, model)
    start = device_values(model, fitter.fit_params)
    chi2 = fitter.fit_toas(maxiter=DD_MAXITER)
    fr = fitter.fitresult
    return {"what": "pint_tpu GLSFitter.fit_toas(maxiter=3), eager, JAX on "
                    "the CPU, on dd_gls_sim_200.tim (dd_noise_realistic_par("
                    "dmx_bins=8)) from the perturbed DD start",
            "ntoas": toas.ntoas, "maxiter": DD_MAXITER,
            "perturb": DD_PERTURB, "fit_params": fitter.fit_params,
            "start": start, **fit_record(model, fitter.fit_params),
            "chi2": float(chi2), "status": fr.status.name,
            "iterations": fr.iterations, "rung": fr.rung,
            "noise_resids": {k: np.asarray(v).tolist()
                             for k, v in fitter.noise_resids.items()}}


def write_gls_reference() -> dict:
    """Write GLS_REF_TIM and pint_tpu's GLS fit on it to GLS_REF_JSON;
    returns the JSON record."""
    os.makedirs(DATA_DIR, exist_ok=True)
    write_dd_gls_sim_tim(GLS_REF_TIM)
    rec = jax_gls_fit(GLS_REF_TIM)
    with open(GLS_REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


def load_jax(timfile: str, grid: bool = False, par=None):
    """(model, toas) of pint_tpu from the par lines (default the J0740
    set's) and ``timfile``; ``grid=True`` freezes M2 and SINI as the
    bench does."""
    from pint_tpu.models import get_model
    from pint_tpu.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(par or par_lines())
        toas = get_TOAs(timfile, model=model)
    if grid:
        model.M2.frozen = True
        model.SINI.frozen = True
    return model, toas


def load_torch(timfile: str, grid: bool = False, par=None):
    """(model, toas) of pint_tpu_torch from the same inputs."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(par or par_lines())
        toas = get_TOAs(timfile, model=model)
    if grid:
        model.M2.frozen = True
        model.SINI.frozen = True
    return model, toas


def tree_numpy(tree):
    """A pint_tpu params dict with every leaf as a numpy array."""
    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def sim_tim(tmp_path_factory, name: str = "j0740_sim.tim") -> str:
    d = tmp_path_factory.mktemp("torch_port")
    return write_sim_tim(os.path.join(str(d), name))


def dd_sim_tim(tmp_path_factory, name: str = "dd_sim.tim") -> str:
    d = tmp_path_factory.mktemp("torch_port_dd")
    return write_dd_sim_tim(os.path.join(str(d), name))


def write_dd_reference() -> dict:
    """Write DD_REF_TIM and pint_tpu's eager fit on it to DD_REF_JSON;
    returns the JSON record."""
    os.makedirs(DATA_DIR, exist_ok=True)
    write_dd_sim_tim(DD_REF_TIM)
    rec = jax_dd_fit(DD_REF_TIM)
    with open(DD_REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


def write_reference(maxiter: int = 2) -> dict:
    """Write REF_TIM and pint_tpu's grid chi2 on it (the SVD solve
    pint_tpu picks on the CPU) to REF_JSON; returns the JSON record."""
    from pint_tpu.fitter import WLSFitter, fit_wls_svd
    from pint_tpu.gridutils import grid_chisq_flat

    os.makedirs(DATA_DIR, exist_ok=True)
    write_sim_tim(REF_TIM)
    model, toas = load_jax(REF_TIM, grid=True)
    fitter = WLSFitter(toas, model)
    rec = {
        "what": "pint_tpu grid_chisq_flat on j0740_sim_200.tim "
                "(j0740_realistic_par(dmx_bins=8), JAX on the CPU)",
        "maxiter": maxiter, "ntoas": toas.ntoas,
        "fit_params": fitter.fit_params,
        "grid": {k: v.tolist() for k, v in GRID.items()},
        "kernel": "fit_wls_svd",
        "chi2": grid_chisq_flat(fitter, GRID, maxiter=maxiter,
                                kernel=fit_wls_svd).tolist(),
    }
    with open(REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(DATA_DIR)))
    print(json.dumps(write_reference()["chi2"]))
    print(json.dumps(write_dd_reference()["chi2"]))
    print(json.dumps(write_gls_reference()["chi2"]))
