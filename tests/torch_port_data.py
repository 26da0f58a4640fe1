"""Shared inputs of the ``test_torch_*`` parity tests: small simulated
data sets, written once as tim files that both :mod:`pint_tpu` and
:mod:`pint_tpu_torch` load, and the pint_tpu objects built from them (one
JAX build per test module).  Three sets: the J0740-class ELL1 set below;
a DD set (``dd_realistic_par(dmx_bins=8)``, the same receivers and
sub-bands) with pint_tpu's eager ``fit_toas(maxiter=3)`` from a
perturbed start stored beside it; and a GLS set
(``dd_noise_realistic_par(dmx_bins=8)``: EFAC/EQUAD/ECORR per receiver
and power-law red noise, 50 epochs of four TOAs) with pint_tpu's
``GLSFitter.fit_toas(maxiter=3)`` from the same start beside it; and a
DDK set in ecliptic coordinates (``ddk_ecliptic_realistic_par
(dmx_bins=8)``, simulated as the DD set is) with pint_tpu's eager
``fit_toas(maxiter=3)`` from a perturbed start beside it; pint_tpu's
DownhillWLSFitter, LMFitter and PowellFitter results on the DD set; and
a noise-fitting set (the GLS set's model with per-TOA errors that vary,
``dd_noise_fit_par``) with pint_tpu's DownhillGLSFitter fit of the
timing and the white-noise parameters beside it; and a wideband set
(``wideband_nanograv_par(dmx_bins=8)``: the GLS set's model and epochs
with NE_SW, two DMJUMPs, DMEFAC/DMEQUAD per receiver and a wideband DM on
every TOA) with pint_tpu's WidebandTOAFitter, WidebandDownhillFitter (the
DMEFACs free) and WidebandLMFitter fits beside it; a spider set
(``spider_realistic_par(dmx_bins=8)``: the FBn orbit, ORBWAVEs and
PLANET_SHAPIRO) with pint_tpu's ``Fitter.auto`` fit beside it; and a
BT_PIECEWISE set (``btpw_par(dmx_bins=8)``) with pint_tpu's eager
``WLSFitter`` fit beside it.

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
    perturb(model, DD_PERTURB)


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


def write_dd_gls_sim_tim(path: str, ntoas: int = NTOAS, seed: int = 0,
                         errors_us=1.0, par=None, finish=None,
                         receivers=None) -> str:
    """Simulate the GLS set with pint_tpu, as
    ``pint_tpu_torch.examples.simulate_dd_noise_realistic`` does with the
    port (the epochs of ``epoch_toas``, TOA errors ``errors_us``;
    EFAC/EQUAD-scaled white noise from ``default_rng(seed + 1)``; one
    realization of ECORR and red noise with ``seed``), and write it to
    ``path``.  ``par`` replaces the GLS set's par lines, and
    ``finish(toas, model)``, if given, runs on the simulated TOAs before
    they are written; ``receivers`` replaces ``examples.RECEIVERS``."""
    from pint_tpu import mjd as mjdmod
    from pint_tpu.models import get_model
    from pint_tpu.residuals import Residuals
    from pint_tpu.simulation import add_correlated_noise, zero_residuals
    from pint_tpu.toa import get_TOAs_array, write_tim
    from pint_tpu_torch.examples import RECEIVERS, epoch_toas

    receivers = receivers or RECEIVERS
    mjds, band, freqs = epoch_toas(ntoas, SPAN_DAYS, CENTER_MJD, receivers)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(par or dd_gls_par_lines())
        toas = get_TOAs_array(mjds, obs="gbt", errors_us=errors_us,
                              freqs_mhz=freqs, ephem="DE421", planets=False)
        for b_mhz, fl in zip(band, toas.flags):
            fl["fe"] = receivers[float(b_mhz)]
        toas = zero_residuals(toas, model)
        sigma_us = np.asarray(Residuals(toas, model).get_data_error())
        rng = np.random.default_rng(seed + 1)
        toas.utc = mjdmod.add_sec(
            toas.utc, rng.standard_normal(ntoas) * sigma_us * 1e-6)
        toas.compute_TDBs(ephem="DE421")
        toas.compute_posvels(ephem="DE421", planets=False)
        toas = add_correlated_noise(toas, model, seed=seed)
        if finish is not None:
            finish(toas, model)
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


#: the committed DDK set in ecliptic coordinates and pint_tpu's eager fit
#: on it
DDK_REF_TIM = os.path.join(DATA_DIR, "ddk_ecl_sim_200.tim")
DDK_REF_JSON = os.path.join(DATA_DIR, "ddk_ecl_sim_200_fit.json")
#: the start of the DDK fit: the DD fit's offsets, and KIN and KOM moved
#: by a fraction of a degree [par units]
DDK_PERTURB = {**DD_PERTURB, "KIN": 0.05, "KOM": 0.5}
#: the DDK reference fit's iterations: at 3 the weak KOM-KIN-PB direction
#: of 200 TOAs still moves, and the fused loop's eigh steps and the
#: eager SVD steps part by 1.4e-3 sigma there; by 6 the fit sits at its
#: fixed point (1.2e-5 sigma apart)
DDK_MAXITER = 6


def variant_par_lines(kind: str):
    """One of ``pint_tpu_torch.examples.VARIANTS`` at this module's size."""
    from pint_tpu_torch.examples import variant_par

    return variant_par(kind, dmx_bins=DMX_BINS, span_days=SPAN_DAYS,
                       center_mjd=CENTER_MJD).splitlines()


def variant_tim(kind: str) -> str:
    """The committed set a variant is checked on: the DDK set for DDK in
    ecliptic coordinates, else the DD or the J0740 set by family."""
    if kind == "DDK_ECL":
        return DDK_REF_TIM
    return DD_REF_TIM if kind.startswith("DD") else REF_TIM


def dm_family_par_lines(kind: str):
    """One of ``pint_tpu_torch.examples.DM_FAMILY`` at this module's
    size."""
    from pint_tpu_torch.examples import dm_family_par

    return dm_family_par(kind, dmx_bins=DMX_BINS, span_days=SPAN_DAYS,
                         center_mjd=CENTER_MJD).splitlines()


def dm_family_tim(kind: str) -> str:
    """The committed set a DM-family variant is checked on: the DD set or
    the J0740 set by its binary."""
    return DD_REF_TIM if kind.startswith("DMF_DD") else REF_TIM


def chrom_family_par_lines(kind: str):
    """One of ``pint_tpu_torch.examples.CHROM_FAMILY`` at this module's
    size."""
    from pint_tpu_torch.examples import chromatic_family_par

    return chromatic_family_par(kind, dmx_bins=DMX_BINS, span_days=SPAN_DAYS,
                                center_mjd=CENTER_MJD).splitlines()


def chrom_family_tim(kind: str) -> str:
    """The committed set a chromatic-family variant is checked on: the DD
    set or the J0740 set by its binary."""
    return DD_REF_TIM if kind.startswith("CHF_DD") else REF_TIM


def ddk_par_lines():
    from pint_tpu_torch.examples import ddk_ecliptic_realistic_par

    return ddk_ecliptic_realistic_par(dmx_bins=DMX_BINS, span_days=SPAN_DAYS,
                                      center_mjd=CENTER_MJD).splitlines()


def write_ddk_sim_tim(path: str, ntoas: int = NTOAS, seed: int = 0) -> str:
    """Simulate the DDK set with pint_tpu, as the DD set, and write it to
    ``path``."""
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_uniform
    from pint_tpu.toa import write_tim
    from pint_tpu_torch.examples import RECEIVERS, receiver_freqs

    band, freqs = receiver_freqs(ntoas)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(ddk_par_lines())
        toas = make_fake_toas_uniform(
            CENTER_MJD - SPAN_DAYS / 2, CENTER_MJD + SPAN_DAYS / 2, ntoas,
            model, obs="gbt", error_us=1.0, freq_mhz=freqs,
            add_noise=True, seed=seed)
    for b_mhz, fl in zip(band, toas.flags):
        fl["fe"] = RECEIVERS[float(b_mhz)]
    write_tim(path, toas)
    return path


def perturb(model, offsets: dict):
    """Move the model's parameters by ``offsets`` [par units]."""
    for name, d in offsets.items():
        model[name].value += d


def jax_ddk_fit(timfile: str) -> dict:
    """pint_tpu's eager WLS fit (JAX on the CPU) of the DDK set from the
    perturbed start: the record that DDK_REF_JSON holds."""
    from pint_tpu.fitter import WLSFitter

    model, toas = load_jax(timfile, par=ddk_par_lines())
    perturb(model, DDK_PERTURB)
    fitter = WLSFitter(toas, model)
    start = device_values(model, fitter.fit_params)
    chi2 = fitter.fit_toas(maxiter=DDK_MAXITER)
    fr = fitter.fitresult
    return {"what": f"pint_tpu WLSFitter.fit_toas(maxiter={DDK_MAXITER}), "
                    "eager, JAX on the CPU, on ddk_ecl_sim_200.tim ("
                    "ddk_ecliptic_realistic_par(dmx_bins=8)) from the "
                    "perturbed start",
            "ntoas": toas.ntoas, "maxiter": DDK_MAXITER,
            "perturb": DDK_PERTURB, "fit_params": fitter.fit_params,
            "start": start, **fit_record(model, fitter.fit_params),
            "chi2": float(chi2), "status": fr.status.name,
            "iterations": fr.iterations, "rung": fr.rung}


def write_ddk_reference() -> dict:
    """Write DDK_REF_TIM and pint_tpu's eager fit on it to DDK_REF_JSON;
    returns the JSON record."""
    os.makedirs(DATA_DIR, exist_ok=True)
    write_ddk_sim_tim(DDK_REF_TIM)
    rec = jax_ddk_fit(DDK_REF_TIM)
    with open(DDK_REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


#: pint_tpu's DownhillWLSFitter, LMFitter and PowellFitter on the DD set,
#: each from the perturbed DD start
FITTERS_REF_JSON = os.path.join(DATA_DIR, "dd_sim_200_fitters.json")
#: Powell's free parameters: the five that DD_PERTURB moves (the rest
#: frozen at the par's values); each chi2 evaluation is a host round
#: trip, and Powell takes ~1,300 of them for these five
POWELL_PARAMS = tuple(DD_PERTURB)


def powell_subset(model):
    """Freeze every free parameter of ``model`` but POWELL_PARAMS."""
    for n in model.free_params:
        if n not in POWELL_PARAMS:
            model[n].frozen = True


def fit_gaps(model, values: dict, uncertainties: dict):
    """(max |value - stored value| / stored sigma, max |uncertainty /
    stored uncertainty - 1|) of ``model``'s parameters over a stored
    record's values and uncertainties; those stored as None (an
    uncertainty pint_tpu left unset) are skipped."""
    sig, unc = 0.0, 0.0
    for n, u in uncertainties.items():
        if u is None:
            continue
        v = float(np.sum(np.asarray(model[n].device_value)
                         - np.asarray(values[n])))
        sig = max(sig, abs(v) / u)
        unc = max(unc, abs(model[n].device_uncertainty / u - 1.0))
    return sig, unc


def fitter_record(fitter, chi2: float) -> dict:
    """A fit's chi2, FitSummary fields and fitted parameters."""
    fr = fitter.fitresult
    return {"fit_params": fitter.fit_params,
            **fit_record(fitter.model, fitter.fit_params),
            "chi2": float(chi2), "status": fr.status.name,
            "iterations": fr.iterations, "rung": fr.rung,
            "converged": bool(fr.converged)}


def jax_fitters(timfile: str) -> dict:
    """pint_tpu's DownhillWLSFitter (defaults), LMFitter (defaults) and
    PowellFitter (defaults, POWELL_PARAMS free) on the DD set from the
    perturbed start (JAX on the CPU): the record FITTERS_REF_JSON holds."""
    from pint_tpu.fitter import DownhillWLSFitter, LMFitter, PowellFitter

    rec = {"what": "pint_tpu DownhillWLSFitter, LMFitter and PowellFitter "
                   "fit_toas() with their defaults, JAX on the CPU, on "
                   "dd_sim_200.tim from the perturbed DD start; Powell "
                   "with only POWELL_PARAMS free",
           "perturb": DD_PERTURB, "powell_params": list(POWELL_PARAMS)}
    for label, cls in (("downhill_wls", DownhillWLSFitter),
                       ("lm", LMFitter), ("powell", PowellFitter)):
        model, toas = load_jax(timfile, par=dd_par_lines())
        perturb_dd(model)
        if cls is PowellFitter:
            powell_subset(model)
        fitter = cls(toas, model)
        start = device_values(model, fitter.fit_params)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            chi2 = fitter.fit_toas()
        rec[label] = {"start": start, **fitter_record(fitter, chi2)}
    return rec


def write_fitters_reference() -> dict:
    """pint_tpu's three fits on DD_REF_TIM to FITTERS_REF_JSON."""
    rec = jax_fitters(DD_REF_TIM)
    with open(FITTERS_REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


#: the committed noise-fitting set (the GLS set's model and epochs, with
#: per-TOA errors from ``examples.noise_fit_errors_us``) and pint_tpu's
#: DownhillGLSFitter fit on it
NOISEFIT_REF_TIM = os.path.join(DATA_DIR, "dd_noisefit_sim_200.tim")
NOISEFIT_REF_JSON = os.path.join(DATA_DIR, "dd_noisefit_sim_200_fit.json")
#: the noise parameters free at 200 TOAs: EFAC, EQUAD and ECORR per
#: receiver; the red noise stays frozen, since 50 epochs do not
#: constrain it
NOISEFIT_FREE = ("EFAC1", "EFAC2", "EFAC3", "EQUAD1", "EQUAD2", "EQUAD3",
                 "ECORR1", "ECORR2", "ECORR3")


def noisefit_par_lines():
    from pint_tpu_torch.examples import dd_noise_fit_par

    return dd_noise_fit_par(DMX_BINS, SPAN_DAYS, CENTER_MJD,
                            free=NOISEFIT_FREE).splitlines()


def noisefit_start(model):
    """The perturbed DD start, and the free noise parameters moved to
    ``examples.NOISE_FIT_START``."""
    from pint_tpu_torch.examples import NOISE_FIT_START

    perturb_dd(model)
    for n in NOISEFIT_FREE:
        model[n].value = NOISE_FIT_START[n]


def write_noisefit_sim_tim(path: str, ntoas: int = NTOAS,
                           seed: int = 0) -> str:
    """Simulate the noise-fitting set with pint_tpu and write it."""
    from pint_tpu_torch.examples import noise_fit_errors_us

    return write_dd_gls_sim_tim(path, ntoas, seed,
                                errors_us=noise_fit_errors_us(ntoas, seed))


def jax_noisefit(timfile: str) -> dict:
    """pint_tpu's DownhillGLSFitter (defaults: maxiter 20, two noise
    fits) of the noise-fitting set from :func:`noisefit_start`: the
    record NOISEFIT_REF_JSON holds, with the noise parameters' values and
    uncertainties (None where pint_tpu left one unset)."""
    from pint_tpu.fitter import DownhillGLSFitter

    model, toas = load_jax(timfile, par=noisefit_par_lines())
    noisefit_start(model)
    fitter = DownhillGLSFitter(toas, model)
    start = device_values(model, fitter.fit_params + list(NOISEFIT_FREE))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas()
    noise_unc = {n: (None if model[n].uncertainty is None
                     else float(model[n].device_uncertainty))
                 for n in NOISEFIT_FREE}
    return {"what": "pint_tpu DownhillGLSFitter.fit_toas() with its "
                    "defaults, JAX on the CPU, on dd_noisefit_sim_200.tim "
                    "(dd_noise_fit_par(dmx_bins=8), EFAC/EQUAD/ECORR free) "
                    "from the perturbed DD start and NOISE_FIT_START",
            "ntoas": toas.ntoas, "perturb": DD_PERTURB, "start": start,
            **fitter_record(fitter, chi2),
            "noise_params": list(NOISEFIT_FREE),
            "noise_values": device_values(model, NOISEFIT_FREE),
            "noise_uncertainties": noise_unc,
            "reduced_chi2": float(fitter.resids.reduced_chi2)}


def write_noisefit_reference() -> dict:
    """Write NOISEFIT_REF_TIM and pint_tpu's fit on it."""
    os.makedirs(DATA_DIR, exist_ok=True)
    write_noisefit_sim_tim(NOISEFIT_REF_TIM)
    rec = jax_noisefit(NOISEFIT_REF_TIM)
    with open(NOISEFIT_REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


#: the committed wideband set and pint_tpu's three wideband fits on it
WB_REF_TIM = os.path.join(DATA_DIR, "wb_sim_200.tim")
WB_REF_JSON = os.path.join(DATA_DIR, "wb_sim_200_fit.json")


def wb_par_lines(free=None):
    """The wideband set's par lines: ``wideband_nanograv_par(dmx_bins=8)``
    with the DMEFACs of ``free`` free (default all three)."""
    from pint_tpu_torch.examples import WB_NOISE_FREE, wideband_nanograv_par

    return wideband_nanograv_par(
        DMX_BINS, SPAN_DAYS, CENTER_MJD,
        free=WB_NOISE_FREE if free is None else free).splitlines()


def wb_start(model):
    """The perturbed DD start with the DMJUMPs at zero and any free DMEFAC
    at 1 (``examples.WB_START``)."""
    from pint_tpu_torch.examples import WB_START

    perturb_dd(model)
    for n, v in WB_START.items():
        if n.startswith("DMJUMP") or not model[n].frozen:
            model[n].value = v


def write_wb_sim_tim(path: str, ntoas: int = NTOAS, seed: int = 0) -> str:
    """Simulate the wideband set with pint_tpu, as
    ``pint_tpu_torch.examples.simulate_wideband_realistic`` does with the
    port: the GLS set's simulation of the wideband par, then pint_tpu's
    ``add_wideband_dm_data`` and white DM noise at the DMEFAC/DMEQUAD-
    scaled per-receiver errors (``examples.set_wideband_dms``)."""
    from pint_tpu.residuals import Residuals
    from pint_tpu.simulation import add_wideband_dm_data
    from pint_tpu_torch.examples import set_wideband_dms, wideband_dm_errors

    def finish(toas, model):
        add_wideband_dm_data(toas, model)
        dm = np.array([float(f["pp_dm"]) for f in toas.flags])
        dme = wideband_dm_errors(toas)
        r = Residuals(toas, model)
        sigma = np.asarray(model.scaled_dm_uncertainty(r.pdict, r.batch,
                                                       dme))
        set_wideband_dms(toas, dm, sigma, dme, seed)

    return write_dd_gls_sim_tim(path, ntoas, seed, par=wb_par_lines(),
                                finish=finish)


#: WidebandTOAFitter's iterations on the wideband set
WB_MAXITER = 3


def wb_noise_record(model, names) -> dict:
    return {"noise_params": list(names),
            "noise_values": device_values(model, names),
            "noise_uncertainties": {
                n: (None if model[n].uncertainty is None
                    else float(model[n].device_uncertainty))
                for n in names}}


def jax_wb_fits(timfile: str) -> dict:
    """pint_tpu's wideband fits (JAX on the CPU) of the wideband set from
    :func:`wb_start`: WidebandTOAFitter.fit_toas(maxiter=3) and
    WidebandLMFitter.fit_toas() with the DMEFACs frozen at the injected
    values, WidebandDownhillFitter.fit_toas() (its defaults) with them
    free: the record WB_REF_JSON holds."""
    from pint_tpu.fitter import (WidebandDownhillFitter, WidebandLMFitter,
                                 WidebandTOAFitter)
    from pint_tpu_torch.examples import WB_NOISE_FREE

    rec = {"what": "pint_tpu WidebandTOAFitter.fit_toas(maxiter=3), "
                   "WidebandLMFitter.fit_toas() (DMEFACs frozen) and "
                   "WidebandDownhillFitter.fit_toas() (DMEFACs free), JAX "
                   "on the CPU, on wb_sim_200.tim (wideband_nanograv_par("
                   "dmx_bins=8)) from the perturbed DD start, DMJUMPs 0",
           "perturb": DD_PERTURB, "maxiter": WB_MAXITER}
    for label, cls, free in (("wideband_gls", WidebandTOAFitter, ()),
                             ("wideband_lm", WidebandLMFitter, ()),
                             ("wideband_downhill", WidebandDownhillFitter,
                              WB_NOISE_FREE)):
        model, toas = load_jax(timfile, par=wb_par_lines(free))
        wb_start(model)
        fitter = cls(toas, model)
        start = device_values(model, fitter.fit_params + list(free))
        kw = {"maxiter": WB_MAXITER} if cls is WidebandTOAFitter else {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            chi2 = fitter.fit_toas(**kw)
        rec[label] = {"start": start, **fitter_record(fitter, chi2),
                      "dof": int(fitter.resids.dof),
                      **wb_noise_record(model, free)}
    return rec


def write_wb_reference() -> dict:
    """Write WB_REF_TIM and pint_tpu's wideband fits on it."""
    os.makedirs(DATA_DIR, exist_ok=True)
    write_wb_sim_tim(WB_REF_TIM)
    rec = jax_wb_fits(WB_REF_TIM)
    with open(WB_REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


#: the committed chromatic set (``chromatic_j1713_par(dmx_bins=8)``, 50
#: epochs of four sub-band TOAs on 430, 820 and 1400 MHz) and pint_tpu's
#: DownhillGLSFitter fit of its timing and chromatic noise beside it
CHROM_REF_TIM = os.path.join(DATA_DIR, "chrom_sim_200.tim")
CHROM_REF_JSON = os.path.join(DATA_DIR, "chrom_sim_200_fit.json")


def chrom_par_lines(free=None):
    """The chromatic set's par lines: ``chromatic_j1713_par(dmx_bins=8)``
    with ``examples.CHROM_NOISE_200``'s amplitudes and the noise
    parameters of ``free`` free (default ``examples.CHROM_NOISE_FREE``)."""
    from pint_tpu_torch.examples import (CHROM_NOISE_200, CHROM_NOISE_FREE,
                                         chromatic_j1713_par)

    return chromatic_j1713_par(
        DMX_BINS, SPAN_DAYS, CENTER_MJD,
        free=CHROM_NOISE_FREE if free is None else free,
        noise=CHROM_NOISE_200).splitlines()


def chrom_start(model):
    """The perturbed DD start, the chromatic terms moved and the free
    noise at its start (``examples.chromatic_start``)."""
    from pint_tpu_torch.examples import chromatic_start

    perturb_dd(model)
    chromatic_start(model)


def write_chrom_sim_tim(path: str, ntoas: int = NTOAS, seed: int = 0) -> str:
    """Simulate the chromatic set with pint_tpu, as
    ``pint_tpu_torch.examples.simulate_chromatic_j1713`` does with the
    port, and write it."""
    from pint_tpu_torch.examples import CHROM_RECEIVERS

    return write_dd_gls_sim_tim(path, ntoas, seed, par=chrom_par_lines(),
                                receivers=CHROM_RECEIVERS)


def jax_chrom_fit(timfile: str) -> dict:
    """pint_tpu's DownhillGLSFitter (its defaults) of the chromatic set
    from :func:`chrom_start`: the record CHROM_REF_JSON holds."""
    from pint_tpu.fitter import DownhillGLSFitter
    from pint_tpu_torch.examples import CHROM_NOISE_FREE

    model, toas = load_jax(timfile, par=chrom_par_lines())
    chrom_start(model)
    fitter = DownhillGLSFitter(toas, model)
    start = device_values(model, fitter.fit_params + list(CHROM_NOISE_FREE))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas()
    return {"what": "pint_tpu DownhillGLSFitter.fit_toas() with its "
                    "defaults, JAX on the CPU, on chrom_sim_200.tim "
                    "(chromatic_j1713_par(dmx_bins=8)) from the perturbed "
                    "DD start and examples.chromatic_start",
            "ntoas": toas.ntoas, "perturb": DD_PERTURB, "start": start,
            **fitter_record(fitter, chi2),
            **wb_noise_record(model, CHROM_NOISE_FREE),
            "reduced_chi2": float(fitter.resids.reduced_chi2)}


def write_chrom_reference() -> dict:
    """Write CHROM_REF_TIM and pint_tpu's fit on it."""
    os.makedirs(DATA_DIR, exist_ok=True)
    write_chrom_sim_tim(CHROM_REF_TIM)
    rec = jax_chrom_fit(CHROM_REF_TIM)
    with open(CHROM_REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


#: the committed WaveX set (the DD par with WaveX, DMWaveX and CMWaveX in
#: place of DMX, ChromaticCM, four CMX ranges and the troposphere) and
#: pint_tpu's WLSFitter fit beside it
WAVEX_REF_TIM = os.path.join(DATA_DIR, "wavex_sim_200.tim")
WAVEX_REF_JSON = os.path.join(DATA_DIR, "wavex_sim_200_fit.json")
def wavex_par_lines():
    """The WaveX set's par lines before the sinusoids
    (``examples.wavex_set_par(span_days, center_mjd)``)."""
    from pint_tpu_torch.examples import wavex_set_par

    return wavex_set_par(SPAN_DAYS, CENTER_MJD).splitlines()


def wavex_model(pkg: str, inject: bool = True):
    """The WaveX set's model in ``pkg`` ("pint_tpu" or "pint_tpu_torch"),
    built by ``examples.wavex_set_model`` with that package's
    ``get_model`` and setup helpers."""
    import importlib

    from pint_tpu_torch.examples import wavex_set_model

    return wavex_set_model(importlib.import_module(pkg + ".models"),
                           importlib.import_module(pkg + ".models.wave"),
                           SPAN_DAYS, CENTER_MJD, inject=inject)


def wavex_full_par_lines():
    """The WaveX set's truth model (the sinusoids injected) as par lines
    of the port."""
    return wavex_model("pint_tpu_torch").as_parfile().splitlines()


def write_wavex_sim_tim(path: str, ntoas: int = NTOAS, seed: int = 0) -> str:
    """Simulate the WaveX set with pint_tpu (uniform TOAs, as the DD set)
    and write it."""
    from pint_tpu.simulation import make_fake_toas_uniform
    from pint_tpu.toa import write_tim
    from pint_tpu_torch.examples import RECEIVERS, receiver_freqs

    band, freqs = receiver_freqs(ntoas)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        toas = make_fake_toas_uniform(
            CENTER_MJD - SPAN_DAYS / 2, CENTER_MJD + SPAN_DAYS / 2, ntoas,
            wavex_model("pint_tpu"), obs="gbt", error_us=1.0,
            freq_mhz=freqs, add_noise=True, seed=seed)
    for b_mhz, fl in zip(band, toas.flags):
        fl["fe"] = RECEIVERS[float(b_mhz)]
    write_tim(path, toas)
    return path


def load_wavex(pkg: str, timfile: str = WAVEX_REF_TIM):
    """(model, toas) of the WaveX set in ``pkg`` at the fit's start: the
    perturbed DD start, the sinusoid amplitudes at zero."""
    import importlib

    get_TOAs = importlib.import_module(pkg + ".toa").get_TOAs
    model = wavex_model(pkg, inject=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        toas = get_TOAs(timfile, model=model)
    perturb_dd(model)
    return model, toas


def jax_wavex_fit(timfile: str) -> dict:
    """pint_tpu's eager WLSFitter.fit_toas(maxiter=3) of the WaveX set from
    :func:`load_wavex`'s start: the record WAVEX_REF_JSON holds."""
    from pint_tpu.fitter import WLSFitter

    model, toas = load_wavex("pint_tpu", timfile)
    fitter = WLSFitter(toas, model)
    start = device_values(model, fitter.fit_params)
    chi2 = fitter.fit_toas(maxiter=DD_MAXITER)
    fr = fitter.fitresult
    return {"what": "pint_tpu WLSFitter.fit_toas(maxiter=3), eager, JAX on "
                    "the CPU, on wavex_sim_200.tim (the DD par without DMX, "
                    "with CM, four CMX ranges, CORRECT_TROPOSPHERE Y and "
                    "WaveX/DMWaveX/CMWaveX from the setup helpers) from the "
                    "perturbed DD start, amplitudes 0",
            "ntoas": toas.ntoas, "maxiter": DD_MAXITER,
            "perturb": DD_PERTURB, "fit_params": fitter.fit_params,
            "start": start, **fit_record(model, fitter.fit_params),
            "chi2": float(chi2), "status": fr.status.name,
            "iterations": fr.iterations, "rung": fr.rung}


def write_wavex_reference() -> dict:
    """Write WAVEX_REF_TIM and pint_tpu's fit on it."""
    os.makedirs(DATA_DIR, exist_ok=True)
    write_wavex_sim_tim(WAVEX_REF_TIM)
    rec = jax_wavex_fit(WAVEX_REF_TIM)
    with open(WAVEX_REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


#: the committed spider set (``spider_realistic_par(dmx_bins=8)``, the
#: DD set's receivers and sub-bands) and pint_tpu's Fitter.auto fit of it
SPIDER_REF_TIM = os.path.join(DATA_DIR, "spider_sim_200.tim")
SPIDER_REF_JSON = os.path.join(DATA_DIR, "spider_sim_200_fit.json")
#: the committed BT_PIECEWISE set (``btpw_par(dmx_bins=8)``) and
#: pint_tpu's eager WLSFitter fit of it
BTPW_REF_TIM = os.path.join(DATA_DIR, "btpw_sim_200.tim")
BTPW_REF_JSON = os.path.join(DATA_DIR, "btpw_sim_200_fit.json")


def spider_par_lines():
    from pint_tpu_torch.examples import spider_realistic_par

    return spider_realistic_par(DMX_BINS, SPAN_DAYS, CENTER_MJD).splitlines()


def btpw_par_lines():
    from pint_tpu_torch.examples import btpw_par

    return btpw_par(DMX_BINS, SPAN_DAYS, CENTER_MJD).splitlines()


def orbit_family_par_lines(kind: str):
    """One of ``pint_tpu_torch.examples.ORBIT_FAMILY`` at this module's
    size."""
    from pint_tpu_torch.examples import orbit_family_par

    return orbit_family_par(kind, dmx_bins=DMX_BINS, span_days=SPAN_DAYS,
                            center_mjd=CENTER_MJD).splitlines()


def orbit_mixed_lines():
    """``examples.orbit_mixed_par`` at this module's size."""
    from pint_tpu_torch.examples import orbit_mixed_par

    return orbit_mixed_par(DMX_BINS, SPAN_DAYS, CENTER_MJD).splitlines()


def orbit_family_tim(kind: str) -> str:
    """The committed set an orbit-family variant is checked on: the DD set
    or the J0740 set by its binary."""
    return DD_REF_TIM if kind.startswith("ORB_DD") else REF_TIM


def write_uniform_sim_tim(path: str, par, ntoas: int = NTOAS,
                          seed: int = 0) -> str:
    """Simulate ``par`` with pint_tpu as the DD set is (uniform TOAs, the
    three receivers in four sub-bands) and write it to ``path``."""
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_uniform
    from pint_tpu.toa import write_tim
    from pint_tpu_torch.examples import RECEIVERS, receiver_freqs

    band, freqs = receiver_freqs(ntoas)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(par)
        toas = make_fake_toas_uniform(
            CENTER_MJD - SPAN_DAYS / 2, CENTER_MJD + SPAN_DAYS / 2, ntoas,
            model, obs="gbt", error_us=1.0, freq_mhz=freqs,
            add_noise=True, seed=seed)
    for b_mhz, fl in zip(band, toas.flags):
        fl["fe"] = RECEIVERS[float(b_mhz)]
    write_tim(path, toas)
    return path


def spider_start(model):
    """The spider fit's start (``examples.spider_start``)."""
    from pint_tpu_torch.examples import spider_start as start

    start(model)


def jax_spider_fit(timfile: str) -> dict:
    """pint_tpu's ``Fitter.auto(...).fit_toas()`` (its defaults, JAX on
    the CPU) of the spider set from :func:`spider_start`: the record
    SPIDER_REF_JSON holds."""
    from pint_tpu.fitter import Fitter
    from pint_tpu_torch.examples import SPIDER_PERTURB

    model, toas = load_jax(timfile, par=spider_par_lines())
    spider_start(model)
    fitter = Fitter.auto(toas, model)
    start = device_values(model, fitter.fit_params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas()
    return {"what": "pint_tpu Fitter.auto(...).fit_toas() with its "
                    "defaults, JAX on the CPU, on spider_sim_200.tim "
                    "(spider_realistic_par(dmx_bins=8)) from the perturbed "
                    "start", "fitter": type(fitter).__name__,
            "ntoas": toas.ntoas, "perturb": SPIDER_PERTURB, "start": start,
            **fitter_record(fitter, chi2)}


def jax_btpw_fit(timfile: str) -> dict:
    """pint_tpu's eager WLSFitter.fit_toas(maxiter=3) of the BT_PIECEWISE
    set from the perturbed DD start: the record BTPW_REF_JSON holds."""
    from pint_tpu.fitter import WLSFitter

    model, toas = load_jax(timfile, par=btpw_par_lines())
    perturb_dd(model)
    fitter = WLSFitter(toas, model)
    start = device_values(model, fitter.fit_params)
    chi2 = fitter.fit_toas(maxiter=DD_MAXITER)
    return {"what": "pint_tpu WLSFitter.fit_toas(maxiter=3), eager, JAX on "
                    "the CPU, on btpw_sim_200.tim (btpw_par(dmx_bins=8)) "
                    "from the perturbed DD start",
            "ntoas": toas.ntoas, "maxiter": DD_MAXITER,
            "perturb": DD_PERTURB, "start": start,
            **fitter_record(fitter, chi2)}


def write_spider_reference() -> dict:
    """Write SPIDER_REF_TIM and pint_tpu's fit on it."""
    os.makedirs(DATA_DIR, exist_ok=True)
    write_uniform_sim_tim(SPIDER_REF_TIM, spider_par_lines())
    rec = jax_spider_fit(SPIDER_REF_TIM)
    with open(SPIDER_REF_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


def write_btpw_reference() -> dict:
    """Write BTPW_REF_TIM and pint_tpu's fit on it."""
    os.makedirs(DATA_DIR, exist_ok=True)
    write_uniform_sim_tim(BTPW_REF_TIM, btpw_par_lines())
    rec = jax_btpw_fit(BTPW_REF_TIM)
    with open(BTPW_REF_JSON, "w") as f:
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


#: pint_tpu's J0740-class simulators and random models, and its residuals
#: on REF_TIM after remove_component("FD"), stored for the port to be held
#: against (tests/test_torch_simulation.py, tests/test_torch_model_api.py)
SIM_REF_JSON = os.path.join(DATA_DIR, "j0740_sim_refs.json")
#: make_fake_toas_fromtim's noise seed on REF_TIM; the random models'
#: draws and seed on pint_tpu's fit of REF_TIM
FROMTIM_SEED = 3
RANDOM_MODELS = 8
RANDOM_MODELS_SEED = 1
#: the random models' scatter witness: pint_tpu's fits (WLS, maxiter 3)
#: of simulate_j0740_realistic(ntoas=300, seed=0), the headline's (M2 and
#: SINI frozen, as the par has them) and one with SCATTER_FROZEN frozen
#: too, each with SCATTER_MODELS draws from RANDOM_MODELS_SEED
SCATTER_FROZEN = ("FD1", "FD2", "FD3", "FD4", "DM")
SCATTER_MODELS = 100
SCATTER_MAXITER = 3


def scatter_ratio(fitter, toas, dphase) -> dict:
    """The random models' scatter against the covariance's prediction, on
    a fitter of either package: the median over TOAs of std(dphase over
    draws) / (F0 |M s L|), M the design matrix with the weighted offset
    profiled out, s the covariance's standard deviations and L the
    Cholesky factor of its correlation with 1e-12 on the diagonal (the
    draw's own), as ``ratio``; with L from the correlation's eigenvectors
    (no jitter, negative eigenvalues clipped: F0 sqrt(diag(M C M^T))) as
    ``ratio_cov``; and the draws' median scatter [us]."""
    names = fitter.covariance_params
    M = np.asarray(fitter.get_designmatrix()[0], np.float64)
    w = 1.0 / np.asarray(toas.error_us, np.float64) ** 2
    Mw = M - (w @ M) / np.sum(w)
    C = np.asarray(fitter.parameter_covariance_matrix,
                   np.float64)[:len(names), :len(names)]
    sd = np.sqrt(np.diag(C))
    R = C / np.outer(sd, sd)
    lam, V = np.linalg.eigh(R)
    f0 = float(fitter.model.F0.value)
    std = np.std(np.asarray(dphase), axis=0)
    out = {"median_std_us": float(np.median(std)) / f0 * 1e6}
    for key, L in (("ratio", np.linalg.cholesky(R + 1e-12 * np.eye(
            len(names)))), ("ratio_cov", V * np.sqrt(np.clip(lam, 0, None)))):
        pred = f0 * np.linalg.norm(Mw @ (sd[:, None] * L), axis=1)
        out[key] = float(np.median(std / pred))
    return out


def toas_record(toas, model) -> dict:
    """A set of pint_tpu's TOAs as JSON: UTC (day, fraction), frequency,
    error, site and flags, and pint_tpu's residuals [s] on them."""
    from pint_tpu.residuals import Residuals

    return {"utc_day": toas.utc.day.tolist(),
            "utc_frac": toas.utc.frac.tolist(),
            "freq_mhz": np.asarray(toas.freq_mhz).tolist(),
            "error_us": np.asarray(toas.error_us).tolist(),
            "obs": [str(o) for o in toas.obs],
            "flags": [dict(f) for f in toas.flags],
            "resid_s": np.asarray(
                Residuals(toas, model).time_resids).tolist()}


def write_sim_references() -> dict:
    """Write pint_tpu's simulate_j0740_class(ntoas=40),
    simulate_j0740_realistic(ntoas=300, seed=0), make_fake_toas_fromtim
    on REF_TIM, calculate_random_models on its fit of REF_TIM (the
    fitted par, the covariance and its names, the draws, the phase and
    time deviations), its residuals on REF_TIM after
    remove_component("FD"), and the scatter of its random models on its
    two fits of the 300-TOA realistic set (``random_models_scatter``: the
    headline's with its par, covariance and names; the one with
    SCATTER_FROZEN frozen with its names) to SIM_REF_JSON; returns the
    JSON record."""
    from pint_tpu.residuals import Residuals
    from pint_tpu.examples import (simulate_j0740_class,
                                   simulate_j0740_realistic)
    from pint_tpu.fitter import WLSFitter
    from pint_tpu.simulation import (calculate_random_models,
                                     make_fake_toas_fromtim)

    rec = {"what": "pint_tpu's J0740-class simulators and random models "
                   "(JAX on the CPU)"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m, t = simulate_j0740_class(ntoas=40)
        rec["class_40"] = toas_record(t, m)
        m, t = simulate_j0740_realistic(ntoas=300, seed=0)
        rec["realistic_300"] = toas_record(t, m)
        m, _ = load_jax(REF_TIM)
        t = make_fake_toas_fromtim(REF_TIM, m, add_noise=True,
                                   seed=FROMTIM_SEED)
        rec["fromtim_200"] = dict(toas_record(t, m), seed=FROMTIM_SEED)
        m, t = load_jax(REF_TIM)
        m.remove_component("FD")
        rec["remove_fd_resid_s"] = np.asarray(
            Residuals(t, m).time_resids).tolist()
        m, t = load_jax(REF_TIM, grid=True)
        fitter = WLSFitter(t, m)
        fitter.fit_toas(maxiter=2)
        dphase, draws = calculate_random_models(
            fitter, t, Nmodels=RANDOM_MODELS, seed=RANDOM_MODELS_SEED)
        dt, _ = calculate_random_models(
            fitter, t, Nmodels=RANDOM_MODELS, seed=RANDOM_MODELS_SEED,
            return_time=True)
    rec["random_models"] = {
        "par": m.as_parfile(), "names": list(fitter.covariance_params),
        "covariance": np.asarray(
            fitter.parameter_covariance_matrix).tolist(),
        "nmodels": RANDOM_MODELS, "seed": RANDOM_MODELS_SEED,
        "draws": np.asarray(draws).tolist(),
        "dphase": np.asarray(dphase).tolist(),
        "dt_s": np.asarray(dt).tolist()}
    scatter = {"ntoas": 300, "seed": 0, "maxiter": SCATTER_MAXITER,
               "nmodels": SCATTER_MODELS, "rm_seed": RANDOM_MODELS_SEED}
    for label, frozen in (("headline", ()), ("frozen", SCATTER_FROZEN)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m, t = simulate_j0740_realistic(ntoas=300, seed=0)
            for n in frozen:
                m[n].frozen = True
            fitter = WLSFitter(t, m)
            fitter.fit_toas(maxiter=SCATTER_MAXITER)
            dphase, _ = calculate_random_models(
                fitter, t, Nmodels=SCATTER_MODELS, seed=RANDOM_MODELS_SEED)
        scatter[label] = dict(scatter_ratio(fitter, t, dphase),
                              frozen=list(frozen),
                              names=list(fitter.covariance_params))
        if label == "headline":
            scatter[label].update(par=m.as_parfile(), covariance=np.asarray(
                fitter.parameter_covariance_matrix).tolist())
    rec["random_models_scatter"] = scatter
    with open(SIM_REF_JSON, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    return rec


WRITERS = {"j0740": write_reference, "dd": write_dd_reference,
           "gls": write_gls_reference, "ddk": write_ddk_reference,
           "fitters": write_fitters_reference,
           "noisefit": write_noisefit_reference,
           "wb_sim_200": write_wb_reference,
           "chrom_sim_200": write_chrom_reference,
           "wavex_sim_200": write_wavex_reference,
           "spider_sim_200": write_spider_reference,
           "btpw_sim_200": write_btpw_reference,
           "sim_refs": write_sim_references}

if __name__ == "__main__":
    # python tests/torch_port_data.py [set ...]: every set by default
    sys.path.insert(0, os.path.dirname(os.path.dirname(DATA_DIR)))
    for name in sys.argv[1:] or WRITERS:
        rec = WRITERS[name]()
        print(name, json.dumps(rec.get("chi2", rec.get("lm", rec.get(
            "wideband_gls", {})).get("chi2"))))
