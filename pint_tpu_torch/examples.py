"""Shared example configurations: the par strings of
:mod:`pint_tpu.examples`, and the simulated full-width DD data sets that
``chip_smoke.py`` fits: white noise only (WLS), and with a NANOGrav-style
noise model (GLS)."""

from __future__ import annotations

import warnings

import numpy as np

#: J0740+6620-class millisecond pulsar with an ELL1 binary — the flagship
#: configuration used by bench.py (the reference's grid benchmark dataset
#: is NANOGrav J0740+6620, `profiling/bench_chisq_grid_WLSFitter.py:10-24`)
J0740_CLASS_PAR = """
PSR J0740-BENCH
RAJ 07:40:45.79 1
DECJ 66:20:33.5 1
F0 346.53199992 1
F1 -1.46e-15 1
PEPOCH 55000
POSEPOCH 55000
DM 14.96 1
BINARY ELL1
PB 4.76694461 1
A1 3.9775561 1
TASC 55000.3 1
EPS1 -5.7e-6 1
EPS2 -1.89e-5 1
M2 0.25
SINI 0.99
TZRMJD 55000.1
TZRFRQ 1400
TZRSITE gbt
EPHEM DE421
"""


def j0740_realistic_par(dmx_bins: int = 70, span_days: float = 4550.0,
                        center_mjd: float = 54975.0) -> str:
    """The flagship par grown to the real NANOGrav J0740+6620 column
    count (the reference's 176 s benchmark fit carries ~dozens of
    DMX/FD/JUMP columns, `profiling/bench_chisq_grid_WLSFitter.py:10-24`;
    the honest-width comparison): ~`dmx_bins` DMX
    windows + FD1-4 + two receiver JUMPs on top of spin/astrometry/
    binary."""
    return "\n".join([J0740_CLASS_PAR.strip()]
                     + _width_lines(dmx_bins, span_days, center_mjd))


#: the DD binary of pint_tpu's DD round-trip test (`tests/test_binary_dd.py`
#: PAR_DD, an eccentric 7.75 d orbit): spin, position, DM and the binary
#: block; M2/SINI stay frozen
FAKEDD_PAR = """
PSR FAKEDD
RAJ 10:22:58.0 1
DECJ +10:01:52.8 1
F0 60.7794479 1
F1 -1.6e-16 1
PEPOCH 55000
POSEPOCH 55000
DM 10.25 1
BINARY DD
PB 7.75 1
A1 9.23 1
T0 55000.2 1
ECC 0.35 1
OM 75.0 1
OMDOT 0.01
GAMMA 0.001
M2 0.3
SINI 0.9
TZRMJD 55000.1
TZRFRQ 1400
TZRSITE gbt
EPHEM DE421
"""

#: receiver bands [MHz] and the -fe flag values the two JUMPs select on
RECEIVERS = {1400.0: "RCVR1400", 800.0: "RCVR800", 1420.0: "RCVR1400L"}
#: channel offsets [MHz] within each receiver band: with one frequency
#: per receiver FD1-4 are degenerate with the offset and the JUMPs
SUBBANDS_MHZ = (-37.5, -12.5, 12.5, 37.5)


def _width_lines(dmx_bins: int, span_days: float, center_mjd: float):
    """FD1-4, the two receiver JUMPs and ``dmx_bins`` DMX windows over the
    span: the columns that bring a par to NANOGrav width."""
    lines = ["FD1 1e-5 1", "FD2 -4e-6 1", "FD3 2e-6 1", "FD4 -1e-6 1",
             "JUMP -fe RCVR800 1e-5 1", "JUMP -fe RCVR1400L 5e-6 1"]
    lo = center_mjd - span_days / 2
    width = span_days / dmx_bins
    for i in range(1, dmx_bins + 1):
        r1 = lo + (i - 1) * width
        r2 = lo + i * width
        lines += [f"DMX_{i:04d} 0 1",
                  f"DMXR1_{i:04d} {r1:.4f}", f"DMXR2_{i:04d} {r2:.4f}"]
    return lines


def dd_realistic_par(dmx_bins: int = 70, span_days: float = 4550.0,
                     center_mjd: float = 54975.0) -> str:
    """:func:`j0740_realistic_par` with the ELL1 binary replaced by the
    DD binary of :data:`FAKEDD_PAR`: 10 nonlinear free parameters (RAJ,
    DECJ, F0, F1, DM, PB, A1, T0, ECC, OM) and 76 linear ones (FD1-4, two
    JUMPs, 70 DMX) at the default width, 86 in all."""
    return "\n".join([FAKEDD_PAR.strip()]
                     + _width_lines(dmx_bins, span_days, center_mjd))


def receiver_freqs(ntoas: int):
    """(per-TOA band [MHz], per-TOA observing frequency [MHz]): the three
    receivers in turn, each cycling through its four sub-bands."""
    band = np.tile(list(RECEIVERS), (ntoas + 2) // 3)[:ntoas]
    sub = np.resize(np.asarray(SUBBANDS_MHZ), (ntoas + 3) // 3).repeat(3)
    return band, band + sub[:ntoas]


def simulate_dd_realistic(ntoas: int = 12500, seed: int = 0,
                          dmx_bins: int = 70, span_days: float = 4550.0,
                          center_mjd: float = 54975.0, device=None):
    """(model, TOAs) of the full-width DD configuration, as
    :func:`pint_tpu.examples.simulate_j0740_realistic` builds the J0740
    set: ``ntoas`` uniform TOAs over the span from gbt with 1 us white
    noise, three receivers carrying -fe flags, each in four sub-bands.
    The residuals of the simulation run on ``device`` (default
    ``"cuda"``)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    band, freqs = receiver_freqs(ntoas)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(dd_realistic_par(
            dmx_bins=dmx_bins, span_days=span_days,
            center_mjd=center_mjd).splitlines())
        toas = make_fake_toas_uniform(
            center_mjd - span_days / 2, center_mjd + span_days / 2, ntoas,
            model, obs="gbt", error_us=1.0, freq_mhz=freqs,
            add_noise=True, seed=seed, device=device)
    for b_mhz, fl in zip(band, toas.flags):
        fl["fe"] = RECEIVERS[float(b_mhz)]
    return model, toas


#: NANOGrav 15-yr-style noise model of the GLS configuration, frozen as in
#: a NANOGrav GLS fit: EFAC/EQUAD/ECORR per receiver (RECEIVERS order),
#: power-law red noise with 30 Fourier modes
NOISE_EFAC = (1.1, 1.05, 1.2)
NOISE_EQUAD_US = (0.2, 0.2, 0.2)
NOISE_ECORR_US = (0.4, 0.3, 0.5)
NOISE_RED = {"TNREDAMP": -13.7, "TNREDGAM": 3.5, "TNREDC": 30}
#: the GLS set's epochs: four sub-band TOAs 0.1 s apart, inside ECORR's
#: 1 s quantization window
TOAS_PER_EPOCH = 4
EPOCH_SPACING_S = 0.1


def dd_noise_realistic_par(dmx_bins: int = 70, span_days: float = 4550.0,
                           center_mjd: float = 54975.0) -> str:
    """:func:`dd_realistic_par` (86 free timing parameters) plus the
    frozen noise lines of the ``dd_gls_nanograv`` configuration."""
    lines = []
    for fe, efac, equad, ecorr in zip(RECEIVERS.values(), NOISE_EFAC,
                                      NOISE_EQUAD_US, NOISE_ECORR_US):
        lines += [f"EFAC -fe {fe} {efac}", f"EQUAD -fe {fe} {equad}",
                  f"ECORR -fe {fe} {ecorr}"]
    lines += [f"{k} {v}" for k, v in NOISE_RED.items()]
    return "\n".join([dd_realistic_par(dmx_bins, span_days, center_mjd)]
                     + lines)


def epoch_toas(ntoas: int, span_days: float = 4550.0,
               center_mjd: float = 54975.0):
    """(MJDs, per-TOA band [MHz], per-TOA frequency [MHz]) of the GLS set:
    ``ntoas / 4`` observing epochs evenly over the span, each one receiver
    in turn (RECEIVERS order) with its four sub-bands 0.1 s apart."""
    nep = ntoas // TOAS_PER_EPOCH
    if nep * TOAS_PER_EPOCH != ntoas:
        raise ValueError(f"ntoas must be a multiple of {TOAS_PER_EPOCH}")
    ep = np.linspace(center_mjd - span_days / 2, center_mjd + span_days / 2,
                     nep)
    k = np.arange(TOAS_PER_EPOCH)
    mjds = (ep[:, None] + k[None, :] * EPOCH_SPACING_S / 86400.0).ravel()
    band = np.repeat(np.resize(list(RECEIVERS), nep), TOAS_PER_EPOCH)
    freqs = band + np.tile(np.asarray(SUBBANDS_MHZ), nep)
    return mjds, band, freqs


def simulate_dd_noise_realistic(ntoas: int = 12500, seed: int = 0,
                                dmx_bins: int = 70,
                                span_days: float = 4550.0,
                                center_mjd: float = 54975.0, device=None):
    """(model, TOAs) of the full-width ``dd_gls_nanograv`` configuration:
    epoch-clustered TOAs (:func:`epoch_toas`) from gbt, put on integer
    model phases (``zero_residuals``), white noise scaled by EFAC/EQUAD
    (numpy ``default_rng(seed + 1)``) and one realization of the ECORR and
    red noise (``add_correlated_noise``, seed ``seed``), as pint_tpu's GLS
    tests build epoch-clustered TOAs (``get_TOAs_array`` +
    ``zero_residuals``).  The residuals run on ``device`` (default
    ``"cuda"``)."""
    from pint_tpu_torch import mjd as mjdmod
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.simulation import add_correlated_noise, zero_residuals
    from pint_tpu_torch.toa import get_TOAs_array

    mjds, band, freqs = epoch_toas(ntoas, span_days, center_mjd)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(dd_noise_realistic_par(
            dmx_bins=dmx_bins, span_days=span_days,
            center_mjd=center_mjd).splitlines())
        toas = get_TOAs_array(mjds, obs="gbt", errors_us=1.0,
                              freqs_mhz=freqs, ephem="DE421", planets=False)
        for b_mhz, fl in zip(band, toas.flags):
            fl["fe"] = RECEIVERS[float(b_mhz)]
        toas = zero_residuals(toas, model, device=device)
        sigma_us = Residuals(toas, model, device=device).get_data_error()
        rng = np.random.default_rng(seed + 1)
        toas.utc = mjdmod.add_sec(
            toas.utc, rng.standard_normal(ntoas) * sigma_us * 1e-6)
        toas.compute_TDBs(ephem="DE421")
        toas.compute_posvels(ephem="DE421", planets=False)
        toas = add_correlated_noise(toas, model, seed=seed, device=device)
    for f in toas.flags:
        f.setdefault("simulated", "1")
    return model, toas
