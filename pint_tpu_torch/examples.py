"""Shared example configurations: the par strings of
:mod:`pint_tpu.examples`, and the simulated full-width DD data set that
``chip_smoke.py`` fits."""

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
