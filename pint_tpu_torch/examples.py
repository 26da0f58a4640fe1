"""Shared example configurations: the par strings and the J0740-class
simulators of :mod:`pint_tpu.examples`, and the simulated full-width
data sets that ``chip_smoke.py`` fits: the DD binary with white noise
only (WLS) and with a NANOGrav-style noise model (GLS, the noise frozen;
and with the noise parameters free and per-TOA errors that vary, for the
downhill fitters' maximum-likelihood noise fit), the DDK binary in
ecliptic coordinates (WLS), and the NANOGrav-style wideband
configuration (the noise model's TOAs with a wideband DM each, DMJUMP,
DMEFAC/DMEQUAD and NE_SW), the chromatic configuration, and the spider
binary (an FBn orbit with ORBWAVEs and PLANET_SHAPIRO), with the
variants of the delay kernel's row function of each family."""

from __future__ import annotations

import math
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


def j0740_class_model():
    """The flagship model of :data:`J0740_CLASS_PAR`
    (:func:`pint_tpu.examples.j0740_class_model`)."""
    from pint_tpu_torch.models import get_model

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_model(J0740_CLASS_PAR.strip().splitlines())


def simulate_j0740_class(ntoas: int = 40, span_days: float = 600.0,
                         center_mjd: float = 55000.0, error_us: float = 1.0,
                         seed: int = 7, device=None):
    """(model, noisy dual-frequency TOAs) of the flagship configuration,
    as :func:`pint_tpu.examples.simulate_j0740_class` makes them: uniform
    TOAs from gbt at 1400 and 800 MHz in turn, white noise of
    ``error_us``.  The residuals of the simulation run on ``device``
    (default ``"cuda"``)."""
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    model = j0740_class_model()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        toas = make_fake_toas_uniform(
            center_mjd - span_days / 2, center_mjd + span_days / 2, ntoas,
            model, obs="gbt", error_us=error_us,
            freq_mhz=np.tile([1400.0, 800.0], (ntoas + 1) // 2)[:ntoas],
            add_noise=True, seed=seed, device=device)
    return model, toas


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


def simulate_j0740_realistic(ntoas: int = 12500, span_days: float = 4550.0,
                             center_mjd: float = 54975.0, seed: int = 0,
                             device=None, dmx_bins: int = 70):
    """(model, TOAs) at the honest NANOGrav-like width, as
    :func:`pint_tpu.examples.simulate_j0740_realistic` makes them: the
    model of :func:`j0740_realistic_par` (70 DMX bins, or ``dmx_bins``;
    the flags are attached after the simulation, so the JUMPs are not in
    the simulated arrival times, as in pint_tpu), ``ntoas`` uniform
    TOAs from gbt at 1400, 800 and 1420 MHz in turn with 1 us white
    noise, each carrying the ``-fe`` flag of its receiver for the JUMPs.
    The residuals of the simulation run on ``device`` (default
    ``"cuda"``)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(j0740_realistic_par(
            dmx_bins=dmx_bins, span_days=span_days,
            center_mjd=center_mjd).splitlines())
        freqs = np.tile([1400.0, 800.0, 1420.0], (ntoas + 2) // 3)[:ntoas]
        toas = make_fake_toas_uniform(
            center_mjd - span_days / 2, center_mjd + span_days / 2, ntoas,
            model, obs="gbt", error_us=1.0, freq_mhz=freqs,
            add_noise=True, seed=seed, device=device)
    fe = {800.0: "RCVR800", 1400.0: "RCVR1400", 1420.0: "RCVR1400L"}
    for f_mhz, fl in zip(freqs, toas.flags):
        fl["fe"] = fe[float(f_mhz)]
    return model, toas


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
    return _simulate_uniform(
        dd_realistic_par(dmx_bins=dmx_bins, span_days=span_days,
                         center_mjd=center_mjd),
        ntoas, seed, span_days, center_mjd, device)


def _simulate_uniform(par: str, ntoas: int, seed: int, span_days: float,
                      center_mjd: float, device):
    """(model, TOAs): ``ntoas`` uniform TOAs of the model of ``par`` over
    the span from gbt with 1 us white noise, three receivers carrying -fe
    flags, each in four sub-bands; the residuals run on ``device``."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    band, freqs = receiver_freqs(ntoas)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(par.splitlines())
        toas = make_fake_toas_uniform(
            center_mjd - span_days / 2, center_mjd + span_days / 2, ntoas,
            model, obs="gbt", error_us=1.0, freq_mhz=freqs,
            add_noise=True, seed=seed, device=device)
    for b_mhz, fl in zip(band, toas.flags):
        fl["fe"] = RECEIVERS[float(b_mhz)]
    return model, toas


#: the proper motion [mas/yr] and parallax [mas] of the DDK configuration
#: (pint_tpu's DDK tests, `tests/test_binary_ddk.py` PAR_DDK), frozen
DDK_PM_PX = {"PMRA": -15.0, "PMDEC": 8.0, "PX": 1.5}
#: the DDK orbit's inclination [deg]: asin of FAKEDD_PAR's SINI 0.9
DDK_KIN_DEG = math.degrees(math.asin(0.9))
#: its longitude of the ascending node [deg] (PAR_DDK's)
DDK_KOM_DEG = 40.0


def ddk_ecliptic_par() -> str:
    """:data:`FAKEDD_PAR` as a NANOGrav release gives such a binary: the
    position in ecliptic coordinates (IERS2010), converted by
    :func:`~pint_tpu_torch.models.astrometry.convert_astrometry` with
    ELONG and ELAT free, its proper motion and parallax (frozen), and the
    DDK binary (KIN, KOM free, K96) in place of DD's SINI."""
    from pint_tpu_torch.models import get_model

    eq = FAKEDD_PAR.strip().splitlines() + [
        f"{k} {v}" for k, v in DDK_PM_PX.items()]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ecl = get_model(eq).as_ECL()
    lines = []
    for ln in FAKEDD_PAR.strip().splitlines():
        key = ln.split()[0]
        if key == "RAJ":
            lines += [f"ELONG {ecl.ELONG.value_as_string()} 1",
                      f"ELAT {ecl.ELAT.value_as_string()} 1",
                      f"PMELONG {ecl.PMELONG.value:.10f}",
                      f"PMELAT {ecl.PMELAT.value:.10f}",
                      f"PX {DDK_PM_PX['PX']}", "ECL IERS2010"]
        elif key == "DECJ":
            continue
        elif key == "BINARY":
            lines.append("BINARY DDK")
        elif key == "SINI":
            lines += [f"KIN {DDK_KIN_DEG:.12f} 1",
                      f"KOM {DDK_KOM_DEG} 1", "K96 1"]
        else:
            lines.append(ln)
    return "\n".join(lines)


def ddk_ecliptic_realistic_par(dmx_bins: int = 70,
                               span_days: float = 4550.0,
                               center_mjd: float = 54975.0) -> str:
    """:func:`ddk_ecliptic_par` at NANOGrav width: 12 nonlinear free
    parameters (ELONG, ELAT, F0, F1, DM, PB, A1, T0, ECC, OM, KIN, KOM)
    and 76 linear ones (FD1-4, two JUMPs, 70 DMX) at the default width,
    88 in all."""
    return "\n".join([ddk_ecliptic_par()]
                     + _width_lines(dmx_bins, span_days, center_mjd))


def simulate_ddk_ecliptic_realistic(ntoas: int = 12500, seed: int = 0,
                                    dmx_bins: int = 70,
                                    span_days: float = 4550.0,
                                    center_mjd: float = 54975.0,
                                    device=None):
    """(model, TOAs) of the full-width DDK configuration in ecliptic
    coordinates, simulated as :func:`simulate_dd_realistic` does."""
    return _simulate_uniform(
        ddk_ecliptic_realistic_par(dmx_bins=dmx_bins, span_days=span_days,
                                   center_mjd=center_mjd),
        ntoas, seed, span_days, center_mjd, device)


def _orthometric(m2: float, sini: float):
    """(H3 [s], STIGMA) of M2 [Msun] and SINI (Freire & Wex 2010)."""
    from pint_tpu_torch import Tsun

    sig = sini / (1.0 + math.sqrt(1.0 - sini**2))
    return m2 * Tsun * sig**3, sig


#: the DD and ELL1 variants of the kernel's row function, each on the DD
#: or the J0740 par with its Shapiro parameters carried over from the
#: par's own M2/SINI (as pint_tpu's tests/test_binary_dd.py:193-237 and
#: tests/test_binary_ell1.py:149-233 build them), the new parameters
#: free; ELL1k's OMDOT 2 deg/yr and LNEDOT 1e-3 /yr are this repo's
#: choice, large enough to move eps1, eps2 over the span
VARIANTS = ("DDS", "DDH", "DDGR", "DDK", "DDK_ECL", "ELL1H", "ELL1H_H4",
            "ELL1H_H3", "ELL1k")
ELL1K_RATES = {"OMDOT": 2.0, "LNEDOT": 1e-3}
#: DDGR's total mass [Msun]: with M2 0.3 its derived SINI is ~0.898 at
#: FAKEDD_PAR's A1 and PB, off clip_unit's saturation
DDGR_MTOT = 1.18


def variant_par(kind: str, dmx_bins: int = 70, span_days: float = 4550.0,
                center_mjd: float = 54975.0) -> str:
    """The par of one of :data:`VARIANTS` at the width of
    :func:`dd_realistic_par` / :func:`j0740_realistic_par`: DDS (SHAPMAX
    = -ln(1 - SINI)), DDH (H3, STIGMA of M2, SINI), DDGR (MTOT, M2), DDK
    in equatorial coordinates with pint_tpu's DDK proper motion and
    parallax and in ecliptic ones (:func:`ddk_ecliptic_realistic_par`),
    ELL1H in its three modes (STIGMA; H4 with the harmonic sum; H3 alone
    with NHARMS 7), ELL1k (:data:`ELL1K_RATES`)."""
    if kind == "DDK_ECL":
        return ddk_ecliptic_realistic_par(dmx_bins, span_days, center_mjd)
    dd = kind.startswith("DD")
    base = (dd_realistic_par if dd else j0740_realistic_par)(
        dmx_bins, span_days, center_mjd).splitlines()
    m2, sini = (0.3, 0.9) if dd else (0.25, 0.99)
    h3, sig = _orthometric(m2, sini)
    binary = kind.split("_")[0]
    swap = {
        "DDS": {"SINI": [f"SHAPMAX {-math.log(1.0 - sini)!r} 1"]},
        "DDH": {"M2": [f"H3 {h3!r} 1"], "SINI": [f"STIGMA {sig!r} 1"]},
        "DDGR": {"M2": [f"M2 {m2} 1"], "SINI": [f"MTOT {DDGR_MTOT} 1"]},
        "DDK": {"SINI": [f"{k} {v}" for k, v in DDK_PM_PX.items()]
                + [f"KIN {DDK_KIN_DEG:.12f} 1", f"KOM {DDK_KOM_DEG} 1",
                   "K96 1"]},
        "ELL1H": {"M2": [f"H3 {h3!r} 1"], "SINI": [f"STIGMA {sig!r} 1"]},
        "ELL1H_H4": {"M2": [f"H3 {h3!r} 1"],
                     "SINI": [f"H4 {sig * h3!r} 1", "NHARMS 7"]},
        "ELL1H_H3": {"M2": [f"H3 {h3!r} 1"], "SINI": ["NHARMS 7"]},
        "ELL1k": {"SINI": [f"SINI {sini}"] + [
            f"{k} {v} 1" for k, v in ELL1K_RATES.items()]},
    }[kind]
    lines = []
    for ln in base:
        key = ln.split()[0]
        if key == "BINARY":
            lines.append(f"BINARY {binary}")
        else:
            lines += swap.get(key, [ln])
    return "\n".join(lines)


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
               center_mjd: float = 54975.0, receivers=RECEIVERS):
    """(MJDs, per-TOA band [MHz], per-TOA frequency [MHz]) of the GLS set:
    ``ntoas / 4`` observing epochs evenly over the span, each one receiver
    in turn (``receivers`` order) with its four sub-bands 0.1 s apart."""
    nep = ntoas // TOAS_PER_EPOCH
    if nep * TOAS_PER_EPOCH != ntoas:
        raise ValueError(f"ntoas must be a multiple of {TOAS_PER_EPOCH}")
    ep = np.linspace(center_mjd - span_days / 2, center_mjd + span_days / 2,
                     nep)
    k = np.arange(TOAS_PER_EPOCH)
    mjds = (ep[:, None] + k[None, :] * EPOCH_SPACING_S / 86400.0).ravel()
    band = np.repeat(np.resize(list(receivers), nep), TOAS_PER_EPOCH)
    freqs = band + np.tile(np.asarray(SUBBANDS_MHZ), nep)
    return mjds, band, freqs


def simulate_dd_noise_realistic(ntoas: int = 12500, seed: int = 0,
                                dmx_bins: int = 70,
                                span_days: float = 4550.0,
                                center_mjd: float = 54975.0, device=None,
                                errors_us=1.0, par: str = None,
                                receivers=RECEIVERS):
    """(model, TOAs) of the full-width ``dd_gls_nanograv`` configuration:
    epoch-clustered TOAs (:func:`epoch_toas`) from gbt with uncertainties
    ``errors_us`` (a scalar or one per TOA), put on integer model phases
    (``zero_residuals``), white noise scaled by EFAC/EQUAD (numpy
    ``default_rng(seed + 1)``) and one realization of the ECORR and red
    noise (``add_correlated_noise``, seed ``seed``), as pint_tpu's GLS
    tests build epoch-clustered TOAs (``get_TOAs_array`` +
    ``zero_residuals``).  ``par`` replaces the configuration's par (the
    wideband and chromatic ones pass their own), ``receivers`` the
    receiver bands and -fe names.  The residuals run on ``device``
    (default ``"cuda"``)."""
    from pint_tpu_torch import mjd as mjdmod
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.simulation import add_correlated_noise, zero_residuals
    from pint_tpu_torch.toa import get_TOAs_array

    mjds, band, freqs = epoch_toas(ntoas, span_days, center_mjd, receivers)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if par is None:
            par = dd_noise_realistic_par(dmx_bins=dmx_bins,
                                         span_days=span_days,
                                         center_mjd=center_mjd)
        model = get_model(par.splitlines())
        toas = get_TOAs_array(mjds, obs="gbt", errors_us=errors_us,
                              freqs_mhz=freqs, ephem="DE421", planets=False)
        for b_mhz, fl in zip(band, toas.flags):
            fl["fe"] = receivers[float(b_mhz)]
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


#: the free noise parameters of the noise-fitting configuration:
#: EFAC, EQUAD, ECORR per receiver (RECEIVERS order) and the red noise's
#: amplitude and index (TNREDC stays fixed)
NOISE_FIT_PARAMS = ("EFAC1", "EFAC2", "EFAC3", "EQUAD1", "EQUAD2", "EQUAD3",
                    "ECORR1", "ECORR2", "ECORR3", "TNREDAMP", "TNREDGAM")
#: the noise fit's start, moved off the injected values (NOISE_EFAC ...)
#: but nonzero, so that the first GLS timing step sees an ECORR weight
NOISE_FIT_START = {**{f"EFAC{i}": 1.0 for i in (1, 2, 3)},
                   **{f"EQUAD{i}": 0.1 for i in (1, 2, 3)},
                   **{f"ECORR{i}": 0.1 for i in (1, 2, 3)},
                   "TNREDAMP": -14.0, "TNREDGAM": 3.0}
#: the range [us] of the noise-fitting set's per-TOA errors, drawn
#: log-uniform as NANOGrav TOA errors vary with S/N: with one error for
#: every TOA, EFAC and EQUAD are exactly degenerate
NOISE_FIT_ERRORS_US = (0.5, 3.0)


def dd_noise_fit_par(dmx_bins: int = 70, span_days: float = 4550.0,
                     center_mjd: float = 54975.0,
                     free=NOISE_FIT_PARAMS) -> str:
    """:func:`dd_noise_realistic_par` (86 free timing parameters) with the
    noise parameters of ``free`` (default all 11 of
    :data:`NOISE_FIT_PARAMS`) free."""
    free = set(free)
    idx = {"EFAC": 0, "EQUAD": 0, "ECORR": 0}
    lines = []
    for ln in dd_noise_realistic_par(dmx_bins, span_days,
                                     center_mjd).splitlines():
        key = ln.split()[0]
        name = key
        if key in idx:
            idx[key] += 1
            name = f"{key}{idx[key]}"
        lines.append(f"{ln} 1" if name in free else ln)
    return "\n".join(lines)


def noise_fit_errors_us(ntoas: int, seed: int = 0) -> np.ndarray:
    """Per-TOA errors [us] of the noise-fitting set: numpy
    ``default_rng(seed + 2)``, log-uniform over NOISE_FIT_ERRORS_US."""
    lo, hi = np.log(NOISE_FIT_ERRORS_US)
    return np.exp(np.random.default_rng(seed + 2).uniform(lo, hi, ntoas))


def simulate_dd_noise_fit(ntoas: int = 12500, seed: int = 0,
                          dmx_bins: int = 70, span_days: float = 4550.0,
                          center_mjd: float = 54975.0, device=None):
    """(truth model, TOAs) of the noise-fitting configuration: the
    ``dd_gls_nanograv`` simulation (:func:`simulate_dd_noise_realistic`)
    with per-TOA errors from :func:`noise_fit_errors_us`, the truth's
    noise parameters free as in :func:`dd_noise_fit_par`."""
    model, toas = simulate_dd_noise_realistic(
        ntoas=ntoas, seed=seed, dmx_bins=dmx_bins, span_days=span_days,
        center_mjd=center_mjd, device=device,
        errors_us=noise_fit_errors_us(ntoas, seed))
    for n in NOISE_FIT_PARAMS:
        model[n].frozen = False
    return model, toas


#: the wideband configuration's DM side, as NANOGrav's wideband releases
#: (12.5-yr, 15-yr) model a pulsar: a DMJUMP on every receiver but one
#: [pc cm^-3], injected into the measured DMs and fitted; DMEFAC per
#: receiver (RECEIVERS order), injected and fitted by maximum likelihood;
#: DMEQUAD per receiver [pc cm^-3], frozen; the measured DMs' errors
#: (-pp_dme) per receiver [pc cm^-3]; and NE_SW [cm^-3] (SWM 0), free
WB_DMJUMP = {"RCVR800": 3e-4, "RCVR1400L": -2e-4}
WB_DMEFAC = (1.1, 1.3, 0.9)
WB_DMEQUAD = (5e-5, 5e-5, 5e-5)
WB_DM_ERROR = (2e-4, 1e-4, 3e-4)
WB_NE_SW = 7.9
#: the wideband fit's free noise parameters, and their start
WB_NOISE_FREE = ("DMEFAC1", "DMEFAC2", "DMEFAC3")
WB_START = {"DMJUMP1": 0.0, "DMJUMP2": 0.0,
            **{n: 1.0 for n in WB_NOISE_FREE}}


def wideband_nanograv_par(dmx_bins: int = 70, span_days: float = 4550.0,
                          center_mjd: float = 54975.0,
                          free=WB_NOISE_FREE) -> str:
    """:func:`dd_noise_realistic_par` (86 free timing parameters, the
    frozen EFAC/EQUAD/ECORR and red noise) with the wideband DM model:
    NE_SW free, a DMJUMP free on two of the three receivers, DMEFAC per
    receiver (those of ``free`` free) and DMEQUAD per receiver frozen.
    The position is J1022+1001's, 0.06 deg off the ecliptic, so the
    solar wind reaches milliseconds at conjunction: 89 free timing
    parameters."""
    lines = [dd_noise_realistic_par(dmx_bins, span_days, center_mjd),
             f"NE_SW {WB_NE_SW} 1", "SWM 0"]
    lines += [f"DMJUMP -fe {fe} {v} 1" for fe, v in WB_DMJUMP.items()]
    for i, (fe, efac, equad) in enumerate(zip(RECEIVERS.values(),
                                              WB_DMEFAC, WB_DMEQUAD), 1):
        lines += [f"DMEFAC -fe {fe} {efac}"
                  + (" 1" if f"DMEFAC{i}" in free else ""),
                  f"DMEQUAD -fe {fe} {equad}"]
    return "\n".join(lines)


def wideband_dm_errors(toas) -> np.ndarray:
    """Each TOA's measured-DM error [pc cm^-3] by its receiver
    (:data:`WB_DM_ERROR`)."""
    err = dict(zip(RECEIVERS.values(), WB_DM_ERROR))
    return np.array([err[f["fe"]] for f in toas.flags])


def set_wideband_dms(toas, dm, sigma, dme, seed: int = 0):
    """The TOAs' -pp_dm flags set to ``dm`` plus white noise of the
    scaled uncertainties ``sigma`` (numpy ``default_rng(seed + 3)``) and
    their -pp_dme flags to ``dme``."""
    rng = np.random.default_rng(seed + 3)
    dm = np.asarray(dm) + rng.standard_normal(toas.ntoas) * np.asarray(sigma)
    for f, v, e in zip(toas.flags, dm, dme):
        f["pp_dm"] = repr(float(v))
        f["pp_dme"] = repr(float(e))
    return toas


def simulate_wideband_realistic(ntoas: int = 12500, seed: int = 0,
                                dmx_bins: int = 70,
                                span_days: float = 4550.0,
                                center_mjd: float = 54975.0, device=None):
    """(truth model, TOAs) of the full-width wideband configuration: the
    ``dd_gls_nanograv`` simulation (:func:`simulate_dd_noise_realistic`)
    of :func:`wideband_nanograv_par`, every TOA given a wideband DM from
    the model's ``total_dm`` (``simulation.add_wideband_dm_data``, so the
    DMJUMPs are in it) plus white noise at the DMEFAC/DMEQUAD-scaled
    per-receiver errors (:func:`set_wideband_dms`): 2 x ``ntoas`` rows.
    The model evaluations run on ``device`` (default ``"cuda"``)."""
    import torch

    from pint_tpu_torch.simulation import add_wideband_dm_data

    model, toas = simulate_dd_noise_realistic(
        ntoas=ntoas, seed=seed, dmx_bins=dmx_bins, span_days=span_days,
        center_mjd=center_mjd, device=device,
        par=wideband_nanograv_par(dmx_bins, span_days, center_mjd))
    add_wideband_dm_data(toas, model, device=device)
    dm = np.array([float(f["pp_dm"]) for f in toas.flags])
    dme = wideband_dm_errors(toas)
    batch = toas.to_batch(device=device)
    p = model.build_pdict(toas, tzr_toas=model.make_tzr_toas_or_none(),
                          device=batch.device)
    with torch.no_grad():
        sigma = model.scaled_dm_uncertainty(
            p, batch, torch.as_tensor(dme, device=batch.device)).cpu()
    set_wideband_dms(toas, dm, sigma.numpy(), dme, seed)
    return model, toas


#: the DM family's variants of the delay kernel's row function, on the DD
#: set (J1022+1001's position, 0.06 deg off the ecliptic) and the ELL1
#: set: the solar wind with SWM 0 or SWM 1, and in each SWX, DMJUMP,
#: FDJUMPDM and FD1JUMP/FD2JUMP (:func:`dm_family_par`)
DM_FAMILY = ("DMF_DD", "DMF_DD_SWM1", "DMF_ELL1", "DMF_ELL1_SWM1")
#: the SWM 1 variants' power-law index
DM_FAMILY_SWP = 2.5


def dm_family_lines(swm: int = 0, swp: float = DM_FAMILY_SWP,
                    span_days: float = 4550.0,
                    center_mjd: float = 54975.0):
    """Par lines of every term of the DM family, all free: NE_SW with a
    Taylor term about SWEPOCH (SWM ``swm``; SWP ``swp`` for SWM 1),
    three SWX ranges over the span whose neighbours overlap by 50 days
    (a TOA there lies in two, as on a shared boundary), a DMJUMP, two
    FDJUMPDM and three FD<k>JUMP members (k = 1, 2)."""
    lines = ["NE_SW 7.9 1", "NE_SW1 0.5 1", f"SWEPOCH {center_mjd:g}",
             f"SWM {swm}"]
    if swm == 1:
        lines.append(f"SWP {swp} 1")
    lo = center_mjd - span_days / 2
    for i, dm in enumerate((4e-4, -2e-4, 3e-4), 1):
        r1 = lo + (i - 1) * span_days / 3 - (50.0 if i > 1 else 0.0)
        r2 = lo + i * span_days / 3
        lines += [f"SWXDM_{i:04d} {dm} 1", f"SWXP_{i:04d} 2",
                  f"SWXR1_{i:04d} {r1:.4f}", f"SWXR2_{i:04d} {r2:.4f}"]
    lines += ["DMJUMP -fe RCVR800 3e-4 1",
              "FDJUMPDM -fe RCVR800 2e-4 1", "FDJUMPDM -fe RCVR1400L -1e-4 1",
              "FD1JUMP -fe RCVR800 3e-6 1", "FD2JUMP -fe RCVR800 -1e-6 1",
              "FD1JUMP -fe RCVR1400L 1e-6 1"]
    return lines


def dm_family_par(kind: str, dmx_bins: int = 70, span_days: float = 4550.0,
                  center_mjd: float = 54975.0) -> str:
    """The par of one of :data:`DM_FAMILY`: :func:`dd_realistic_par` or
    :func:`j0740_realistic_par` with :func:`dm_family_lines`."""
    base = (dd_realistic_par if kind.startswith("DMF_DD")
            else j0740_realistic_par)(dmx_bins, span_days, center_mjd)
    return "\n".join([base] + dm_family_lines(
        1 if kind.endswith("SWM1") else 0, span_days=span_days,
        center_mjd=center_mjd))


#: the chromatic configuration (``chromatic_j1713``): a J1713+0747-class
#: chromatic noise fit, the chromatic terms as EPTA DR2 and PPTA DR3 model
#: them.  Its receivers span 430-1400 MHz (NANOGrav's 430 MHz and 820 MHz
#: receivers and L-band), so that f^-4 and f^-2 separate; the -fe names
#: are those the JUMP and noise lines key on (RCVR430 in place of
#: RCVR1400L)
CHROM_RECEIVERS = {1400.0: "RCVR1400", 820.0: "RCVR800", 430.0: "RCVR430"}
#: the chromatic delays: the troposphere; CM (index 4, CM frozen: a
#: constant CM is degenerate with FD1-4 and the receiver JUMPs) with CM1
#: and CM2 free; J1713's 2008 exponential dip (index -2 frozen, amplitude
#: ~1 us at 1400 MHz and timescale ~30 d free); a chromatic Gaussian event
#: (index 4 frozen, amplitude free); and NE_SW, frozen
CHROM_LINES = ("CORRECT_TROPOSPHERE Y", "TNCHROMIDX 4", "CM 8.0",
               "CM1 0.5 1", "CM2 0.05 1", "CMEPOCH 54975",
               "EXPDIPEP_1 54750", "EXPDIPAMP_1 1e-6 1", "EXPDIPIDX_1 -2",
               "EXPDIPTAU_1 30 1", "CHROMGAUSS_EPOCH_1 56500",
               "CHROMGAUSS_LOGAMP_1 -7 1", "CHROMGAUSS_LOGSIG_1 1.3",
               "CHROMGAUSS_CHROMIDX_1 4", "CHROMGAUSS_SIGN_1 -1",
               "NE_SW 7.9")
#: its noise: chromatic (index TNCHROMIDX) and solar-wind power-law GPs,
#: 30 modes each, ~730 ns and ~290 ns rms at 430 MHz (at ~290 ns the
#: chromatic GP goes undetected in 12,500 TOAs: PERF.md)
CHROM_NOISE = {"TNCHROMAMP": -15.8, "TNCHROMGAM": 3.0, "TNCHROMC": 30,
               "TNSWAMP": -7.5, "TNSWGAM": 2.0, "TNSWC": 30}
#: the free noise parameters of the chromatic fit, and the fit's start:
#: each moved by this offset from its injected value
CHROM_NOISE_FREE = ("TNCHROMAMP", "TNCHROMGAM", "TNSWAMP")
CHROM_NOISE_OFFSET = {"TNCHROMAMP": 0.4, "TNCHROMGAM": -0.5, "TNSWAMP": 0.5}
#: the chromatic timing parameters' perturbed start
CHROM_PERTURB = {"CM1": 0.05, "CM2": 0.005, "EXPDIPAMP_1": 1e-7,
                 "EXPDIPTAU_1": 3.0, "CHROMGAUSS_LOGAMP_1": 0.05}


def chromatic_j1713_par(dmx_bins: int = 70, span_days: float = 4550.0,
                        center_mjd: float = 54975.0, free=CHROM_NOISE_FREE,
                        noise=None) -> str:
    """:func:`dd_noise_realistic_par` (86 free timing parameters, the
    frozen EFAC/EQUAD/ECORR per receiver and red noise) on
    :data:`CHROM_RECEIVERS`, with :data:`CHROM_LINES` (5 more free timing
    parameters: 91) and the noise of :data:`CHROM_NOISE`, updated by
    ``noise`` (those of ``free`` free)."""
    base = dd_noise_realistic_par(dmx_bins, span_days, center_mjd)
    base = base.replace("RCVR1400L", CHROM_RECEIVERS[430.0])
    lines = [base, *CHROM_LINES]
    lines += [f"{k} {v}" + (" 1" if k in free else "")
              for k, v in {**CHROM_NOISE, **(noise or {})}.items()]
    return "\n".join(lines)


def simulate_chromatic_j1713(ntoas: int = 12500, seed: int = 0,
                             dmx_bins: int = 70, span_days: float = 4550.0,
                             center_mjd: float = 54975.0, device=None,
                             noise=None):
    """(truth model, TOAs) of the full-width chromatic configuration: the
    ``dd_gls_nanograv`` simulation (:func:`simulate_dd_noise_realistic`:
    ``ntoas / 4`` epochs of four sub-band TOAs) of
    :func:`chromatic_j1713_par` on :data:`CHROM_RECEIVERS`, the chromatic
    and solar-wind GPs (their amplitudes updated by ``noise``) injected
    with the ECORR and red noise by ``add_correlated_noise``.  The model
    evaluations run on ``device`` (default ``"cuda"``)."""
    return simulate_dd_noise_realistic(
        ntoas=ntoas, seed=seed, dmx_bins=dmx_bins, span_days=span_days,
        center_mjd=center_mjd, device=device,
        par=chromatic_j1713_par(dmx_bins, span_days, center_mjd,
                                noise=noise),
        receivers=CHROM_RECEIVERS)


def chromatic_start(model):
    """Move a chromatic model to the fit's start: the chromatic timing
    parameters by :data:`CHROM_PERTURB`, the free noise parameters by
    :data:`CHROM_NOISE_OFFSET` (the spin, orbit and DM start is the
    caller's)."""
    for n, d in {**CHROM_PERTURB, **CHROM_NOISE_OFFSET}.items():
        if n in CHROM_PERTURB or not model[n].frozen:
            model[n].value = model[n].value + d


#: the chromatic family's variants of the delay kernel's row function:
#: each new term alone on the DD set (J1022+1001's position) and on the
#: ELL1 set (:func:`chromatic_family_par`)
CHROM_TERMS = ("TROPO", "CM", "CMX", "DMWAVEX", "CMWAVEX", "WAVEX",
               "EXPDIP", "GAUSS")
CHROM_FAMILY = tuple(f"CHF_{b}_{t}" for b in ("DD", "ELL1")
                     for t in CHROM_TERMS)


def chromatic_family_lines(term: str, span_days: float = 4550.0,
                           center_mjd: float = 54975.0):
    """Par lines of one chromatic-family term, its parameters free (CMX
    and CMWaveX with the TNCHROMIDX of a frozen CM): three CMX ranges
    whose neighbours overlap by 50 days; two sinusoid modes at 1 and 2
    cycles per span; a dip and a Gaussian event with their index free."""
    lo = center_mjd - span_days / 2
    chrom = ["TNCHROMIDX 4", f"CMEPOCH {center_mjd:g}"]
    if term == "TROPO":
        return ["CORRECT_TROPOSPHERE Y"]
    if term == "CM":
        return chrom + ["CM 8.0 1", "CM1 0.5 1", "CM2 0.05 1"]
    if term == "CMX":
        lines = list(chrom)
        for i, v in enumerate((0.4, -0.3, 0.2), 1):
            r1 = lo + (i - 1) * span_days / 3 - (50.0 if i > 1 else 0.0)
            lines += [f"CMX_{i:04d} {v} 1", f"CMXR1_{i:04d} {r1:.4f}",
                      f"CMXR2_{i:04d} {lo + i * span_days / 3:.4f}"]
        return lines
    if term.endswith("WAVEX"):
        stem = {"DMWAVEX": "DMWX", "CMWAVEX": "CMWX", "WAVEX": "WX"}[term]
        amps = {"DMWX": (3e-4, -2e-4), "CMWX": (0.3, -0.2),
                "WX": (2e-6, -1e-6)}[stem]
        lines = list(chrom) if term == "CMWAVEX" else []
        lines.append(f"{stem}EPOCH {center_mjd:g}")
        for k in (1, 2):
            lines += [f"{stem}FREQ_{k:04d} {k / span_days!r}",
                      f"{stem}SIN_{k:04d} {amps[0] / k} 1",
                      f"{stem}COS_{k:04d} {amps[1] / k} 1"]
        return lines
    if term == "EXPDIP":
        return ["EXPDIPEP_1 54750", "EXPDIPAMP_1 1e-6 1",
                "EXPDIPIDX_1 -2 1", "EXPDIPTAU_1 30 1"]
    if term == "GAUSS":
        return ["CHROMGAUSS_EPOCH_1 56500", "CHROMGAUSS_LOGAMP_1 -6 1",
                "CHROMGAUSS_LOGSIG_1 1.3 1", "CHROMGAUSS_CHROMIDX_1 4 1",
                "CHROMGAUSS_SIGN_1 -1"]
    raise ValueError(f"unknown chromatic-family term {term!r}")


def chromatic_family_par(kind: str, dmx_bins: int = 70,
                         span_days: float = 4550.0,
                         center_mjd: float = 54975.0) -> str:
    """The par of one of :data:`CHROM_FAMILY`: :func:`dd_realistic_par`
    or :func:`j0740_realistic_par` with :func:`chromatic_family_lines`."""
    _, binary, term = kind.split("_", 2)
    base = (dd_realistic_par if binary == "DD"
            else j0740_realistic_par)(dmx_bins, span_days, center_mjd)
    return "\n".join([base] + chromatic_family_lines(term, span_days,
                                                     center_mjd))


#: the WaveX set (the reference set of the WaveX family): the modes of
#: each sinusoid family (harmonics of 1 / span), the amplitudes the
#: simulation injects (sin, cos; mode k gets 1/k of them), and four CMX
#: ranges over the span, neighbours sharing a boundary
WAVEX_MODES = {"wavex_setup": 3, "dmwavex_setup": 3, "cmwavex_setup": 2}
WAVEX_AMPS = {"WX": (2e-6, -1e-6), "DMWX": (3e-4, 2e-4), "CMWX": (0.3, -0.2)}
WAVEX_CMX = (0.4, -0.3, 0.2, -0.1)
#: the chromatic reference set's GP amplitudes (its 50 epochs), ~3 us and
#: ~0.9 us rms at 430 MHz: at ~0.3 us 50 epochs do not detect the GPs,
#: maximum likelihood drives them to zero, and there the GLS normal matrix
#: is singular, where this package's solve (the SVD of the square root)
#: and pint_tpu's (eigh of the normal matrix) part by up to 16x in the DM,
#: FD and JUMP uncertainties (PERF.md)
CHROM_NOISE_200 = {"TNCHROMAMP": -15.2, "TNSWAMP": -7.0}


def wavex_set_par(span_days: float = 4550.0,
                  center_mjd: float = 54975.0) -> str:
    """The WaveX set's par before its sinusoids: :func:`dd_realistic_par`
    without DMX, with CM (index 4, CM1 free), the four CMX ranges of
    :data:`WAVEX_CMX` (free) and the troposphere."""
    lines = [ln for ln in dd_realistic_par(1, span_days,
                                           center_mjd).splitlines()
             if not ln.startswith("DMX")]
    lines += ["CORRECT_TROPOSPHERE Y", "TNCHROMIDX 4", "CM 8.0",
              "CM1 0.5 1", f"CMEPOCH {center_mjd:g}"]
    edges = center_mjd - span_days / 2 + span_days * np.arange(5) / 4
    for i, v in enumerate(WAVEX_CMX, 1):
        lines += [f"CMX_{i:04d} {v} 1", f"CMXR1_{i:04d} {edges[i - 1]:.4f}",
                  f"CMXR2_{i:04d} {edges[i]:.4f}"]
    return "\n".join(lines)


def wavex_set_model(models, wave, span_days: float = 4550.0,
                    center_mjd: float = 54975.0, inject: bool = True):
    """The WaveX set's model: ``models.get_model`` of
    :func:`wavex_set_par`, then ``wave``'s ``wavex_setup``,
    ``dmwavex_setup`` and ``cmwavex_setup`` (:data:`WAVEX_MODES`
    harmonics of 1 / span, amplitudes free), with :data:`WAVEX_AMPS`
    injected if ``inject``.  ``models`` and ``wave`` are the ``models``
    and ``models.wave`` modules of this package or of pint_tpu."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = models.get_model(wavex_set_par(span_days,
                                               center_mjd).splitlines())
    for setup, n in WAVEX_MODES.items():
        getattr(wave, setup)(model, span_days, n_freqs=n)
    if inject:
        for stem, (a_s, a_c) in WAVEX_AMPS.items():
            for name in model.free_params:
                if name.startswith((stem + "SIN_", stem + "COS_")):
                    k = int(name[-4:])
                    model[name].value = \
                        (a_s if "SIN_" in name else a_c) / k
    return model


#: the spider-binary configuration (``spider_fbn_orbwave``): a redback
#: millisecond pulsar of J1023+0038's class (PB 0.198 d, A1 0.343 ls,
#: EPS1/EPS2 ~1e-5; M2 and SINI frozen), timed as black-widow and redback
#: users time such a pulsar: the orbit by an FBn Taylor series in place
#: of PB/PBDOT and PINT's ORBWAVE Fourier series for the wander of its
#: orbital phase, with the planets' Shapiro delays
SPIDER_PAR = """
PSR J1023-SPIDER
RAJ 10:23:47.687 1
DECJ 00:38:40.85 1
F0 592.42146 1
F1 -2.4e-15 1
PEPOCH 55000
POSEPOCH 55000
DM 14.33 1
PLANET_SHAPIRO Y
BINARY ELL1
A1 0.343356 1
TASC 55000.1 1
EPS1 1.2e-5 1
EPS2 -8e-6 1
M2 0.24
SINI 0.67
TZRMJD 55000.1
TZRFRQ 1400
TZRSITE gbt
EPHEM DE421
"""
#: its orbital period [d]
SPIDER_PB_DAYS = 0.1980963
#: FB1 [1/s^2] (free) and FB2 [1/s^3] (frozen): each moves the orbital
#: phase by ~5e-3 and ~6e-4 orbits at the ends of the 4,550-day span
SPIDER_FB12 = (-2.5e-19, 5e-28)
#: the ORBWAVE harmonics' (C, S) amplitudes [orbits], harmonics 0-3, free;
#: ORBWAVE_EPOCH is the span's middle and ORBWAVE_OM's period the span
SPIDER_ORBWAVE = ((2e-3, -1.5e-3), (1e-3, 8e-4), (-6e-4, 5e-4),
                  (3e-4, -4e-4))
#: the spider fit's start: offsets [par units] from the simulated truth
SPIDER_PERTURB = {"F0": 1e-10, "A1": 3e-6, "EPS1": 1e-6, "EPS2": -1e-6,
                  "FB0": 3e-14, "FB1": 2e-21, "ORBWAVEC0": 1e-4,
                  "ORBWAVES1": -1e-4}


def spider_orbit_lines(span_days: float = 4550.0,
                       center_mjd: float = 54975.0, pb_days: float = None,
                       fb12=SPIDER_FB12, orbwave=SPIDER_ORBWAVE):
    """Par lines of an FBn orbit of period ``pb_days`` (FB0 and FB1 free,
    FB2 frozen; :data:`SPIDER_FB12`) and of ORBWAVE harmonics
    (``orbwave``, free) with ORBWAVE_EPOCH at the span's middle and
    ORBWAVE_OM's period the span; either part left out where ``pb_days``
    or ``orbwave`` is None."""
    lines = []
    if pb_days is not None:
        lines += [f"FB0 {1.0 / (pb_days * 86400.0)!r} 1",
                  f"FB1 {fb12[0]!r} 1", f"FB2 {fb12[1]!r}"]
    if orbwave:
        lines += [f"ORBWAVE_OM {2.0 * math.pi / (span_days * 86400.0)!r}",
                  f"ORBWAVE_EPOCH {center_mjd!r}"]
        for k, (c, s) in enumerate(orbwave):
            lines += [f"ORBWAVEC{k} {c!r} 1", f"ORBWAVES{k} {s!r} 1"]
    return lines


def spider_realistic_par(dmx_bins: int = 70, span_days: float = 4550.0,
                         center_mjd: float = 54975.0) -> str:
    """:data:`SPIDER_PAR` at NANOGrav width (:func:`j0740_realistic_par`'s
    FD1-4, two receiver JUMPs and DMX bins) with
    :func:`spider_orbit_lines`: 19 nonlinear free parameters (RAJ, DECJ,
    F0, F1, DM, A1, TASC, EPS1, EPS2, FB0, FB1 and the eight ORBWAVE
    amplitudes) and 76 linear ones at the default width, 95 in all."""
    return "\n".join(
        [SPIDER_PAR.strip()]
        + spider_orbit_lines(span_days, center_mjd, SPIDER_PB_DAYS)
        + _width_lines(dmx_bins, span_days, center_mjd))


def simulate_spider_realistic(ntoas: int = 12500, seed: int = 0,
                              dmx_bins: int = 70, span_days: float = 4550.0,
                              center_mjd: float = 54975.0, device=None):
    """(model, TOAs) of the full-width spider configuration, simulated as
    :func:`simulate_dd_realistic` does (the planets' positions loaded:
    the model sets PLANET_SHAPIRO)."""
    return _simulate_uniform(
        spider_realistic_par(dmx_bins=dmx_bins, span_days=span_days,
                             center_mjd=center_mjd),
        ntoas, seed, span_days, center_mjd, device)


def spider_start(model):
    """Move a spider model to its fit's start (:data:`SPIDER_PERTURB`)."""
    for n, d in SPIDER_PERTURB.items():
        model[n].value = model[n].value + d


#: the BT_PIECEWISE pieces over the 4,550-day span: (XR1, XR2) as
#: fractions of the span, and the T0X shift [d] and A1X offset [ls] from
#: the par's T0 and A1 (None: the piece keeps the global value); a gap
#: lies between the second and the third piece
BTPW_PIECES = (((0.0, 0.24), 3e-5, 5e-6), ((0.24, 0.48), None, -4e-6),
               ((0.52, 0.76), -2e-5, None), ((0.76, 1.0), 1e-5, 3e-6))


def btpw_par(dmx_bins: int = 70, span_days: float = 4550.0,
             center_mjd: float = 54975.0) -> str:
    """:func:`dd_realistic_par` as a BT_PIECEWISE binary (M2, SINI and
    OMDOT dropped, as BT has no Shapiro delay) with the four pieces of
    :data:`BTPW_PIECES`, their T0X and A1X free."""
    lo = center_mjd - span_days / 2
    lines = []
    t0 = a1 = None
    for ln in dd_realistic_par(dmx_bins, span_days, center_mjd).splitlines():
        key = ln.split()[0]
        if key in ("M2", "SINI", "OMDOT"):
            continue
        if key == "T0":
            t0 = float(ln.split()[1])
        if key == "A1":
            a1 = float(ln.split()[1])
        lines.append("BINARY BT_PIECEWISE" if key == "BINARY" else ln)
    for i, ((f1, f2), dt0, da1) in enumerate(BTPW_PIECES, 1):
        lines += [f"XR1_{i:04d} {lo + f1 * span_days:.4f}",
                  f"XR2_{i:04d} {lo + f2 * span_days:.4f}"]
        if dt0 is not None:
            lines.append(f"T0X_{i:04d} {t0 + dt0!r} 1")
        if da1 is not None:
            lines.append(f"A1X_{i:04d} {a1 + da1!r} 1")
    return "\n".join(lines)


#: the orbit family's variants of the delay kernel's row function: each
#: term alone on the DD set (its 7.75 d orbit) and on the ELL1 set (the
#: J0740 par's 4.77 d orbit) (:func:`orbit_family_par`)
ORBIT_TERMS = ("FB", "ORBWAVE", "PLANET")
ORBIT_FAMILY = tuple(f"ORB_{b}_{t}" for b in ("DD", "ELL1")
                     for t in ORBIT_TERMS)
#: the DD and the ELL1 set's orbital periods [d]
ORBIT_PB_DAYS = {"DD": 7.75, "ELL1": 4.76694461}
#: the ORBWAVE amplitudes [orbits] of the single-term variants
ORBIT_ORBWAVE = ((3e-4, -2e-4), (1e-4, 1.5e-4))


def orbit_family_lines(term: str, binary: str, span_days: float = 4550.0,
                       center_mjd: float = 54975.0):
    """Par lines of one orbit-family term on ``binary`` ("DD" or "ELL1"):
    an FBn orbit of the par's period (FB0, FB1 free, FB2 frozen), two
    ORBWAVE harmonics (free) on the PB orbit, or PLANET_SHAPIRO."""
    if term == "FB":
        return spider_orbit_lines(span_days, center_mjd,
                                  ORBIT_PB_DAYS[binary], orbwave=None)
    if term == "ORBWAVE":
        return spider_orbit_lines(span_days, center_mjd,
                                  orbwave=ORBIT_ORBWAVE)
    if term == "PLANET":
        return ["PLANET_SHAPIRO Y"]
    raise ValueError(f"unknown orbit-family term {term!r}")


#: the J0740 par's binary lines (``ORB_NONE_PLANET`` drops them)
J0740_BINARY_KEYS = ("BINARY", "PB", "A1", "TASC", "EPS1", "EPS2", "M2",
                     "SINI")


def orbit_family_par(kind: str, dmx_bins: int = 70,
                     span_days: float = 4550.0,
                     center_mjd: float = 54975.0) -> str:
    """The par of one of :data:`ORBIT_FAMILY`: :func:`dd_realistic_par` or
    :func:`j0740_realistic_par` with :func:`orbit_family_lines` (the FBn
    variants without PB and PBDOT); and ``ORB_NONE_PLANET``, the J0740
    par without its binary, with PLANET_SHAPIRO."""
    _, binary, term = kind.split("_", 2)
    base = (dd_realistic_par if binary == "DD"
            else j0740_realistic_par)(dmx_bins, span_days, center_mjd)
    drop = {"FB": ("PB", "PBDOT")}.get(term, ())
    if binary == "NONE":
        drop, binary = J0740_BINARY_KEYS, "ELL1"
    base = "\n".join(ln for ln in base.splitlines()
                     if ln.split()[0] not in drop)
    return "\n".join([base] + orbit_family_lines(term, binary, span_days,
                                                 center_mjd))


def orbit_mixed_par(dmx_bins: int = 70, span_days: float = 4550.0,
                    center_mjd: float = 54975.0) -> str:
    """:func:`spider_realistic_par` with the DM family's terms
    (:func:`dm_family_lines`, SWM 0) and the chromatic family's CM: a
    layout of the orbit family's kernels that runs every family's
    terms."""
    return "\n".join([spider_realistic_par(dmx_bins, span_days, center_mjd)]
                     + dm_family_lines(0, span_days=span_days,
                                       center_mjd=center_mjd)
                     + chromatic_family_lines("CM", span_days, center_mjd))
