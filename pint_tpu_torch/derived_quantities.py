"""Astrophysical quantities derived from timing parameters.

A carried copy of :mod:`pint_tpu.derived_quantities` (the reference's
`src/pint/derived_quantities.py`) on numpy and the port's constants: the
same formula set, in plain SI/astronomer floats instead of astropy
Quantities.  Unit
conventions (documented per function): periods [s], frequencies [Hz],
orbital periods [days], projected semi-major axes [light-s], masses
[Msun], angles [deg or rad as noted], magnetic fields [G].
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from pint_tpu_torch import Tsun, c as C

__all__ = [
    "p_to_f", "pferrs", "pulsar_age", "pulsar_edot", "pulsar_B",
    "pulsar_B_lightcyl", "mass_funct", "mass_funct2", "pulsar_mass",
    "companion_mass", "pbdot", "gamma", "omdot", "sini", "omdot_to_mtot",
    "a1sini", "shklovskii_factor", "dispersion_slope",
]

SECS_PER_DAY = 86400.0
SECS_PER_YEAR = 365.25 * SECS_PER_DAY
Tsun_s = Tsun                              # ~4.925490947e-6 s
I_NS = 1.0e45                              # canonical moment of inertia, g cm^2
PC_M = 3.0856775814913673e16


def p_to_f(p, pd, pdd: Optional[float] = None):
    """Period [s] (+derivatives) -> frequency [Hz] (+derivatives)
    (reference ibid:37)."""
    f = 1.0 / p
    fd = -pd / p**2
    if pdd is None:
        return f, fd
    fdd = 0.0 if pdd == 0.0 else 2.0 * pd**2 / p**3 - pdd / p**2
    return f, fd, fdd


def pferrs(porf, porferr, pdorfd=None, pdorfderr=None):
    """(value, error) propagation for the p<->f transformation
    (reference ibid:88)."""
    if pdorfd is None:
        return 1.0 / porf, porferr / porf**2
    forp = 1.0 / porf
    fdorpd = -pdorfd / porf**2
    fdorpderr = math.sqrt((4.0 * pdorfd**2 * porferr**2 / porf**6)
                          + pdorfderr**2 / porf**4)
    return forp, porferr / porf**2, fdorpd, fdorpderr


def pulsar_age(f: float, fdot: float, n: int = 3) -> float:
    """Characteristic age [yr], -f/((n-1) fdot) (reference ibid:148)."""
    return -f / ((n - 1) * fdot) / SECS_PER_YEAR


def pulsar_edot(f: float, fdot: float, I: float = I_NS) -> float:
    """Spin-down luminosity [erg/s] (reference ibid:193)."""
    return -4.0 * math.pi**2 * I * f * fdot


def pulsar_B(f: float, fdot: float) -> float:
    """Surface dipole field estimate [G], 3.2e19 sqrt(P Pdot)
    (reference ibid:231)."""
    return 3.2e19 * math.sqrt(max(-fdot / f**3, 0.0))


def pulsar_B_lightcyl(f: float, fdot: float) -> float:
    """Light-cylinder field [G] (reference ibid:273)."""
    p = 1.0 / f
    pd = -fdot / f**2
    return 2.9e8 * p ** (-5.0 / 2.0) * math.sqrt(pd)


def mass_funct(pb_days: float, x_ls: float) -> float:
    """Binary mass function [Msun], 4 pi^2 x^3 / (G Pb^2)
    (reference ibid:317)."""
    pb = pb_days * SECS_PER_DAY
    return 4.0 * math.pi**2 * (x_ls) ** 3 / (Tsun_s * pb**2)


def mass_funct2(mp: float, mc: float, i_deg: float) -> float:
    """Mass function [Msun] from component masses + inclination
    (reference ibid:357)."""
    return (mc * math.sin(math.radians(i_deg))) ** 3 / (mc + mp) ** 2


def pulsar_mass(pb_days: float, x_ls: float, mc: float,
                i_deg: float) -> float:
    """Pulsar mass [Msun] from the mass function with known companion
    mass and inclination (reference ibid:402)."""
    massfunct = mass_funct(pb_days, x_ls)
    sini_ = math.sin(math.radians(i_deg))
    ca = massfunct
    cb = 2 * massfunct * mc
    cc = massfunct * mc**2 - (mc * sini_) ** 3
    return (-cb + math.sqrt(cb**2 - 4 * ca * cc)) / (2 * ca)


def companion_mass(pb_days: float, x_ls: float, i_deg: float = 60.0,
                   mp: float = 1.4) -> float:
    """Companion mass [Msun] by solving the cubic mass function
    (reference ibid:469, same monic-cubic closed form)."""
    massfunct = mass_funct(pb_days, x_ls)
    sini_ = math.sin(math.radians(i_deg))
    # monic cubic: mc^3 - (mf/sini^3) mc^2 - (2 mp mf/sini^3) mc - mp^2 mf/sini^3
    a = -massfunct / sini_**3
    b = -2 * mp * massfunct / sini_**3
    c = -(mp**2) * massfunct / sini_**3
    # depressed-cubic real root (Cardano)
    p = b - a**2 / 3.0
    q = 2 * a**3 / 27.0 - a * b / 3.0 + c
    disc = (q / 2) ** 2 + (p / 3) ** 3
    if disc >= 0:
        s = math.sqrt(disc)
        u1 = np.cbrt(-q / 2 + s)
        u2 = np.cbrt(-q / 2 - s)
        t = u1 + u2
    else:
        r = math.sqrt(-(p**3) / 27.0)
        phi = math.acos(-q / (2 * r))
        t = 2 * np.cbrt(r) * math.cos(phi / 3.0)
    return float(t - a / 3.0)


def pbdot(mp: float, mc: float, pb_days: float, e: float) -> float:
    """GR orbital-decay rate [s/s] (Peters 1964; reference ibid:573)."""
    pb = pb_days * SECS_PER_DAY
    fe = (1.0 + 73.0 / 24 * e**2 + 37.0 / 96 * e**4) / (1 - e**2) ** 3.5
    return (-192.0 * math.pi / 5 *
            (2.0 * math.pi / pb) ** (5.0 / 3.0) *
            Tsun_s ** (5.0 / 3.0) * fe * mp * mc / (mp + mc) ** (1.0 / 3.0))


def gamma(mp: float, mc: float, pb_days: float, e: float) -> float:
    """Einstein-delay amplitude GAMMA [s] (reference ibid:638)."""
    pb = pb_days * SECS_PER_DAY
    return (e * (pb / (2.0 * math.pi)) ** (1.0 / 3.0) *
            Tsun_s ** (2.0 / 3.0) * (mp + mc) ** (-4.0 / 3.0) *
            mc * (mp + 2 * mc))


def omdot(mp: float, mc: float, pb_days: float, e: float) -> float:
    """GR periastron advance [deg/yr] (reference ibid:699)."""
    pb = pb_days * SECS_PER_DAY
    rad_per_s = (3.0 * (2.0 * math.pi / pb) ** (5.0 / 3.0) *
                 Tsun_s ** (2.0 / 3.0) * (mp + mc) ** (2.0 / 3.0) /
                 (1.0 - e**2))
    return math.degrees(rad_per_s) * SECS_PER_YEAR


def sini(mp: float, mc: float, pb_days: float, x_ls: float) -> float:
    """GR sin(i) from masses and Keplerian parameters (reference
    ibid:759)."""
    massfunct = mass_funct(pb_days, x_ls)
    return (massfunct * (mp + mc) ** 2 / mc**3) ** (1.0 / 3.0)


def omdot_to_mtot(omdot_deg_yr: float, pb_days: float, e: float) -> float:
    """Total mass [Msun] implied by a periastron advance (reference
    ibid:916)."""
    pb = pb_days * SECS_PER_DAY
    od = math.radians(omdot_deg_yr) / SECS_PER_YEAR
    return ((od / 3.0 * (1.0 - e**2) *
             (pb / (2.0 * math.pi)) ** (5.0 / 3.0)) ** (3.0 / 2.0)
            / Tsun_s)


def a1sini(mp: float, mc: float, pb_days: float) -> float:
    """Projected semi-major axis x = a1 sin i [light-s] for i=90 deg
    (reference ibid:980)."""
    pb = pb_days * SECS_PER_DAY
    return ((Tsun_s * mc**3 / (mp + mc) ** 2) ** (1.0 / 3.0) *
            (pb / (2.0 * math.pi)) ** (2.0 / 3.0))


def shklovskii_factor(pm_mas_yr: float, d_kpc: float) -> float:
    """Shklovskii correction factor a_s = mu^2 d / c [1/s]; multiply by a
    period to get the apparent Pdot contribution (reference ibid:1035)."""
    mu = math.radians(pm_mas_yr / 3600.0e3) / SECS_PER_YEAR  # rad/s
    return mu**2 * (d_kpc * 1e3 * PC_M) / C


def dispersion_slope(dm: float) -> float:
    """Dispersion slope [1/s] = DM * DMconst (reference ibid:1073)."""
    from pint_tpu_torch import DMconst

    return DMconst * dm * 1e12  # DMconst is s MHz^2 / (pc cm^-3)
