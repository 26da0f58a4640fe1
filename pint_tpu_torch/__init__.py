"""pint_tpu_torch — the PyTorch/CUDA port of pint_tpu.

The same pulsar-timing pipeline as :mod:`pint_tpu` (par/tim loading, clock
and barycentric corrections, the composable timing model, residuals, WLS
fits and chi2 grids), written in PyTorch for an NVIDIA H100.  Host-side
preparation is numpy, as in :mod:`pint_tpu`; device code is eager PyTorch
plus hand-written CUDA kernels (``pint_tpu_torch/csrc``).

Importing this package never imports jax and never changes torch's global
state (default dtype, TF32 flags, default device): every tensor is built
with an explicit dtype and device.  Entry points take ``device=None``,
which means ``"cuda"``; see :func:`pint_tpu_torch.utils.resolve_device`.

Physical constants are the same as :mod:`pint_tpu`'s (reference
`src/pint/__init__.py:56-106`): IAU/tempo conventions.
"""

__version__ = "0.1.0"

# --- fundamental constants (SI) ----------------------------------------------
#: speed of light [m/s] (exact, SI definition)
c = 299792458.0
#: astronomical unit [m] (IAU 2012 exact)
AU = 149597870700.0
#: light-second [m]
ls = c
#: Julian year [s]
JULIAN_YEAR = 365.25 * 86400.0
#: seconds per day
SECS_PER_DAY = 86400.0
#: days per Julian century / millennium
DAYS_PER_CENTURY = 36525.0
#: MJD of the J2000.0 epoch (TT): 2000 Jan 1.5 TT
MJD_J2000 = 51544.5

# --- tempo/pulsar conventions -------------------------------------------------
#: Dispersion constant, tempo convention (reference `src/pint/__init__.py:90`):
#: delay[s] = DM[pc/cm^3] / (2.41e-4 * freq[MHz]^2).  This is *defined* as
#: 1/2.41e-4 exactly, not the more precise physical e^2/(2 pi m_e c) value,
#: for compatibility with tempo/tempo2.
DMconst = 1.0 / 2.41e-4  # s MHz^2 cm^3 / pc

#: GM_sun / c^3 [s] — solar mass in time units (IAU 2009 GM_sun)
GMsun = 1.32712440018e20  # m^3/s^2
Tsun = GMsun / c**3  # 4.92549094765e-06 s

#: planet masses in time units GM/c^3 [s], from the IAU 2009 system mass
#: ratios (same convention as reference `src/pint/__init__.py:81-88`);
#: Tearth includes the Moon.
Tmercury = Tsun / 6023600.0
Tvenus = Tsun / 408523.71
Tearth = Tsun / 328900.56
Tmars = Tsun / 3098708.0
Tjupiter = Tsun / 1047.3486
Tsaturn = Tsun / 3497.898
Turanus = Tsun / 22902.98
Tneptune = Tsun / 19412.24

# Planetary GM values [m^3/s^2] (IAU/DE421-era values, as used for Shapiro
# delays; reference `src/pint/__init__.py:92-106` uses the same bodies).
GM_BODY = {
    "sun": GMsun,
    "mercury": 2.2032e13,
    "venus": 3.24858592e14,
    "earth": 3.986004418e14,
    "moon": 4.9028e12,
    "mars": 4.282837e13,
    "jupiter": 1.26686534e17,
    "saturn": 3.7931187e16,
    "uranus": 5.793939e15,
    "neptune": 6.836529e15,
    "pluto": 8.71e11,
}
#: T_body = GM/c^3 [s] for Shapiro delay per body
T_BODY = {k: v / c**3 for k, v in GM_BODY.items()}

#: parsec [m] (exact from au and arcsec definition)
PARSEC = AU * 3600.0 * 180.0 / 3.141592653589793
#: kilometer per second in AU/day, etc. left to pint_tpu.units

#: mean obliquity of the ecliptic at J2000, IERS 2010 [arcsec]
OBLIQUITY_J2000_ARCSEC = 84381.406

from pint_tpu_torch.dd import DD  # noqa: E402,F401

__all__ = [
    "c",
    "AU",
    "ls",
    "DMconst",
    "Tsun",
    "GM_BODY",
    "T_BODY",
    "PARSEC",
    "SECS_PER_DAY",
    "MJD_J2000",
    "DD",
    "__version__",
]
