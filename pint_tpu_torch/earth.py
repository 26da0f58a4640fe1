"""Earth orientation: ITRF (geocentric, rotating) -> GCRS (geocentric, inertial).

Replaces the reference's pyerfa dependency (`src/pint/erfautils.py:84`,
`gcrs_posvel_from_itrf`) — ERFA is not available in this environment, so the
IAU transformation chain is implemented directly:

    r_GCRS = P(t) · N(t) · R3(-GAST) · W(t) · r_ITRF

* ``W`` — polar motion.  No IERS tables ship with this package (the reference
  downloads them via astropy); an :class:`EOPProvider` hook supplies
  ``xp/yp/UT1-UTC`` when the user has IERS data, else zeros (documented error:
  |xp,yp| ≲ 0.3" → ≲10 m of observatory position ≈ 30 ns light-time, and
  |UT1-UTC| ≤ 0.9 s → ≤ 420 m tangential ≈ 1.4 µs — absorbed by fitted
  astrometry for long data sets).
* ``GAST`` — Earth rotation: IAU 2006 GMST polynomial on the Earth Rotation
  Angle + equation of the equinoxes.
* ``N`` — IAU 1980 nutation truncated to the 13 largest terms (|Δψ| ≥ 0.005"),
  giving ≲0.02" ≈ 1e-7 rad ≈ 0.6 m at the geocenter distance (≈2 ns).
* ``P`` — IAU 1976 (Lieske) precession angles ζ_A, z_A, θ_A.

Total accuracy without EOP data: ~µs-level absolute, dominated by UT1;
with user-supplied EOP: ~few ns.  All pure numpy (host precompute — this runs
once per TOA set at load time; see `SURVEY.md §7` host/device split).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from pint_tpu_torch.utils import PosVel

ARCSEC = np.pi / (180.0 * 3600.0)
TURNAS = 1296000.0  # arcsec per turn
#: Earth rotation rate [rad/s of UT1] (IERS conventional value)
OMEGA_EARTH = 2.0 * np.pi * 1.00273781191135448 / 86400.0


class EOP(NamedTuple):
    """Earth-orientation parameters at an epoch."""

    ut1_minus_utc: np.ndarray  # seconds
    xp: np.ndarray  # polar motion, arcsec
    yp: np.ndarray  # arcsec


#: EOPProvider: callable mjd_utc(float array) -> EOP
EOPProvider = Callable[[np.ndarray], EOP]


def null_eop(mjd_utc) -> EOP:
    """Default EOP provider: UT1=UTC, no polar motion (see module docstring)."""
    z = np.zeros_like(np.asarray(mjd_utc, np.float64))
    return EOP(z, z, z)


class TableEOP:
    """EOP provider interpolating a user-supplied (mjd, ut1-utc, xp, yp) table.

    The table format is four float columns; users with IERS finals2000A data
    can produce one trivially.  Linear interpolation, clamped at the ends.
    """

    def __init__(self, mjd, dut1, xp, yp):
        self.mjd = np.asarray(mjd, np.float64)
        self.dut1 = np.asarray(dut1, np.float64)
        self.xp = np.asarray(xp, np.float64)
        self.yp = np.asarray(yp, np.float64)

    @classmethod
    def from_file(cls, path):
        arr = np.loadtxt(path)
        return cls(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3])

    def __call__(self, mjd_utc) -> EOP:
        m = np.asarray(mjd_utc, np.float64)
        return EOP(
            np.interp(m, self.mjd, self.dut1),
            np.interp(m, self.mjd, self.xp),
            np.interp(m, self.mjd, self.yp),
        )


# --- fundamental arguments (Delaunay), IERS Conventions ----------------------


def _delaunay(t):
    """Five fundamental luni-solar arguments [rad]; t = TDB Julian centuries
    since J2000.0 (TT is fine at this accuracy)."""
    # mean anomaly of the Moon
    el = (485868.249036 + t * (1717915923.2178 + t * (31.8792 + t * 0.051635))) % TURNAS
    # mean anomaly of the Sun
    elp = (1287104.79305 + t * (129596581.0481 + t * (-0.5532 - t * 0.000136))) % TURNAS
    # mean argument of latitude of the Moon (F = L - Omega)
    f = (335779.526232 + t * (1739527262.8478 + t * (-12.7512 - t * 0.001037))) % TURNAS
    # mean elongation of the Moon from the Sun
    d = (1072260.70369 + t * (1602961601.2090 + t * (-6.3706 + t * 0.006593))) % TURNAS
    # mean longitude of the Moon's ascending node
    om = (450160.398036 + t * (-6962890.5431 + t * (7.4722 + t * 0.007702))) % TURNAS
    return (el * ARCSEC, elp * ARCSEC, f * ARCSEC, d * ARCSEC, om * ARCSEC)


# IAU 1980 nutation series, largest 13 terms.
# Columns: multipliers (l, l', F, D, Om), dpsi [0.1 mas], dpsi_t [0.1mas/cy],
# deps [0.1 mas], deps_t.  (Subset of the published IAU 1980 table.)
_NUT80 = np.array(
    [
        #  l   l'  F   D   Om     dpsi      dpsi_t   deps     deps_t
        [0, 0, 0, 0, 1, -171996.0, -174.2, 92025.0, 8.9],
        [0, 0, 2, -2, 2, -13187.0, -1.6, 5736.0, -3.1],
        [0, 0, 2, 0, 2, -2274.0, -0.2, 977.0, -0.5],
        [0, 0, 0, 0, 2, 2062.0, 0.2, -895.0, 0.5],
        [0, 1, 0, 0, 0, 1426.0, -3.4, 54.0, -0.1],
        [1, 0, 0, 0, 0, 712.0, 0.1, -7.0, 0.0],
        [0, 1, 2, -2, 2, -517.0, 1.2, 224.0, -0.6],
        [0, 0, 2, 0, 1, -386.0, -0.4, 200.0, 0.0],
        [1, 0, 2, 0, 2, -301.0, 0.0, 129.0, -0.1],
        [0, -1, 2, -2, 2, 217.0, -0.5, -95.0, 0.3],
        [1, 0, 0, -2, 0, -158.0, 0.0, -1.0, 0.0],
        [0, 0, 2, -2, 1, 129.0, 0.1, -70.0, 0.0],
        [-1, 0, 2, 0, 2, 123.0, 0.0, -53.0, 0.0],
    ]
)


def nutation_angles(t):
    """(dpsi, deps) nutation in longitude/obliquity [rad], truncated IAU 1980.

    t = Julian centuries TT since J2000.0.
    """
    el, elp, f, d, om = _delaunay(t)
    args = np.stack([el, elp, f, d, om], axis=-1)  # (..., 5)
    mult = _NUT80[:, :5]  # (13, 5)
    arg = args @ mult.T  # (..., 13)
    dpsi = np.sum((_NUT80[:, 5] + _NUT80[:, 6] * t[..., None]) * np.sin(arg), axis=-1)
    deps = np.sum((_NUT80[:, 7] + _NUT80[:, 8] * t[..., None]) * np.cos(arg), axis=-1)
    # table units are 0.1 mas
    return dpsi * 1e-4 * ARCSEC, deps * 1e-4 * ARCSEC


def mean_obliquity(t):
    """IAU 2006 mean obliquity of the ecliptic [rad]."""
    eps = 84381.406 + t * (
        -46.836769 + t * (-0.0001831 + t * (0.00200340 + t * (-5.76e-7 - t * 4.34e-8)))
    )
    return eps * ARCSEC


def precession_angles(t):
    """IAU 1976 (Lieske) equatorial precession angles [rad]."""
    zeta = (2306.2181 + t * (0.30188 + t * 0.017998)) * t * ARCSEC
    z = (2306.2181 + t * (1.09468 + t * 0.018203)) * t * ARCSEC
    theta = (2004.3109 + t * (-0.42665 - t * 0.041833)) * t * ARCSEC
    return zeta, z, theta


def _r1(a):
    c, s = np.cos(a), np.sin(a)
    o, zz = np.ones_like(c), np.zeros_like(c)
    return np.stack(
        [
            np.stack([o, zz, zz], -1),
            np.stack([zz, c, s], -1),
            np.stack([zz, -s, c], -1),
        ],
        -2,
    )


def _r2(a):
    c, s = np.cos(a), np.sin(a)
    o, zz = np.ones_like(c), np.zeros_like(c)
    return np.stack(
        [
            np.stack([c, zz, -s], -1),
            np.stack([zz, o, zz], -1),
            np.stack([s, zz, c], -1),
        ],
        -2,
    )


def _r3(a):
    c, s = np.cos(a), np.sin(a)
    o, zz = np.ones_like(c), np.zeros_like(c)
    return np.stack(
        [
            np.stack([c, s, zz], -1),
            np.stack([-s, c, zz], -1),
            np.stack([zz, zz, o], -1),
        ],
        -2,
    )


def precession_matrix(t):
    """Mean-of-date -> J2000 rotation.

    The classic J2000->date precession matrix is R3(-z)·R2(θ)·R3(-ζ)
    (Lieske/ERFA pmat76); this returns its transpose R3(ζ)·R2(-θ)·R3(z) so
    that the ITRF->GCRS chain in :func:`itrf_to_gcrs_matrix` carries of-date
    vectors back to the J2000/GCRS frame.  Direction validated in
    tests/test_astronomy.py::test_precession_direction (CIP x-coordinate in
    J2000 must *grow* as +2004"/cy · t).
    """
    zeta, z, theta = precession_angles(t)
    return _r3(zeta) @ _r2(-theta) @ _r3(z)


def nutation_matrix(t, dpsi, deps):
    """True-of-date -> mean-of-date rotation (inverse of the classic
    mean->true nutation matrix R1(-(ε+Δε))·R3(-Δψ)·R1(ε))."""
    eps = mean_obliquity(t)
    return _r1(-eps) @ _r3(dpsi) @ _r1(eps + deps)


def era(ut1_jd_frac_a, ut1_jd_frac_b):
    """Earth Rotation Angle [rad] from a two-part UT1 Julian date."""
    # ERA(UT1) = 2π (0.7790572732640 + 1.00273781191135448 * (JD_UT1 − 2451545.0))
    d1 = ut1_jd_frac_a - 2451545.0
    d2 = ut1_jd_frac_b
    frac = (
        0.7790572732640
        + 0.00273781191135448 * (d1 + d2)
        + (d1 % 1.0)
        + (d2 % 1.0)
    )
    return 2.0 * np.pi * (frac % 1.0)


def gmst06(ut1_mjd, tt_centuries):
    """GMST (IAU 2006) [rad] from UT1 MJD and TT Julian centuries."""
    theta = era(ut1_mjd + 2400000.5, 0.0)
    t = tt_centuries
    dpoly = (
        0.014506
        + t * (4612.156534 + t * (1.3915817 + t * (-0.00000044 + t * (-0.000029956 - t * 3.68e-8))))
    ) * ARCSEC
    return (theta + dpoly) % (2.0 * np.pi)


def gast(ut1_mjd, tt_centuries, dpsi=None, deps=None):
    """Greenwich apparent sidereal time [rad] (equinox-based)."""
    t = np.asarray(tt_centuries, np.float64)
    if dpsi is None:
        dpsi, deps = nutation_angles(t)
    eps = mean_obliquity(t)
    # equation of the equinoxes (principal term + largest complementary term)
    om = _delaunay(t)[4]
    ee = dpsi * np.cos(eps) + (0.00264 * np.sin(om)) * ARCSEC
    return (gmst06(ut1_mjd, t) + ee) % (2.0 * np.pi)


def polar_motion_matrix(xp_as, yp_as):
    """W = R2(xp) R1(yp) (s' neglected, < 0.1 mas/century)."""
    return _r2(xp_as * ARCSEC) @ _r1(yp_as * ARCSEC)


def itrf_to_gcrs_matrix(tt_mjd, ut1_mjd, xp_as=0.0, yp_as=0.0):
    """Full rotation matrix taking ITRF vectors to GCRS at epoch(s).

    tt_mjd / ut1_mjd: float64 arrays (precision ~ns-level is ample for the
    orientation; the *time tags* stay exact elsewhere).
    """
    tt_mjd = np.asarray(tt_mjd, np.float64)
    t = (tt_mjd - 51544.5) / 36525.0
    dpsi, deps = nutation_angles(t)
    theta = gast(ut1_mjd, t, dpsi, deps)
    P = precession_matrix(t)
    N = nutation_matrix(t, dpsi, deps)
    W = polar_motion_matrix(np.asarray(xp_as, np.float64), np.asarray(yp_as, np.float64))
    return P @ N @ _r3(-theta) @ W


def itrf_to_gcrs_posvel(itrf_xyz_m, tt_mjd, ut1_mjd, xp_as=0.0, yp_as=0.0) -> PosVel:
    """Observatory GCRS position [m] and velocity [m/s] from ITRF coordinates.

    Velocity = Ω × r rotated to GCRS (precession/nutation rates are ~1e-9 of
    Earth rotation; neglected, same as the reference's accuracy envelope for
    `gcrs_posvel_from_itrf`, `src/pint/erfautils.py`).
    """
    R = itrf_to_gcrs_matrix(tt_mjd, ut1_mjd, xp_as, yp_as)
    r = np.asarray(itrf_xyz_m, np.float64)
    r = np.broadcast_to(r, R.shape[:-2] + (3,))
    pos = np.einsum("...ij,...j->...i", R, r)
    # The station is fixed in the rotating frame, so v_GCRS = R · (ω × r_ITRF).
    omega = np.array([0.0, 0.0, OMEGA_EARTH])
    v_body = np.cross(np.broadcast_to(omega, r.shape), r)
    vel = np.einsum("...ij,...j->...i", R, v_body)
    return PosVel(pos, vel)


def geodetic_to_itrf(lat_deg, lon_deg, height_m):
    """WGS84 geodetic -> ITRF cartesian [m] (for user convenience)."""
    a = 6378137.0
    f = 1.0 / 298.257223563
    e2 = f * (2 - f)
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    x = (N + height_m) * np.cos(lat) * np.cos(lon)
    y = (N + height_m) * np.cos(lat) * np.sin(lon)
    z = (N * (1 - e2) + height_m) * np.sin(lat)
    return np.stack([x, y, z], axis=-1)
