"""Solar-system ephemerides: body positions/velocities w.r.t. the SSB.

Equivalent of the reference's `src/pint/solar_system_ephemerides.py` (which
wraps astropy+jplephem and *downloads* JPL DE kernels).  This environment has
neither astropy nor jplephem nor network access, so this module provides:

* :class:`SPKEphemeris` — a from-scratch reader for JPL SPK/DAF binary kernels
  (``.bsp``; DAF file format per NAIF's SPK Required Reading; Chebyshev
  segment types 2 and 3).  Users drop ``de421.bsp``/``de440.bsp`` into
  ``$PINT_TPU_EPHEM_DIR`` (or CWD) and get full JPL precision — this replaces
  the reference's jplephem dependency with native code.
* :class:`BuiltinEphemeris` — an analytic fallback: truncated VSOP87D for
  the Earth (:mod:`pint_tpu.data.vsop87d_earth`) + an extended Meeus/ELP
  lunar series + heliocentric Keplerian mean elements (JPL "Approximate
  Positions of the Planets", Standish) for the other planets and the SSB
  offset.  Earth accuracy ~100-300 km (sub-ms light time).
* :class:`IntegratedEphemeris` — the default no-kernel path for real
  data: a 9-body numerical integration (+ solar 1PN term) whose EMB
  initial conditions are least-squares fit to the analytic theory over
  the data window, regenerating the full perturbation spectrum.  Earth
  accuracy ~100 km, zero phase wraps on the reference's B1855+09 golden
  data (tests/test_tempo2_parity.py).  Disk-cached per window.

All returns are ICRS-equatorial, SSB-centered, SI units (m, m/s).
Host-side numpy (load-time precompute; see SURVEY.md §7).  An on-device
Chebyshev pack for end-to-end jitted pipelines is provided by
:meth:`SPKEphemeris.chebyshev_pack`.
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from pint_tpu_torch import GM_BODY
from pint_tpu_torch.utils import PosVel

AU_KM = 149597870.700
DAY_S = 86400.0
#: seconds of TDB past J2000 (JD 2451545.0 TDB) per MJD(TDB) day
_J2000_MJD = 51544.5

# NAIF integer codes
NAIF = {
    "ssb": 0,
    "mercury_bary": 1,
    "venus_bary": 2,
    "emb": 3,
    "mars_bary": 4,
    "jupiter_bary": 5,
    "saturn_bary": 6,
    "uranus_bary": 7,
    "neptune_bary": 8,
    "pluto_bary": 9,
    "sun": 10,
    "moon": 301,
    "earth": 399,
    "mercury": 199,
    "venus": 299,
    "mars": 499,
    "jupiter": 599,
    "saturn": 699,
    "uranus": 799,
    "neptune": 899,
    "pluto": 999,
}

# For the giant planets the planet-barycenter offset is far below timing
# relevance (Shapiro-delay geometry), so barycenter codes substitute.
_BARY_FALLBACK = {499: 4, 599: 5, 699: 6, 799: 7, 899: 8, 999: 9, 199: 1, 299: 2}


def mjd_tdb_to_et(mjd_tdb):
    """MJD(TDB) -> ET seconds past J2000 TDB."""
    return (np.asarray(mjd_tdb, np.float64) - _J2000_MJD) * DAY_S


class _Segment:
    __slots__ = (
        "target",
        "center",
        "frame",
        "dtype",
        "et_beg",
        "et_end",
        "init",
        "intlen",
        "rsize",
        "n",
        "coeffs",
    )

    def __init__(self, target, center, frame, dtype, et_beg, et_end, init, intlen, rsize, n, coeffs):
        self.target = target
        self.center = center
        self.frame = frame
        self.dtype = dtype
        self.et_beg = et_beg
        self.et_end = et_end
        self.init = init
        self.intlen = intlen
        self.rsize = rsize
        self.n = n
        self.coeffs = coeffs  # (n, ncomp, ncoef) Chebyshev coefficients [km]

    def posvel_km(self, et):
        """Evaluate (pos[km], vel[km/s]) at ET seconds (vectorized)."""
        et = np.asarray(et, np.float64)
        idx = np.floor((et - self.init) / self.intlen).astype(np.int64)
        idx = np.clip(idx, 0, self.n - 1)
        mid = self.init + (idx + 0.5) * self.intlen
        radius = self.intlen / 2.0
        s = (et - mid) / radius  # in [-1, 1]
        c = self.coeffs[idx]  # (..., ncomp, ncoef)
        ncoef = c.shape[-1]
        # Chebyshev via Clenshaw recurrence, plus derivative recurrence
        b0 = np.zeros(s.shape + (c.shape[-2],))
        b1 = np.zeros_like(b0)
        d0 = np.zeros_like(b0)
        d1 = np.zeros_like(b0)
        s2 = (2.0 * s)[..., None]
        for k in range(ncoef - 1, 0, -1):
            d0, d1 = s2 * d0 - d1 + 2.0 * b0, d0
            b0, b1 = s2 * b0 - b1 + c[..., k], b0
        # p = c0 + s*b1 - b2  =>  p' = b1 + s*b1' - b2'
        dval = b0 + s[..., None] * d0 - d1
        val = s[..., None] * b0 - b1 + c[..., 0]
        if c.shape[-2] >= 6:  # type 3: velocity stored explicitly
            return val[..., 0:3], val[..., 3:6]
        return val, dval / radius


class SPKEphemeris:
    """JPL SPK (``.bsp``) kernel reader: DAF format, segment types 2 & 3.

    Format implemented from the public NAIF SPK/DAF specification (the
    reference instead imports ``jplephem``; cf.
    `src/pint/solar_system_ephemerides.py:18-45`).
    """

    def __init__(self, path: str):
        self.path = path
        self.segments: Dict[Tuple[int, int], list] = {}
        with open(path, "rb") as f:
            data = f.read()
        self._parse(data)
        self.name = os.path.splitext(os.path.basename(path))[0].lower()

    # -- DAF plumbing ----------------------------------------------------------

    def _parse(self, data: bytes):
        locidw = data[0:8].decode("ascii", "replace")
        if not (locidw.startswith("DAF/SPK") or locidw.startswith("NAIF/DAF")):
            raise ValueError(f"{self.path}: not an SPK kernel (ID word {locidw!r})")
        locfmt = data[88:96].decode("ascii", "replace")
        if "LTL" in locfmt:
            en = "<"
        elif "BIG" in locfmt:
            en = ">"
        else:
            # pre-FTP-validation files: guess from ND plausibility
            nd_l = struct.unpack("<i", data[8:12])[0]
            en = "<" if 0 < nd_l < 124 else ">"
        nd, ni = struct.unpack(en + "ii", data[8:16])
        fward, bward, free = struct.unpack(en + "iii", data[76:88])
        ss = nd + (ni + 1) // 2  # summary size in doubles
        f64 = np.dtype(en + "f8")
        i32 = np.dtype(en + "i4")
        words = np.frombuffer(data, dtype=f64)

        recno = fward
        while recno > 0:
            base = (recno - 1) * 128  # word index of record start
            nxt, _prev, nsum = words[base : base + 3]
            for k in range(int(nsum)):
                sbase = base + 3 + k * ss
                dbl = words[sbase : sbase + nd]
                ints = np.frombuffer(
                    words[sbase + nd : sbase + ss].tobytes(), dtype=i32
                )[:ni]
                self._load_segment(words, dbl, ints)
            recno = int(nxt)

    def _load_segment(self, words, dbl, ints):
        et_beg, et_end = float(dbl[0]), float(dbl[1])
        target, center, frame, dtype, begin, end = (int(x) for x in ints[:6])
        if dtype not in (2, 3):
            return  # only Chebyshev position(/velocity) segments are used by DE
        seg_words = words[begin - 1 : end]
        init, intlen, rsize, n = seg_words[-4:]
        rsize, n = int(rsize), int(n)
        recs = seg_words[: rsize * n].reshape(n, rsize)
        ncomp = 3 if dtype == 2 else 6
        ncoef = (rsize - 2) // ncomp
        coeffs = recs[:, 2:].reshape(n, ncomp, ncoef)
        self.segments.setdefault((target, center), []).append(
            _Segment(
                target, center, frame, dtype, et_beg, et_end, float(init), float(intlen), rsize, n, coeffs
            )
        )

    # -- public API ------------------------------------------------------------

    def _chain(self, code: int):
        """Chain of segment lists from SSB(0) to `code` (e.g. 399: 0->3->399)."""
        if code == 0:
            return []
        for (tgt, ctr), segs in self.segments.items():
            if tgt == code:
                return self._chain(ctr) + [segs]
        if code in _BARY_FALLBACK:
            return self._chain(_BARY_FALLBACK[code])
        raise KeyError(f"body {code} not reachable in {self.path}")

    @staticmethod
    def _pick(segs, et):
        """Segment covering all epochs in `et`, else EphemerisError."""
        from pint_tpu_torch.exceptions import EphemerisError

        lo, hi = float(np.min(et)), float(np.max(et))
        for seg in segs:
            if seg.et_beg <= lo and hi <= seg.et_end:
                return seg
        spans = [(s.et_beg, s.et_end) for s in segs]
        raise EphemerisError(
            f"epochs ET [{lo}, {hi}] s outside kernel segment span(s) {spans} "
            f"(no extrapolation beyond the .bsp coverage)"
        )

    def posvel(self, body: str, mjd_tdb) -> PosVel:
        """(pos [m], vel [m/s]) of `body` w.r.t. SSB, ICRS axes."""
        code = NAIF[body.lower()]
        et = mjd_tdb_to_et(mjd_tdb)
        pos = 0.0
        vel = 0.0
        for segs in self._chain(code):
            p, v = self._pick(segs, et).posvel_km(et)
            pos = pos + p
            vel = vel + v
        return PosVel(np.asarray(pos) * 1e3, np.asarray(vel) * 1e3)

    def chebyshev_pack(self, body: str, mjd_start: float, mjd_end: float):
        """Extract (init, intlen, coeffs[m]) covering [mjd_start, mjd_end] for
        on-device evaluation (summed over the SSB chain after re-fitting is
        NOT done — each chain link is returned separately)."""
        code = NAIF[body.lower()]
        out = []
        e0, e1 = mjd_tdb_to_et(mjd_start), mjd_tdb_to_et(mjd_end)
        for segs in self._chain(code):
            seg = self._pick(segs, np.array([e0, e1]))
            i0 = max(0, int(np.floor((e0 - seg.init) / seg.intlen)))
            i1 = min(seg.n - 1, int(np.floor((e1 - seg.init) / seg.intlen)))
            out.append(
                (
                    seg.init + i0 * seg.intlen,
                    seg.intlen,
                    np.asarray(seg.coeffs[i0 : i1 + 1]) * 1e3,
                )
            )
        return out


# --- analytic fallback --------------------------------------------------------

# --- truncated VSOP87D Earth (see pint_tpu/data/vsop87d_earth.py) ----------


def _vsop_series(series, tau):
    """Evaluate sum_k tau^k * sum_i A cos(B + C tau) and its tau-derivative.

    tau: Julian millennia TDB from J2000 (array).  Returns (value, d/dtau).
    """
    tau = np.asarray(tau, np.float64)
    val = np.zeros_like(tau)
    dval = np.zeros_like(tau)
    for k, tab in enumerate(series):
        A, B, C = tab[:, 0], tab[:, 1], tab[:, 2]
        arg = B[None, :] + C[None, :] * tau[..., None]
        s_k = np.sum(A * np.cos(arg), axis=-1)
        ds_k = -np.sum(A * C * np.sin(arg), axis=-1)
        tk = tau**k
        val += tk * s_k
        dval += tk * ds_k
        if k > 0:
            dval += k * tau ** (k - 1) * s_k
    return val, dval


def _ecl_date_to_icrs_matrix(t_cy):
    """(N,3,3) rotation: dynamical-ecliptic-of-date -> ICRS/J2000 equator.

    Mean obliquity of date tilts ecliptic -> mean equator of date, then the
    (vectorized) Lieske precession matrix carries mean-of-date back to
    J2000.  The ~23 mas frame bias J2000->ICRS is far below the series
    truncation and is omitted, consistently with the ITRF chain in
    :mod:`pint_tpu.earth`.
    """
    from pint_tpu_torch.earth import _r1, mean_obliquity, precession_matrix

    eps = mean_obliquity(np.asarray(t_cy, np.float64))
    return precession_matrix(np.asarray(t_cy, np.float64)) @ _r1(-eps)


def vsop87_earth_helio_icrs(mjd_tdb):
    """Heliocentric Earth (pos [m], vel [m/s]) in ICRS from the truncated
    VSOP87D series — the precision core of the analytic fallback, replacing
    Keplerian mean elements for the one body where accuracy matters most.

    The rotation matrix's own time-derivative (precession, ~1 m/s at 1 AU)
    is neglected in the velocity.
    """
    from pint_tpu_torch.data import vsop87d_earth as v

    t = np.asarray(mjd_tdb, np.float64)
    scalar = t.ndim == 0
    t = np.atleast_1d(t)
    tau = (t - _J2000_MJD) / 365250.0
    L, dL = _vsop_series(v.L_SERIES, tau)
    B, dB = _vsop_series(v.B_SERIES, tau)
    R, dR = _vsop_series(v.R_SERIES, tau)
    cl, sl = np.cos(L), np.sin(L)
    cb, sb = np.cos(B), np.sin(B)
    pos = np.stack([R * cb * cl, R * cb * sl, R * sb], axis=-1)
    vel = np.stack(
        [
            dR * cb * cl - R * sb * dB * cl - R * cb * sl * dL,
            dR * cb * sl - R * sb * dB * sl + R * cb * cl * dL,
            dR * sb + R * cb * dB,
        ],
        axis=-1,
    )
    M = _ecl_date_to_icrs_matrix(tau * 10.0)  # millennia -> centuries
    pos = np.einsum("...ij,...j->...i", M, pos) * AU_KM * 1e3
    vel = np.einsum("...ij,...j->...i", M, vel) * AU_KM * 1e3 \
        / (365250.0 * DAY_S)
    if scalar:
        return pos[0], vel[0]
    return pos, vel


# JPL "Approximate Positions of the Planets" (E.M. Standish) Keplerian mean
# elements, J2000 ecliptic, valid 1800-2050.  Columns: a [au], e, I [deg],
# L [deg], long.peri [deg], long.node [deg]; then centennial rates of each.
_KEPLER_ELEMENTS = {
    "mercury": (0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628, 48.33076593,
                0.00000037, 0.00001906, -0.00594749, 149472.67411175, 0.16047689, -0.12534081),
    "venus": (0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718, 76.67984255,
              0.00000390, -0.00004107, -0.00078890, 58517.81538729, 0.00268329, -0.27769418),
    "emb": (1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193, 0.0,
            0.00000562, -0.00004392, -0.01294668, 35999.37244981, 0.32327364, 0.0),
    "mars": (1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959, 49.55953891,
             0.00001847, 0.00007882, -0.00813131, 19140.30268499, 0.44441088, -0.29257343),
    "jupiter": (5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983, 100.47390909,
                -0.00011607, -0.00013253, -0.00183714, 3034.74612775, 0.21252668, 0.20469106),
    "saturn": (9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831, 113.66242448,
               -0.00125060, -0.00050991, 0.00193609, 1222.49362201, -0.41897216, -0.28867794),
    "uranus": (19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630, 74.01692503,
               -0.00196176, -0.00004397, -0.00242939, 428.48202785, 0.40805281, 0.04240589),
    "neptune": (30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227, 131.78422574,
                0.00026291, 0.00005105, 0.00035372, 218.45945325, -0.32241464, -0.00508664),
    "pluto": (39.48211675, 0.24882730, 17.14001206, 238.92903833, 224.06891629, 110.30393684,
              -0.00031596, 0.00005170, 0.00004818, 145.20780515, -0.04062942, -0.01183482),
}

#: Earth/Moon mass ratio (DE421 convention)
EMRAT = 81.30056907419062
_MOON_FRAC = 1.0 / (1.0 + EMRAT)  # Moon's share of the E-M separation to EMB

#: obliquity used to rotate J2000 ecliptic -> ICRS equatorial [rad]
_EPS0 = np.deg2rad(84381.406 / 3600.0)

# Truncated ELP-2000/Meeus lunar series.  Args: multiples of (D, M, M', F);
# dL in 1e-6 deg, dR in 1e-3 km, dB in 1e-6 deg (separate table).
_MOON_LR = np.array(
    [
        # D  M  M'  F     dL        dR
        [0, 0, 1, 0, 6288774.0, -20905355.0],
        [2, 0, -1, 0, 1274027.0, -3699111.0],
        [2, 0, 0, 0, 658314.0, -2955968.0],
        [0, 0, 2, 0, 213618.0, -569925.0],
        [0, 1, 0, 0, -185116.0, 48888.0],
        [0, 0, 0, 2, -114332.0, -3149.0],
        [2, 0, -2, 0, 58793.0, 246158.0],
        [2, -1, -1, 0, 57066.0, -152138.0],
        [2, 0, 1, 0, 53322.0, -170733.0],
        [2, -1, 0, 0, 45758.0, -204586.0],
        [0, 1, -1, 0, -40923.0, -129620.0],
        [1, 0, 0, 0, -34720.0, 108743.0],
        [0, 1, 1, 0, -30383.0, 104755.0],
        [2, 0, 0, -2, 15327.0, 10321.0],
        [0, 0, 1, 2, -12528.0, 0.0],
        [0, 0, 1, -2, 10980.0, 79661.0],
        [4, 0, -1, 0, 10675.0, -34782.0],
        [0, 0, 3, 0, 10034.0, -23210.0],
        [4, 0, -2, 0, 8548.0, -21636.0],
        [2, 1, -1, 0, -7888.0, 24208.0],
        [2, 1, 0, 0, -6766.0, 30824.0],
        [1, 0, -1, 0, -5163.0, -8379.0],
        [1, 1, 0, 0, 4987.0, -16675.0],
        [2, -1, 1, 0, 4036.0, -12831.0],
        [2, 0, 2, 0, 3994.0, -10445.0],
        [4, 0, 0, 0, 3861.0, -11650.0],
        [2, 0, -3, 0, 3665.0, 14403.0],
        [0, 1, -2, 0, -2689.0, -7003.0],
        [2, 0, -1, 2, -2602.0, 0.0],
        [2, -1, -2, 0, 2390.0, 10056.0],
        [1, 0, 1, 0, -2348.0, 6322.0],
        [2, -2, 0, 0, 2236.0, -9884.0],
        [0, 1, 2, 0, -2120.0, 5751.0],
        [0, 2, 0, 0, -2069.0, 0.0],
        [2, -2, -1, 0, 2048.0, -4950.0],
        [2, 0, 1, -2, -1773.0, 4130.0],
        [2, 0, 0, 2, -1595.0, 0.0],
        [4, -1, -1, 0, 1215.0, -3958.0],
        [0, 0, 2, 2, -1110.0, 0.0],
        [3, 0, -1, 0, -892.0, 3258.0],
        [2, 1, 1, 0, -810.0, 2616.0],
        [4, -1, -2, 0, 759.0, -1897.0],
        [0, 2, -1, 0, -713.0, -2117.0],
        [2, 2, -1, 0, -700.0, 2354.0],
        [2, 1, -2, 0, 691.0, 0.0],
        [2, -1, 0, -2, 596.0, 0.0],
        [4, 0, 1, 0, 549.0, -1423.0],
        [0, 0, 4, 0, 537.0, -1117.0],
        [4, -1, 0, 0, 520.0, -1571.0],
        [1, 0, -2, 0, -487.0, -1739.0],
        [2, 1, 0, -2, -399.0, 0.0],
        [0, 0, 2, -2, -381.0, -4421.0],
        [1, 1, 1, 0, 351.0, 0.0],
        [3, 0, -2, 0, -340.0, 0.0],
        [4, 0, -3, 0, 330.0, 0.0],
        [2, -1, 2, 0, 327.0, 0.0],
        [0, 2, 1, 0, -323.0, 1165.0],
        [1, 1, -1, 0, 299.0, 0.0],
        [2, 0, 3, 0, 294.0, 0.0],
        [2, 0, -1, -2, 0.0, 8752.0],
    ]
)
_MOON_B = np.array(
    [
        # D  M  M'  F     dB
        [0, 0, 0, 1, 5128122.0],
        [0, 0, 1, 1, 280602.0],
        [0, 0, 1, -1, 277693.0],
        [2, 0, 0, -1, 173237.0],
        [2, 0, -1, 1, 55413.0],
        [2, 0, -1, -1, 46271.0],
        [2, 0, 0, 1, 32573.0],
        [0, 0, 2, 1, 17198.0],
        [2, 0, 1, -1, 9266.0],
        [0, 0, 2, -1, 8822.0],
        [2, -1, 0, -1, 8216.0],
        [2, 0, -2, -1, 4324.0],
        [2, 0, 1, 1, 4200.0],
        [2, 1, 0, -1, -3359.0],
        [2, -1, -1, 1, 2463.0],
        [2, -1, 0, 1, 2211.0],
        [2, -1, -1, -1, 2065.0],
        [0, 1, -1, -1, -1870.0],
        [4, 0, -1, -1, 1828.0],
        [0, 1, 0, 1, -1794.0],
        [0, 0, 0, 3, -1749.0],
        [0, 1, -1, 1, -1565.0],
        [1, 0, 0, 1, -1491.0],
        [0, 1, 1, 1, -1475.0],
        [0, 1, 1, -1, -1410.0],
        [0, 1, 0, -1, -1344.0],
        [1, 0, 0, -1, -1335.0],
        [0, 0, 3, 1, 1107.0],
        [4, 0, 0, -1, 1021.0],
        [4, 0, -1, 1, 833.0],
        [0, 0, 1, -3, 777.0],
        [4, 0, -2, 1, 671.0],
        [2, 0, 0, -3, 607.0],
        [2, 0, 2, -1, 596.0],
        [2, -1, 1, -1, 491.0],
        [2, 0, -2, 1, -451.0],
        [0, 0, 3, -1, 439.0],
        [2, 0, 2, 1, 422.0],
        [2, 0, -3, -1, 421.0],
        [2, 1, -1, 1, -366.0],
        [2, 1, 0, 1, -351.0],
        [4, 0, 0, 1, 331.0],
        [2, -1, 1, 1, 315.0],
        [2, -2, 0, -1, 302.0],
        [0, 0, 1, 3, -283.0],
        [2, 1, 1, -1, -229.0],
        [1, 1, 0, -1, 223.0],
        [1, 1, 0, 1, 223.0],
        [0, 1, -2, -1, -220.0],
        [2, 1, -1, -1, -220.0],
        [1, 0, 1, 1, -185.0],
        [2, -1, -2, -1, 181.0],
        [0, 1, 2, 1, -177.0],
        [4, 0, -2, -1, 176.0],
        [4, -1, -1, -1, 166.0],
        [1, 0, 1, -1, -164.0],
        [4, 0, 1, -1, 132.0],
        [1, 0, -1, -1, -119.0],
        [4, -1, 0, -1, 115.0],
        [2, -2, 0, 1, 107.0],
    ]
)


def _ecl_to_icrs(v):
    """Rotate J2000-ecliptic vectors to ICRS equatorial."""
    ce, se = np.cos(_EPS0), np.sin(_EPS0)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([x, ce * y - se * z, se * y + ce * z], axis=-1)


def _kepler_posvel_au(name, t_cy, dL_rad=0.0, da_frac=0.0):
    """Heliocentric J2000-ecliptic (pos [au], vel [au/day]) from mean
    elements.  ``dL_rad``/``da_frac``: corrections to the mean longitude
    [rad] and semi-major axis [fractional] — the giant-planet parameters
    the DE405-anchored IC fit solves for (see
    `IntegratedEphemeris._integrate_window`)."""
    a0, e0, i0, L0, w0, O0, da, de, di, dL, dw, dO = _KEPLER_ELEMENTS[name]
    a = (a0 + da * t_cy) * (1.0 + da_frac)
    e = e0 + de * t_cy
    inc = np.deg2rad(i0 + di * t_cy)
    L = np.deg2rad(L0 + dL * t_cy) + dL_rad
    wbar = np.deg2rad(w0 + dw * t_cy)
    Om = np.deg2rad(O0 + dO * t_cy)
    w = wbar - Om  # argument of perihelion
    M = np.remainder(L - wbar + np.pi, 2 * np.pi) - np.pi
    # Kepler equation, Newton iteration (fixed count; e < 0.25 for all bodies)
    E = M + e * np.sin(M)
    for _ in range(6):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    cosE, sinE = np.cos(E), np.sin(E)
    # perifocal coordinates
    xp = a * (cosE - e)
    yp = a * np.sqrt(1 - e * e) * sinE
    # mean motion [rad/day]
    n = np.deg2rad(dL) / 36525.0
    rdot_f = a * n / (1.0 - e * cosE)
    vxp = -rdot_f * sinE
    vyp = rdot_f * np.sqrt(1 - e * e) * cosE
    cw, sw = np.cos(w), np.sin(w)
    cO, sO = np.cos(Om), np.sin(Om)
    ci, si = np.cos(inc), np.sin(inc)
    r11 = cO * cw - sO * sw * ci
    r12 = -cO * sw - sO * cw * ci
    r21 = sO * cw + cO * sw * ci
    r22 = -sO * sw + cO * cw * ci
    r31 = sw * si
    r32 = cw * si
    pos = np.stack([r11 * xp + r12 * yp, r21 * xp + r22 * yp, r31 * xp + r32 * yp], -1)
    vel = np.stack([r11 * vxp + r12 * vyp, r21 * vxp + r22 * vyp, r31 * vxp + r32 * vyp], -1)
    return pos, vel


def _moon_pos_km(t_cy):
    """Geocentric Moon position only, ecliptic frame [km]."""
    t = np.asarray(t_cy, np.float64)
    deg = np.pi / 180.0
    Lp = (218.3164477 + 481267.88123421 * t - 0.0015786 * t**2) * deg
    D = (297.8501921 + 445267.1114034 * t - 0.0018819 * t**2) * deg
    M = (357.5291092 + 35999.0502909 * t - 0.0001536 * t**2) * deg
    Mp = (134.9633964 + 477198.8675055 * t + 0.0087414 * t**2) * deg
    F = (93.2720950 + 483202.0175233 * t - 0.0036539 * t**2) * deg
    E = 1.0 - 0.002516 * t - 0.0000074 * t**2

    def series(table, trig):
        args = (
            table[:, 0] * D[..., None]
            + table[:, 1] * M[..., None]
            + table[:, 2] * Mp[..., None]
            + table[:, 3] * F[..., None]
        )
        ecorr = np.where(np.abs(table[:, 1]) > 0, E[..., None] ** np.abs(table[:, 1]), 1.0)
        return args, ecorr

    argsLR, eLR = series(_MOON_LR, np.sin)
    dL = np.sum(_MOON_LR[:, 4] * eLR * np.sin(argsLR), axis=-1) * 1e-6 * deg
    dR = np.sum(_MOON_LR[:, 5] * eLR * np.cos(argsLR), axis=-1) * 1e-3
    argsB, eB = series(_MOON_B, np.sin)
    dB = np.sum(_MOON_B[:, 4] * eB * np.sin(argsB), axis=-1) * 1e-6 * deg
    # additive planetary/flattening corrections (Meeus ch. 47: the Venus
    # term A1, Jupiter term A2, and Earth-flattening term A3); ~26 km in
    # longitude, ~15 km in latitude — above the extended series floor
    A1 = (119.75 + 131.849 * t) * deg
    A2 = (53.09 + 479264.290 * t) * deg
    A3 = (313.45 + 481266.484 * t) * deg
    dL = dL + (3958.0 * np.sin(A1) + 1962.0 * np.sin(Lp - F)
               + 318.0 * np.sin(A2)) * 1e-6 * deg
    dB = dB + (-2235.0 * np.sin(Lp) + 382.0 * np.sin(A3)
               + 175.0 * np.sin(A1 - F) + 175.0 * np.sin(A1 + F)
               + 127.0 * np.sin(Lp - Mp) - 115.0 * np.sin(Lp + Mp)) \
        * 1e-6 * deg

    lon = Lp + dL
    lat = dB
    r = 385000.56 + dR  # km
    cl, sl = np.cos(lon), np.sin(lon)
    cb, sb = np.cos(lat), np.sin(lat)
    return np.stack([r * cb * cl, r * cb * sl, r * sb], -1)


def _moon_geocentric_km(t_cy):
    """Geocentric Moon, **ecliptic of date** (pos [km], vel [km/day]).

    Extended Meeus/ELP series.  Callers must precess the output to ICRS
    with :func:`_ecl_date_to_icrs_matrix` (both ephemeris classes do) —
    treating it as J2000 would introduce a ~1.4 deg/cy frame error
    (~100+ km).  Velocity by central difference of the series (smooth
    analytic function).
    """
    t = np.asarray(t_cy, np.float64)
    pos = _moon_pos_km(t)
    dt = 1e-7  # centuries ≈ 5.3 min
    vel = (_moon_pos_km(t + dt) - _moon_pos_km(t - dt)) / (2 * dt * 36525.0)
    return pos, vel


class BuiltinEphemeris:
    """Analytic fallback ephemeris (see module docstring for accuracy).

    The Earth is computed from the truncated VSOP87D series
    (:func:`vsop87_earth_helio_icrs`) + the extended Meeus/ELP lunar series
    (ecliptic of date, precessed to ICRS) — ~50-150 km, i.e. sub-ms in
    light time, measured against the reference's tempo2 golden residuals
    (tests/test_tempo2_parity.py).  The Sun/SSB offset and the outer
    planets still use Keplerian mean elements (their error enters timing
    only through the GM-weighted SSB sum and Shapiro geometry, suppressed
    by 3-6 orders of magnitude).
    """

    name = "builtin_analytic"

    def __init__(self, warn=True):
        if warn:
            warnings.warn(
                "Using the builtin analytic ephemeris (no JPL .bsp kernel "
                "found).  Earth position errors are ~1e2 km (sub-ms light "
                "time): fine for simulation and differential fitting, NOT "
                "for absolute ns-level timing of real data.  Supply a DE "
                "kernel via $PINT_TPU_EPHEM_DIR for full accuracy.",
                stacklevel=2,
            )

    def _helio_all(self, t_cy):
        out = {}
        for name in _KEPLER_ELEMENTS:
            p, v = _kepler_posvel_au(name, t_cy)
            out[name] = (p, v)
        return out

    @staticmethod
    def _ssb_offset(helio_si):
        """Sun w.r.t. SSB from a dict of heliocentric SI (pos, vel):
        the GM-weighted barycentre sum."""
        gm_tot = GM_BODY["sun"]
        psum = 0.0
        vsum = 0.0
        for name, (p, v) in helio_si.items():
            key = "earth" if name == "emb" else name
            gm = GM_BODY[key] + (GM_BODY["moon"] if name == "emb" else 0.0)
            gm_tot = gm_tot + gm
            psum = psum + gm * p
            vsum = vsum + gm * v
        return -psum / gm_tot, -vsum / gm_tot

    def _earth_moon_helio_si(self, mjd_tdb, t_cy):
        """(earth, moon_geo, emb) heliocentric/geocentric ICRS [m, m/s]."""
        ep, ev = vsop87_earth_helio_icrs(mjd_tdb)
        mp_km, mv_kmd = _moon_geocentric_km(t_cy)
        M = _ecl_date_to_icrs_matrix(t_cy)
        mp = np.einsum("...ij,...j->...i", M, mp_km) * 1e3
        mv = np.einsum("...ij,...j->...i", M, mv_kmd) * 1e3 / DAY_S
        emb_p = ep + _MOON_FRAC * mp
        emb_v = ev + _MOON_FRAC * mv
        return (ep, ev), (mp, mv), (emb_p, emb_v)

    def posvel(self, body: str, mjd_tdb) -> PosVel:
        body = body.lower()
        mjd_tdb = np.asarray(mjd_tdb, np.float64)
        if body == "ssb":
            z = np.zeros(np.shape(mjd_tdb) + (3,))
            return PosVel(z, z.copy())
        t = (mjd_tdb - _J2000_MJD) / 36525.0
        helio = self._helio_all(t)
        (ep, ev), (mp, mv), (emb_p, emb_v) = \
            self._earth_moon_helio_si(mjd_tdb, t)

        def kepler_si(name):
            p, v = helio[name]
            return (_ecl_to_icrs(np.asarray(p)) * AU_KM * 1e3,
                    _ecl_to_icrs(np.asarray(v)) * AU_KM * 1e3 / DAY_S)

        # Sun w.r.t. SSB: GM-weighted sum of heliocentric positions, with
        # the VSOP87-grade EMB replacing its Keplerian mean elements
        helio_si = {name: ((emb_p, emb_v) if name == "emb"
                           else kepler_si(name)) for name in helio}
        sun_p, sun_v = self._ssb_offset(helio_si)

        if body == "sun":
            p, v = sun_p, sun_v
        elif body == "earth":
            p, v = ep + sun_p, ev + sun_v
        elif body == "moon":
            p, v = ep + mp + sun_p, ev + mv + sun_v
        elif body == "emb":
            p, v = emb_p + sun_p, emb_v + sun_v
        else:
            key = body[:-5] if body.endswith("_bary") else body
            kp, kv = kepler_si(key)
            p, v = kp + sun_p, kv + sun_v
        return PosVel(np.asarray(p), np.asarray(v))


# --- integrated ephemeris -----------------------------------------------------

#: bodies carried by the N-body integration, in state-vector order
_NBODY_NAMES = ("sun", "mercury", "venus", "emb", "mars", "jupiter",
                "saturn", "uranus", "neptune")
_NBODY_VERSION = 4  # bump to invalidate on-disk caches
C_M_S = 299792458.0


def _nbody_gm():
    from pint_tpu_torch import GM_BODY

    return np.array([
        GM_BODY["sun"], GM_BODY["mercury"], GM_BODY["venus"],
        GM_BODY["earth"] + GM_BODY["moon"], GM_BODY["mars"],
        GM_BODY["jupiter"], GM_BODY["saturn"], GM_BODY["uranus"],
        GM_BODY["neptune"],
    ])


def _nbody_rhs_factory(gm):
    n = len(gm)
    gm_sun = gm[0]

    def rhs(t, y):
        r = y[:3 * n].reshape(n, 3)
        d = r[None, :, :] - r[:, None, :]
        dist2 = np.einsum("ijk,ijk->ij", d, d)
        np.fill_diagonal(dist2, 1.0)
        inv3 = dist2**-1.5
        np.fill_diagonal(inv3, 0.0)
        a = np.einsum("ij,ijk->ik", gm[None, :] * inv3, d)
        # 1PN Schwarzschild term of the Sun (EIH, Sun-field only): moves
        # the Earth ~5 km over a decade (perihelion advance), above the
        # fitted-IC noise floor
        v = y[3 * n:].reshape(n, 3)
        rs = r[1:] - r[0]
        vs = v[1:] - v[0]
        r2 = np.einsum("ij,ij->i", rs, rs)
        rnorm = np.sqrt(r2)
        rv = np.einsum("ij,ij->i", rs, vs)
        v2 = np.einsum("ij,ij->i", vs, vs)
        coef = gm_sun / (C_M_S**2 * r2 * rnorm)
        a_gr = coef[:, None] * (
            (4.0 * gm_sun / rnorm - v2)[:, None] * rs
            + 4.0 * rv[:, None] * vs)
        a[1:] += a_gr
        return np.concatenate([y[3 * n:], a.ravel()])

    return rhs


class IntegratedEphemeris(BuiltinEphemeris):
    """Numerically integrated solar system, seeded by the analytic theory.

    The 9-body system (Sun + planets, Earth+Moon as EMB) is integrated
    (DOP853, rtol 1e-12, + the Sun's 1PN Schwarzschild term) over a window
    covering the requested epochs.  The EMB initial conditions are then
    *fit* to the truncated-VSOP87 analytic trajectory over the whole
    window (3-iteration Gauss-Newton with a frozen sensitivity matrix):
    the dynamics regenerates the full perturbation spectrum that any
    truncated analytic series lacks, while the least-squares seed averages
    the series' periodic truncation noise down to its systematic floor.

    On top of the integration, queries inside the CANONICAL window
    (~2000-2018) are served with the baked Earth-position correction
    field (:mod:`pint_tpu.data.ephem_correction`, fit by
    :mod:`pint_tpu.ephemcal` against the DE-ephemeris truth published
    in the reference's golden artifacts) applied to the geocenter —
    default ON, disabled by ``PINT_TPU_NO_EPH_CORR=1``.

    Measured against the reference's tempo2 golden residuals on B1855+09
    (tests/test_tempo2_parity.py): median light-time gap ~8 us with
    zero phase wraps (cross-validated holdout prediction ~11-15 us),
    vs ~190 us for the uncorrected integration, ~320 us/141 wraps for
    the pure analytic series and ~1.3 ms for Keplerian mean elements.
    Windows are cached on disk (``$PINT_TPU_CACHE`` or
    ``~/.cache/pint_tpu``).

    This replaces nothing in the reference (which downloads JPL kernels,
    `solar_system_ephemerides.py`); it is the zero-download path to
    ~10-us-grade real-data timing.
    """

    name = "builtin_integrated"

    #: sampling step of the stored trajectory [days]
    _STEP = 4.0
    #: window quantum + padding [days]
    _QUANTUM = 512.0
    _PAD = 700.0
    #: the CANONICAL window [MJD], quantum-aligned: one fixed span
    #: covering the reference-era pulsar datasets (~2000-2018).  Any
    #: query fitting inside it is served from this single build rather
    #: than its own quantized window, so (a) every dataset in the era
    #: sees the SAME trajectory (no per-window IC-fit scatter), and
    #: (b) the baked Earth-position correction table
    #: (:mod:`pint_tpu.data.ephem_correction`, fit against exactly this
    #: build) applies exactly.  Queries outside fall back to the
    #: quantized-window scheme unchanged.
    _CANONICAL = (51712.0, 58368.0)

    def __init__(self, warn=False):
        super().__init__(warn=False)
        if warn:
            warnings.warn(
                "No JPL .bsp kernel found: using the built-in integrated "
                "ephemeris (N-body fit to the analytic theory; ~km-grade "
                "Earth inside the 2000-2018 calibrated span, ~100 km "
                "outside it).  Supply a DE kernel via $PINT_TPU_EPHEM_DIR "
                "for full accuracy.", stacklevel=2)
        #: (wlo, whi) -> {body: CubicSpline}; every quantized window ever
        #: built in this process
        self._windows = {}

    # -- window management -------------------------------------------------
    @staticmethod
    def _cache_dir():
        d = os.environ.get("PINT_TPU_CACHE")
        if not d:
            d = os.path.join(os.path.expanduser("~"), ".cache", "pint_tpu")
        return d

    #: widest window the anchor extension may create [days] — beyond
    #: this the query epoch is too far from the DE405 table for the
    #: anchored fit to help, and the analytic-anchored build is used
    _ANCHOR_EXTEND_MAX = 20000.0

    @staticmethod
    def _anchor_range():
        """(lo, hi) MJD of the DE405 anchor table, or None when absent
        or not enabled.

        The anchor is OPT-IN (``PINT_TPU_DE_ANCHOR=1``) and now LEGACY:
        fitting the initial conditions to the 2-year DE405 table nails
        the in-window trajectory (measured 1366 km -> 7 km vs the
        table; tests/test_de_anchor.py) but EXTRAPOLATES worse than
        the analytic-anchored fit on multi-year datasets, because a
        2-year anchor cannot constrain the giant-planet mean-element
        errors.  The DEFAULT path supersedes it: the baked correction
        field (:mod:`pint_tpu.data.ephem_correction`, fit from the
        same table PLUS the multi-pulsar golden projections over
        2002-2017) reaches anchor-table grade in-window without the
        extrapolation pathology (B1855 tempo2-gap median ~8 us)."""
        if os.environ.get("PINT_TPU_DE_ANCHOR") != "1":
            return None
        try:
            from pint_tpu_torch.data import de_anchor
        except ImportError:
            return None
        return (float(de_anchor.MJD_TDB[0]), float(de_anchor.MJD_TDB[-1]))

    def _window_key(self, mjd):
        """The quantized window covering this query, a pure function of
        the query epochs ALONE.  Earlier designs extended one global
        window as new epochs arrived; because the EMB initial-condition
        fit runs over the whole window, extension changed the served
        Earth positions for epochs already answered — results then
        depended on query *history* (test-order-dependent parity
        failures).  Deterministic quantization means the same dataset
        always gets the same integration no matter what else the process
        touched; distinct datasets may use overlapping windows (disk
        cache makes rebuilds cheap).

        When the DE405 anchor table is available and the union stays
        under _ANCHOR_EXTEND_MAX days, the window is extended to cover
        the table so the build can fit its initial conditions to real
        JPL-ephemeris positions (still a pure function of the query)."""
        mjd = np.atleast_1d(np.asarray(mjd, np.float64))
        lo, hi = float(np.min(mjd)), float(np.max(mjd))
        ar = self._anchor_range()
        if ar is not None:
            ulo, uhi = min(lo, ar[0] - 50.0), max(hi, ar[1] + 50.0)
            if uhi - ulo <= self._ANCHOR_EXTEND_MAX:
                lo, hi = ulo, uhi
        # canonical preference only on the default path: the legacy
        # opt-in anchored mode (ar set) keeps its smaller quantized
        # windows — anchored builds never serve the correction, and
        # canonicalizing them would force a needless full-era anchored
        # integration
        if ar is None:
            clo, chi = self._CANONICAL
            if clo + self._STEP <= lo and hi <= chi - self._STEP:
                return clo, chi
        q = self._QUANTUM
        wlo = float(np.floor((lo - self._PAD) / q) * q)
        whi = float(np.ceil((hi + self._PAD) / q) * q)
        return wlo, whi

    def _splines_for(self, mjd, key=None):
        if key is not None:
            # pinned path: never serve silent CubicSpline extrapolation —
            # a query outside the pinned window falls back to its own
            # quantized window (still deterministic, still correct)
            m = np.atleast_1d(np.asarray(mjd, np.float64))
            if not (key[0] <= float(np.min(m))
                    and float(np.max(m)) <= key[1]):
                key = None
        if key is None:
            key = self._window_key(mjd)
        sp = self._windows.get(key)
        if sp is None:
            sp = self._windows[key] = self._build(*key)
        else:
            self._windows[key] = self._windows.pop(key)  # LRU touch
        # bounded LRU: a long-lived process touching many datasets must
        # not accumulate spline sets forever (the disk cache makes a
        # rebuild cheap)
        while len(self._windows) > 8:
            self._windows.pop(next(iter(self._windows)))
        return sp

    def pinned_to(self, mjd_span):
        """A view of this ephemeris whose every query is served from the
        single window quantized from ``mjd_span`` — so a multi-observatory
        dataset (whose posvels are computed in per-site groups with
        different time ranges) sees ONE consistent integration throughout.
        The span must cover the later queries (the window pad leaves
        ~700 days of slack)."""
        return _PinnedEphemeris(self, self._window_key(mjd_span))

    def _build(self, wlo, whi):
        ar = self._anchor_range()
        anch = "a" if (ar is not None and wlo <= ar[0]
                       and ar[1] <= whi) else ""
        gc = self._stored_gcorr()
        if gc:
            import hashlib
            h = hashlib.sha1(repr(sorted(gc.items())).encode()) \
                .hexdigest()[:8]
            anch += f"c{h}"
        tag = f"nbody_{int(wlo)}_{int(whi)}_v{_NBODY_VERSION}{anch}.npz"
        path = os.path.join(self._cache_dir(), tag)
        grid = None
        states = None
        if os.path.isfile(path):
            try:
                with np.load(path) as f:
                    grid, states = f["grid"], f["states"]
            except Exception:
                grid = None
        if grid is None:
            grid, states = self._integrate_window(wlo, whi)
            try:
                os.makedirs(self._cache_dir(), exist_ok=True)
                # the tmp name must END in .npz: np.savez appends the
                # suffix otherwise and the atomic rename then targets a
                # file that does not exist (the disk cache silently
                # never persisted — found as hundreds of orphaned
                # *.tmpPID.npz files)
                tmp = path + f".tmp{os.getpid()}.npz"
                try:
                    np.savez_compressed(tmp, grid=grid, states=states)
                    os.replace(tmp, path)
                finally:
                    # a killed/failed write must not orphan its tmp
                    # (a time-limited run can be killed mid-write)
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                # sweep tmp orphans from writers that died before the
                # finally could run (SIGKILL) — anything older than 1 h
                # is dead, its PID notwithstanding
                import glob
                import time
                for stale in glob.glob(
                        os.path.join(self._cache_dir(), "*.tmp*.npz")):
                    try:
                        if time.time() - os.path.getmtime(stale) > 3600:
                            os.unlink(stale)
                    except OSError:
                        pass
            except OSError:
                pass
        # QUINTIC interpolation of the stored 4-day samples: a cubic
        # spline's interpolation error on the annual orbit at h=4 d is
        # (2*pi*h/T)^4/384 * 1 AU ~ 9 km — a 4-day-period wiggle in
        # every served Earth position (~30 us of light time, found as
        # the dominant term of the DE405-anchor fit residual spectrum).
        # k=5 drops it to ~30 m; the integrator's rtol=1e-12 samples
        # are smooth enough that the higher order is free accuracy.
        from scipy.interpolate import make_interp_spline
        sp = {
            nm: make_interp_spline(grid, states[:, 3 * i:3 * i + 3],
                                   k=5)
            for i, nm in enumerate(_NBODY_NAMES)
        }
        if not anch:
            corr = self._correction_spline(wlo, whi)
            if corr is not None:
                sp["_earth_corr"] = corr
        return sp

    @classmethod
    def _correction_spline(cls, wlo, whi):
        """The baked Earth-SSB position-correction spline
        (:mod:`pint_tpu.data.ephem_correction` — fit against the
        CANONICAL unanchored build from the reference's published
        DE-ephemeris truth: the DE405 daily table, the `testtimes`
        3-D golden rows, the J1744-1134 golden Roemer column, and the
        multi-pulsar tempo2 residual-gap curves), or None when absent,
        disabled (``PINT_TPU_NO_EPH_CORR=1``), or not applicable to
        this window.  The table's knots span the full canonical window
        (data-free edges are tapered at bake time), so evaluation
        never extrapolates."""
        if os.environ.get("PINT_TPU_NO_EPH_CORR") == "1":
            return None
        if (wlo, whi) != cls._CANONICAL:
            return None
        try:
            from pint_tpu_torch.data import ephem_correction as ec
        except ImportError:
            return None
        from scipy.interpolate import CubicSpline
        return CubicSpline(np.asarray(ec.KNOT_MJD, np.float64),
                           np.asarray(ec.CORR_M, np.float64))

    # -- the integration itself --------------------------------------------
    def _analytic_emb_helio(self, mjd):
        mjd = np.atleast_1d(np.asarray(mjd, np.float64))
        _, _, (emb_p, _v) = self._earth_moon_helio_si(
            mjd, (mjd - _J2000_MJD) / 36525.0)
        return emb_p

    def _base_ic(self, mjd0, gcorr=None):
        """Initial state from the analytic theory; ``gcorr`` maps a
        planet name to its (dL_rad, da_frac) mean-element correction
        (the giant-planet fit parameters of the anchored build)."""
        t = (mjd0 - _J2000_MJD) / 36525.0
        gcorr = gcorr or {}
        pos = [np.zeros(3)]
        vel = [np.zeros(3)]
        for nm in _NBODY_NAMES[1:]:
            if nm == "emb":
                p = self._analytic_emb_helio([mjd0])
                pp = self._analytic_emb_helio([mjd0 + 0.01])
                pm = self._analytic_emb_helio([mjd0 - 0.01])
                pos.append(p[0])
                vel.append((pp[0] - pm[0]) / (0.02 * DAY_S))
            else:
                dl, dafr = gcorr.get(nm, (0.0, 0.0))
                p, v = _kepler_posvel_au(nm, np.array([t]), dl, dafr)
                pos.append(_ecl_to_icrs(p)[0] * AU_KM * 1e3)
                vel.append(_ecl_to_icrs(v)[0] * AU_KM * 1e3 / DAY_S)
        return np.array(pos), np.array(vel)

    #: giant-planet mean-element corrections the anchored fit solves
    #: for, as (planet, which) with which in {"dL" [rad], "da" [frac]}
    _GIANT_PARAMS = (("jupiter", "dL"), ("jupiter", "da"),
                     ("saturn", "dL"), ("saturn", "da"),
                     ("uranus", "dL"))
    #: finite-difference steps for the frozen sensitivity matrix:
    #: EMB pos [m], EMB vel [m/s], then per _GIANT_PARAMS entry
    _FIT_STEPS = [1e4] * 3 + [1e-3] * 3 + [1e-5, 1e-7, 1e-5, 1e-7, 1e-4]

    def _anchor_emb_bary(self):
        """(mjd_tdb, emb_pos_m) of the DE405 anchor table, converted
        geocenter->EMB with the lunar series (mu*moon_geo ~ 4671 km, so
        the series' ~50-100 km Moon error enters at only ~1 km)."""
        from pint_tpu_torch.data import de_anchor

        mjd = np.asarray(de_anchor.MJD_TDB, np.float64)
        t_cy = (mjd - _J2000_MJD) / 36525.0
        mp_km, _ = _moon_geocentric_km(t_cy)
        M = _ecl_date_to_icrs_matrix(t_cy)
        mp = np.einsum("...ij,...j->...i", M, mp_km) * 1e3
        return mjd, np.asarray(de_anchor.EARTH_POS_M, np.float64) \
            + _MOON_FRAC * mp

    @staticmethod
    def _stored_gcorr():
        """Giant-planet mean-element corrections from the baked-in
        multi-dataset calibration (see :mod:`pint_tpu.ephemcal`), as a
        {planet: (dL_rad, da_frac)} dict; empty when the calibration
        data is absent or disabled (PINT_TPU_NO_EPHEMCAL=1)."""
        if os.environ.get("PINT_TPU_NO_EPHEMCAL") == "1":
            return {}
        try:
            from pint_tpu_torch.data import ephem_calibration
        except ImportError:
            return {}
        return dict(ephem_calibration.GIANT_CORRECTIONS)

    def _integrate_window(self, wlo, whi, gcorr_base=None,
                          free_giants=None):
        """Integrate the window and fit the initial conditions.

        Two regimes:

        * **DE405-anchored** (the default whenever the window covers the
          anchor table): the fit target is the table's 730 daily
          BARYCENTRIC EMB positions — true JPL-ephemeris information.
          Free parameters: the EMB state (6), optionally
          mean-longitude/semi-major corrections for the giant planets
          (``free_giants`` — these move the Sun-vs-SSB term, the
          dominant error of the mean-element theory: measured ~1400 km
          Earth-SSB error unanchored), and a constant frame offset (3,
          absorbing bodies outside the 9-body system — Pluto alone
          shifts the DE SSB by ~40 km).  When the baked-in calibration
          supplies giant corrections (``gcorr_base``, default
          `_stored_gcorr`), the giants are FIXED there — the
          calibration fit them against multi-year sky-projected truth,
          which a 2-year anchor cannot constrain in extrapolation.
        * **analytic-anchored** (table absent/disabled/too far): the
          fit target is the truncated-VSOP87 heliocentric EMB over the
          whole window, EMB state only — the zero-data fallback.
        """
        from scipy.integrate import solve_ivp

        gm = _nbody_gm()
        rhs = _nbody_rhs_factory(gm)
        mjd0 = 0.5 * (wlo + whi)
        grid = np.arange(wlo, whi + self._STEP / 2, self._STEP)
        ts = grid - mjd0

        anchor = None
        ar = self._anchor_range()
        if ar is not None and wlo <= ar[0] and ar[1] <= whi:
            anchor = self._anchor_emb_bary()

        base = self._stored_gcorr() if gcorr_base is None else gcorr_base
        if free_giants is None:
            # The giants float ONLY in (opt-in) anchored builds: their
            # Sun-vs-SSB error is quasi-static-but-rotating, which the
            # 6 EMB dofs + offset cannot represent (measured in-window
            # floor 218 km without them, 7 km with).  Anchored mode is
            # an IN-WINDOW tool — a 2-year anchor cannot determine the
            # giants' slow terms, so the fitted values must not be
            # trusted in extrapolation (see _anchor_range).
            free_giants = self._GIANT_PARAMS if anchor is not None \
                else ()
        if anchor is None:
            free_giants = ()
        ngiant = len(free_giants)
        npar = 6 + ngiant
        _giant_steps = dict(zip(self._GIANT_PARAMS,
                                self._FIT_STEPS[6:]))
        steps = list(self._FIT_STEPS[:6]) + \
            [_giant_steps[g] for g in free_giants]

        def run(theta):
            gcorr = {nm: tuple(v) for nm, v in base.items()}
            for (nm, which), v in zip(free_giants, theta[6:]):
                dl, dafr = gcorr.get(nm, (0.0, 0.0))
                gcorr[nm] = (dl + v, dafr) if which == "dL" else \
                    (dl, dafr + v)
            pos, vel = self._base_ic(mjd0, gcorr)
            pos, vel = pos.copy(), vel.copy()
            pos[3] += theta[:3]
            vel[3] += theta[3:6]
            mtot = gm.sum()
            pos -= (gm[:, None] * pos).sum(0) / mtot
            vel -= (gm[:, None] * vel).sum(0) / mtot
            y0 = np.concatenate([pos.ravel(), vel.ravel()])
            kw = dict(rtol=1e-12, atol=1e-2, method="DOP853")
            fw = solve_ivp(rhs, (0, ts[-1] * DAY_S), y0,
                           t_eval=ts[ts >= 0] * DAY_S, **kw)
            bw = solve_ivp(rhs, (0, ts[0] * DAY_S), y0,
                           t_eval=ts[ts < 0][::-1] * DAY_S, **kw)
            return np.concatenate([bw.y[:, ::-1], fw.y], axis=1).T

        if anchor is not None:
            from scipy.interpolate import CubicSpline

            amjd, aemb = anchor

            def predict(Y):
                # barycentric EMB of the integration at anchor epochs
                return CubicSpline(grid, Y[:, 9:12])(amjd)

            # Hybrid fit target:
            # * the anchor rows (sigma ~10 m), with the constant frame
            #   offset profiled out EXACTLY (per-axis demean) — offset
            #   and IC columns are near-degenerate for quasi-static
            #   residuals, and an unscaled min-norm lstsq would split a
            #   static shift across orbital dofs, matching it in-window
            #   while swinging ~20x harder outside (measured: 74 km
            #   static perturbation -> 1400 km 1.5 yr past the anchor);
            # * the truncated-VSOP87 heliocentric EMB over the WHOLE
            #   window at its own ~40 km truncation grade — a weak
            #   tether that bounds extrapolation drift far from the
            #   anchor (a 2-year perfect anchor alone EXTRAPOLATES
            #   worse than fitting mediocre data everywhere: measured
            #   190 -> 768 us median on the B1855 holdout).
            # Anchor-dominant weights: anchored mode is OPT-IN for
            # in-window DE-grade accuracy (see _anchor_range), so the
            # anchor rows must win outright wherever they constrain;
            # the VSOP tether only keeps the far field from running
            # away (the two targets disagree systematically by
            # ~1400 km — one trajectory cannot satisfy both, and
            # balanced weights were measured to give the worst of both:
            # 727 us in-window AND 272 us on the B1855 holdout).
            ana = self._analytic_emb_helio(grid)
            wa, wv = 1.0 / 10.0, 1.0 / 40e3     # [1/m]

            def resid_vec(Y):
                ra = predict(Y) - aemb
                ra = ra - ra.mean(axis=0)
                rv = (Y[:, 9:12] - Y[:, 0:3]) - ana
                return np.concatenate([wa * ra.ravel(),
                                       wv * rv.ravel()])

            theta = np.zeros(npar)
            J = None
            for _ in range(3):
                Y = run(theta)
                r0 = resid_vec(Y)
                if J is None:  # frozen sensitivity (near-linear)
                    cols = []
                    for k in range(npar):
                        th2 = theta.copy()
                        th2[k] += steps[k]
                        cols.append((resid_vec(run(th2)) - r0)
                                    / steps[k])
                    J = np.column_stack(cols)
                upd, *_ = np.linalg.lstsq(J, -r0, rcond=None)
                theta = theta + upd
            Y = run(theta)
            # the frame offset is whatever constant remains vs DE405
            off = -(predict(Y) - aemb).mean(axis=0)
            nstate = 3 * len(_NBODY_NAMES)
            states = Y[:, :nstate].copy()
            # translate every body into the DE405 SSB frame
            states += np.tile(off, len(_NBODY_NAMES))
            return grid, states

        ana = self._analytic_emb_helio(grid)
        dic = np.zeros(6)
        J = None
        for _ in range(3):
            Y = run(np.concatenate([dic, np.zeros(ngiant)]))
            emb = Y[:, 9:12] - Y[:, 0:3]
            res = (emb - ana).ravel()
            if J is None:  # frozen sensitivity (the problem is near-linear)
                J = np.zeros((res.size, 6))
                steps = self._FIT_STEPS[:6]
                for k in range(6):
                    d2 = dic.copy()
                    d2[k] += steps[k]
                    Yk = run(np.concatenate([d2, np.zeros(ngiant)]))
                    J[:, k] = ((Yk[:, 9:12] - Yk[:, 0:3]) - emb).ravel() \
                        / steps[k]
            upd, *_ = np.linalg.lstsq(J, -res, rcond=None)
            dic = dic + upd
        Y = run(np.concatenate([dic, np.zeros(ngiant)]))
        nstate = 3 * len(_NBODY_NAMES)
        return grid, Y[:, :nstate]

    # -- posvel ------------------------------------------------------------
    def posvel(self, body: str, mjd_tdb, _window_key=None) -> PosVel:
        body = body.lower()
        mjd = np.asarray(mjd_tdb, np.float64)
        if body == "ssb":
            z = np.zeros(np.shape(mjd) + (3,))
            return PosVel(z, z.copy())
        splines = self._splines_for(mjd, key=_window_key)
        t_cy = (mjd - _J2000_MJD) / 36525.0
        if body in ("earth", "moon", "emb"):
            emb_p = splines["emb"](mjd)
            emb_v = splines["emb"](mjd, 1) / DAY_S
            if body == "emb":
                return PosVel(emb_p, emb_v)
            mp_km, mv_kmd = _moon_geocentric_km(t_cy)
            M = _ecl_date_to_icrs_matrix(t_cy)
            mp = np.einsum("...ij,...j->...i", M, mp_km) * 1e3
            mv = np.einsum("...ij,...j->...i", M, mv_kmd) * 1e3 / DAY_S
            if body == "earth":
                p_e = emb_p - _MOON_FRAC * mp
                v_e = emb_v - _MOON_FRAC * mv
                # baked truth correction applies to the GEOCENTER (it
                # was fit against geocenter truth — Roemer projections
                # and the DE405 daily table — so no lunar-series error
                # enters); 'emb'/'moon' stay on the raw integration
                corr = splines.get("_earth_corr")
                if corr is not None:
                    p_e = p_e + corr(mjd)
                    v_e = v_e + corr(mjd, 1) / DAY_S
                return PosVel(p_e, v_e)
            return PosVel(emb_p + (1.0 - _MOON_FRAC) * mp,
                          emb_v + (1.0 - _MOON_FRAC) * mv)
        key = body[:-5] if body.endswith("_bary") else body
        if key in splines:
            return PosVel(splines[key](mjd),
                          splines[key](mjd, 1) / DAY_S)
        return super().posvel(body, mjd_tdb)


# --- SPK writer ---------------------------------------------------------------

#: (body, center) pairs written by write_spk, with their NAIF codes and
#: Chebyshev record length [days] (the real DE kernels use the same
#: chain topology: SSB->EMB->{Earth,Moon}, SSB->Sun, SSB->planet
#: barys).  Records are 4 days for EVERY body, aligned to 4-day MJD
#: boundaries: the integrated ephemeris serves cubic splines with
#: 4-day knots (IntegratedEphemeris._STEP) on a 4-day-aligned grid, so
#: knot-aligned records see an exactly-cubic source and the Chebyshev
#: fit is exact — longer records straddle knots, where the source is
#: only C^2 and high-order convergence collapses (measured: 74 km
#: Mercury error with 8-day records vs sub-mm aligned).
_WRITE_PAIRS = (
    (("emb", "ssb"), (3, 0), 4.0),
    (("earth", "emb"), (399, 3), 4.0),
    (("moon", "emb"), (301, 3), 4.0),
    (("sun", "ssb"), (10, 0), 4.0),
    (("mercury", "ssb"), (1, 0), 4.0),
    (("venus", "ssb"), (2, 0), 4.0),
    (("mars", "ssb"), (4, 0), 4.0),
    (("jupiter", "ssb"), (5, 0), 4.0),
    (("saturn", "ssb"), (6, 0), 4.0),
    (("uranus", "ssb"), (7, 0), 4.0),
    (("neptune", "ssb"), (8, 0), 4.0),
)


def write_spk(path: str, eph, mjd_lo: float, mjd_hi: float,
              ncoef: int = 13) -> str:
    """Write a JPL-format SPK (``.bsp``) kernel from any ephemeris
    object with a ``posvel(body, mjd_tdb)`` method — the inverse of
    :class:`SPKEphemeris` (DAF + type-2 Chebyshev position segments,
    little-endian).

    This is how the builtin integrated ephemeris's "drop in a .bsp for
    full precision" claim becomes testable without network access: a
    kernel written from the integrator and read back through the SPK
    path must reproduce the direct path exactly
    (tests/test_spk_writer.py), so when a REAL ``de421.bsp`` is placed
    in ``$PINT_TPU_EPHEM_DIR`` the same plumbing serves full JPL
    precision.  Reference counterpart: the kernel files consumed via
    jplephem in `solar_system_ephemerides.py:18-45`.
    """
    import struct

    from numpy.polynomial import chebyshev as _cheb

    # 4-day-aligned start (see _WRITE_PAIRS: knot alignment)
    et_lo = mjd_tdb_to_et(4.0 * np.floor(mjd_lo / 4.0))
    et_hi = mjd_tdb_to_et(mjd_hi)

    segments = []  # (target, center, init, intlen, records)
    for (body, center), (tcode, ccode), days in _WRITE_PAIRS:
        intlen = days * DAY_S
        n = int(np.ceil((et_hi - et_lo) / intlen))
        init = et_lo
        # Chebyshev-Gauss nodes per record; one batched posvel call
        k = np.arange(ncoef)
        nodes = np.cos(np.pi * (k + 0.5) / ncoef)[::-1]  # (-1, 1)
        mids = init + (np.arange(n) + 0.5) * intlen
        radius = intlen / 2.0
        et = (mids[:, None] + nodes[None, :] * radius).ravel()
        mjd = et / DAY_S + _J2000_MJD
        p = eph.posvel(body, mjd).pos
        if center != "ssb":
            p = p - eph.posvel(center, mjd).pos
        p_km = (p / 1e3).reshape(n, ncoef, 3)
        recs = np.empty((n, 2 + 3 * ncoef))
        recs[:, 0] = mids
        recs[:, 1] = radius
        for i in range(n):
            # interpolation through the Gauss nodes (exact fit)
            c = _cheb.chebfit(nodes, p_km[i], ncoef - 1)  # (ncoef, 3)
            recs[i, 2:] = c.T.ravel()
        segments.append((tcode, ccode, init, intlen, recs))

    # --- DAF assembly (record = 1024 bytes = 128 f64 words) ------------
    nd, ni = 2, 6
    data_word = 3 * 128 + 1          # 1-based word address of record 4
    seg_meta = []
    blobs = []
    w = data_word
    for tcode, ccode, init, intlen, recs in segments:
        n, rsize = recs.shape
        words = np.concatenate(
            [recs.ravel(), [init, intlen, float(rsize), float(n)]])
        seg_meta.append((tcode, ccode, w, w + words.size - 1,
                         init, init + n * intlen))
        blobs.append(words)
        w += words.size
    free = w

    fr = bytearray(1024)
    fr[0:8] = b"DAF/SPK "
    struct.pack_into("<ii", fr, 8, nd, ni)
    fr[16:76] = b"pint_tpu write_spk".ljust(60)
    struct.pack_into("<iii", fr, 76, 2, 2, free)
    fr[88:96] = b"LTL-IEEE"

    sr = bytearray(1024)
    struct.pack_into("<ddd", sr, 0, 0.0, 0.0, float(len(seg_meta)))
    ss = nd + (ni + 1) // 2          # summary size [words]
    for k, (tc, cc, beg, end, e0, e1) in enumerate(seg_meta):
        off = (3 + k * ss) * 8
        struct.pack_into("<dd", sr, off, e0, e1)
        struct.pack_into("<iiiiii", sr, off + 16, tc, cc, 1, 2, beg, end)
    nr = bytearray(1024)

    with open(path, "wb") as f:
        f.write(bytes(fr) + bytes(sr) + bytes(nr))
        for words in blobs:
            f.write(np.asarray(words, "<f8").tobytes())
    return path


# --- loader -------------------------------------------------------------------

_EPHEM_CACHE: Dict[str, object] = {}


def _search_dirs():
    dirs = []
    env = os.environ.get("PINT_TPU_EPHEM_DIR")
    if env:
        dirs.append(env)
    dirs += [os.getcwd(), os.path.join(os.path.dirname(__file__), "data", "ephem")]
    return dirs


def load_ephemeris(name: Optional[str] = "DE421"):
    """Resolve an ephemeris by name ('DE421'), path, or fallback to builtin.

    Mirrors the reference's resolution order (`solar_system_ephemerides.py`)
    minus the network download (zero-egress environment).
    """
    key = (name or "builtin").lower()
    # the mode override is part of the cache identity: changing
    # PINT_TPU_EPHEM_MODE between calls must not serve stale instances
    mode = os.environ.get("PINT_TPU_EPHEM_MODE", "").lower()
    cache_key = (key, mode)
    if cache_key in _EPHEM_CACHE:
        return _EPHEM_CACHE[cache_key]
    eph = None
    analytic_names = ("builtin", "builtin_analytic")
    builtin_names = analytic_names + ("builtin_integrated",)
    if key == "builtin_integrated":
        eph = _shared_integrated()
    elif key not in analytic_names:
        if os.path.isfile(key) or os.path.isfile(str(name)):
            eph = SPKEphemeris(str(name) if os.path.isfile(str(name)) else key)
        else:
            fname = key if key.endswith(".bsp") else key + ".bsp"
            for d in _search_dirs():
                p = os.path.join(d, fname)
                if os.path.isfile(p):
                    eph = SPKEphemeris(p)
                    break
    if eph is None:
        # fallback resolution: a missing *named kernel* always warns; the
        # substitute is the integrated ephemeris (best offline accuracy)
        # unless PINT_TPU_EPHEM_MODE=analytic.  Explicit "builtin" stays
        # the cheap analytic series unless the mode forces integrated.
        if key not in builtin_names:
            warnings.warn(
                f"ephemeris kernel {name!r} not found on disk; falling "
                "back to the builtin "
                + ("analytic" if mode == "analytic" else "integrated")
                + " ephemeris (~100-300 km Earth; sub-ms light time). "
                "Supply the .bsp via $PINT_TPU_EPHEM_DIR for full "
                "accuracy.", stacklevel=2)
        if mode == "analytic":
            eph = BuiltinEphemeris(warn=False)
        elif key in analytic_names and mode != "integrated":
            eph = BuiltinEphemeris(warn=False)
        else:
            eph = _shared_integrated()
    _EPHEM_CACHE[cache_key] = eph
    return eph


class _PinnedEphemeris:
    """Window-pinned view of an :class:`IntegratedEphemeris` (see
    `IntegratedEphemeris.pinned_to`)."""

    def __init__(self, eph: "IntegratedEphemeris", key):
        self._eph = eph
        self._key = key
        self.name = eph.name

    def posvel(self, body: str, mjd_tdb) -> PosVel:
        return self._eph.posvel(body, mjd_tdb, _window_key=self._key)


_INTEGRATED_SINGLETON: Optional["IntegratedEphemeris"] = None


def _shared_integrated() -> "IntegratedEphemeris":
    """One IntegratedEphemeris instance for every kernel-name fallback, so
    each quantized window is integrated once per process and shared (the
    instance keeps a dict of windows; results are a pure function of each
    query's own span — see `IntegratedEphemeris._window_key`)."""
    global _INTEGRATED_SINGLETON
    if _INTEGRATED_SINGLETON is None:
        _INTEGRATED_SINGLETON = IntegratedEphemeris(warn=False)
    return _INTEGRATED_SINGLETON


def objPosVel_wrt_SSB(objname: str, mjd_tdb, ephem="DE421") -> PosVel:
    """Drop-in analogue of the reference's `objPosVel_wrt_SSB`
    (`src/pint/solar_system_ephemerides.py`): SI units, ICRS, SSB-centered."""
    eph = ephem if hasattr(ephem, "posvel") else load_ephemeris(ephem)
    return eph.posvel(objname, mjd_tdb)
