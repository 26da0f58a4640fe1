"""Two-float MJD times and time-scale conversions (UTC/TAI/TT/TDB).

Replaces the reference's astropy-Time + ``np.longdouble`` time handling
(`src/pint/pulsar_mjd.py`): a time is an ``MJD`` pytree of
``(day: int64, frac: float64 in [0,1))``.  The fraction resolution is
86400 s × 2⁻⁵² ≈ 19 ps, far below the ~ns timing requirement, and epoch
*differences* are returned as exact double-double seconds, so no precision is
lost forming ``t - PEPOCH`` over decades-long baselines.

Scale conventions follow tempo/tempo2 ("pulsar_mjd", reference
`src/pint/pulsar_mjd.py:36-114`): a UTC day is always 86400 fractional-day
units long; on a day with a leap second the extra second is absorbed at the
UTC→TAI step via the leap-second table, never smeared into the day length.

This module is deliberately **pure numpy**: time-scale conversion is
host-side loader work (reference: `TOAs.compute_TDBs`, `src/pint/toa.py:2262`),
and on this image every jax op lands on the TPU backend whose emulated f64 is
not IEEE-correct — host precompute must stay on true-IEEE CPU floats.
Device-side code only ever sees exact (day, frac) pairs or DD/QS seconds
produced here.

The TT→TDB conversion is the Fairhead & Bretagnon (1990) analytic series in
:mod:`pint_tpu.tdbseries`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from pint_tpu_torch import dd as ddm
from pint_tpu_torch.dd import DD

SECS_PER_DAY = 86400.0
TT_MINUS_TAI = 32.184  # s, exact by definition
MJD_J2000 = 51544.5  # TT


class MJD(NamedTuple):
    """A (vector of) time(s) as integer MJD day + float64 day fraction.

    The time *scale* is contextual (functions below are explicit about what
    scale they expect); the pytree carries no metadata so it can flow through
    jit/vmap.
    """

    day: np.ndarray  # integer-valued (int64)
    frac: np.ndarray  # float64 in [0, 1)

    @property
    def mjd_float(self):
        """Lossy float64 view (for plotting / rough work only)."""
        return self.day + self.frac

    def to_dd_day(self) -> DD:
        """MJD as a double-double number of days (exact)."""
        return ddm.add_f(ddm.from_float(np.asarray(self.frac, np.float64)),
                         np.asarray(self.day, np.float64))


def normalize(day, frac) -> MJD:
    """Carry the fraction into [0,1) adjusting the day."""
    day = np.asarray(day)
    frac = np.asarray(frac, np.float64)
    carry = np.floor(frac)
    return MJD((day + carry.astype(day.dtype)), frac - carry)


def from_mjd_float(x) -> MJD:
    """Build from a plain float64 MJD (≈19 ps resolution near MJD 5e4)."""
    x = np.asarray(x, np.float64)
    d = np.floor(x)
    return MJD(d.astype(np.int64), x - d)


def from_day_frac(day, frac) -> MJD:
    return normalize(np.asarray(day, np.int64), frac)


def from_string(s: str) -> MJD:
    """Host-side exact parse of a decimal MJD string (tim-file precision)."""
    s = s.strip()
    neg = s.startswith("-")
    body = s.lstrip("+-")
    if "." in body:
        ip, fp = body.split(".")
    else:
        ip, fp = body, ""
    day = int(ip) if ip else 0
    # the decimal module gives a correctly-rounded fraction
    from decimal import Decimal

    frac = float(Decimal("0." + fp)) if fp else 0.0
    if neg:
        day, frac = (-day, 0.0) if frac == 0.0 else (-day - 1, 1.0 - frac)
    if frac >= 1.0:  # rounding of 0.999... can land exactly on 1.0
        day, frac = day + 1, 0.0
    return MJD(np.int64(day), np.float64(frac))


def add_sec(t: MJD, sec) -> MJD:
    """t + seconds (f64).  Rounding ≤ ~19 ps per call."""
    return normalize(t.day, t.frac + np.asarray(sec, np.float64) / SECS_PER_DAY)


def diff_sec(a: MJD, b: MJD) -> DD:
    """(a - b) in seconds, exact to double-double precision."""
    ddays = (np.asarray(a.day, np.int64) - np.asarray(b.day, np.int64)).astype(
        np.float64
    )
    dfrac = ddm.sum_ff(a.frac, -np.asarray(b.frac, np.float64))
    # ddays * 86400 is exact in f64 for |ddays| < 1e11; dfrac*86400 via DD mul
    out = ddm.add(ddm.prod_ff(ddays, SECS_PER_DAY), ddm.mul_f(dfrac, SECS_PER_DAY))
    return out


def diff_day_dd(a: MJD, b: MJD) -> DD:
    """(a - b) in days, exact."""
    ddays = (np.asarray(a.day, np.int64) - np.asarray(b.day, np.int64)).astype(
        np.float64
    )
    dfrac = ddm.sum_ff(a.frac, -np.asarray(b.frac, np.float64))
    return ddm.add_f(dfrac, ddays)


# --- leap seconds -------------------------------------------------------------
# (MJD of UTC day on which TAI-UTC changed, TAI-UTC in seconds from that day).
# Public IERS facts; the modern (post-1972) integer-leap-second era. The table
# is closed: no leap second has been scheduled since 2017-01-01, and none is
# before the framework's data horizon. Pre-1972 "rubber seconds" are not
# supported (the reference's pulsar timing data never predates 1972).
_LEAP_TABLE = np.array(
    [
        (41317, 10.0),  # 1972-01-01
        (41499, 11.0),  # 1972-07-01
        (41683, 12.0),  # 1973-01-01
        (42048, 13.0),  # 1974-01-01
        (42413, 14.0),  # 1975-01-01
        (42778, 15.0),  # 1976-01-01
        (43144, 16.0),  # 1977-01-01
        (43509, 17.0),  # 1978-01-01
        (43874, 18.0),  # 1979-01-01
        (44239, 19.0),  # 1980-01-01
        (44786, 20.0),  # 1981-07-01
        (45151, 21.0),  # 1982-07-01
        (45516, 22.0),  # 1983-07-01
        (46247, 23.0),  # 1985-07-01
        (47161, 24.0),  # 1988-01-01
        (47892, 25.0),  # 1990-01-01
        (48257, 26.0),  # 1991-01-01
        (48804, 27.0),  # 1992-07-01
        (49169, 28.0),  # 1993-07-01
        (49534, 29.0),  # 1994-07-01
        (50083, 30.0),  # 1996-01-01
        (50630, 31.0),  # 1997-07-01
        (51179, 32.0),  # 1999-01-01
        (53736, 33.0),  # 2006-01-01
        (54832, 34.0),  # 2009-01-01
        (56109, 35.0),  # 2012-07-01
        (57204, 36.0),  # 2015-07-01
        (57754, 37.0),  # 2017-01-01
    ],
    dtype=np.float64,
)

_LEAP_MJD = np.asarray(_LEAP_TABLE[:, 0])
_LEAP_OFF = np.asarray(_LEAP_TABLE[:, 1])


def tai_minus_utc(utc_day) -> np.ndarray:
    """TAI-UTC [s] for the given UTC MJD day number(s)."""
    idx = np.searchsorted(_LEAP_MJD, np.asarray(utc_day, np.float64), side="right")
    idx = np.clip(idx - 1, 0, _LEAP_OFF.shape[0] - 1)
    return _LEAP_OFF[idx]


def utc_to_tai(t: MJD) -> MJD:
    return add_sec(t, tai_minus_utc(t.day))


def tai_to_utc(t: MJD) -> MJD:
    # offset is a step function of the *UTC* day; one fixed-point pass is exact
    # except within a second of a boundary, where a second pass settles it.
    guess = add_sec(t, -tai_minus_utc(t.day))
    return add_sec(t, -tai_minus_utc(guess.day))


def tai_to_tt(t: MJD) -> MJD:
    return add_sec(t, TT_MINUS_TAI)


def tt_to_tai(t: MJD) -> MJD:
    return add_sec(t, -TT_MINUS_TAI)


def utc_to_tt(t: MJD) -> MJD:
    return tai_to_tt(utc_to_tai(t))


def tt_to_tdb(t: MJD) -> MJD:
    """Geocentric TT→TDB via the FB90 series (see pint_tpu.tdbseries)."""
    from pint_tpu_torch import tdbseries

    return add_sec(t, tdbseries.tdb_minus_tt(_tt_julian_millennia(t)))


def tdb_to_tt(t: MJD) -> MJD:
    from pint_tpu_torch import tdbseries

    # series argument in TDB instead of TT differs at the 1e-12 s level
    return add_sec(t, -tdbseries.tdb_minus_tt(_tt_julian_millennia(t)))


def _tt_julian_millennia(t: MJD):
    """Julian millennia since J2000.0 for series arguments (f64 is plenty)."""
    return ((np.asarray(t.day, np.float64) - 51544.0) + (t.frac - 0.5)) / 365250.0


def utc_to_tdb(t: MJD) -> MJD:
    return tt_to_tdb(utc_to_tt(t))
