"""Tropospheric propagation delay of topocentric TOAs.

Port of :mod:`pint_tpu.models.troposphere` (reference `TroposphereDelay`,
`src/pint/models/troposphere_delay.py:20`):

* the Davis et al. (1985, App. A) hydrostatic zenith delay from the US
  Standard Atmosphere pressure at the site altitude;
* the Niell (1996, eq. 4) hydrostatic mapping function, the continued
  fraction with latitude- and season-dependent coefficients plus a height
  correction, scaling the zenith delay to the source altitude;
* a wet zenith delay of 0, as the reference (and tempo2).

The source altitude depends on the time, the site and the host
astrometry values alone, so the per-TOA delay is built on the host in
``mask_entries`` (numpy) and rides in the params dict; on CUDA the
``delay_chain`` kernel reads it as one float64 row input.  The Niell
coefficient tables are published geophysical data.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from pint_tpu_torch import c as C_LIGHT
from pint_tpu_torch.models.parameter import BoolParam
from pint_tpu_torch.models.timing_model import DelayComponent, zeros_rows
from pint_tpu_torch.toabatch import TOABatch

#: the per-TOA delay [s] in the params dict's masks (the delay kernel's
#: row input, kernels/delay_chain.py TROPO_DELAY)
TROPO_DELAY = "__tropo_delay__"

#: Niell (1996) hydrostatic coefficients on the latitude grid (padded at
#: the poles)
_LAT = np.array([0.0, 15.0, 30.0, 45.0, 60.0, 75.0, 90.0])
_A_AVG = np.array([1.2769934, 1.2769934, 1.2683230, 1.2465397, 1.2196049,
                   1.2045996, 1.2045996]) * 1e-3
_B_AVG = np.array([2.9153695, 2.9153695, 2.9152299, 2.9288445, 2.9022565,
                   2.9024912, 2.9024912]) * 1e-3
_C_AVG = np.array([62.610505, 62.610505, 62.837393, 63.721774, 63.824265,
                   64.258455, 64.258455]) * 1e-3
_A_AMP = np.array([0.0, 0.0, 1.2709626, 2.6523662, 3.4000452, 4.1202191,
                   4.1202191]) * 1e-5
_B_AMP = np.array([0.0, 0.0, 2.1414979, 3.0160779, 7.2562722, 11.723375,
                   11.723375]) * 1e-5
_C_AMP = np.array([0.0, 0.0, 9.0128400, 4.3497037, 84.795348, 170.37206,
                   170.37206]) * 1e-5
_A_HT, _B_HT, _C_HT = 2.53e-5, 5.49e-3, 1.14e-3
#: Niell wet coefficients (no seasonal term)
_AW = np.array([5.8021897, 5.8021897, 5.6794847, 5.8118019, 5.9727542,
                6.1641693, 6.1641693]) * 1e-4
_BW = np.array([1.4275268, 1.4275268, 1.5138625, 1.4572752, 1.5007428,
                1.7599082, 1.7599082]) * 1e-3
_CW = np.array([4.3472961, 4.3472961, 4.6729510, 4.3908931, 4.4626982,
                5.4736038, 5.4736038]) * 1e-2

_DOY_OFFSET = -28.0     # phase of the seasonal term (reference ibid:96)
_EARTH_R = 6356766.0    # m, US Standard Atmosphere reference radius


def itrf_to_geodetic(xyz_m: np.ndarray):
    """(lat_rad, lon_rad, height_m) from ITRF cartesian coordinates
    (WGS84; the iterative inverse of
    :func:`pint_tpu_torch.earth.geodetic_to_itrf`)."""
    a = 6378137.0
    f = 1.0 / 298.257223563
    e2 = f * (2 - f)
    x, y, z = xyz_m
    lon = math.atan2(y, x)
    p = math.hypot(x, y)
    lat = math.atan2(z, p * (1 - e2))
    for _ in range(5):
        N = a / math.sqrt(1 - e2 * math.sin(lat) ** 2)
        h = p / math.cos(lat) - N
        lat = math.atan2(z, p * (1 - e2 * N / (N + h)))
    N = a / math.sqrt(1 - e2 * math.sin(lat) ** 2)
    h = p / math.cos(lat) - N
    return lat, lon, h


def _herring(sin_alt, a, b, c):
    """Niell eq. 4's continued fraction, normalized to 1 at the zenith."""
    top = 1.0 + a / (1.0 + b / (1.0 + c))
    bot = sin_alt + a / (sin_alt + b / (sin_alt + c))
    return top / bot


def _interp_lat(table: np.ndarray, abs_lat_deg) -> np.ndarray:
    return np.interp(abs_lat_deg, _LAT, table)


def zenith_delay_sec(lat_rad: float, height_m: float) -> float:
    """The Davis hydrostatic zenith delay [s] from the standard-atmosphere
    pressure at the site (reference ibid:255-268)."""
    H = height_m
    gph = _EARTH_R * H / (_EARTH_R + H)
    T = 288.15 - 0.0065 * gph
    p_kpa = 101.325 * (288.15 / T) ** -5.25575
    return (p_kpa / 43.921) / (
        C_LIGHT * (1 - 0.00266 * math.cos(2 * lat_rad)
                   - 0.00028 * (H / 1000.0)))


def niell_hydrostatic_map(alt_rad, lat_deg, height_m, year_frac):
    """The Niell hydrostatic mapping function with its seasonal and
    height terms."""
    abs_lat = np.abs(np.asarray(lat_deg, np.float64))
    season = np.cos(2.0 * np.pi * year_frac) * np.where(
        np.asarray(lat_deg) < 0, -1.0, 1.0)   # hemispheres in antiphase
    a = _interp_lat(_A_AVG, abs_lat) + _interp_lat(_A_AMP, abs_lat) * season
    b = _interp_lat(_B_AVG, abs_lat) + _interp_lat(_B_AMP, abs_lat) * season
    c = _interp_lat(_C_AVG, abs_lat) + _interp_lat(_C_AMP, abs_lat) * season
    s = np.sin(np.asarray(alt_rad, np.float64))
    s = np.clip(s, 0.05, None)          # guard below-horizon pathologies
    m = _herring(s, a, b, c)
    # the height correction (Niell eq. 6)
    dm = (1.0 / s - _herring(s, _A_HT, _B_HT, _C_HT)) * (height_m / 1000.0)
    return m + dm


def niell_wet_map(alt_rad, lat_deg):
    """The Niell wet mapping function."""
    abs_lat = np.abs(np.asarray(lat_deg, np.float64))
    s = np.clip(np.sin(np.asarray(alt_rad, np.float64)), 0.05, None)
    return _herring(s, _interp_lat(_AW, abs_lat),
                    _interp_lat(_BW, abs_lat), _interp_lat(_CW, abs_lat))


class TroposphereDelay(DelayComponent):
    """The hydrostatic tropospheric delay (CORRECT_TROPOSPHERE)."""

    register = True
    category = "troposphere"

    def __init__(self):
        super().__init__()
        self.add_param(BoolParam(
            "CORRECT_TROPOSPHERE", value=True,
            description="Enable the troposphere delay model"))

    def mask_entries(self, toas) -> Dict[str, np.ndarray]:
        """The per-TOA tropospheric delay [s], on the host (the source
        altitude's geometry does not depend on the fit, as in the
        reference's TOA-table cache)."""
        from pint_tpu_torch import mjd as mjdmod
        from pint_tpu_torch.earth import itrf_to_gcrs_matrix
        from pint_tpu_torch.models.astrometry import host_psr_dir
        from pint_tpu_torch.observatory import get_observatory

        out = super().mask_entries(toas)
        delay = np.zeros(toas.ntoas)
        if not self.CORRECT_TROPOSPHERE.value:
            out[TROPO_DELAY] = delay
            return out
        src = host_psr_dir(self._parent)
        tt = mjdmod.utc_to_tt(toas.utc).mjd_float
        ut1 = toas.utc.mjd_float            # UT1 ~ UTC well within 1 s
        # the day-of-year fraction anchored at J2000 with Niell's -28 d
        # phase (reference `_get_year_fraction_fast`, ibid:384)
        year_frac = ((tt - 51544.5 + _DOY_OFFSET) % 365.25) / 365.25
        for obsname in toas.observatories:
            itrf = getattr(get_observatory(obsname), "itrf_xyz", None)
            if itrf is None:
                continue                # barycentre, geocentre: no air
            sel = np.flatnonzero(toas.obs == obsname)
            lat, lon, h = itrf_to_geodetic(np.asarray(itrf, np.float64))
            up_itrf = np.array([math.cos(lat) * math.cos(lon),
                                math.cos(lat) * math.sin(lon),
                                math.sin(lat)])
            R = itrf_to_gcrs_matrix(tt[sel], ut1[sel])
            up_gcrs = np.einsum("nij,j->ni", R, up_itrf)
            alt = np.arcsin(np.clip(up_gcrs @ src, -1.0, 1.0))
            delay[sel] = zenith_delay_sec(lat, h) * niell_hydrostatic_map(
                alt, math.degrees(lat), h, year_frac[sel])
        out[TROPO_DELAY] = delay
        return out

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        if not self.CORRECT_TROPOSPHERE.value:
            return zeros_rows(batch)
        d = p["mask"].get(TROPO_DELAY)
        if d is None:                   # a batch built without masks
            return zeros_rows(batch)
        return d
