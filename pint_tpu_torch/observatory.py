"""Observatory registry: ground sites, special locations, satellite hooks.

Equivalent of the reference's `src/pint/observatory/` package
(`__init__.py:135` Observatory/get_observatory, `topo_obs.py:65` TopoObs,
`special_locations.py:71,117` barycenter/geocenter).  Site facts (ITRF
coordinates, codes, aliases) live in `pint_tpu/data/observatories_data.py`.

An Observatory provides:

* ``clock_corrections(mjd_utc)`` — site clock chain -> UTC [s]
* ``posvel_gcrs(tt_mjd, ut1_mjd)`` — geocentric ICRS position/velocity
* identity (name, aliases, tempo/itoa codes)

Time-scale work (UTC->TT->TDB) and SSB barycentering live in the TOA loader
(`pint_tpu.toa`) so they can be vectorized over the whole TOA table at once.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from pint_tpu_torch import clock as clockmod
from pint_tpu_torch.earth import EOPProvider, itrf_to_gcrs_posvel, null_eop
from pint_tpu_torch.exceptions import ObservatoryError
from pint_tpu_torch.utils import PosVel


class Observatory:
    """Base observatory; subclasses define location/clock behavior."""

    def __init__(self, name: str, aliases: Optional[List[str]] = None, fullname: str = ""):
        self.name = name.lower()
        self.aliases = [a.lower() for a in (aliases or [])]
        self.fullname = fullname or name

    # identity ------------------------------------------------------------
    @property
    def tempo_code(self) -> str:
        return ""

    @property
    def itoa_code(self) -> str:
        return ""

    # physics -------------------------------------------------------------
    def clock_corrections(self, mjd_utc, include_gps=True, limits="warn"):
        """Clock corrections [s] to add to the site TOA to reach UTC."""
        return np.zeros_like(np.asarray(mjd_utc, np.float64))

    def posvel_gcrs(self, tt_mjd, ut1_mjd=None, eop: EOPProvider = null_eop) -> PosVel:
        """Geocentric ICRS (GCRS) position [m] / velocity [m/s]."""
        raise NotImplementedError

    @property
    def is_barycenter(self) -> bool:
        return False

    @property
    def is_geocenter(self) -> bool:
        return False


class TopoObs(Observatory):
    """A ground-based observatory at fixed ITRF coordinates.

    cf. reference `src/pint/observatory/topo_obs.py:65`.
    """

    def __init__(self, name, itrf_xyz, tempo_code="", itoa_code="", aliases=None,
                 clock_file="", apply_gps2utc=True, bogus_last_correction=False,
                 fullname=""):
        super().__init__(name, aliases, fullname)
        self.itrf_xyz = np.asarray(itrf_xyz, np.float64)
        self._tempo_code = tempo_code
        self._itoa_code = itoa_code
        self.clock_file = clock_file
        self.apply_gps2utc = apply_gps2utc
        self.bogus_last_correction = bogus_last_correction

    @property
    def tempo_code(self):
        return self._tempo_code

    @property
    def itoa_code(self):
        return self._itoa_code

    def clock_corrections(self, mjd_utc, include_gps=True, limits="warn"):
        mjd_utc = np.asarray(mjd_utc, np.float64)
        corr = np.zeros_like(mjd_utc)
        # some sites (jbroach, jbdfb, ncyobs) chain several clock files
        files = self.clock_file if isinstance(self.clock_file, (list, tuple)) else (
            [self.clock_file] if self.clock_file else []
        )
        for entry in files:
            # chain entries may be {'name': ..., 'valid_beyond_ends': True}
            fname = entry["name"] if isinstance(entry, dict) else entry
            fmt = "tempo2" if fname.endswith(".clk") else "tempo"
            cf = clockmod.find_clock_file(
                fname,
                fmt=fmt,
                obscode=self._tempo_code or None,
                limits=limits,
                bogus_last_correction=self.bogus_last_correction,
            )
            if cf is not None:
                corr = corr + cf.evaluate(mjd_utc, limits=limits)
        if include_gps and self.apply_gps2utc:
            corr = corr + clockmod.gps_to_utc_correction(mjd_utc, limits=limits)
        return corr

    def posvel_gcrs(self, tt_mjd, ut1_mjd=None, eop: EOPProvider = null_eop) -> PosVel:
        from pint_tpu_torch.mjd import tai_minus_utc

        tt_mjd = np.asarray(tt_mjd, np.float64)
        if ut1_mjd is None:
            e = eop(tt_mjd)
            # tai_minus_utc wants a UTC day; shift TT by the ~64-69 s offset
            # first so epochs just before a leap-second boundary resolve to
            # the correct table row
            utc_guess = tt_mjd - (32.184 + 37.0) / 86400.0
            ut1_mjd = tt_mjd - (32.184 + tai_minus_utc(utc_guess) - e.ut1_minus_utc) / 86400.0
            return itrf_to_gcrs_posvel(self.itrf_xyz, tt_mjd, ut1_mjd, e.xp, e.yp)
        return itrf_to_gcrs_posvel(self.itrf_xyz, tt_mjd, ut1_mjd)


class BarycenterObs(Observatory):
    """TOAs already referred to the solar-system barycenter ('@'/'bat').

    cf. reference `special_locations.py:71`.  No clock corrections, no
    geometry; TDB times are taken as given.
    """

    @property
    def is_barycenter(self):
        return True

    @property
    def tempo_code(self):
        return "@"

    def posvel_gcrs(self, tt_mjd, ut1_mjd=None, eop=null_eop):
        z = np.zeros(np.shape(np.asarray(tt_mjd)) + (3,))
        return PosVel(z, z.copy())


class GeocenterObs(Observatory):
    """TOAs referred to the geocenter (cf. `special_locations.py:117`)."""

    @property
    def is_geocenter(self):
        return True

    @property
    def tempo_code(self):
        return "0"

    @property
    def itoa_code(self):
        return "GC"

    def posvel_gcrs(self, tt_mjd, ut1_mjd=None, eop=null_eop):
        z = np.zeros(np.shape(np.asarray(tt_mjd)) + (3,))
        return PosVel(z, z.copy())


class T2SpacecraftObs(Observatory):
    """Spacecraft whose GCRS position rides in per-TOA tim flags
    (tempo2 convention: ``-telx -tely -telz`` [km], optionally
    ``-vx -vy -vz`` [km/s]); reference `T2SpacecraftObs`,
    `src/pint/observatory/special_locations.py:161`."""

    #: compute_posvels must source the geometry from the TOA flags
    needs_flag_positions = True

    def posvel_gcrs_from_flags(self, flags_list) -> PosVel:
        try:
            pos = np.array([[float(f["telx"]), float(f["tely"]),
                             float(f["telz"])] for f in flags_list]) * 1e3
        except KeyError as e:
            raise ObservatoryError(
                "spacecraft TOAs need -telx/-tely/-telz flags (GCRS "
                f"position in km); missing {e}")
        have_v = [all(k in f for k in ("vx", "vy", "vz"))
                  for f in flags_list]
        some_v = ["vx" in f or "vy" in f or "vz" in f for f in flags_list]
        if all(have_v):
            vel = np.array([[float(f["vx"]), float(f["vy"]),
                             float(f["vz"])] for f in flags_list]) * 1e3
        elif any(some_v):
            raise ObservatoryError(
                "spacecraft TOA velocity flags are incomplete: supply all "
                "of -vx/-vy/-vz on every TOA, or none at all")
        else:
            import warnings as _w

            _w.warn("spacecraft TOAs have no -vx/-vy/-vz flags; GCRS "
                    "velocities set to zero (Doppler terms omitted)")
            vel = np.zeros_like(pos)
        return PosVel(pos, vel)

    def posvel_gcrs(self, tt_mjd, ut1_mjd=None, eop=null_eop):
        raise ObservatoryError(
            "spacecraft positions come from TOA flags; use "
            "posvel_gcrs_from_flags")


class SatelliteObs(Observatory):
    """An orbiting observatory whose GCRS posvel comes from an orbit table.

    The reference builds these from FT2/FPorbit files
    (`satellite_obs.py:283`); here the table is injected (see
    `pint_tpu.event_toas` for the FT2/FPorbit loaders).
    """

    def __init__(self, name, mjd_tt, pos_gcrs_m, vel_gcrs_ms, aliases=None):
        super().__init__(name, aliases)
        self.mjd_tt = np.asarray(mjd_tt, np.float64)
        self.pos = np.asarray(pos_gcrs_m, np.float64)
        self.vel = np.asarray(vel_gcrs_ms, np.float64)

    def posvel_gcrs(self, tt_mjd, ut1_mjd=None, eop=null_eop):
        t = np.asarray(tt_mjd, np.float64)
        # np.interp clamps silently; an event outside the orbit table
        # would get the frozen endpoint position (km-scale error, ms of
        # barycentering) — refuse instead (the reference errors too).
        # Slack: ~2 table sample intervals (clamp error within slack
        # stays at the interpolation-error scale), not a fixed minute.
        step = np.median(np.diff(self.mjd_tt)) if len(self.mjd_tt) > 1 \
            else 1.0 / 86400.0
        slack = 2.0 * float(step)
        if t.size and (t.min() < self.mjd_tt[0] - slack
                       or t.max() > self.mjd_tt[-1] + slack):
            raise ValueError(
                f"TOAs (MJD {t.min():.3f}-{t.max():.3f}) fall outside "
                f"the orbit table of observatory {self.name!r} "
                f"(MJD {self.mjd_tt[0]:.3f}-{self.mjd_tt[-1]:.3f})")
        pos = np.stack([np.interp(t, self.mjd_tt, self.pos[:, i]) for i in range(3)], -1)
        vel = np.stack([np.interp(t, self.mjd_tt, self.vel[:, i]) for i in range(3)], -1)
        return PosVel(pos, vel)


# --- registry -----------------------------------------------------------------

_registry: Dict[str, Observatory] = {}
_alias_map: Dict[str, str] = {}


def register(obs: Observatory, overwrite=False):
    # a user registration into a fresh process must not pre-empt the
    # built-in site table (_load_defaults only fills an EMPTY registry,
    # so registering first would silently hide every default site)
    if not _loading:
        _load_defaults()
    if obs.name in _registry and not overwrite:
        raise ObservatoryError(f"observatory {obs.name!r} already registered")
    _registry[obs.name] = obs
    for a in obs.aliases:
        _alias_map[a] = obs.name
    if obs.tempo_code:
        _alias_map[obs.tempo_code.lower()] = obs.name
    if obs.itoa_code:
        _alias_map[obs.itoa_code.lower()] = obs.name


_loading = False


def _load_defaults():
    global _loading
    if _registry or _loading:
        return
    _loading = True
    from pint_tpu_torch.data.observatories_data import SITES

    for (name, xyz, tcode, icode, aliases, clock_file, gps, bogus) in SITES:
        register(
            TopoObs(name, xyz, tempo_code=tcode, itoa_code=icode,
                    aliases=list(aliases), clock_file=clock_file,
                    apply_gps2utc=gps, bogus_last_correction=bogus)
        )
    register(BarycenterObs("barycenter", aliases=["bat", "ssb", "bary", "@"]))
    register(GeocenterObs("geocenter", aliases=["coe", "geo"]))
    register(T2SpacecraftObs("stl_geo", aliases=["spacecraft"]))
    _loading = False


def get_observatory(name: str) -> Observatory:
    """Look up by name, alias, tempo code, or ITOA code (case-insensitive).

    cf. reference `get_observatory` (`observatory/__init__.py:519`).
    """
    _load_defaults()
    key = str(name).lower().strip()
    if key in _registry:
        return _registry[key]
    if key in _alias_map:
        return _registry[_alias_map[key]]
    raise ObservatoryError(f"unknown observatory {name!r}")


def list_observatories() -> List[str]:
    _load_defaults()
    return sorted(_registry)
