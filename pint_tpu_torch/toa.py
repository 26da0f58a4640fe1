"""Host-side TOA loading: ``.tim`` parsing, clock corrections, TDB, posvels.

The pipeline mirrors the reference's `get_TOAs`
(`src/pint/toa.py:110`):

    parse .tim  →  apply clock corrections  →  compute TDBs  →  compute posvels

but the product is a :class:`pint_tpu.toabatch.TOABatch` — dense f64 arrays
for the jitted compute core — instead of an astropy Table.  Everything in this
module is deliberately plain numpy on the host: it is one-time O(N) load work
(the reference spends ~16 s of pure-python per 10k TOAs here; see
`profiling/README.txt:40-50`), vectorized here over TOAs.

Supported ``.tim`` formats: Tempo2, Princeton, Parkes (reference
`_toa_format`, `src/pint/toa.py:442`). Inline commands:
FORMAT, MODE, INFO, TIME, EFAC, EQUAD, EMIN/EMAX, FMIN/FMAX, SKIP/NOSKIP,
END, PHASE, JUMP, INCLUDE, TRACK (reference `src/pint/toa.py:69,760-860`).
"""

from __future__ import annotations

import os
import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from pint_tpu_torch import c as C_LIGHT
from pint_tpu_torch import mjd as mjdmod
from pint_tpu_torch import tdbseries
from pint_tpu_torch.exceptions import TimFileError
from pint_tpu_torch.mjd import MJD
from pint_tpu_torch.observatory import get_observatory
from pint_tpu_torch.toabatch import TOABatch, make_batch
from pint_tpu_torch.utils import PosVel

__all__ = ["TOA", "TOAs", "get_TOAs", "read_tim", "write_tim", "merge_TOAs",
           "get_TOAs_array"]

_COMMANDS = (
    "DITHER", "EFAC", "EMAX", "EMAP", "EMIN", "EQUAD", "FMAX", "FMIN",
    "INCLUDE", "INFO", "JUMP", "MODE", "NOSKIP", "PHA1", "PHA2", "PHASE",
    "SEARCH", "SIGMA", "SIM", "SKIP", "TIME", "TRACK", "ZAWGT", "FORMAT",
    "END",
)

#: planets whose positions `compute_posvels(planets=True)` attaches
PLANETS = ("jupiter", "saturn", "venus", "uranus", "neptune")


@dataclass
class TOA:
    """One time-of-arrival: site-UTC epoch + metadata (host record)."""

    mjd: MJD                      # UTC at the observatory (two-part)
    error_us: float = 0.0
    freq_mhz: float = np.inf
    obs: str = "barycenter"
    flags: Dict[str, str] = field(default_factory=dict)

    def __str__(self):  # pragma: no cover - debugging aid
        return (f"{self.mjd.day}{str(float(self.mjd.frac))[1:]}:"
                f" {self.error_us} us at '{self.obs}' at {self.freq_mhz} MHz")


def _classify(line: str, fmt: str) -> str:
    """Line-type classification, matching the reference's precedence
    (`src/pint/toa.py:442`)."""
    if re.match(r"[0-9a-z@] ", line):
        return "Princeton"
    if line.startswith(("C ", "c ", "#", "CC ")):
        return "Comment"
    if line.upper().lstrip().startswith(_COMMANDS):
        return "Command"
    if re.match(r"^\s*$", line):
        return "Blank"
    if re.match(r"^ ", line) and len(line) > 41 and line[41] == ".":
        return "Parkes"
    if len(line) > 80 or fmt == "Tempo2":
        return "Tempo2"
    if re.match(r"\S\S", line) and len(line) > 14 and line[14] == ".":
        return "ITOA"
    return "Unknown"


def _parse_line(line: str, fmt: str) -> Tuple[str, Optional[TOA], List[str]]:
    """Parse one tim line → (kind, TOA-or-None, command-fields)."""
    kind = _classify(line, fmt)
    if kind == "Command":
        return kind, None, line.split()
    if kind in ("Comment", "Blank"):
        return kind, None, []
    if kind == "Unknown":
        raise TimFileError(f"unable to identify TOA format of line {line!r} "
                           "(missing FORMAT 1 header?)")
    if kind == "Tempo2":
        fields = line.split()
        if len(fields) < 5:
            raise TimFileError(f"short Tempo2 TOA line: {line!r}")
        name, freq, epoch, err, obs = fields[:5]
        flags = {"name": name}
        rest = fields[5:]
        if len(rest) % 2:
            raise TimFileError(f"flags must come in -key value pairs: {line!r}")
        for i in range(0, len(rest), 2):
            k = rest[i].lstrip("-")
            if not k or not rest[i].startswith("-"):
                raise TimFileError(f"bad flag {rest[i]!r} in {line!r}")
            if k in ("error", "freq", "scale", "MJD", "flags", "obs", "name"):
                raise TimFileError(f"TOA flag {k!r} would overwrite a TOA "
                                   f"column: {line!r}")
            flags[k] = rest[i + 1]
        return kind, TOA(mjd=mjdmod.from_string(epoch), error_us=float(err),
                         freq_mhz=_freq(float(freq)), obs=get_observatory(obs).name,
                         flags=flags), []
    if kind == "Princeton":
        obs = get_observatory(line[0]).name
        freq = float(line[15:24])
        ii, ff = line[24:44].split(".")
        day = int(ii)
        if day < 40000:   # two-digit-year era TOAs (tempo convention)
            day += 39126
        t = mjdmod.from_string(f"{day}.{ff.strip()}")
        err = float(line[44:53])
        flags = {}
        try:
            flags["ddm"] = str(float(line[68:78]))
        except (ValueError, IndexError):
            pass
        return kind, TOA(mjd=t, error_us=err, freq_mhz=_freq(freq), obs=obs,
                         flags=flags), []
    if kind == "Parkes":
        name = line[1:25].strip()
        freq = float(line[25:34])
        ii = int(line[34:41])
        ff = line[42:55].strip()
        if float(line[55:62] or 0.0) != 0.0:
            raise TimFileError("Parkes phase-offset column is not supported")
        err = float(line[63:71])
        obs = get_observatory(line[79]).name
        return kind, TOA(mjd=mjdmod.from_string(f"{ii}.{ff}"), error_us=err,
                         freq_mhz=_freq(freq), obs=obs,
                         flags={"name": name} if name else {}), []
    raise TimFileError(f"TOA format {kind!r} not supported: {line!r}")


def _freq(f: float) -> float:
    return np.inf if f == 0.0 else f


def read_tim(path_or_lines: Union[str, Sequence[str]], fmt: str = "Unknown"
             ) -> Tuple[List[TOA], List[str]]:
    """Read a tim file (or iterable of lines) → (toas, commands-seen).

    Applies inline commands exactly as the reference does
    (`src/pint/toa.py:760-860`): EFAC/EQUAD scale the
    uncertainty, EMIN/EMAX/FMIN/FMAX filter, TIME accumulates an offset
    recorded in the ``to`` flag, PHASE in the ``phase`` flag, JUMP brackets
    mark TOAs with ``tim_jump`` flags, INCLUDE recurses.
    """
    if isinstance(path_or_lines, str):
        basedir = os.path.dirname(os.path.abspath(path_or_lines))
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        basedir, lines = ".", list(path_or_lines)

    toas: List[TOA] = []
    commands: List[str] = []
    # one shared command state across INCLUDEd files, so e.g. an END inside
    # an include terminates the whole read (reference shares its cdict,
    # `src/pint/toa.py:760-832`)
    st = {"FORMAT": fmt, "EFAC": 1.0, "EQUAD": 0.0, "EMIN": 0.0,
          "EMAX": np.inf, "FMIN": 0.0, "FMAX": np.inf, "TIME": 0.0,
          "PHASE": 0, "SKIP": False, "END": False, "INFO": None,
          "JUMP_ACTIVE": False, "JUMP_N": 0}

    def handle_command(fields, basedir):
        cmd = fields[0].upper()
        commands.append(" ".join(fields))
        if cmd == "SKIP":
            st["SKIP"] = True
        elif cmd == "NOSKIP":
            st["SKIP"] = False
        elif cmd == "END":
            st["END"] = True
        elif cmd == "FORMAT":
            st["FORMAT"] = "Tempo2" if fields[1] == "1" else "Unknown"
        elif cmd == "TIME":
            st["TIME"] += float(fields[1])
        elif cmd == "PHASE":
            st["PHASE"] += int(float(fields[1]))
        elif cmd in ("EFAC", "EQUAD", "EMIN", "EMAX", "FMIN", "FMAX"):
            st[cmd] = float(fields[1])
        elif cmd == "INFO":
            st["INFO"] = fields[1] if len(fields) > 1 else None
        elif cmd == "JUMP":
            if st["JUMP_ACTIVE"]:
                st["JUMP_ACTIVE"] = False
            else:
                st["JUMP_ACTIVE"] = True
                st["JUMP_N"] += 1
        elif cmd == "INCLUDE":
            path = os.path.join(basedir, fields[1])
            # the included file declares its own FORMAT; restore the parent's
            # afterwards (reference `src/pint/toa.py:806-816`)
            saved_fmt, st["FORMAT"] = st["FORMAT"], "Unknown"
            try:
                with open(path) as f:
                    process(f.readlines(),
                            os.path.dirname(os.path.abspath(path)))
            finally:
                st["FORMAT"] = saved_fmt
        elif cmd == "MODE":
            if fields[1:] and fields[1] != "1":
                warnings.warn(f"MODE {fields[1]} is ignored (only MODE 1, "
                              "fit-with-errors, is meaningful)")
        # DITHER/EMAP/PHA1/PHA2/SEARCH/SIGMA/SIM/TRACK/ZAWGT: recorded, ignored

    def process(lines, basedir):
        for raw in lines:
            if st["END"]:
                break
            # commands stay live inside SKIP blocks (reference handles
            # Command lines before its SKIP check,
            # `src/pint/toa.py:771-830`); only TOA lines
            # are suppressed.
            if st["SKIP"] and _classify(raw, st["FORMAT"]) != "Command":
                continue
            kind, toa, fields = _parse_line(raw, st["FORMAT"])
            if kind == "Command":
                handle_command(fields, basedir)
                if st["END"]:
                    break
                continue
            if toa is None:
                continue
            # EMIN/EMAX filter on the *raw* uncertainty, then EFAC/EQUAD
            # rescale (reference order, `src/pint/toa.py:836-845`)
            if not (st["EMIN"] <= toa.error_us <= st["EMAX"]) or \
                    not (st["FMIN"] <= toa.freq_mhz <= st["FMAX"]):
                continue
            toa.error_us = float(np.hypot(toa.error_us * st["EFAC"],
                                          st["EQUAD"]))
            if st["INFO"]:
                toa.flags.setdefault("info", st["INFO"])
            if st["JUMP_ACTIVE"]:
                toa.flags["jump"] = str(st["JUMP_N"])
                toa.flags["tim_jump"] = str(st["JUMP_N"])
            if st["PHASE"]:
                toa.flags["phase"] = str(st["PHASE"])
            if st["TIME"]:
                # recorded only; applied with the clock corrections, like the
                # reference's handling of "-to" flags (toa.py:2238)
                toa.flags["to"] = str(st["TIME"])
            toas.append(toa)

    process(lines, basedir)
    return toas, commands


def format_toa_line(toa: TOA) -> str:
    """One Tempo2-format output line (cf. reference `format_toa_line`,
    `src/pint/toa.py:567`)."""
    name = toa.flags.get("name", "unk")
    freq = 0.0 if np.isinf(toa.freq_mhz) else toa.freq_mhz
    obs = get_observatory(toa.obs)
    code = obs.tempo_code or toa.obs
    flagstr = " ".join(
        f"-{k} {v}" for k, v in sorted(toa.flags.items()) if k != "name"
    )
    day, frac = int(toa.mjd.day), float(toa.mjd.frac)
    fracstr = f"{frac:.16f}"
    if fracstr.startswith("1"):  # frac within 10 ps of midnight rounded up
        day, fracstr = day + 1, f"{0.0:.16f}"
    return (f"{name} {freq:.6f} {day}{fracstr[1:]} "
            f"{toa.error_us:.3f} {code} {flagstr}").rstrip()


def write_tim(path, toas: "TOAs", commentflag: Optional[str] = None):
    """Write a Tempo2-format tim file."""
    with open(path, "w") as f:
        f.write("FORMAT 1\n")
        for t in toas.to_list():
            prefix = ""
            if commentflag and commentflag in t.flags:
                prefix = "C "
            f.write(prefix + format_toa_line(t) + "\n")


class TOAs:
    """Host container of TOAs: numpy columns + per-TOA flag dicts.

    The analogue of the reference's ``TOAs``
    (`src/pint/toa.py:1184`), with the astropy Table replaced
    by plain arrays and the device-facing data exported via :meth:`to_batch`.
    """

    def __init__(self, toalist: Sequence[TOA], commands: Optional[List[str]] = None,
                 filename: Optional[str] = None):
        if len(toalist) == 0:
            raise TimFileError("no TOAs")
        self.filename = filename
        self.commands = commands or []
        self.ephem: Optional[str] = None
        self.planets = False
        self.clock_corr_info: Dict[str, object] = {}
        n = len(toalist)
        self.utc = MJD(np.array([int(t.mjd.day) for t in toalist], np.int64),
                       np.array([float(t.mjd.frac) for t in toalist], np.float64))
        self.error_us = np.array([t.error_us for t in toalist], np.float64)
        self.freq_mhz = np.array([t.freq_mhz for t in toalist], np.float64)
        self.obs = np.array([t.obs for t in toalist])
        self.flags: List[Dict[str, str]] = [dict(t.flags) for t in toalist]
        self.tdb: Optional[MJD] = None
        self.ssb_obs_pos: Optional[np.ndarray] = None   # m
        self.ssb_obs_vel: Optional[np.ndarray] = None   # m/s
        self.obs_sun_pos: Optional[np.ndarray] = None   # m
        self.obs_planet_pos: Dict[str, np.ndarray] = {}
        # index into original file ordering (survives select())
        self.index = np.arange(n)

    # -- basic introspection ------------------------------------------------
    @property
    def ntoas(self) -> int:
        return len(self.flags)

    def __len__(self):
        return self.ntoas

    @property
    def observatories(self):
        return set(self.obs.tolist())

    @property
    def first_MJD(self) -> float:
        return float(np.min(self.utc.mjd_float))

    @property
    def last_MJD(self) -> float:
        return float(np.max(self.utc.mjd_float))

    def get_mjds(self, high_precision=False):
        """UTC MJDs as float64 (or the exact two-part MJD)."""
        return self.utc if high_precision else self.utc.mjd_float

    def get_errors(self):
        return self.error_us

    def get_freqs(self):
        return self.freq_mhz

    def get_obss(self):
        return self.obs

    def get_pulse_numbers(self) -> Optional[np.ndarray]:
        if all("pn" not in f for f in self.flags):
            return None
        return np.array([float(f.get("pn", np.nan)) for f in self.flags])

    @classmethod
    def from_columns(cls, utc: MJD, error_us, freq_mhz, obs,
                     flags: Optional[List[Dict[str, str]]] = None,
                     filename: Optional[str] = None) -> "TOAs":
        """Column-wise construction, bypassing per-row TOA objects —
        photon-event files carry 1e6-1e7 rows where the per-row path
        costs minutes of pure python."""
        self = cls.__new__(cls)
        self.filename = filename
        self.commands = []
        self.ephem = None
        self.planets = False
        self.clock_corr_info = {}
        n = len(utc.day)
        self.utc = MJD(np.asarray(utc.day, np.int64),
                       np.asarray(utc.frac, np.float64))
        self.error_us = np.broadcast_to(
            np.asarray(error_us, np.float64), (n,)).copy()
        self.freq_mhz = np.broadcast_to(
            np.asarray(freq_mhz, np.float64), (n,)).copy()
        self.obs = (np.full(n, obs) if isinstance(obs, str)
                    else np.asarray(obs))
        self.flags = flags if flags is not None else [{} for _ in range(n)]
        if len(self.flags) != n:
            raise ValueError("flags list length mismatch")
        self.tdb = None
        self.ssb_obs_pos = None
        self.ssb_obs_vel = None
        self.obs_sun_pos = None
        self.obs_planet_pos = {}
        self.index = np.arange(n)
        return self

    @property
    def is_wideband(self) -> bool:
        """True when any TOA carries a ``-pp_dm`` wideband DM measurement
        (reference `TOAs.is_wideband`,
        `src/pint/toa.py:1659`)."""
        return any("pp_dm" in f for f in self.flags)

    def get_dm_data(self):
        """Wideband DM measurements: ``(index, dm, dm_error)`` — the TOA
        row indices carrying ``-pp_dm``/``-pp_dme`` flags and their values
        [pc cm^-3] — or None if no TOA has DM data (reference
        `WidebandDMResiduals.get_dm_data`,
        `src/pint/residuals.py:1114`)."""
        idx = [i for i, f in enumerate(self.flags) if "pp_dm" in f]
        if not idx:
            return None
        dm = np.array([float(self.flags[i]["pp_dm"]) for i in idx])
        dme = np.array([float(self.flags[i].get("pp_dme", 0.0))
                        for i in idx])
        if np.any(dme <= 0.0):
            raise ValueError(
                "wideband TOAs need positive -pp_dme DM uncertainties")
        return np.array(idx), dm, dme

    def get_flag_value(self, flag, fill_value=None, as_type=None):
        vals = []
        idx = []
        for i, f in enumerate(self.flags):
            v = f.get(flag, fill_value)
            if v is not fill_value and as_type is not None:
                v = as_type(v)
            vals.append(v)
            if f.get(flag) is not None:
                idx.append(i)
        return vals, idx

    def to_list(self, undo_clkcorr=True) -> List[TOA]:
        """Back to per-TOA records; by default un-applies clock corrections
        (and drops the ``clkcorr`` flag) so written tim files are raw site
        arrival times, as the reference does
        (`src/pint/toa.py:1624`)."""
        out = []
        for i in range(self.ntoas):
            t = MJD(self.utc.day[i], self.utc.frac[i])
            flags = dict(self.flags[i])
            if undo_clkcorr and "clkcorr" in flags:
                t = mjdmod.add_sec(t, -float(flags.pop("clkcorr")))
            out.append(TOA(mjd=MJD(np.int64(t.day), np.float64(t.frac)),
                           error_us=float(self.error_us[i]),
                           freq_mhz=float(self.freq_mhz[i]),
                           obs=str(self.obs[i]), flags=flags))
        return out

    def select(self, mask) -> "TOAs":
        """Boolean/index subset (new object; host-side)."""
        mask = np.asarray(mask)
        out = object.__new__(TOAs)
        out.filename = self.filename
        out.commands = self.commands
        out.ephem = self.ephem
        out.planets = self.planets
        out.clock_corr_info = dict(self.clock_corr_info)
        out.utc = MJD(self.utc.day[mask], self.utc.frac[mask])
        out.error_us = self.error_us[mask]
        out.freq_mhz = self.freq_mhz[mask]
        out.obs = self.obs[mask]
        idx = np.arange(self.ntoas)[mask] if mask.dtype == bool else mask
        out.flags = [dict(self.flags[i]) for i in idx]
        # optional photon-event columns (see event_toas.load_fits_TOAs)
        for attr in ("energies", "weights"):
            col = getattr(self, attr, None)
            if col is not None:
                setattr(out, attr, np.asarray(col)[idx])
        out.is_photon_events = getattr(self, "is_photon_events", False)
        extra = getattr(self, "extra", None)
        if extra is not None:
            out.extra = {k: np.asarray(v)[idx] for k, v in extra.items()}
        out.index = self.index[mask]
        out.tdb = None if self.tdb is None else MJD(self.tdb.day[mask],
                                                    self.tdb.frac[mask])
        out._tdb_topo_applied = getattr(self, "_tdb_topo_applied", False)
        for col in ("ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos"):
            v = getattr(self, col)
            setattr(out, col, None if v is None else v[mask])
        out.obs_planet_pos = {k: v[mask] for k, v in self.obs_planet_pos.items()}
        return out

    # -- pipeline stages ----------------------------------------------------
    def apply_clock_corrections(self, include_bipm=False, bipm_version="BIPM2021",
                                limits="warn"):
        """Shift site TOAs to (BIPM-realized) UTC, per observatory group.

        cf. reference `src/pint/toa.py:2195`.  Idempotent via
        the ``clkcorr`` flag.
        """
        if any("clkcorr" in f for f in self.flags):
            return
        from pint_tpu_torch import clock as clockmod

        # "-to" flags are TIME offsets applied together with the clock
        # corrections (reference `src/pint/toa.py:2238`)
        corr = np.array([float(f.get("to", 0.0)) for f in self.flags])
        for obsname in self.observatories:
            sel = self.obs == obsname
            site = get_observatory(obsname)
            csel = site.clock_corrections(self.utc.mjd_float[sel], limits=limits)
            if include_bipm and not site.is_barycenter:
                csel = csel + clockmod.bipm_correction(
                    self.utc.mjd_float[sel], version=bipm_version, limits=limits)
            corr[sel] += csel
        self.utc = mjdmod.add_sec(self.utc, corr)
        for i, f in enumerate(self.flags):
            if corr[i] != 0.0:
                f["clkcorr"] = str(corr[i])
        self.clock_corr_info.update(
            include_bipm=include_bipm, bipm_version=bipm_version)

    def compute_TDBs(self, ephem: Optional[str] = "DE421", method="default"):
        """UTC → TDB at each TOA (geocentric FB90 series; the topocentric
        term, ~2 us diurnal amplitude, is applied in :meth:`compute_posvels`
        once the observatory geometry is available — cf. reference
        `src/pint/toa.py:2262`).

        Barycentric ('@'/'bat') TOAs are *already* TDB by convention
        (reference `special_locations.py:71` sets timescale tdb) and pass
        through unchanged.
        """
        tdb = mjdmod.utc_to_tdb(self.utc)
        bary = np.array([get_observatory(o).is_barycenter for o in self.obs])
        self.tdb = MJD(np.where(bary, self.utc.day, tdb.day),
                       np.where(bary, self.utc.frac, tdb.frac))
        self._tdb_topo_applied = False
        self.ephem = self.ephem or ephem

    def compute_posvels(self, ephem: Optional[str] = "DE421", planets=False):
        """Attach SSB-relative observatory/Sun/planet geometry.

        cf. reference `src/pint/toa.py:2334`.
        """
        from pint_tpu_torch.ephemeris import load_ephemeris

        if self.tdb is None:
            self.compute_TDBs(ephem=ephem)
        eph = load_ephemeris(ephem)
        self.ephem = ephem
        self.planets = planets
        tdb_f = self.tdb.mjd_float
        if hasattr(eph, "pinned_to") and len(tdb_f):
            # serve every per-observatory group below from the ONE window
            # quantized from the full dataset span (integrated-ephemeris
            # consistency; see IntegratedEphemeris.pinned_to)
            eph = eph.pinned_to(tdb_f)
        tt = mjdmod.utc_to_tt(self.utc)

        n = self.ntoas
        self.ssb_obs_pos = np.zeros((n, 3))
        self.ssb_obs_vel = np.zeros((n, 3))
        self.obs_sun_pos = np.zeros((n, 3))
        wanted = PLANETS if planets else ()
        self.obs_planet_pos = {p: np.zeros((n, 3)) for p in wanted}
        tdb_topo = np.zeros(n)

        for obsname in self.observatories:
            sel = np.flatnonzero(self.obs == obsname)
            site = get_observatory(obsname)
            t_sel = tdb_f[sel]
            if site.is_barycenter:
                ssb_obs = PosVel(np.zeros((len(sel), 3)), np.zeros((len(sel), 3)))
            else:
                earth = eph.posvel("earth", t_sel)
                if site.is_geocenter:
                    ssb_obs = earth
                else:
                    if getattr(site, "needs_flag_positions", False):
                        geo = site.posvel_gcrs_from_flags(
                            [self.flags[i] for i in sel])
                    else:
                        geo = site.posvel_gcrs(tt.mjd_float[sel])
                    ssb_obs = PosVel(earth.pos + geo.pos, earth.vel + geo.vel)
                    # topocentric TDB-TT term (v_earth·r_obs)/c², ~2 us
                    # diurnal (tdbseries.py:180); the FB90 series applied in
                    # compute_TDBs is geocentric only
                    tdb_topo[sel] = tdbseries.tdb_minus_tt_topo(
                        geo.pos, earth.vel)
            self.ssb_obs_pos[sel] = ssb_obs.pos
            self.ssb_obs_vel[sel] = ssb_obs.vel
            sun = eph.posvel("sun", t_sel)
            self.obs_sun_pos[sel] = sun.pos - ssb_obs.pos
            for p in wanted:
                body = eph.posvel(p, t_sel)
                self.obs_planet_pos[p][sel] = body.pos - ssb_obs.pos

        if not getattr(self, "_tdb_topo_applied", False) and np.any(tdb_topo):
            self.tdb = mjdmod.add_sec(self.tdb, tdb_topo)
            self._tdb_topo_applied = True

    # -- export -------------------------------------------------------------
    def to_batch(self, policy: Optional[str] = None,
                 device=None) -> TOABatch:
        """Export the device-facing struct-of-arrays batch onto ``device``
        (default ``"cuda"``; see :func:`pint_tpu_torch.utils.resolve_device`).

        ``policy`` ("raise" | "mask" | "warn") is the input-validation
        policy applied by :func:`pint_tpu.toabatch.make_batch` to
        non-finite/nonpositive uncertainties, non-finite MJDs and empty
        selections; default $PINT_TPU_VALIDATE -> "raise".  Photon-event
        TOAs (``is_photon_events``) default to "off": their zero
        uncertainties are by construction (unbinned likelihoods), not
        data corruption."""
        if policy is None and getattr(self, "is_photon_events", False):
            policy = "off"
        if self.tdb is None:
            raise ValueError("run compute_TDBs/compute_posvels before to_batch")
        if self.ssb_obs_pos is None and any(
                not get_observatory(o).is_barycenter for o in self.observatories):
            raise ValueError(
                "topocentric/geocentric TOAs need compute_posvels() before "
                "to_batch(); zero geometry is only valid for barycentric data")
        # center the fraction at |frac|<=0.5 for best dd cancellation
        frac = np.asarray(self.tdb.frac, np.float64)
        day = np.asarray(self.tdb.day, np.int64).copy()
        hi = frac > 0.5
        day[hi] += 1
        frac = np.where(hi, frac - 1.0, frac)
        pn = self.get_pulse_numbers()
        return make_batch(
            tdb_day=day, tdb_frac=frac, error_us=self.error_us,
            freq_mhz=self.freq_mhz,
            ssb_obs_pos_ls=None if self.ssb_obs_pos is None
            else self.ssb_obs_pos / C_LIGHT,
            ssb_obs_vel_c=None if self.ssb_obs_vel is None
            else self.ssb_obs_vel / C_LIGHT,
            obs_sun_pos_ls=None if self.obs_sun_pos is None
            else self.obs_sun_pos / C_LIGHT,
            pulse_number=pn,
            obs_planet_pos_ls={k: v / C_LIGHT
                               for k, v in self.obs_planet_pos.items()},
            policy=policy,
            device=device,
        )


def _toa_cache_key(timfile: str, ephem, planets, include_bipm,
                   bipm_version, limits) -> str:
    """Content hash of the tim file + preparation settings (reference
    caches on file hashes the same way, `toa.py:334-404`)."""
    import hashlib

    h = hashlib.sha256()

    def feed(path):
        with open(path, "rb") as f:
            data = f.read()
        h.update(data)
        # INCLUDEd tim files are part of the content (read_tim recurses)
        basedir = os.path.dirname(os.path.abspath(path))
        for line in data.decode("ascii", "replace").splitlines():
            fields = line.split()
            if fields and fields[0].upper() == "INCLUDE" and len(fields) > 1:
                sub = fields[1]
                if not os.path.isabs(sub):
                    sub = os.path.join(basedir, sub)
                if os.path.exists(sub):
                    feed(sub)

    feed(timfile)
    h.update(repr((ephem, planets, include_bipm, bipm_version, limits,
                   3)).encode())        # trailing int = cache format rev
    return h.hexdigest()


def get_TOAs(timfile, ephem="DE421", planets=False, include_bipm=False,
             bipm_version="BIPM2021", model=None, limits="warn",
             usepickle=False, picklefilename=None) -> TOAs:
    """Load, clock-correct, and barycenter-prepare TOAs from a tim file.

    Equivalent of the reference's `get_TOAs`
    (`src/pint/toa.py:110`).  If ``model`` is given, EPHEM /
    CLOCK / PLANET_SHAPIRO defaults are taken from it.  ``usepickle``
    caches the fully-prepared TOAs next to the tim file, keyed on a
    content hash of the file + preparation settings (reference
    `load_pickle`/`save_pickle`, `toa.py:334-404`); a stale or
    incompatible cache is silently rebuilt.
    """
    if model is not None:
        if getattr(model, "EPHEM", None) and model.EPHEM.value:
            ephem = model.EPHEM.value
        if getattr(model, "PLANET_SHAPIRO", None) and model.PLANET_SHAPIRO.value:
            planets = True
        clk = getattr(model, "CLOCK", None)
        if clk is not None and clk.value and clk.value.upper().startswith("TT(BIPM"):
            include_bipm = True
            v = clk.value.upper().replace("TT(", "").replace(")", "")
            if v != "BIPM":
                bipm_version = v
    cachefile = None
    if usepickle and isinstance(timfile, str):
        import gzip
        import pickle

        cachefile = picklefilename or timfile + ".pint_tpu_pickle.gz"
        key = _toa_cache_key(timfile, ephem, planets, include_bipm,
                             bipm_version, limits)
        if os.path.exists(cachefile):
            try:
                with gzip.open(cachefile, "rb") as f:
                    stored_key, t = pickle.load(f)
                if stored_key == key:
                    return t
            except Exception:
                pass  # unreadable/incompatible cache: rebuild below
    toalist, commands = read_tim(timfile)
    t = TOAs(toalist, commands=commands,
             filename=timfile if isinstance(timfile, str) else None)
    t.apply_clock_corrections(include_bipm=include_bipm,
                              bipm_version=bipm_version, limits=limits)
    t.compute_TDBs(ephem=ephem)
    t.compute_posvels(ephem=ephem, planets=planets)
    if cachefile is not None:
        import gzip
        import pickle

        with gzip.open(cachefile, "wb") as f:
            pickle.dump((key, t), f)
    return t


def get_TOAs_array(times, obs="bary", errors_us=1.0, freqs_mhz=np.inf,
                   flags=None, ephem="DE421", planets=False,
                   include_bipm=False, **kw) -> TOAs:
    """Build prepared TOAs from arrays (reference `get_TOAs_array`,
    `src/pint/toa.py:2787`).

    ``times`` may be an :class:`MJD` pair or float64 MJDs (UTC at site).
    """
    if not isinstance(times, MJD):
        times = mjdmod.from_mjd_float(np.atleast_1d(np.asarray(times, np.float64)))
    else:
        times = MJD(np.atleast_1d(times.day), np.atleast_1d(times.frac))
    n = times.day.shape[0]
    errors_us = np.broadcast_to(np.asarray(errors_us, np.float64), (n,))
    freqs_mhz = np.broadcast_to(np.asarray(freqs_mhz, np.float64), (n,))
    if np.ndim(obs):
        obs_arr = [get_observatory(o).name for o in np.asarray(obs)]
    else:
        obs_arr = [get_observatory(obs).name] * n
    toalist = [TOA(mjd=MJD(times.day[i], times.frac[i]),
                   error_us=float(errors_us[i]), freq_mhz=float(freqs_mhz[i]),
                   obs=str(obs_arr[i]),
                   flags=dict(flags[i]) if flags is not None else {})
               for i in range(n)]
    t = TOAs(toalist)
    t.apply_clock_corrections(include_bipm=include_bipm, **kw)
    t.compute_TDBs(ephem=ephem)
    t.compute_posvels(ephem=ephem, planets=planets)
    return t


def merge_TOAs(toas_list: Sequence[TOAs]) -> TOAs:
    """Concatenate prepared TOAs objects (reference `merge_TOAs`,
    `src/pint/toa.py:2757`)."""
    toas_list = list(toas_list)
    ephems = {t.ephem for t in toas_list}
    if len(ephems) > 1:
        raise ValueError(f"cannot merge TOAs with different ephemerides: {ephems}")
    # clock-correction state must agree, or the merged object's idempotency
    # guard would leave the uncorrected subset permanently uncorrected
    corrected = {any("clkcorr" in f for f in t.flags) for t in toas_list}
    if len(corrected) > 1:
        raise ValueError("cannot merge clock-corrected with uncorrected TOAs")
    infos = {tuple(sorted(t.clock_corr_info.items())) for t in toas_list}
    if len(infos) > 1:
        raise ValueError(
            f"cannot merge TOAs with different clock settings: {infos}")
    alltoas = [x for t in toas_list for x in t.to_list(undo_clkcorr=False)]
    out = TOAs(alltoas, commands=[c for t in toas_list for c in t.commands])
    out.ephem = toas_list[0].ephem
    out.planets = all(t.planets for t in toas_list)
    out.clock_corr_info = dict(toas_list[0].clock_corr_info)
    # photon-event columns: propagate when every input carries them
    for attr in ("energies", "weights"):
        cols = [getattr(t, attr, None) for t in toas_list]
        if all(c is not None for c in cols):
            setattr(out, attr, np.concatenate([np.asarray(c) for c in cols]))
        elif any(c is not None for c in cols):
            warnings.warn(f"merge_TOAs: only some inputs carry {attr}; "
                          "the merged TOAs drops the column")
    # re-deriving the prepared columns keeps merge simple and exact
    if all(t.tdb is not None for t in toas_list):
        out.compute_TDBs(ephem=out.ephem)
    if all(t.ssb_obs_pos is not None for t in toas_list):
        out.compute_posvels(ephem=out.ephem, planets=out.planets)
    return out
