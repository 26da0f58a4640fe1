"""Observatory clock-correction files: parsing, interpolation, registry.

Equivalent of the reference's `src/pint/observatory/clock_file.py` (906 LoC)
and `global_clock_corrections.py`.  Differences forced by this environment:

* **No network.**  The reference auto-downloads the IPTA clock-correction
  repository; here corrections are resolved from local directories only
  (``$PINT_TPU_CLOCK_DIR``, ``$TEMPO/clock``, ``$TEMPO2/clock``, CWD).  When a
  file is absent the correction is zero and a single warning is emitted per
  site (policy ``limits='warn'``) or :class:`~pint_tpu.exceptions.
  ClockCorrectionError` is raised (``limits='error'``).

Formats supported (format behavior matched to the reference parsers,
`clock_file.py:441` tempo2 / `clock_file.py:566` tempo):

* **tempo2**: ``# FROM TO`` header line, then ``mjd  offset_seconds`` rows.
* **tempo**: fixed columns — MJD in cols 0:9, two corrections (µs) in cols
  9:21 / 21:33, site code in col 34; correction = clkcorr2 - clkcorr1; the
  hard-coded tempo quirk ``clkcorr1 -= 818.8 if clkcorr1 > 800`` applies;
  ``INCLUDE`` lines are followed.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np

from pint_tpu_torch.exceptions import (ClockCorrectionError,
                                 ClockCorrectionOutOfRange,
                                 ClockCorrectionWarning)


class ClockFile:
    """MJD -> clock offset [s], linearly interpolated.

    mjd values must be non-decreasing; evaluation outside the span follows
    ``limits``: 'warn' (clamp to end values with a warning) or 'error'.
    """

    def __init__(self, mjd, offset_s, friendly_name="", valid_beyond_ends=False,
                 leading_comment=""):
        self.mjd = np.asarray(mjd, np.float64)
        self.offset = np.asarray(offset_s, np.float64)
        order = np.argsort(self.mjd, kind="stable")
        if not np.array_equal(order, np.arange(len(order))):
            self.mjd, self.offset = self.mjd[order], self.offset[order]
        self.friendly_name = friendly_name
        self.valid_beyond_ends = valid_beyond_ends
        self.leading_comment = leading_comment

    def evaluate(self, mjd, limits="warn"):
        mjd = np.asarray(mjd, np.float64)
        if len(self.mjd) == 0:
            return np.zeros_like(mjd)
        if not self.valid_beyond_ends:
            bad = (mjd < self.mjd[0]) | (mjd > self.mjd[-1])
            if np.any(bad):
                msg = (
                    f"{np.sum(bad)} MJD(s) outside clock file "
                    f"{self.friendly_name} span [{self.mjd[0]}, {self.mjd[-1]}] "
                    f"(last correction at MJD {self.last_correction_mjd:.2f}"
                    " — the clock file may simply be stale; see "
                    "pint_tpu.clockcorr.update_clock_files)"
                )
                if limits == "error":
                    raise ClockCorrectionOutOfRange(msg)
                warnings.warn(msg, ClockCorrectionWarning)
        return np.interp(mjd, self.mjd, self.offset)

    @property
    def last_correction_mjd(self):
        return self.mjd[-1] if len(self.mjd) else -np.inf

    # -- parsers ---------------------------------------------------------------

    @classmethod
    def read(cls, filename, fmt="tempo", **kw):
        if fmt == "tempo":
            return cls.read_tempo(filename, **kw)
        elif fmt == "tempo2":
            return cls.read_tempo2(filename, **kw)
        raise ValueError(f"unknown clock file format {fmt!r}")

    @classmethod
    def read_tempo2(cls, filename, bogus_last_correction=False, valid_beyond_ends=False):
        mjd: List[float] = []
        clk: List[float] = []
        leading = []
        with open(filename) as f:
            header = f.readline()
            if not header.startswith("#"):
                raise ValueError(f"{filename}: tempo2 clock file must start with '# FROM TO' header")
            for line in f:
                if line.startswith("#"):
                    leading.append(line.rstrip())
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                try:
                    m = float(parts[0].replace("D", "E").replace("d", "e"))
                    c = float(parts[1].replace("D", "E").replace("d", "e"))
                except ValueError:
                    continue
                mjd.append(m)
                clk.append(c)
        mjd, clk = _trim(mjd, clk, bogus_last_correction)
        return cls(mjd, clk, friendly_name=str(filename),
                   valid_beyond_ends=valid_beyond_ends,
                   leading_comment="\n".join(leading))

    @classmethod
    def read_tempo(cls, filename, obscode=None, bogus_last_correction=False,
                   process_includes=True, valid_beyond_ends=False):
        mjds: List[float] = []
        clkcorrs: List[float] = []
        with open(filename) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                ls = line.split()
                if ls and (ls[0].upper().startswith("MJD") or ls[0].startswith("=====")):
                    continue  # header furniture
                if ls and ls[0].upper() == "INCLUDE" and process_includes and obscode is not None:
                    inc = cls.read_tempo(Path(filename).parent / ls[1], obscode=obscode)
                    mjds.extend(inc.mjd.tolist())
                    clkcorrs.extend(inc.offset.tolist())
                    continue
                try:
                    mjd = float(line[:9])
                    if (mjd < 39000 and mjd != 0) or mjd > 100000:
                        mjd = None
                except (ValueError, IndexError):
                    mjd = None
                try:
                    c1 = float(line[9:21])
                except (ValueError, IndexError):
                    c1 = None
                try:
                    c2 = float(line[21:33])
                except (ValueError, IndexError):
                    c2 = None
                try:
                    csite = line[34].lower()
                except IndexError:
                    csite = None
                if obscode is not None and csite != obscode.lower():
                    continue
                if mjd is None or (c1 is None and c2 is None):
                    continue
                c1 = c1 or 0.0
                c2 = c2 or 0.0
                if c1 > 800.0:  # hard-coded tempo convention
                    c1 -= 818.8
                mjds.append(mjd)
                clkcorrs.append((c2 - c1) * 1e-6)  # µs -> s
        mjds, clkcorrs = _trim(mjds, clkcorrs, bogus_last_correction)
        return cls(mjds, clkcorrs, friendly_name=str(filename),
                   valid_beyond_ends=valid_beyond_ends)

    # -- writers (round-trip support, cf. reference `ClockFile.write_tempo2_clock_file`) --

    def write_tempo2(self, filename, hdrline="# UTC(obs) UTC"):
        with open(filename, "w") as f:
            print(hdrline, file=f)
            for m, c in zip(self.mjd, self.offset):
                print(f"{m:.5f} {c:.12e}", file=f)

    def write_tempo(self, filename, obscode="1"):
        with open(filename, "w") as f:
            print("   MJD       EECO-REF    NIST-REF NS      DATE    COMMENTS", file=f)
            print("=========    ========    ======== ==    ========  ========", file=f)
            for m, c in zip(self.mjd, self.offset):
                f.write(f"{m:9.2f}{0.0:12.3f}{c * 1e6:12.3f} {obscode}\n")

    def merge(self, other: "ClockFile") -> "ClockFile":
        mjd = np.concatenate([self.mjd, other.mjd])
        off = np.concatenate([self.offset, other.offset])
        return ClockFile(mjd, off, friendly_name=f"{self.friendly_name}+{other.friendly_name}")


def _trim(mjd, clk, bogus_last):
    if bogus_last and len(mjd):
        mjd, clk = mjd[:-1], clk[:-1]
    while len(mjd) and mjd[0] == 0:
        mjd, clk = mjd[1:], clk[1:]
    return mjd, clk


# --- registry / search --------------------------------------------------------

_warned: set = set()
_cache: dict = {}


def clock_search_dirs() -> List[str]:
    from pint_tpu_torch.clockcorr import clock_cache_dir

    dirs = []
    for env, sub in (("PINT_TPU_CLOCK_DIR", ""),
                     ("PINT_CLOCK_OVERRIDE", "")):
        v = os.environ.get(env)
        if v:
            dirs.append(v)
    # the global-repository download cache (pint_tpu.clockcorr) comes
    # BEFORE any TEMPO/TEMPO2 install dirs: freshly downloaded IPTA
    # corrections must not be shadowed by a stale env installation
    # (explicit PINT_TPU_CLOCK_DIR/PINT_CLOCK_OVERRIDE still win above)
    cache = clock_cache_dir()
    if cache not in dirs:
        dirs.append(cache)
    for env, sub in (("TEMPO2", "clock"), ("TEMPO", "clock")):
        v = os.environ.get(env)
        if v:
            dirs.append(os.path.join(v, sub))
    dirs.append(os.path.join(os.path.dirname(__file__), "data", "clock"))
    dirs.append(os.getcwd())
    return dirs


def reset_cache() -> None:
    """Forget cached clock-file lookups (including cached MISSES) and
    one-time warnings — called by `pint_tpu.clockcorr.update_clock_files`
    so fresh downloads are picked up within the same process."""
    _cache.clear()
    _warned.clear()


def find_clock_file(name: str, fmt="tempo", obscode=None, limits="warn",
                    bogus_last_correction=False) -> Optional[ClockFile]:
    """Locate and parse a clock file by bare name (e.g. ``time_gbt.dat``).

    Returns None (with a one-time warning) when unavailable and
    ``limits='warn'``; raises ClockCorrectionError when ``limits='error'``.
    A cached miss is re-judged against the *current* call's ``limits`` so a
    strict caller still gets the exception.
    """
    key = (name, fmt, obscode, bogus_last_correction)
    if key not in _cache:
        cf = None
        for d in clock_search_dirs():
            p = os.path.join(d, name)
            if os.path.isfile(p):
                if fmt == "tempo":
                    cf = ClockFile.read(p, fmt=fmt, obscode=obscode,
                                        bogus_last_correction=bogus_last_correction)
                else:
                    cf = ClockFile.read(p, fmt=fmt,
                                        bogus_last_correction=bogus_last_correction)
                break
        _cache[key] = cf
    cf = _cache[key]
    if cf is None:
        msg = (f"Clock file {name!r} not found in {clock_search_dirs()} — "
               f"run pint_tpu.clockcorr.update_clock_files() where the "
               f"IPTA repository is reachable (this environment has no "
               f"network); corrections treated as 0.")
        if limits == "error":
            raise ClockCorrectionError(msg)
        if name not in _warned:
            warnings.warn(msg, ClockCorrectionWarning)
            _warned.add(name)
    return cf


def gps_to_utc_correction(mjd_utc, limits="warn"):
    """GPS->UTC clock correction [s] (reference applies ``gps2utc.clk``).

    GPS time = TAI - 19 s by construction; UTC(GPS) realization differs from
    UTC by <10 ns (the downloaded file contains those residuals).  Without the
    file the correction is ~0 and we return zeros.
    """
    cf = find_clock_file("gps2utc.clk", fmt="tempo2", limits="warn")
    if cf is None:
        return np.zeros_like(np.asarray(mjd_utc, np.float64))
    return cf.evaluate(mjd_utc, limits=limits)


def bipm_correction(mjd_utc, version="BIPM2021", limits="warn"):
    """TT(BIPMxxxx) - TT(TAI) correction [s] from a tai2tt_bipmXXXX.clk file."""
    cf = find_clock_file(f"tai2tt_{version.lower()}.clk", fmt="tempo2", limits="warn")
    if cf is None:
        return np.zeros_like(np.asarray(mjd_utc, np.float64))
    return cf.evaluate(mjd_utc, limits=limits)
