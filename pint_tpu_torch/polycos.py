"""Polynomial ephemerides ("polycos"): generation, evaluation, tempo I/O.

The port of :mod:`pint_tpu.polycos` (the reference's `Polycos`,
`src/pint/polycos.py:484`), tempo polyco convention
(tempo.sourceforge.net/ref_man_sections/tz-polyco.txt):

    dt   = 1440 (T - TMID)                       [minutes]
    phi  = RPHASE + 60 dt F0 + c1 + c2 dt + c3 dt^2 + ...
    f    = F0 + (c2 + 2 c3 dt + 3 c4 dt^2 + ...) / 60   [Hz]

The absolute phases of ALL segments' sample points come from one launch
of the fused phase kernel in its words mode (``PhaseCalc.phase_frac``,
the TZR phase subtracted as pint_tpu subtracts it; the reference loops
segments, making fake TOAs per segment), rounded in quad-single so that
~1e11-cycle absolute phases lose nothing; the small per-segment
Vandermonde least-squares solves stay on the host, in float64 numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

import torch

from pint_tpu_torch import mjd as mjdmod
from pint_tpu_torch import qs
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.observatory import get_observatory
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import TOA, TOAs

__all__ = ["PolycoEntry", "Polycos", "tempo_polyco_file_reader",
           "tempo_polyco_file_writer"]

MIN_PER_DAY = 1440.0


@dataclass
class PolycoEntry:
    """One polyco segment (reference `PolycoEntry`, `polycos.py:85`)."""

    tmid: float                 # segment midpoint, UTC MJD
    mjdspan: float              # segment span [days]
    rphase_int: int             # integer part of the reference phase
    rphase_frac: float          # fractional part of the reference phase
    f0: float                   # [Hz]
    ncoeff: int
    coeffs: np.ndarray          # (ncoeff,) tempo COEFF array
    obs: str = "coe"
    obsfreq: float = np.inf     # [MHz]
    psrname: str = "PSR"
    dm: float = 0.0
    log10_rms: float = -99.0

    @property
    def tstart(self) -> float:
        return self.tmid - self.mjdspan / 2.0

    @property
    def tstop(self) -> float:
        return self.tmid + self.mjdspan / 2.0

    def dt_min(self, t_mjd) -> np.ndarray:
        return (np.asarray(t_mjd, np.float64) - self.tmid) * MIN_PER_DAY

    def evalabsphase(self, t_mjd):
        """(int, frac) absolute phase at UTC MJD(s) t."""
        dt = self.dt_min(t_mjd)
        poly = np.polynomial.polynomial.polyval(dt, self.coeffs)
        # split the big linear term exactly on the host
        lin = 60.0 * dt * self.f0
        total_frac = self.rphase_frac + poly + lin
        ip = np.floor(total_frac)
        return self.rphase_int + ip.astype(np.int64), total_frac - ip

    def evalphase(self, t_mjd):
        """Fractional phase in [0, 1)."""
        return self.evalabsphase(t_mjd)[1]

    def evalfreq(self, t_mjd) -> np.ndarray:
        """Apparent spin frequency [Hz]."""
        dt = self.dt_min(t_mjd)
        dcoef = np.polynomial.polynomial.polyder(self.coeffs)
        return self.f0 + np.polynomial.polynomial.polyval(dt, dcoef) / 60.0

    def evalfreqderiv(self, t_mjd) -> np.ndarray:
        """Apparent spin frequency derivative [Hz/s]."""
        dt = self.dt_min(t_mjd)
        d2 = np.polynomial.polynomial.polyder(self.coeffs, 2)
        return np.polynomial.polynomial.polyval(dt, d2) / (60.0**2)


class Polycos:
    """A set of polyco segments covering a time range."""

    def __init__(self, entries: Optional[List[PolycoEntry]] = None):
        self.entries: List[PolycoEntry] = entries or []

    # -- generation --------------------------------------------------------
    @classmethod
    def generate_polycos(cls, model: TimingModel, mjd_start: float,
                         mjd_end: float, obs: str = "gbt",
                         segLength: float = 60.0, ncoeff: int = 12,
                         obsFreq: float = 1400.0,
                         nsamples: int = 0, device=None) -> "Polycos":
        """Fit polycos over [mjd_start, mjd_end] (reference
        `Polycos.generate_polycos`, `polycos.py:562`).

        ``segLength`` in minutes.  All segments' model phases come from
        one words-mode launch of the phase kernel on ``device`` (the card
        unless it says otherwise; the plain composition on the CPU).
        """
        if nsamples <= 0:
            nsamples = max(2 * ncoeff, 24)
        span_days = segLength / MIN_PER_DAY
        nseg = max(1, int(np.ceil((mjd_end - mjd_start) / span_days - 1e-9)))
        tmids = mjd_start + span_days * (np.arange(nseg) + 0.5)
        # Chebyshev-ish sample nodes avoid Runge trouble at segment edges
        nodes = np.cos(np.pi * (np.arange(nsamples) + 0.5) / nsamples)
        dt_min = nodes[::-1] * (segLength / 2.0)          # (nsamples,)

        # sample epochs as exact (day, frac) two-part MJDs: a bare f64 MJD
        # near 55000 quantizes time at ulp ~0.63 us, which would imprint a
        # ~2e-4-cycle sawtooth on every sampled phase (the reference uses
        # longdouble epochs for the same reason, `polycos.py:595`)
        days = np.floor(tmids).astype(np.int64)
        fracs = tmids - np.floor(tmids)
        day_grid = np.repeat(days, nsamples)
        frac_grid = (fracs[:, None] + dt_min[None, :] / MIN_PER_DAY).ravel()

        obsname = get_observatory(obs).name
        toalist = [TOA(mjd=mjdmod.from_day_frac(int(d), float(f)),
                       error_us=1.0, freq_mhz=obsFreq, obs=obsname)
                   for d, f in zip(day_grid, frac_grid)]
        toas = TOAs(toalist)
        toas.apply_clock_corrections()
        ephem = model.EPHEM.value or "DE421"
        toas.compute_TDBs(ephem=ephem)
        toas.compute_posvels(ephem=ephem, planets=model.planets_flag)
        r = Residuals(toas, model, subtract_mean=False, device=device)
        with torch.no_grad():
            # the QS absolute phase less the TZR phase, as four words
            w = model.calc.phase_frac(r.pdict, r.batch, "words")
            ip, fp = qs.round_nearest(qs.QS(*[w[:, k] for k in range(4)]))
            fp = qs.to_f64(fp)
        ip = ip.to(torch.float64).cpu().numpy().reshape(nseg, nsamples)
        fp = fp.cpu().numpy().reshape(nseg, nsamples)

        f0 = float(model.F0.value)
        psr = model.PSR.value or "PSR"
        dm = float(model.DM.value) if "DM" in model else 0.0
        entries = []
        # fit in u = dt/half on [-1, 1]: a raw Vandermonde in minutes is
        # hopelessly ill-conditioned at degree ~12 (30^11 column range)
        half = segLength / 2.0
        u = dt_min / half
        V = np.vander(u, ncoeff, increasing=True)
        upow = half ** np.arange(ncoeff)
        for k in range(nseg):
            # reference phase: model phase at the sample nearest tmid
            imid = int(np.argmin(np.abs(dt_min)))
            rph_i = ip[k, imid]
            rph_f = fp[k, imid]
            # small residual phase after removing rphase + 60 f0 dt
            y = (ip[k] - rph_i) + (fp[k] - rph_f) - 60.0 * f0 * dt_min
            cu, *_ = np.linalg.lstsq(V, y, rcond=None)
            resid = V @ cu - y
            rms = np.sqrt(np.mean(resid**2))
            c = cu / upow          # coefficients of the dt-minutes poly
            entries.append(PolycoEntry(
                tmid=float(tmids[k]), mjdspan=span_days,
                rphase_int=int(rph_i), rphase_frac=float(rph_f),
                f0=f0, ncoeff=ncoeff, coeffs=np.asarray(c),
                obs=obsname, obsfreq=obsFreq, psrname=psr, dm=dm,
                log10_rms=float(np.log10(max(rms, 1e-99)))))
        return cls(entries)

    # -- evaluation --------------------------------------------------------
    def find_entry(self, t_mjd) -> List[int]:
        """Index of the covering segment for each time (raises if a time
        is outside every segment)."""
        t = np.atleast_1d(np.asarray(t_mjd, np.float64))
        out = np.full(len(t), -1)
        for i, e in enumerate(self.entries):
            inside = (t >= e.tstart - 1e-9) & (t <= e.tstop + 1e-9)
            out[inside] = i
        if np.any(out < 0):
            raise ValueError(
                f"times {t[out < 0]} not covered by any polyco segment")
        return out

    def eval_abs_phase(self, t_mjd):
        """(int, frac) absolute phase at UTC MJD(s)."""
        t = np.atleast_1d(np.asarray(t_mjd, np.float64))
        idx = self.find_entry(t)
        ints = np.zeros(len(t), np.int64)
        fracs = np.zeros(len(t))
        for i in np.unique(idx):
            m = idx == i
            ints[m], fracs[m] = self.entries[i].evalabsphase(t[m])
        return ints, fracs

    def eval_phase(self, t_mjd):
        return self.eval_abs_phase(t_mjd)[1]

    def eval_spin_freq(self, t_mjd):
        t = np.atleast_1d(np.asarray(t_mjd, np.float64))
        idx = self.find_entry(t)
        out = np.zeros(len(t))
        for i in np.unique(idx):
            m = idx == i
            out[m] = self.entries[i].evalfreq(t[m])
        return out

    # -- I/O ---------------------------------------------------------------
    def write_polyco_file(self, filename: str = "polyco.dat"):
        tempo_polyco_file_writer(self, filename)

    @classmethod
    def read_polyco_file(cls, filename: str) -> "Polycos":
        return tempo_polyco_file_reader(filename)


def _fortran_e(x: float, width: int = 25, prec: int = 17) -> str:
    """Fortran D-exponent float field, as tempo writes coefficients."""
    s = f"{x:{width}.{prec}e}"
    return s.replace("e", "D")


def tempo_polyco_file_writer(polycos: Polycos,
                             filename: str = "polyco.dat"):
    """Write tempo-format polyco.dat (reference
    `tempo_polyco_table_writer`, `polycos.py:360`)."""
    lines = []
    for e in polycos.entries:
        day, frac = int(np.floor(e.tmid)), e.tmid - np.floor(e.tmid)
        sec = frac * 86400.0
        hh, rem = divmod(sec, 3600.0)
        mm, ss = divmod(rem, 60.0)
        utc = f"{int(hh):02d}{int(mm):02d}{ss:05.2f}"
        obscode = get_observatory(e.obs).tempo_code or "0"
        rphase = e.rphase_int + e.rphase_frac
        # TMID at .13f (fits the 20-char column): .11f would quantize the
        # epoch at 0.86 us ~ 3e-4 cycles for a millisecond pulsar
        lines.append(
            f"{e.psrname:10.10s} {'DD-MMM-YY':>9s}{float(utc):>12.2f}"
            f"{e.tmid:20.13f}{e.dm:21.6f}{0.0:7.3f}{e.log10_rms:7.3f}\n")
        lines.append(
            f"{rphase:20.6f}{e.f0:18.12f}{obscode:>5s}"
            f"{e.mjdspan * MIN_PER_DAY:5.0f}{e.ncoeff:5d}"
            f"{e.obsfreq:21.3f}\n")
        for i in range(0, e.ncoeff, 3):
            chunk = e.coeffs[i:i + 3]
            lines.append("".join(_fortran_e(c) for c in chunk) + "\n")
    with open(filename, "w") as f:
        f.write("".join(lines))


def tempo_polyco_file_reader(filename: str) -> Polycos:
    """Read tempo-format polyco.dat (reference
    `tempo_polyco_table_reader`, `polycos.py:232`)."""
    entries = []
    with open(filename) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    i = 0
    while i < len(lines):
        h1 = lines[i].split()
        psr = h1[0]
        tmid = float(h1[3])
        dm = float(h1[4])
        logrms = float(h1[-1])
        h2 = lines[i + 1]
        rphase = float(h2[0:20])
        f0 = float(h2[20:38])
        obscode = h2[38:43].strip()
        span_min = float(h2[43:48])
        ncoeff = int(h2[48:53])
        obsfreq = float(h2[53:74])
        ncl = (ncoeff + 2) // 3
        coeffs = []
        for ln in lines[i + 2:i + 2 + ncl]:
            coeffs += [float(x.replace("D", "e"))
                       for x in ln.split()]
        i += 2 + ncl
        rint = int(np.floor(rphase))
        entries.append(PolycoEntry(
            tmid=tmid, mjdspan=span_min / MIN_PER_DAY,
            rphase_int=rint, rphase_frac=rphase - rint, f0=f0,
            ncoeff=ncoeff, coeffs=np.asarray(coeffs[:ncoeff]),
            obs=obscode, obsfreq=obsfreq, psrname=psr, dm=dm,
            log10_rms=logrms))
    return Polycos(entries)
