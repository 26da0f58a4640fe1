"""Shared example configurations: the par strings of
:mod:`pint_tpu.examples` (the simulators that build TOAs for them live in
:mod:`pint_tpu` and are not ported)."""

from __future__ import annotations

#: J0740+6620-class millisecond pulsar with an ELL1 binary — the flagship
#: configuration used by bench.py (the reference's grid benchmark dataset
#: is NANOGrav J0740+6620, `profiling/bench_chisq_grid_WLSFitter.py:10-24`)
J0740_CLASS_PAR = """
PSR J0740-BENCH
RAJ 07:40:45.79 1
DECJ 66:20:33.5 1
F0 346.53199992 1
F1 -1.46e-15 1
PEPOCH 55000
POSEPOCH 55000
DM 14.96 1
BINARY ELL1
PB 4.76694461 1
A1 3.9775561 1
TASC 55000.3 1
EPS1 -5.7e-6 1
EPS2 -1.89e-5 1
M2 0.25
SINI 0.99
TZRMJD 55000.1
TZRFRQ 1400
TZRSITE gbt
EPHEM DE421
"""


def j0740_realistic_par(dmx_bins: int = 70, span_days: float = 4550.0,
                        center_mjd: float = 54975.0) -> str:
    """The flagship par grown to the real NANOGrav J0740+6620 column
    count (the reference's 176 s benchmark fit carries ~dozens of
    DMX/FD/JUMP columns, `profiling/bench_chisq_grid_WLSFitter.py:10-24`;
    the honest-width comparison): ~`dmx_bins` DMX
    windows + FD1-4 + two receiver JUMPs on top of spin/astrometry/
    binary."""
    lines = [J0740_CLASS_PAR.strip()]
    lines += ["FD1 1e-5 1", "FD2 -4e-6 1", "FD3 2e-6 1", "FD4 -1e-6 1",
              "JUMP -fe RCVR800 1e-5 1", "JUMP -fe RCVR1400L 5e-6 1"]
    lo = center_mjd - span_days / 2
    width = span_days / dmx_bins
    for i in range(1, dmx_bins + 1):
        r1 = lo + (i - 1) * width
        r2 = lo + i * width
        lines += [f"DMX_{i:04d} 0 1",
                  f"DMXR1_{i:04d} {r1:.4f}", f"DMXR2_{i:04d} {r2:.4f}"]
    return "\n".join(lines)
