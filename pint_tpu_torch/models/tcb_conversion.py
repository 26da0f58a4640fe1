"""TCB <-> TDB conversion of timing models.

Reference: `tcb_conversion.py` (`src/pint/models/tcb_conversion.py:1-159`)
and tempo2's `transform` plugin.  TCB and TDB tick at slightly different
rates; to first order a parameter x with effective time-dimensionality d
(the power of seconds in the quantity as it enters the timing formula)
converts as

    x_tdb = x_tcb * IFTE_K**(-d)        (Irwin & Fukushima 1999)

and epochs transform affinely about IFTE_MJD0.  The reference derives d
from astropy units at runtime (`parameter.py:2603`); here the same powers
are tabulated per parameter family (values cross-checked against the
reference's ``tcb2tdb_scale_factor`` annotations), since device parameters
are raw floats.

As in the reference, the conversion is approximate — the converted model
should be re-fit — and the same parameter classes are left unconverted:
TZR*, DMJUMP, FD/FDJUMP, EQUAD/ECORR/red-noise amplitudes, pair
parameters (WAVE/IFUNC), and variable-index chromatic parameters.
"""

from __future__ import annotations

import warnings
from typing import Optional

from pint_tpu_torch.models.parameter import MJDParam, split_prefix
from pint_tpu_torch.models.timing_model import TimingModel

__all__ = ["IFTE_K", "IFTE_MJD0", "convert_tcb_tdb",
           "effective_dimensionality"]

# Irwin & Fukushima 1999, as used by tempo2 (reference tcb_conversion.py:22-26)
IFTE_MJD0 = 43144.0003725
IFTE_KM1 = 1.55051979176e-8
IFTE_K = 1.0 + IFTE_KM1

#: effective time-dimensionality (power of seconds) per exact name
_DIM_EXACT = {
    "DM": -1, "NE_SW": -1,
    "PB": 1, "A1": 1,
    "M2": 1, "MTOT": 1,     # Tsun*M is a time (reference scale G/c^3)
    "OMDOT": -1,            # rad / time
    "PX": -1,               # PX*(c/au) is a rate (reference astrometry.py:79)
    "PMRA": -1, "PMDEC": -1, "PMELONG": -1, "PMELAT": -1,
    "H3": 1, "H4": 1, "STIG": 0,
    "GAMMA": 1,
    "EPS1DOT": -1, "EPS2DOT": -1, "EDOT": -1,
}

#: dimensionality of indexed families as a function of the index
_DIM_PREFIX = {
    "F": lambda k: -(k + 1),          # F0: s^-1, F1: s^-2, ...
    "DM": lambda k: -(k + 1),         # DM1 per year, ...
    "NE_SW": lambda k: -(k + 1),
    "DMX_": lambda k: -1,
    "FB": lambda k: -(k + 1),         # orbital frequency derivatives
    "GLF0_": lambda k: -1,
    "GLF1_": lambda k: -2,
    "GLF2_": lambda k: -3,
    "GLF0D_": lambda k: -1,
    "GLTD_": lambda k: 1,
    "PWF0_": lambda k: -1,
    "PWF1_": lambda k: -2,
    "PWF2_": lambda k: -3,
    "WXSIN_": lambda k: 1,            # sinusoidal delay amplitudes [s]
    "WXCOS_": lambda k: 1,
    "DMWXSIN_": lambda k: -1,
    "DMWXCOS_": lambda k: -1,
    "WXFREQ_": lambda k: -1,          # 1/d (reference wavex.py:118)
    "DMWXFREQ_": lambda k: -1,
    "JUMP": lambda k: 1,              # phase jumps are times [s]
}

#: families the reference deliberately leaves unconverted
#: (tcb_conversion.py:108-117)
_SKIP_PREFIXES = ("TZR", "DMJUMP", "FD", "EFAC", "EQUAD", "TNEQ", "ECORR",
                  "DMEFAC", "DMEQUAD", "RNAMP", "TNRED", "WAVE", "IFUNC",
                  "CM", "CMX", "CMWX", "SIFUNC", "PW_", "SWM")


def effective_dimensionality(name: str) -> Optional[int]:
    """Power of seconds for parameter ``name``, or None if it is not
    rate-converted (dimensionless, excluded, or an epoch)."""
    for skip in _SKIP_PREFIXES:
        if name.startswith(skip):
            return None
    if name in _DIM_EXACT:
        return _DIM_EXACT[name]
    try:
        stem, index = split_prefix(name)
    except ValueError:
        return None
    if stem in _DIM_PREFIX:
        return _DIM_PREFIX[stem](index)
    return None


def convert_tcb_tdb(model: TimingModel, backwards: bool = False) -> None:
    """In-place approximate conversion (reference `convert_tcb_tdb`,
    `src/pint/models/tcb_conversion.py:98`); re-fit the
    result."""
    target = "TCB" if backwards else "TDB"
    units = model.UNITS.value
    if units == target or (units is None and not backwards):
        warnings.warn("model already in target units; doing nothing")
        return
    warnings.warn(
        f"converting timing model {'TDB->TCB' if backwards else 'TCB->TDB'}:"
        " the conversion is approximate; re-fit the converted model")
    sgn = -1 if backwards else 1
    for name in model.params:
        par = model[name]
        if par.value is None or not par.convert_tcb2tdb:
            continue
        if isinstance(par, MJDParam):
            if name.startswith(_SKIP_PREFIXES):
                continue
            # t_tdb = (t_tcb - t0)/K + t0 (reference ibid:70-97)
            factor = IFTE_K if backwards else 1.0 / IFTE_K
            par.set_value((par.mjd_float - IFTE_MJD0) * factor + IFTE_MJD0)
            if par.uncertainty is not None:
                par.uncertainty *= factor
        else:
            d = effective_dimensionality(name)
            if not d:
                continue
            factor = IFTE_K ** (sgn * -d)
            try:
                par.value = par.value * factor
            except TypeError:  # non-numeric (pairs are skipped upstream)
                continue
            if par.uncertainty is not None:
                par.uncertainty *= factor
    model.UNITS.value = target
