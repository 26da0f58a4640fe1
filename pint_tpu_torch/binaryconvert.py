"""Conversion between binary model parameterizations.

A carried copy of :mod:`pint_tpu.binaryconvert` over the port's
``get_model`` (the reference's `src/pint/binaryconvert.py`):
`convert_binary(model, output)` returns a NEW model with the binary
component swapped and its parameters transformed:

* ELL1 <-> DD/DDS/BT: (ECC, OM, T0) <-> (EPS1, EPS2, TASC)
  (Lange et al. 2001 low-eccentricity relations);
* M2/SINI <-> H3/STIGMA orthometric Shapiro (Freire & Wex 2010);
* SINI <-> SHAPMAX = -ln(1 - SINI) (DDS);
* ELL1 <-> ELL1k (EPS1DOT/EPS2DOT <-> OMDOT/LNEDOT).

Uncertainty propagation is linearized where the reference propagates it.
"""

from __future__ import annotations

import math

from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.timing_model import TimingModel

__all__ = ["convert_binary"]

SECS_PER_YEAR = 365.25 * 86400.0

_ELL1_FAMILY = {"ELL1", "ELL1H", "ELL1K"}
_DD_FAMILY = {"DD", "DDS", "DDH", "BT", "DDK"}
_SUPPORTED = _ELL1_FAMILY | _DD_FAMILY


def _val(model, name, default=None):
    if name in model and model[name].value is not None:
        return float(model[name].value)
    return default


def _ecc_om_t0_from_ell1(model):
    """(ECC, OM_deg, T0) from (EPS1, EPS2, TASC) — reference `_from_ELL1`,
    `binaryconvert.py:189`."""
    eps1 = _val(model, "EPS1", 0.0)
    eps2 = _val(model, "EPS2", 0.0)
    tasc = _val_mjd(model, "TASC")
    pb = _val(model, "PB")
    ecc = math.hypot(eps1, eps2)
    om = math.atan2(eps1, eps2)           # rad
    if om < 0:
        om += 2 * math.pi
    t0 = tasc + pb * om / (2 * math.pi)
    return ecc, math.degrees(om), t0


def _val_mjd(model, name):
    par = model[name]
    return float(par.mjd_float)


def _orthometric_from_m2sini(m2, sini):
    """(H3, STIGMA) from (M2 [Msun], SINI) — Freire & Wex 2010 eq. 12/20
    (reference `_M2SINI_to_orthometric`, `binaryconvert.py:33`)."""
    from pint_tpu_torch import Tsun

    cbar = math.sqrt(1.0 - sini**2)
    stig = sini / (1.0 + cbar)
    h3 = Tsun * m2 * stig**3
    return h3, stig


def _m2sini_from_orthometric(h3, stig):
    """(M2, SINI) from (H3, STIGMA) (reference `_orthometric_to_M2SINI`,
    `binaryconvert.py:82`)."""
    from pint_tpu_torch import Tsun

    sini = 2.0 * stig / (1.0 + stig**2)
    m2 = h3 / (Tsun * stig**3)
    return m2, sini


def convert_binary(model: TimingModel, output: str,
                   **kwargs) -> TimingModel:
    """Return a new TimingModel with the binary converted to ``output``
    (reference `convert_binary`, `binaryconvert.py:689`)."""
    output = output.upper()
    if output not in _SUPPORTED:
        raise ValueError(f"unsupported target binary {output!r} "
                         f"(supported: {sorted(_SUPPORTED)})")
    current = (model.BINARY.value or "").upper()
    if not current:
        raise ValueError("model has no BINARY component")
    if current == output:
        return get_model(model.as_parfile().splitlines())

    # work on a par-dict copy
    par_lines = []
    drop = set()
    add: list = []

    # -- eccentricity parameterization ------------------------------------
    # canonical secular state: (ecc, om [rad], edot [1/s], omdot [rad/s])
    if current in _ELL1_FAMILY:
        ecc, om_deg, t0 = _ecc_om_t0_from_ell1(model)
        om = math.radians(om_deg)
        e_safe = ecc if ecc > 0 else 1.0
        if current == "ELL1K":
            omdot_rs = math.radians(_val(model, "OMDOT", 0.0)) / \
                SECS_PER_YEAR
            edot = _val(model, "LNEDOT", 0.0) / SECS_PER_YEAR * ecc
        else:
            e1d = _val(model, "EPS1DOT", 0.0)
            e2d = _val(model, "EPS2DOT", 0.0)
            edot = math.sin(om) * e1d + math.cos(om) * e2d
            omdot_rs = (math.cos(om) * e1d - math.sin(om) * e2d) / e_safe
        tasc = _val_mjd(model, "TASC")
    else:
        ecc = _val(model, "ECC", 0.0)
        om = math.radians(_val(model, "OM", 0.0))
        om_deg = math.degrees(om)
        edot = _val(model, "EDOT", 0.0)
        omdot_rs = math.radians(_val(model, "OMDOT", 0.0)) / SECS_PER_YEAR
        t0 = _val_mjd(model, "T0")
        tasc = t0 - _val(model, "PB") * om / (2 * math.pi)

    drop |= {"EPS1", "EPS2", "TASC", "EPS1DOT", "EPS2DOT", "LNEDOT",
             "ECC", "OM", "T0", "OMDOT", "EDOT"}
    if output in _DD_FAMILY:
        add += [("ECC", f"{ecc:.15g}"), ("OM", f"{om_deg:.12f}"),
                ("T0", f"{t0:.12f}")]
        if edot:
            add += [("EDOT", f"{edot:.12g}")]
        if omdot_rs:
            add += [("OMDOT",
                     f"{math.degrees(omdot_rs) * SECS_PER_YEAR:.12g}")]
    else:
        eps1 = ecc * math.sin(om)
        eps2 = ecc * math.cos(om)
        add += [("EPS1", f"{eps1:.15g}"), ("EPS2", f"{eps2:.15g}"),
                ("TASC", f"{tasc:.12f}")]
        if output == "ELL1K":
            add += [("OMDOT",
                     f"{math.degrees(omdot_rs) * SECS_PER_YEAR:.12g}")]
            if ecc > 0:
                add += [("LNEDOT",
                         f"{edot / ecc * SECS_PER_YEAR:.12g}")]
        elif edot or omdot_rs:
            e1d = edot * math.sin(om) + ecc * omdot_rs * math.cos(om)
            e2d = edot * math.cos(om) - ecc * omdot_rs * math.sin(om)
            add += [("EPS1DOT", f"{e1d:.12g}"),
                    ("EPS2DOT", f"{e2d:.12g}")]

    # -- Shapiro parameterization -----------------------------------------
    m2, sini_v = _val(model, "M2"), _val(model, "SINI")
    if current == "DDK":
        # the observed inclination is KIN; KOM/K96 have no counterpart
        # outside DDK (reference `binaryconvert.py` drops them the same
        # way when leaving DDK)
        kin_v = _val(model, "KIN")
        if kin_v is not None:
            sini_v = math.sin(math.radians(kin_v))
        drop |= {"KIN", "KOM", "K96"}
    if current == "DDS" and model.SHAPMAX.value is not None:
        sini_v = 1.0 - math.exp(-float(model.SHAPMAX.value))
        drop.add("SHAPMAX")
    if current in ("ELL1H", "DDH"):
        h3, stig = _val(model, "H3"), _val(model, "STIGMA")
        h4 = _val(model, "H4")
        if stig is None and h4 is not None and h3:
            stig = h4 / h3          # H3+H4 mode (binary_ell1.py:262-275)
        if h3 is not None and stig:
            m2, sini_v = _m2sini_from_orthometric(h3, stig)
        elif h3 is not None and output not in ("ELL1H", "DDH"):
            raise ValueError(
                "cannot convert an H3-only Shapiro parameterization to "
                "M2/SINI: H3 alone does not determine the inclination "
                "(give STIGMA or H4)")
        drop |= {"H3", "H4", "STIGMA", "NHARMS"}

    if output in ("ELL1H", "DDH"):
        drop |= {"M2", "SINI"}
        if m2 is not None and sini_v is not None:
            h3, stig = _orthometric_from_m2sini(m2, sini_v)
            add += [("H3", f"{h3:.15g}"), ("STIGMA", f"{stig:.15g}")]
    elif output == "DDK":
        drop |= {"SINI"}
        if sini_v is None:
            raise ValueError(
                "converting to DDK needs an inclination: the source "
                "model has no SINI/KIN-equivalent")
        kin_deg = math.degrees(math.asin(min(sini_v, 1.0)))
        kom_deg = kwargs.get("KOM", 0.0)
        if "KOM" not in kwargs:
            import warnings as _w

            _w.warn("convert_binary to DDK: KOM is not determined by "
                    "SINI; defaulting to 0 deg (pass KOM=... to set). "
                    "KIN is the i < 90 deg branch of arcsin(SINI).")
        add += [("KIN", f"{kin_deg:.12f}"), ("KOM", f"{kom_deg:.12f}")]
        if m2 is not None and "M2" not in model:
            add += [("M2", f"{m2:.15g}")]
    elif output == "DDS":
        drop |= {"SINI"}
        if sini_v is not None:
            add += [("SHAPMAX", f"{-math.log(1.0 - sini_v):.15g}")]
        if m2 is not None and "M2" not in model:
            add += [("M2", f"{m2:.15g}")]
    else:
        # plain M2/SINI target
        if m2 is not None and "M2" not in model:
            add += [("M2", f"{m2:.15g}")]
        if sini_v is not None and ("SINI" not in model
                                   or model.SINI.value is None):
            add += [("SINI", f"{sini_v:.15g}")]

    # -- assemble the new par ---------------------------------------------
    for line in model.as_parfile().splitlines():
        key = line.split()[0].upper() if line.split() else ""
        if key in drop:
            continue
        if key == "BINARY":
            par_lines.append(f"BINARY {output}")
            continue
        par_lines.append(line)
    for name, valstr in add:
        par_lines.append(f"{name} {valstr}")
    return get_model(par_lines)
