"""Typed model parameters.

The analogue of the reference's parameter zoo
(`src/pint/models/parameter.py`): each parameter knows its
name, aliases, par-file units, frozen/fittable state, and uncertainty, and can
round-trip a ``.par`` line.  Two representations coexist:

* the **host value** in par-file units (what users see; exact-MJD /
  sexagesimal strings are parsed losslessly), and
* the **device value** in canonical internal units (radians, seconds, Hz,
  pc/cm^3, ...) — the entry that lands in the params pytree consumed by the
  jitted component functions.  ``par2dev`` is the fixed conversion factor.

Bool/str/int parameters configure the *structure* of the compiled model and
never enter the pytree.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pint_tpu_torch import mjd as mjdmod
from pint_tpu_torch.mjd import MJD

__all__ = [
    "Param", "FloatParam", "MJDParam", "AngleParam", "StrParam", "BoolParam",
    "IntParam", "MaskParam", "PairParam", "prefixParameter", "maskParameter",
    "funcParameter", "parse_number",
]

# fortran-style exponents appear in tempo-era par files
_FORT = re.compile(r"[dD]")


def parse_number(s: str) -> float:
    return float(_FORT.sub("e", s))


def _fmt(x: float) -> str:
    """Repr-exact but compact float formatting for par output."""
    x = float(x)
    if math.isfinite(x) and x == int(x) and abs(x) < 1e16:
        return str(int(x)) + ".0"
    return repr(x)


class Param:
    """Base parameter: metadata + par-line round-trip."""

    kind = "abstract"
    #: does this parameter enter the device params pytree?
    on_device = False

    def __init__(self, name: str, value=None, units: str = "",
                 description: str = "", aliases: Sequence[str] = (),
                 frozen: bool = True, uncertainty: Optional[float] = None,
                 par2dev: float = 1.0, convert_tcb2tdb: bool = True,
                 tcb2tdb_scale_factor: Optional[float] = None):
        self.name = name
        self.value = value
        self.units = units
        self.description = description
        self.aliases = list(aliases)
        self.frozen = frozen
        self.uncertainty = uncertainty      # par-file units
        self.par2dev = par2dev
        self.convert_tcb2tdb = convert_tcb2tdb
        self.tcb2tdb_scale_factor = tcb2tdb_scale_factor
        #: "prefix" bookkeeping (F0/F1..., DMX_0001...): set by prefixParameter
        self.prefix: Optional[str] = None
        self.index: Optional[int] = None

    # -- value handling ---------------------------------------------------
    def set_from_string(self, s: str):
        raise NotImplementedError

    def value_as_string(self) -> str:
        raise NotImplementedError

    @property
    def device_value(self):
        raise NotImplementedError(f"{self.name} has no device representation")

    def set_device_value(self, v):
        raise NotImplementedError

    @property
    def device_uncertainty(self) -> Optional[float]:
        return None if self.uncertainty is None else self.uncertainty * self.par2dev

    def set_device_uncertainty(self, u: float):
        self.uncertainty = float(u) / self.par2dev

    # -- par I/O ----------------------------------------------------------
    def from_parfile_line(self, fields: List[str]):
        """fields = [NAME, value, [fit], [uncertainty]] (already split)."""
        self.set_from_string(fields[1])
        if len(fields) >= 3:
            try:
                fit = int(fields[2])
                self.frozen = fit == 0
            except ValueError:
                # third field is an uncertainty, not a fit flag
                self.uncertainty = parse_number(fields[2])
        if len(fields) >= 4:
            self.uncertainty = parse_number(fields[3])

    def as_parfile_line(self) -> str:
        if self.value is None:
            return ""
        line = f"{self.name:15s} {self.value_as_string():>25s}"
        if not self.frozen:
            line += " 1"
        elif self.uncertainty is not None:
            line += " 0"
        if self.uncertainty is not None:
            line += f" {self.uncertainty_as_string()}"
        return line + "\n"

    def uncertainty_as_string(self) -> str:
        return _fmt(float(self.uncertainty))

    def __repr__(self):  # pragma: no cover
        return (f"{type(self).__name__}({self.name}={self.value}"
                f"{' frozen' if self.frozen else ' FIT'})")


class FloatParam(Param):
    """A real-valued physical parameter (reference ``floatParameter``,
    `src/pint/models/parameter.py:623`).

    ``unit_scale``: tempo-convention implicit 1e-12 scaling (PBDOT, XDOT,
    EDOT...): par files write either the physical value (~1e-12) or the
    value in units of 1e-12; magnitudes above ``scale_threshold`` are
    multiplied by ``scale_factor`` (reference `parameter.py:623`,
    `pulsar_binary.py:110-113`)."""

    kind = "float"
    on_device = True

    def __init__(self, name, value=None, units="", long_double=False,
                 unit_scale=False, scale_factor=1e-12, scale_threshold=1e-7,
                 **kw):
        # long_double is accepted for signature parity; device math is dd/f64
        super().__init__(name, value=value, units=units, **kw)
        self.unit_scale = unit_scale
        self.scale_factor = scale_factor
        self.scale_threshold = scale_threshold

    def set_from_string(self, s: str):
        v = parse_number(s)
        if self.unit_scale and abs(v) > self.scale_threshold:
            v *= self.scale_factor
        self.value = v

    def from_parfile_line(self, fields: List[str]):
        super().from_parfile_line(fields)
        # the uncertainty is thresholded on its own magnitude (a par file
        # may give an explicit 1e-12-scale value with a bare-convention
        # uncertainty, reference `parameter.py` _set_uncertainty)
        if self.unit_scale and self.uncertainty is not None and \
                abs(self.uncertainty) > self.scale_threshold:
            self.uncertainty *= self.scale_factor

    def value_as_string(self) -> str:
        return _fmt(self.value)

    @property
    def device_value(self) -> float:
        return float(self.value) * self.par2dev

    def set_device_value(self, v):
        self.value = float(v) / self.par2dev


class IntParam(Param):
    kind = "int"

    def set_from_string(self, s: str):
        self.value = int(float(s))

    def value_as_string(self) -> str:
        return str(self.value)


class BoolParam(Param):
    kind = "bool"

    _TRUE = {"1", "Y", "YES", "T", "TRUE"}
    _FALSE = {"0", "N", "NO", "F", "FALSE"}

    def set_from_string(self, s: str):
        u = s.strip().upper()
        if u in self._TRUE:
            self.value = True
        elif u in self._FALSE:
            self.value = False
        else:
            raise ValueError(f"cannot parse boolean {self.name} from {s!r}")

    def value_as_string(self) -> str:
        return "Y" if self.value else "N"

    def as_parfile_line(self) -> str:
        if self.value is None:
            return ""
        return f"{self.name:15s} {self.value_as_string():>25s}\n"


class StrParam(Param):
    kind = "str"

    def set_from_string(self, s: str):
        self.value = s

    def value_as_string(self) -> str:
        return str(self.value)

    def as_parfile_line(self) -> str:
        if self.value is None:
            return ""
        return f"{self.name:15s} {self.value_as_string():>25s}\n"


class MJDParam(Param):
    """An epoch parameter held as an exact (day, frac) pair (reference
    ``MJDParameter``, `src/pint/models/parameter.py:1066`).

    Device representation: float64 array ``[day, frac]``.  Fitting moves only
    the fraction; the day part is quasi-static.  Resolution 19 ps.
    """

    kind = "mjd"
    on_device = True

    def __init__(self, name, value=None, units="d", **kw):
        super().__init__(name, value=None, units=units, **kw)
        if value is not None:
            self.set_value(value)

    def set_value(self, v):
        if isinstance(v, MJD):
            self.value = v
        elif isinstance(v, str):
            self.value = mjdmod.from_string(v)
        else:
            self.value = mjdmod.from_mjd_float(float(v))

    def set_from_string(self, s: str):
        self.value = mjdmod.from_string(s)

    def value_as_string(self) -> str:
        day, frac = int(self.value.day), float(self.value.frac)
        fs = f"{frac:.16f}"
        if fs.startswith("1"):
            day, fs = day + 1, f"{0.0:.16f}"
        return f"{day}{fs[1:]}"

    @property
    def device_value(self) -> np.ndarray:
        return np.array([float(self.value.day), float(self.value.frac)])

    def set_device_value(self, v):
        self.value = mjdmod.from_day_frac(int(round(float(v[0]))), float(v[1]))

    @property
    def mjd_float(self) -> float:
        return float(self.value.mjd_float)


def _parse_sexagesimal(s: str) -> Tuple[float, float, float, int]:
    sign = -1 if s.strip().startswith("-") else 1
    parts = s.strip().lstrip("+-").split(":")
    if len(parts) == 1:
        return float(parts[0]), 0.0, 0.0, sign
    if len(parts) == 2:
        return float(parts[0]), float(parts[1]), 0.0, sign
    return float(parts[0]), float(parts[1]), float(parts[2]), sign


class AngleParam(Param):
    """An angle parameter; value stored in **radians**.

    ``units`` selects the par-file convention: ``"H:M:S"`` (RAJ, uncertainty
    in seconds of hourangle), ``"D:M:S"`` (DECJ, uncertainty in arcsec), or
    ``"deg"`` (ecliptic coordinates, uncertainty in degrees).  cf. reference
    ``AngleParameter`` (`src/pint/models/parameter.py:1256`).
    """

    kind = "angle"
    on_device = True

    def __init__(self, name, value=None, units="deg", **kw):
        super().__init__(name, value=value, units=units, **kw)

    def set_from_string(self, s: str):
        if self.units == "H:M:S":
            h, m, sec, sign = _parse_sexagesimal(s)
            self.value = sign * (h + m / 60 + sec / 3600) * math.pi / 12.0
        elif self.units == "D:M:S":
            d, m, sec, sign = _parse_sexagesimal(s)
            self.value = sign * (d + m / 60 + sec / 3600) * math.pi / 180.0
        else:  # decimal degrees
            self.value = parse_number(s) * math.pi / 180.0

    def value_as_string(self) -> str:
        if self.units == "H:M:S":
            return self._sexagesimal(self.value * 12.0 / math.pi, 13)
        if self.units == "D:M:S":
            return self._sexagesimal(self.value * 180.0 / math.pi, 12)
        return f"{self.value * 180.0 / math.pi:.15f}"

    @staticmethod
    def _sexagesimal(x: float, secdigits: int) -> str:
        sign = "-" if x < 0 else ""
        x = abs(x)
        d = int(x)
        m = int((x - d) * 60)
        s = ((x - d) * 60 - m) * 60
        if s >= 60 - 0.5 * 10 ** (-secdigits):  # carry
            s = 0.0
            m += 1
            if m == 60:
                m, d = 0, d + 1
        return f"{sign}{d:02d}:{m:02d}:{s:0{3 + secdigits}.{secdigits}f}"

    @property
    def device_value(self) -> float:
        return float(self.value)

    def set_device_value(self, v):
        self.value = float(v)

    # uncertainties are quoted in per-convention units
    @property
    def device_uncertainty(self):
        if self.uncertainty is None:
            return None
        if self.units == "H:M:S":       # seconds of hourangle
            return self.uncertainty * math.pi / (12 * 3600)
        if self.units == "D:M:S":       # arcseconds
            return self.uncertainty * math.pi / (180 * 3600)
        return self.uncertainty * math.pi / 180.0

    def set_device_uncertainty(self, u: float):
        if self.units == "H:M:S":
            self.uncertainty = float(u) * (12 * 3600) / math.pi
        elif self.units == "D:M:S":
            self.uncertainty = float(u) * (180 * 3600) / math.pi
        else:
            self.uncertainty = float(u) * 180.0 / math.pi


class MaskParam(FloatParam):
    """A float parameter applying only to a flag/frequency/MJD/telescope-
    selected subset of TOAs (reference ``maskParameter``,
    `src/pint/models/parameter.py:1784`).

    Par syntax: ``JUMP -fe L-wide 0.2 1`` / ``EFAC mjd 57000 58000 1.1`` /
    ``EQUAD tel ao 0.5`` / ``JUMP freq 1400 1500 1e-6``.
    The boolean TOA mask is computed host-side (:meth:`select_mask`) and
    enters the pytree alongside the value as ``<NAME><index>__mask``.
    """

    kind = "mask"

    def __init__(self, name, index=1, key=None, key_value=(), **kw):
        super().__init__(name if name.endswith(str(index)) or index is None
                         else f"{name}{index}", **kw)
        self.prefix = name if index is not None else None
        self.index = index
        self.key = key              # 'mjd' | 'freq' | 'tel' | '-<flag>'
        self.key_value = list(key_value)

    def from_parfile_line(self, fields: List[str]):
        """fields = [NAME, key, key_val..., value, [fit], [uncert]]."""
        key = fields[1]
        if key.startswith("-"):
            self.key, self.key_value = key, [fields[2]]
            rest = fields[3:]
        elif key.lower() in ("mjd", "freq"):
            self.key = key.lower()
            self.key_value = [parse_number(fields[2]), parse_number(fields[3])]
            rest = fields[4:]
        elif key.lower() in ("tel",):
            self.key, self.key_value = "tel", [fields[2]]
            rest = fields[3:]
        else:
            raise ValueError(
                f"cannot parse mask selection {key!r} for {self.name}")
        if rest:
            self.set_from_string(rest[0])
        if len(rest) >= 2:
            try:
                self.frozen = int(rest[1]) == 0
            except ValueError:
                self.uncertainty = parse_number(rest[1])
        if len(rest) >= 3:
            self.uncertainty = parse_number(rest[2])

    def as_parfile_line(self) -> str:
        if self.value is None:
            return ""
        name = self.prefix or self.name
        if self.key is None:
            keypart = ""
        elif self.key in ("mjd", "freq"):
            keypart = f"{self.key} {self.key_value[0]} {self.key_value[1]}"
        else:
            keypart = f"{self.key} {self.key_value[0]}"
        line = f"{name} {keypart} {self.value_as_string()}"
        if not self.frozen:
            line += " 1"
        if self.uncertainty is not None:
            line += f" {self.uncertainty_as_string()}"
        return line + "\n"

    def select_mask(self, toas) -> np.ndarray:
        """Boolean mask over a host TOAs object (cf. reference
        ``maskParameter.select_toa_mask`` + ``TOASelect``,
        `src/pint/toa_select.py:8`)."""
        n = toas.ntoas
        if self.key is None:
            return np.ones(n, bool)
        if self.key == "mjd":
            m = toas.utc.mjd_float
            lo, hi = sorted(self.key_value)
            return (m >= lo) & (m <= hi)
        if self.key == "freq":
            lo, hi = sorted(self.key_value)
            return (toas.freq_mhz >= lo) & (toas.freq_mhz <= hi)
        if self.key == "tel":
            from pint_tpu_torch.observatory import get_observatory

            want = get_observatory(str(self.key_value[0])).name
            return np.asarray(toas.obs) == want
        flag = self.key.lstrip("-")
        want = str(self.key_value[0])
        return np.array([f.get(flag) == want for f in toas.flags])

    @property
    def mask_pytree_name(self) -> str:
        return f"{self.name}__mask"


class PairParam(Param):
    """Two values on one line (reference ``pairParameter``,
    `src/pint/models/parameter.py:2198`)."""

    kind = "pair"
    on_device = True

    def set_from_string(self, s: str):
        a, b = s.split()
        self.value = (parse_number(a), parse_number(b))

    def from_parfile_line(self, fields: List[str]):
        self.value = (parse_number(fields[1]), parse_number(fields[2]))

    def value_as_string(self) -> str:
        return f"{_fmt(self.value[0])} {_fmt(self.value[1])}"

    @property
    def device_value(self) -> np.ndarray:
        return np.array(self.value) * self.par2dev

    def set_device_value(self, v):
        self.value = (float(v[0]) / self.par2dev, float(v[1]) / self.par2dev)


class funcParameter(Param):
    """A read-only derived parameter (reference ``funcParameter``,
    `src/pint/models/parameter.py:2375`)."""

    kind = "func"

    def __init__(self, name, func=None, params=(), units="", **kw):
        super().__init__(name, units=units, **kw)
        self.func = func
        self.source_params = list(params)
        self._model = None

    def bind(self, model):
        self._model = model

    @property
    def value(self):
        if self._model is None or self.func is None:
            return None
        vals = [getattr(self._model, p).value for p in self.source_params]
        if any(v is None for v in vals):
            return None
        return self.func(*vals)

    @value.setter
    def value(self, v):
        if v is not None:
            raise AttributeError(f"{self.name} is derived and read-only")

    def set_from_string(self, s: str):
        raise ValueError(
            f"{self.name} is a derived (read-only) parameter of this model"
            + (f", computed from {self.source_params}; set those instead"
               if self.source_params else ""))

    def value_as_string(self) -> str:
        return _fmt(float(self.value))

    def as_parfile_line(self) -> str:
        return ""


def prefixParameter(parameter_type="float", name="", index=None, prefix=None,
                    units="", description_template=None, **kw) -> Param:
    """Build an indexed member of a prefix family (F0..Fn, DMX_0001...,
    WXSIN_0001...); cf. reference ``prefixParameter``
    (`src/pint/models/parameter.py:1436`)."""
    cls = {"float": FloatParam, "mjd": MJDParam, "pair": PairParam}[parameter_type]
    if prefix is None:
        prefix, index = split_prefix(name)
    elif not name:
        name = make_prefixed_name(prefix, index)
    desc = description_template(index) if description_template else \
        kw.pop("description", "")
    p = cls(name, units=units, description=desc, **kw)
    p.prefix = prefix
    p.index = index
    return p


def maskParameter(name, index=1, **kw) -> MaskParam:
    return MaskParam(name, index=index, **kw)


_PREFIX_RE = re.compile(r"^([A-Za-z0-9_]*[A-Za-z_])(\d+)$")


def split_prefix(name: str) -> Tuple[str, int]:
    m = _PREFIX_RE.match(name)
    if m is None:
        raise ValueError(f"{name!r} is not a prefixed parameter name")
    return m.group(1), int(m.group(2))


def make_prefixed_name(prefix: str, index: int) -> str:
    if prefix.endswith("_"):
        return f"{prefix}{index:04d}"
    return f"{prefix}{index}"
