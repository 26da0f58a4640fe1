"""BT and DD binary models: full Keplerian orbits.

Port of the BT/DD part of :mod:`pint_tpu.models.binary_dd` (reference
`BinaryBT`/`BinaryDD`, `src/pint/models/binary_bt.py:17`,
`binary_dd.py:34`, delegating to `stand_alone_psr_binaries/BT_model.py`
and `DD_model.py`; Blandford & Teukolsky 1976, Damour & Deruelle 1986).
DDS, DDH, DDK, DDGR and BT_piecewise are not ported yet.

The eccentric anomaly comes from the ``kepler_E`` CUDA kernel
(:func:`pint_tpu_torch.kernels.kepler.kepler_E_op`, its plain version on
the CPU) with pint_tpu's implicit-function tangent; the rest of the delay
is one elementwise chain, and the fitters autodiff through it.
"""

from __future__ import annotations

import math
from typing import List

import torch

from pint_tpu_torch import Tsun
from pint_tpu_torch.kernels.kepler import kepler_E_op
from pint_tpu_torch.models.binary_orbits import (
    OrbwaveMixin,
    clip_unit,
    orbits_and_freq,
    true_anomaly_continuous,
)
from pint_tpu_torch.models.parameter import (
    FloatParam,
    MJDParam,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.spindown import dt_seconds_qs
from pint_tpu_torch.models.timing_model import DelayComponent, pv
from pint_tpu_torch.toabatch import TOABatch

SECS_PER_DAY = 86400.0
SECS_PER_YEAR = 365.25 * SECS_PER_DAY
DEG_PER_YEAR = (math.pi / 180.0) / SECS_PER_YEAR
DEG = math.pi / 180.0


class BinaryDDBase(OrbwaveMixin, DelayComponent):
    """Shared Keplerian machinery (T0/ECC/OM parameterization)."""

    category = "pulsar_system"
    #: omega advances as OM + (OMDOT/n) * true anomaly (DD eq. between
    #: [16] and [17]); BT instead uses the linear-in-time form
    omega_from_nu = True

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam("PB", units="d", par2dev=SECS_PER_DAY,
                                  description="Orbital period"))
        self.add_param(FloatParam("PBDOT", value=0.0, units="d/d",
                                  unit_scale=True,
                                  description="Orbital period derivative"))
        self.add_param(FloatParam("A1", units="ls",
                                  description="Projected semi-major axis"))
        self.add_param(FloatParam("A1DOT", value=0.0, units="ls/s",
                                  aliases=["XDOT"], unit_scale=True,
                                  description="d(A1)/dt"))
        self.add_param(MJDParam("T0",
                                description="Epoch of periastron"))
        self.add_param(FloatParam("ECC", units="", aliases=["E"],
                                  description="Eccentricity"))
        self.add_param(FloatParam("EDOT", value=0.0, units="1/s",
                                  unit_scale=True,
                                  description="Eccentricity derivative"))
        self.add_param(FloatParam("OM", units="deg", par2dev=DEG,
                                  description="Longitude of periastron"))
        self.add_param(FloatParam("OMDOT", value=0.0, units="deg/yr",
                                  par2dev=DEG_PER_YEAR,
                                  description="Periastron advance rate"))
        self.add_param(FloatParam("GAMMA", value=0.0, units="s",
                                  description="Einstein-delay amplitude"))
        self.add_param(prefixParameter(
            "float", "FB0", units="1/s", frozen=True,
            description_template=lambda i:
            f"Orbital frequency derivative {i}" if i else
            "Orbital frequency (alternative to PB)"))
        self._init_orbwave_params()

    def make_param(self, name: str):
        try:
            stem, index = split_prefix(name)
        except ValueError:
            return None
        if stem == "FB":
            return prefixParameter("float", name, units=f"1/s^{index + 1}",
                                   description_template=lambda i:
                                   f"Orbital frequency derivative {i}")
        return self._make_orbwave_param(stem, name)

    def prefix_families(self):
        # ORBWAVEC/S exist only on demand; FB is discoverable via FB0
        return ["ORBWAVEC", "ORBWAVES"]

    def fb_names(self) -> List[str]:
        return [q.name for q in self.prefix_params("FB")
                if q.value is not None]

    def validate(self):
        self.require("A1", "T0", "ECC", "OM")
        if self.PB.value is None and not self.fb_names():
            from pint_tpu_torch.exceptions import MissingParameter

            raise MissingParameter(
                f"{type(self).__name__} requires PB or FB0")
        fbs = self.fb_names()
        for i, n in enumerate(fbs):
            if n != f"FB{i}":
                raise ValueError(
                    f"non-contiguous FB series at {n}: FB indices must "
                    "run 0..k without gaps")
        if not 0.0 <= self.ECC.value < 1.0:
            raise ValueError("ECC must be in [0, 1)")
        self._validate_orbwaves()

    # -- hooks for the model variants -------------------------------------
    def d_r(self, p):
        """Relativistic deformation of the radial eccentricity (DR)."""
        return 0.0

    def d_th(self, p):
        """Relativistic deformation of the angular eccentricity (DTH)."""
        return 0.0

    def shapiro_delay(self, p, e, E, omega, batch, dt):
        return torch.zeros_like(E)

    def aberration_delay(self, p, e, nu, omega):
        return torch.zeros_like(nu)

    def _dt(self, p, batch, delay):
        """(t_bary - T0) [s], f64 (exact two-part difference)."""
        return dt_seconds_qs(p, batch, delay, "T0")[1]

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        dt = self._dt(p, batch, delay)
        orbits, forb = self._apply_orbwaves(
            p, batch, delay, *orbits_and_freq(p, dt, self.fb_names()))
        frac = orbits - torch.floor(orbits)
        M = 2.0 * math.pi * frac
        # saturate once where e is formed: every downstream expression
        # (kepler solve, sqrt(1-e^2), nhat = n/(1-e cosE), true anomaly)
        # must stay finite for out-of-range trial steps; clip_unit keeps
        # the ECC gradient alive so fitters can step back into range
        e = clip_unit(pv(p, "ECC") + dt * pv(p, "EDOT"))
        E = kepler_E_op(M, e)
        a1 = pv(p, "A1") + dt * pv(p, "A1DOT")
        n = 2.0 * math.pi * forb
        nu = true_anomaly_continuous(E, e, orbits, M)
        if self.omega_from_nu:
            omega = pv(p, "OM") + pv(p, "OMDOT") / n * nu
        else:
            omega = pv(p, "OM") + pv(p, "OMDOT") * dt
        er = e * (1.0 + self.d_r(p))
        # eth can leave [0,1) via DR/DTH trial steps even with e in range
        eth = clip_unit(e * (1.0 + self.d_th(p)))
        sinE, cosE = torch.sin(E), torch.cos(E)
        alpha = a1 * torch.sin(omega)
        beta = a1 * torch.sqrt(1.0 - eth**2) * torch.cos(omega)
        gamma = pv(p, "GAMMA")
        # Dre = Roemer + Einstein; derivatives wrt E (DD eq. [48-50])
        Dre = alpha * (cosE - er) + (beta + gamma) * sinE
        Drep = -alpha * sinE + (beta + gamma) * cosE
        Drepp = -alpha * cosE - (beta + gamma) * sinE
        nhat = n / (1.0 - e * cosE)
        # inverse timing, DD eq. [46-52]
        delayI = Dre * (
            1.0 - nhat * Drep + (nhat * Drep) ** 2
            + 0.5 * nhat**2 * Dre * Drepp
            - 0.5 * e * sinE / (1.0 - e * cosE) * nhat**2 * Dre * Drep)
        return delayI + self.shapiro_delay(p, e, E, omega, batch, dt) \
            + self.aberration_delay(p, e, nu, omega)


class BinaryBT(BinaryDDBase):
    """Blandford & Teukolsky (1976) model: linear omega advance, no
    Shapiro/aberration/deformation terms (reference `binary_bt.py:17` +
    `BT_model.py`)."""

    register = True
    omega_from_nu = False


class BinaryDD(BinaryDDBase):
    """Damour & Deruelle (1986) with M2/SINI Shapiro, DR/DTH deformations
    and A0/B0 aberration (reference `binary_dd.py:34` + `DD_model.py`)."""

    register = True

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam("M2", units="Msun",
                                  description="Companion mass"))
        self.add_param(FloatParam("SINI", units="",
                                  description="Sine of inclination"))
        self.add_param(FloatParam("DR", value=0.0, units="",
                                  description="Radial deformation"))
        self.add_param(FloatParam("DTH", value=0.0, units="",
                                  description="Angular deformation"))
        self.add_param(FloatParam("A0", value=0.0, units="s",
                                  description="Aberration coefficient A0"))
        self.add_param(FloatParam("B0", value=0.0, units="s",
                                  description="Aberration coefficient B0"))

    def validate(self):
        super().validate()
        if self.SINI.value is not None and not 0.0 <= self.SINI.value <= 1.0:
            raise ValueError("SINI must be between 0 and 1")

    def d_r(self, p):
        return pv(p, "DR")

    def d_th(self, p):
        return pv(p, "DTH")

    def _tm2_sini(self, p, batch, dt):
        if self.M2.value is None or self.SINI.value is None:
            return None, None
        # saturate with a live gradient so out-of-range trial steps keep
        # a restoring SINI design-matrix column (see clip_unit)
        return pv(p, "M2") * Tsun, clip_unit(pv(p, "SINI"))

    def shapiro_delay(self, p, e, E, omega, batch, dt):
        """DD eq. [26]."""
        tm2, sini = self._tm2_sini(p, batch, dt)
        if tm2 is None:
            return torch.zeros_like(E)
        sinE, cosE = torch.sin(E), torch.cos(E)
        # with e and sini both saturated into [0, 1) the bracket is
        # strictly positive; the floor is belt-and-braces against
        # rounding at extreme conjunctions
        arg = 1.0 - e * cosE - sini * (torch.sin(omega) * (cosE - e)
                                       + torch.sqrt(1.0 - e**2)
                                       * torch.cos(omega) * sinE)
        return -2.0 * tm2 * torch.log(torch.clamp(arg, min=1e-12))

    def aberration_delay(self, p, e, nu, omega):
        """DD eq. [27].  No value-based short-circuit: A0/B0 default to 0
        but stay in the graph so fits and grids over them see real
        derivatives."""
        s, c = torch.sin(omega + nu), torch.cos(omega + nu)
        return pv(p, "A0") * (s + e * torch.sin(omega)) + \
            pv(p, "B0") * (c + e * torch.cos(omega))
