"""ELL1-family binary models: near-circular orbits via Laplace-Lagrange
parameters (EPS1 = e sin om, EPS2 = e cos om), closed-form — no Kepler
iteration, fully vmap-friendly.

Port of :mod:`pint_tpu.models.binary_ell1` (ELL1; ELL1H and ELL1k are
not ported yet).

Reference: `BinaryELL1`/`BinaryELL1H`/`BinaryELL1k`
(`src/pint/models/binary_ell1.py:57,310,423`) delegating to
`stand_alone_psr_binaries/ELL1_model.py` (Lange et al. 2001; third-order
eccentricity terms from Zhu et al. 2019 / Fiore et al. 2023), ELL1H
orthometric Shapiro (Freire & Wex 2010), ELL1k (Susobhanan et al. 2018).

TPU-native design decisions:

* The Roemer delay's O(e^3) trig expansion is organized as a 4-harmonic
  Fourier series ``sum_k S_k sin(k Phi) + C_k cos(k Phi)`` with closed-form
  coefficient functions of (eps1, eps2) — one table instead of the
  reference's three hand-expanded polynomials; the dPhi-derivatives needed
  for the inverse-timing expansion fall out as ``k``-weighted sums of the
  same table.
* All math is f64: orbital-phase accuracy needs ~1e-10 of an orbit, within
  even TPU's emulated f64 once ``t - TASC`` is formed by the exact
  two-part-MJD path (`pint_tpu.models.spindown.dt_seconds_qs`).
* Hand-written parameter derivatives (1.5k LoC in the reference) do not
  exist: the fitters autodiff through this function.
"""

from __future__ import annotations

import math
from typing import List

import torch

from pint_tpu_torch import Tsun
from pint_tpu_torch.models.binary_orbits import OrbwaveMixin, clip_unit
from pint_tpu_torch.models.parameter import (
    FloatParam,
    MJDParam,
    funcParameter,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import DelayComponent, pv
from pint_tpu_torch.models.spindown import dt_seconds_qs
from pint_tpu_torch.toabatch import TOABatch

SECS_PER_DAY = 86400.0
SECS_PER_YEAR = 365.25 * SECS_PER_DAY
DEG_PER_YEAR = (math.pi / 180.0) / SECS_PER_YEAR


def roemer_harmonics(e1, e2):
    """Fourier coefficients (S_k, C_k), k = 1..4, of the ELL1 Roemer delay
    per unit a1 (Lange et al. 2001 to O(e); O(e^2), O(e^3) terms per
    Zhu et al. 2019 eq. 1 / Fiore et al. 2023 eq. 4)."""
    S = [
        1.0 - (5.0 * e2**2 + 3.0 * e1**2) / 8.0,
        e2 / 2.0 - (5.0 * e2**3 + 3.0 * e1**2 * e2) / 12.0,
        (3.0 / 8.0) * (e2**2 - e1**2),
        e2**3 / 3.0 - e1**2 * e2,
    ]
    C = [
        e1 * e2 / 4.0,
        -e1 / 2.0 + e1 * e2**2 / 2.0 + e1**3 / 3.0,
        -(3.0 / 4.0) * e1 * e2,
        -e1 * e2**2 + e1**3 / 3.0,
    ]
    return S, C


def roemer_series(Phi, e1, e2, dphi_order: int = 0):
    """d^n(Roemer delay per a1)/dPhi^n from the harmonic table."""
    S, C = roemer_harmonics(e1, e2)
    out = 0.0
    for k in range(1, 5):
        s, c = torch.sin(k * Phi), torch.cos(k * Phi)
        if dphi_order == 0:
            out = out + S[k - 1] * s + C[k - 1] * c
        elif dphi_order == 1:
            out = out + k * (S[k - 1] * c - C[k - 1] * s)
        elif dphi_order == 2:
            out = out - k * k * (S[k - 1] * s + C[k - 1] * c)
        else:
            raise ValueError(dphi_order)
    return out


class BinaryELL1Base(OrbwaveMixin, DelayComponent):
    """Shared ELL1 machinery; subclasses provide the Shapiro delay."""

    category = "pulsar_system"
    binary_model_name = "ELL1Base"

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
        self.add_param(MJDParam("TASC",
                                description="Epoch of ascending node"))
        self.add_param(FloatParam("EPS1", value=0.0, units="",
                                  description="ECC*sin(OM) at TASC"))
        self.add_param(FloatParam("EPS2", value=0.0, units="",
                                  description="ECC*cos(OM) at TASC"))
        self.add_param(prefixParameter(
            "float", "FB0", units="1/s", frozen=True,
            description_template=lambda i:
            f"Orbital frequency derivative {i}" if i else
            "Orbital frequency (alternative to PB)"))
        self.FB0.value = None
        self._init_orbwave_params()
        self.add_param(funcParameter(
            "ECC", params=("EPS1", "EPS2"),
            func=lambda e1, e2: math.hypot(e1, e2),
            description="Eccentricity (derived)"))
        self.add_param(funcParameter(
            "OM", params=("EPS1", "EPS2"),
            func=lambda e1, e2: math.degrees(math.atan2(e1, e2)) % 360.0,
            description="Longitude of periastron [deg] (derived)"))

    # -- prefix family (FB0, FB1, ...) ------------------------------------
    def make_param(self, name: str):
        try:
            stem, index = split_prefix(name)
        except ValueError:
            return None
        if stem == "FB":
            return prefixParameter("float", name, units=f"1/s^{index + 1}",
                                   description_template=lambda i:
                                   f"Orbital frequency derivative {i}")
        made = self._make_orbwave_param(stem, name)
        if made is not None:
            return made
        return None

    def prefix_families(self):
        # ORBWAVEC/S exist only on demand; FB is discoverable via FB0
        return ["ORBWAVEC", "ORBWAVES"]

    def fb_names(self) -> List[str]:
        return [q.name for q in self.prefix_params("FB")
                if q.value is not None]

    def validate(self):
        self.require("A1", "TASC")
        if self.PB.value is None and not self.fb_names():
            from pint_tpu_torch.exceptions import MissingParameter

            raise MissingParameter(
                f"{type(self).__name__} requires PB or FB0")
        # FB series must be contiguous from 0 (a gap would silently shift
        # higher FBs into the wrong Taylor slot; reference OrbitFBX raises
        # the same way)
        fbs = self.fb_names()
        for i, n in enumerate(fbs):
            if n != f"FB{i}":
                raise ValueError(
                    f"non-contiguous FB series at {n}: FB indices must "
                    "run 0..k without gaps")
        self._validate_orbwaves()

    # -- orbital kinematics ------------------------------------------------
    def _ttasc(self, p: dict, batch: TOABatch, delay):
        """(t_bary - TASC) [s], f64 (exact two-part difference)."""
        return dt_seconds_qs(p, batch, delay, "TASC")[1]

    def _orbits_and_freq(self, p: dict, dt, batch, delay):
        """(orbit count, orbital frequency [1/s]) at dt = t - TASC, plus
        the ORBWAVE Fourier phase variations when present (reference
        `OrbitWaves`, an alternative to the FBn Taylor series)."""
        from pint_tpu_torch.models.binary_orbits import orbits_and_freq

        return self._apply_orbwaves(
            p, batch, delay, *orbits_and_freq(p, dt, self.fb_names()))

    def _eps(self, p: dict, dt):
        """(eps1(t), eps2(t))."""
        return (pv(p, "EPS1") + dt * pv(p, "EPS1DOT")
                if "EPS1DOT" in p["const"] else pv(p, "EPS1") + 0.0 * dt,
                pv(p, "EPS2") + dt * pv(p, "EPS2DOT")
                if "EPS2DOT" in p["const"] else pv(p, "EPS2") + 0.0 * dt)

    def shapiro_delay(self, p: dict, Phi):
        return torch.zeros_like(Phi)

    def roemer_const(self, e1):
        """The -(3/2)*eps1 Roemer term.  A true constant for ELL1/ELL1H
        (dropped, unobservable); ELL1k keeps it because eps1(t) varies
        under OMDOT/LNEDOT (reference `ELL1k_model.py:120-134`)."""
        return 0.0

    def orbital_phase(self, p: dict, batch: TOABatch,
                      delay) -> torch.Tensor:
        """Fractional orbital phase in [0, 1) at each TOA, measured from
        TASC (reference `photonphase --addorbphase`,
        `src/pint/scripts/photonphase.py:277-283`)."""
        dt = self._ttasc(p, batch, delay)
        orbits, _ = self._orbits_and_freq(p, dt, batch, delay)
        return orbits - torch.floor(orbits)

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        dt = self._ttasc(p, batch, delay)
        orbits, forb = self._orbits_and_freq(p, dt, batch, delay)
        # reduce to [0,1) before the 2*pi multiply so sin/cos see small args
        Phi = 2.0 * math.pi * (orbits - torch.floor(orbits))
        e1, e2 = self._eps(p, dt)
        a1 = pv(p, "A1") + dt * pv(p, "A1DOT")
        nhat = 2.0 * math.pi * forb
        Dre = a1 * (roemer_series(Phi, e1, e2, 0) + self.roemer_const(e1))
        Drep = a1 * roemer_series(Phi, e1, e2, 1)
        Drepp = a1 * roemer_series(Phi, e1, e2, 2)
        # inverse-timing expansion: Dre evaluated at the pulsar proper
        # emission phase (Lange et al. 2001 / D&D 1986 eq. 46-52 treatment)
        delayI = Dre * (1.0 - nhat * Drep + (nhat * Drep) ** 2
                        + 0.5 * nhat**2 * Dre * Drepp)
        return delayI + self.shapiro_delay(p, Phi)


class BinaryELL1(BinaryELL1Base):
    """ELL1 with M2/SINI Shapiro delay (Lange et al. 2001 eq. A16)."""

    register = True
    binary_model_name = "ELL1"

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam("EPS1DOT", value=0.0, units="1/s",
                                  unit_scale=True,
                                  description="d(EPS1)/dt"))
        self.add_param(FloatParam("EPS2DOT", value=0.0, units="1/s",
                                  unit_scale=True,
                                  description="d(EPS2)/dt"))
        self.add_param(FloatParam("M2", units="Msun",
                                  description="Companion mass"))
        self.add_param(FloatParam("SINI", units="",
                                  description="Sine of inclination"))

    def validate(self):
        super().validate()
        if self.SINI.value is not None and not 0.0 <= self.SINI.value <= 1.0:
            raise ValueError("SINI must be between 0 and 1")

    def shapiro_delay(self, p: dict, Phi):
        if self.M2.value is None or self.SINI.value is None:
            return torch.zeros_like(Phi)
        tm2 = pv(p, "M2") * Tsun
        # saturated with a live gradient: trial steps past SINI = 1 stay
        # finite AND keep a restoring design-matrix column (clip_unit)
        sini = clip_unit(pv(p, "SINI"))
        return -2.0 * tm2 * torch.log(
            torch.clamp(1.0 - sini * torch.sin(Phi), min=1e-12))
