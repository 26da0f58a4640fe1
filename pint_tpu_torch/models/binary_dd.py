"""BT and DD-family binary models: full Keplerian orbits.

Port of :mod:`pint_tpu.models.binary_dd` (reference
`BinaryBT`/`BinaryDD`/`BinaryDDS`/`BinaryDDH`/`BinaryDDK`/`BinaryDDGR`,
`src/pint/models/binary_bt.py:17`, `binary_dd.py:34,135,211,382`,
`binary_ddk.py:45`, delegating to `stand_alone_psr_binaries/BT_model.py`,
`DD_model.py`, `DDK_model.py` and `DDGR_model.py`; Blandford & Teukolsky
1976, Damour & Deruelle 1986, Kopeikin 1995 and 1996, Taylor & Weisberg
1989), and BT_piecewise (`BinaryBTPiecewise`, `binary_bt.py:84`).

The eccentric anomaly comes from the ``kepler_E`` CUDA kernel
(:func:`pint_tpu_torch.kernels.kepler.kepler_E_op`, its plain version on
the CPU) with pint_tpu's implicit-function tangent; the rest of the delay
is one elementwise chain, and the fitters autodiff through it.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
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
from pint_tpu_torch.models.timing_model import (DelayComponent,
                                               epoch_days, pv)
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

    def a1_val(self, p, batch, dt):
        """Projected semi-major axis [ls] at each TOA; DDK adds the
        Kopeikin proper-motion/annual-parallax corrections."""
        return pv(p, "A1") + dt * pv(p, "A1DOT")

    def omega_extra(self, p, batch, dt):
        """Additive per-TOA correction to omega [rad] (0 except DDK)."""
        return 0.0

    def dt_extra(self, p, batch, dt):
        """Per-TOA adjustment of (t - T0) [s]; identity except for the
        piecewise models, which re-reference whole MJD ranges to
        alternative epochs."""
        return dt

    def _dt(self, p, batch, delay):
        """(t_bary - T0) [s], f64 (exact two-part difference), with the
        variant's :meth:`dt_extra`."""
        return self.dt_extra(p, batch, dt_seconds_qs(p, batch, delay,
                                                     "T0")[1])

    def orbital_phase(self, p: dict, batch: TOABatch,
                      delay) -> torch.Tensor:
        """Fractional orbital phase in [0, 1) at each TOA, measured from
        T0 (:meth:`pint_tpu.models.binary_dd.BinaryDDBase.orbital_phase`)."""
        orbits, _ = self._apply_orbwaves(
            p, batch, delay, *orbits_and_freq(p, self._dt(p, batch, delay),
                                              self.fb_names()))
        return orbits - torch.floor(orbits)

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
        a1 = self.a1_val(p, batch, dt)
        n = 2.0 * math.pi * forb
        nu = true_anomaly_continuous(E, e, orbits, M)
        if self.omega_from_nu:
            omega = pv(p, "OM") + pv(p, "OMDOT") / n * nu
        else:
            omega = pv(p, "OM") + pv(p, "OMDOT") * dt
        omega = omega + self.omega_extra(p, batch, dt)
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


class BinaryDDS(BinaryDD):
    """DD with SHAPMAX = -ln(1 - SINI) for nearly edge-on orbits
    (reference `binary_dd.py:135` + `DDS_model.py`)."""

    register = True

    def __init__(self):
        super().__init__()
        self.remove_param("SINI")
        self.add_param(FloatParam("SHAPMAX", units="",
                                  description="-ln(1-SINI)"))

    def validate(self):
        BinaryDDBase.validate(self)
        self.require("SHAPMAX")

    def _tm2_sini(self, p, batch, dt):
        if self.M2.value is None or self.SHAPMAX.value is None:
            return None, None
        return pv(p, "M2") * Tsun, 1.0 - torch.exp(-pv(p, "SHAPMAX"))


class BinaryDDH(BinaryDD):
    """DD with orthometric Shapiro parameters H3/STIGMA (reference
    `binary_dd.py:211` + `DDH_model.py`; Freire & Wex 2010):
    TM2 = H3/STIGMA^3, SINI = 2 STIGMA/(1+STIGMA^2)."""

    register = True

    def __init__(self):
        super().__init__()
        self.remove_param("SINI")
        self.remove_param("M2")
        self.add_param(FloatParam("H3", units="s",
                                  description="Third Shapiro harmonic"))
        self.add_param(FloatParam("STIGMA", units="", aliases=["VARSIGMA"],
                                  description="Orthometric ratio"))

    def validate(self):
        BinaryDDBase.validate(self)
        self.require("H3", "STIGMA")

    def _tm2_sini(self, p, batch, dt):
        h3, sig = pv(p, "H3"), pv(p, "STIGMA")
        return h3 / sig**3, 2.0 * sig / (1.0 + sig**2)


class BinaryDDK(BinaryDD):
    """DD with Kopeikin annual-orbital-parallax and proper-motion
    corrections (reference `binary_ddk.py:45` +
    `stand_alone_psr_binaries/DDK_model.py`; Kopeikin 1995 eqs. 15-19,
    Kopeikin 1996 eqs. 8-10; Damour & Taylor 1992 KIN/KOM convention).

    SINI is replaced by the inclination KIN and the longitude of the
    ascending node KOM; the observed a1, omega and sin(i) then vary with
    time through the Earth's orbit (annual-orbital parallax, scale 1/PX)
    and the pulsar's proper motion (K96 flag, Kopeikin 1996).  The
    corrections are evaluated in the astrometry component's native frame
    (equatorial or ecliptic), exactly as the reference does.
    """

    register = True

    def __init__(self):
        super().__init__()
        self.remove_param("SINI")
        self.add_param(FloatParam("KIN", units="deg", par2dev=DEG,
                                  description="Orbital inclination"))
        self.add_param(FloatParam("KOM", units="deg", par2dev=DEG,
                                  description="Longitude of ascending "
                                              "node (DT92, E through N)"))
        from pint_tpu_torch.models.parameter import BoolParam

        self.add_param(BoolParam("K96", value=True,
                                 description="Apply Kopeikin 1996 "
                                             "proper-motion corrections"))

    def validate(self):
        BinaryDDBase.validate(self)
        self.require("KIN", "KOM")
        if self._parent is not None:
            if "PX" not in self._parent or \
                    not self._parent.PX.value:
                import warnings as _w

                _w.warn("DDK's annual-orbital-parallax terms need PX; "
                        "PX is unset (treated as 0: terms disabled)")

    def _astrometry(self):
        for comp in self._parent.components.values():
            if hasattr(comp, "kopeikin_frame"):
                return comp
        raise AttributeError("BinaryDDK needs an astrometry component")

    def _kopeikin(self, p, batch, dt):
        """(delta_a1 [ls], delta_omega [rad], kin [rad] per TOA)."""
        from pint_tpu_torch.models.astrometry import KPC_LS

        sl, cl, sb, cb, mu_lon, mu_lat, obs = \
            self._astrometry().kopeikin_frame(p, batch)
        skom, ckom = torch.sin(pv(p, "KOM")), torch.cos(pv(p, "KOM"))
        kin0 = pv(p, "KIN")
        tt0_yr = dt / SECS_PER_YEAR
        # K96 is a host boolean flag (never fit), folded in as a constant
        k96 = 1.0 if self.K96.value else 0.0
        # Kopeikin 1996 eq. 10: secular inclination change from PM
        d_kin = k96 * (-mu_lon * skom + mu_lat * ckom) * tt0_yr
        kin = kin0 + d_kin
        sin_kin = torch.sin(kin)
        cos_kin = torch.cos(kin)
        a1_0 = pv(p, "A1") + dt * pv(p, "A1DOT")
        # Kopeikin 1996 eqs. 8-9
        d_a1_pm = a1_0 * d_kin * cos_kin / sin_kin
        d_om_pm = k96 * (mu_lon * ckom + mu_lat * skom) * tt0_yr / sin_kin
        # Kopeikin 1995 eqs. 15-19 (annual-orbital parallax); obs in ls,
        # 1/d expressed as PX/KPC_LS so PX = 0 cleanly disables the terms
        dI0 = -obs[:, 0] * sl + obs[:, 1] * cl
        dJ0 = -obs[:, 0] * sb * cl - obs[:, 1] * sb * sl + obs[:, 2] * cb
        inv_d = pv(p, "PX") / KPC_LS
        d_a1_px = a1_0 * cos_kin / sin_kin * (dI0 * skom - dJ0 * ckom) \
            * inv_d
        d_om_px = -(dI0 * ckom + dJ0 * skom) * inv_d / sin_kin
        return d_a1_pm + d_a1_px, d_om_pm + d_om_px, kin

    # The Kopeikin triple feeds three hooks per delay evaluation;
    # delay() computes it once and scopes it to the super() call.
    _kop_active = None

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        self._kop_active = self._kopeikin(p, batch,
                                          self._dt(p, batch, delay))
        try:
            return super().delay(p, batch, delay)
        finally:
            self._kop_active = None

    def a1_val(self, p, batch, dt):
        d_a1, _, _ = self._kop_active
        return pv(p, "A1") + dt * pv(p, "A1DOT") + d_a1

    def omega_extra(self, p, batch, dt):
        _, d_om, _ = self._kop_active
        return d_om

    def _tm2_sini(self, p, batch, dt):
        if self.M2.value is None:
            return None, None
        _, _, kin = self._kop_active
        return pv(p, "M2") * Tsun, clip_unit(torch.sin(kin))


class BinaryDDGR(BinaryDD):
    """DD with general relativity assumed: every post-Keplerian quantity
    (SINI, GAMMA, OMDOT, PBDOT, DR, DTH) is *derived* from the component
    masses (reference `binary_dd.py:211` + `DDGR_model.py`; Taylor &
    Weisberg 1989 eqs. 15-25; tempo's mass2dd).

    Parameters: MTOT (total mass), M2 (companion), plus optional XOMDOT/
    XPBDOT excesses beyond the GR prediction.  Any SINI/GAMMA/OMDOT/
    PBDOT/DR/DTH in the par file are read but overridden, exactly like
    the reference.  The derived quantities are injected as offsets in the
    params dict, so fits autodiff straight through the GR formulas.
    """

    register = True

    def __init__(self):
        super().__init__()
        self.remove_param("SINI")
        self.add_param(FloatParam("MTOT", units="Msun", aliases=["MTOT"],
                                  description="Total system mass"))
        self.add_param(FloatParam("XOMDOT", value=0.0, units="deg/yr",
                                  par2dev=DEG_PER_YEAR,
                                  description="Excess OMDOT beyond GR"))
        self.add_param(FloatParam("XPBDOT", value=0.0, units="d/d",
                                  unit_scale=True,
                                  description="Excess PBDOT beyond GR"))

    def validate(self):
        BinaryDDBase.validate(self)
        self.require("MTOT", "M2")

    def _gr_pk(self, p):
        """Derived PK quantities from (MTOT, M2, PB, ECC, A1) — Taylor &
        Weisberg (1989) eqs. 15-25 in c = 1 seconds units
        (Tsun = GM_sun/c^3)."""
        mtot = pv(p, "MTOT")
        m2 = pv(p, "M2")
        m1 = mtot - m2
        e = pv(p, "ECC")
        a1 = pv(p, "A1")
        fbs = self.fb_names()
        if fbs:
            n = 2.0 * math.pi * pv(p, fbs[0])
        else:
            n = 2.0 * math.pi / pv(p, "PB")
        gm = Tsun * mtot                      # [s]
        arr0 = (gm / n**2) ** (1.0 / 3.0)     # [s] non-relativistic
        # relativistic Kepler (TW89 eq. 15), fixed-count iteration: the
        # correction is O(Tsun*M/arr) ~ 1e-6, so each pass squares the
        # residual -- 4 is ample
        corr = m1 * m2 / mtot**2 - 9.0
        arr = arr0
        for _ in range(4):
            arr = arr0 * (1.0 + corr * gm / (2.0 * arr)) ** (2.0 / 3.0)
        ar = arr * m2 / mtot
        sini = a1 / ar                        # TW89 eq. 20
        gamma = e * Tsun * m2 * (m1 + 2.0 * m2) / (n * arr0 * mtot)
        fe = (1.0 + (73.0 / 24.0) * e**2 + (37.0 / 96.0) * e**4) \
            * (1.0 - e**2) ** -3.5            # TW89 eq. 19
        # TW89 eq. 18, dimensionless (masses in Msun, Tsun carries GM/c^3)
        pbdot = (-192.0 * math.pi / 5.0) * (n * Tsun) ** (5.0 / 3.0) \
            * m1 * m2 * mtot ** (-1.0 / 3.0) * fe
        k = 3.0 * gm / (arr0 * (1.0 - e**2))  # TW89 eq. 16, per-orbit/2pi
        dr = Tsun * (3.0 * m1**2 + 6.0 * m1 * m2 + 2.0 * m2**2) \
            / (mtot * arr)                    # TW89 eq. 24
        dth = Tsun * (3.5 * m1**2 + 6.0 * m1 * m2 + 2.0 * m2**2) \
            / (mtot * arr)                    # TW89 eq. 25
        return {"sini": sini, "gamma": gamma, "pbdot": pbdot, "k": k,
                "dr": dr, "dth": dth, "n": n}

    def _with_gr(self, p):
        """Params dict with the GR-derived PK values injected as offsets,
        so the base DD machinery (and autodiff) sees them as
        parameters."""
        pk = self._gr_pk(p)
        # omega = OM + (OMDOT/n) nu in the base class; the GR advance is
        # k nu with k per-radian-of-nu, plus the XOMDOT excess
        omdot = pk["k"] * pk["n"] + pv(p, "XOMDOT")
        pbdot = pk["pbdot"] + pv(p, "XPBDOT")
        delta = dict(p["delta"])
        for name, val in (("GAMMA", pk["gamma"]), ("OMDOT", omdot),
                          ("PBDOT", pbdot), ("DR", pk["dr"]),
                          ("DTH", pk["dth"])):
            delta[name] = val - p["const"][name]
        p2 = dict(p)
        p2["delta"] = delta
        return p2, pk

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        p2, _pk = self._with_gr(p)
        return super().delay(p2, batch, delay)

    def _tm2_sini(self, p, batch, dt):
        pk = self._gr_pk(p)
        return pv(p, "M2") * Tsun, clip_unit(pk["sini"])


#: the mask entry of BinaryBTPiecewise that the delay kernel reads: each
#: TOA's piece (its position in ``piece_indices``), -1 for none
BTPW_INDEX = "__btpwidx__"


class BinaryBTPiecewise(BinaryBT):
    """BT with piecewise-constant T0 and/or A1 over MJD ranges (reference
    `binary_bt.py:84` + `stand_alone_psr_binaries/BT_piecewise.py`).

    Each piece ``i`` is an MJD window [XR1_iiii, XR2_iiii) carrying an
    alternative epoch T0X_iiii [MJD] and/or projected semi-major axis
    A1X_iiii [ls]; TOAs outside every window use the global T0/A1.  The
    window membership masks are computed on the host into the params
    dict, so the delay stays one branch-free chain; the windows may not
    overlap, so one piece index per TOA (:data:`BTPW_INDEX`) tells the
    delay kernel the same.
    """

    register = True
    _stems = ("T0X_", "A1X_", "XR1_", "XR2_")

    def piece_indices(self) -> List[int]:
        return sorted({q.index for q in self.prefix_params("XR1_")})

    def add_piece(self, xr1: float, xr2: float, t0x=None, a1x=None,
                  index=None, frozen=True):
        if index is None:
            index = 1 + max(self.piece_indices(), default=-1)
        self.add_param(prefixParameter("float", f"XR1_{index:04d}",
                                       units="d", value=xr1))
        self.add_param(prefixParameter("float", f"XR2_{index:04d}",
                                       units="d", value=xr2))
        if t0x is not None:
            self.add_param(prefixParameter("float", f"T0X_{index:04d}",
                                           units="d", value=t0x,
                                           frozen=frozen))
        if a1x is not None:
            self.add_param(prefixParameter("float", f"A1X_{index:04d}",
                                           units="ls", value=a1x,
                                           frozen=frozen))
        return index

    def prefix_families(self):
        return list(self._stems) + super().prefix_families()

    def make_param(self, name: str):
        try:
            stem, _ = split_prefix(name)
        except ValueError:
            return None
        if stem in ("XR1_", "XR2_", "T0X_"):
            return prefixParameter("float", name, units="d")
        if stem == "A1X_":
            return prefixParameter("float", name, units="ls")
        return super().make_param(name)

    def validate(self):
        super().validate()
        for i in self.piece_indices():
            x1 = self.params.get(f"XR1_{i:04d}")
            x2 = self.params.get(f"XR2_{i:04d}")
            if x1 is None or x2 is None or x1.value is None \
                    or x2.value is None:
                raise ValueError(f"piece {i}: XR1/XR2 must both be given")
            if not x1.value < x2.value:
                raise ValueError(f"piece {i}: XR1 must be < XR2")
        # overlapping windows would double-apply T0/A1 shifts (reference
        # BT_piecewise raises 'Group boundary overlap detected')
        spans = sorted((float(self.params[f"XR1_{i:04d}"].value),
                        float(self.params[f"XR2_{i:04d}"].value), i)
                       for i in self.piece_indices())
        for (a1_, a2_, ia), (b1_, _b2, ib) in zip(spans, spans[1:]):
            if b1_ < a2_:
                raise ValueError(
                    f"piece windows {ia} and {ib} overlap "
                    f"([{a1_}, {a2_}) vs [{b1_}, ...))")

    def has_piece_value(self, stem: str, i: int) -> bool:
        """Whether piece ``i`` sets ``stem`` ("T0X_" or "A1X_")."""
        q = self.params.get(f"{stem}{i:04d}")
        return q is not None and q.value is not None

    def mask_entries(self, toas):
        out = super().mask_entries(toas)
        mjd = np.asarray(toas.tdb.mjd_float)
        pieces = self.piece_indices()
        index = np.full(mjd.shape, -1, dtype=np.int32)
        for k, i in enumerate(pieces):
            x1 = float(self.params[f"XR1_{i:04d}"].value)
            x2 = float(self.params[f"XR2_{i:04d}"].value)
            inside = (mjd >= x1) & (mjd < x2)
            out[f"__btpw_mask_{i:04d}__"] = inside.astype(np.float64)
            index[inside] = k
        if pieces:
            out[BTPW_INDEX] = index
        return out

    def piece_shift(self, p, i: int):
        """Piece ``i``'s shift of t - T0 [s]: (T0 - T0X_i) in days."""
        return (epoch_days(p, "T0") - pv(p, f"T0X_{i:04d}")) * SECS_PER_DAY

    def dt_extra(self, p, batch, dt):
        for i in self.piece_indices():
            if not self.has_piece_value("T0X_", i):
                continue
            mask = p["mask"][f"__btpw_mask_{i:04d}__"]
            dt = dt + mask * self.piece_shift(p, i)
        return dt

    def a1_val(self, p, batch, dt):
        a1 = super().a1_val(p, batch, dt)
        for i in self.piece_indices():
            if not self.has_piece_value("A1X_", i):
                continue
            mask = p["mask"][f"__btpw_mask_{i:04d}__"]
            a1 = a1 + mask * (pv(p, f"A1X_{i:04d}")
                              + dt * pv(p, "A1DOT") - a1)
        return a1
