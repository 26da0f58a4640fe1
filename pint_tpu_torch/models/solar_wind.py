"""Solar-wind dispersion: the NE_SW electron-density model and its
piecewise form SWX.

Port of :mod:`pint_tpu.models.solar_wind` (reference
`SolarWindDispersion` / `SolarWindDispersionX`,
`src/pint/models/solar_wind_dispersion.py:272,608`).  SWM=0 is the
spherically symmetric 1/r^2 model of Edwards et al. 2006 (eqs. 29-30):

    DM_sw = n_e(1 AU) * AU^2 * rho / (r * sin(rho))      [pc cm^-3]

with rho = pi - (Sun-pulsar elongation seen from the observatory) and r
the observatory-Sun distance.  NE_SW may carry Taylor derivatives
(NE_SW1, ... about SWEPOCH).  SWM=1 is the general power-law model (You
et al. 2012; Hazboun et al. 2022) by a 64-node Gauss-Legendre leg and a
closed-form half range (:func:`solar_wind_geometry_p_pc`), differentiable
in the index SWP.

On CUDA these delays are terms of the ``delay_chain`` kernel's row
function (``csrc/delay_chain.cuh``); the functions here are its plain
version, written in the kernel's operation order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch import AU, c as C
from pint_tpu_torch.models.dispersion import dispersion_delay
from pint_tpu_torch.models.parameter import (
    FloatParam,
    MJDParam,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import (
    DelayComponent,
    epoch_days,
    pv,
    range_entries,
    zeros_rows,
)
from pint_tpu_torch.toabatch import TOABatch
from pint_tpu_torch.utils import taylor_horner

SECS_PER_YEAR = 365.25 * 86400.0
AU_LS = AU / C                      # 1 au in light-seconds
PC_LS = 3.0856775814913673e16 / C   # 1 pc in light-seconds
#: the SWX range index of each TOA that the delay kernel reads
SWX_INDEX = "__swxidx__"


def _geometry_pc_impl(xp, obs_sun_pos_ls, psr_dir):
    """AU^2 * rho / (r sin rho) in parsecs (Edwards et al. 2006 eq. 30;
    reference `solar_wind_geometry`, `solar_wind_dispersion.py:370-398`),
    generic over torch and numpy."""
    if xp is torch:
        r = torch.linalg.norm(obs_sun_pos_ls, dim=1)
        dot = torch.sum(obs_sun_pos_ls * psr_dir, dim=1)
    else:
        r = np.linalg.norm(obs_sun_pos_ls, axis=1)
        dot = np.sum(obs_sun_pos_ls * psr_dir, axis=1)
    safe_r = xp.where(r > 0.0, r, 1.0)
    # elongation: the angle at the observatory between Sun and pulsar
    cos_elong = xp.clip(dot / safe_r, -1.0, 1.0)
    rho = math.pi - xp.arccos(cos_elong)
    sin_rho = xp.sin(rho)
    safe_sin = xp.where(sin_rho > 1e-12, sin_rho, 1.0)
    geom = AU_LS**2 * rho / (safe_r * safe_sin) / PC_LS
    # barycentric rows (r == 0) carry no solar-wind delay
    return xp.where((r > 0.0) & (sin_rho > 1e-12), geom, 0.0)


def solar_wind_geometry_pc(obs_sun_pos_ls: torch.Tensor,
                           psr_dir: torch.Tensor) -> torch.Tensor:
    return _geometry_pc_impl(torch, obs_sun_pos_ls, psr_dir)


def solar_wind_geometry_pc_np(obs_sun_pos_ls: np.ndarray,
                              psr_dir: np.ndarray) -> np.ndarray:
    """The numpy twin, for host-side consumers."""
    return _geometry_pc_impl(np, obs_sun_pos_ls, psr_dir)


#: Gauss-Legendre nodes and weights of the finite leg of the power-law
#: path integral (csrc/delay_chain.cuh holds the same 64 pairs)
GL_X, GL_W = np.polynomial.legendre.leggauss(64)


def half_range(p):
    """The half-range integral int_0^{pi/2} cos^{p-2} = sqrt(pi)/2 *
    Gamma((p-1)/2) / Gamma(p/2) of the SWM=1 geometry: a function of SWP
    alone (the delay kernel reads it from a θ slot)."""
    return 0.5 * math.sqrt(math.pi) * torch.exp(
        torch.lgamma((p - 1.0) / 2.0) - torch.lgamma(p / 2.0))


def solar_wind_geometry_p_pc(obs_sun_pos_ls: torch.Tensor,
                             psr_dir: torch.Tensor, p, half=None,
                             au_p=None) -> torch.Tensor:
    """General power-law solar-wind geometry [pc] for n_e ~ (r/1AU)^-p
    (SWM=1; :func:`pint_tpu.models.solar_wind.solar_wind_geometry_p_pc`):
    with z = b tan(phi) the path integral from the observatory to
    infinity is b^{1-p} [int_0^{pi/2} cos^{p-2} - int_0^{phi0}
    cos^{p-2}], phi0 = arctan(-z_sun / b), the half range in closed form
    (:func:`half_range`) and the finite leg by 64-node Gauss-Legendre,
    summed node by node.  ``half`` and ``au_p`` (AU_LS**p) may be given,
    as the delay kernel's θ slots give them.  Requires p > 1."""
    r = torch.linalg.norm(obs_sun_pos_ls, dim=1)
    safe_r = torch.where(r > 0.0, r, 1.0)
    cos_t = torch.clamp(torch.sum(obs_sun_pos_ls * psr_dir, dim=1) / safe_r,
                        -1.0, 1.0)
    theta = torch.arccos(cos_t)           # solar elongation
    b = safe_r * torch.sin(theta)         # impact parameter [ls]
    b = torch.clamp(b, min=1e-6)          # conjunction guard
    z_sun = safe_r * cos_t                # obs -> impact-point distance [ls]
    phi0 = torch.atan2(-z_sun, b)
    if half is None:
        half = half_range(p)
    if au_p is None:
        au_p = AU_LS ** p
    # Gauss-Legendre on [0, phi0] (phi0 may be negative: a signed leg)
    mid = 0.5 * phi0
    acc = 0.0 * mid
    for x, w in zip(GL_X.tolist(), GL_W.tolist()):
        acc = acc + w * torch.cos(mid * (1.0 + x)) ** (p - 2.0)
    leg = mid * acc
    geom = b ** (1.0 - p) * au_p * (half - leg) / PC_LS
    return torch.where(r > 0.0, geom, 0.0)


def _astrometry_of(comp):
    for c in comp._parent.components.values():
        if hasattr(c, "psr_dir"):
            return c
    raise AttributeError(
        f"{type(comp).__name__} needs an astrometry component")


class SolarWindDispersion(DelayComponent):
    """NE_SW solar-wind dispersion: SWM=0 (1/r^2, Edwards et al. 2006) or
    SWM=1 (power-law index SWP, You et al. 2012 / Hazboun et al. 2022)."""

    register = True
    category = "solar_wind"

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam(
            "NE_SW", value=0.0, units="cm^-3", aliases=["NE1AU", "SOLARN0"],
            description="Solar wind electron density at 1 AU"))
        self.add_param(FloatParam(
            "SWM", value=0.0, units="",
            description="Solar wind model (0: 1/r^2; 1: power-law SWP)"))
        self.add_param(FloatParam(
            "SWP", value=2.0, units="",
            description="Solar wind power-law index (SWM=1)"))
        self.add_param(MJDParam("SWEPOCH",
                                description="NE_SW reference epoch"))

    def ne_sw_names(self):
        out = ["NE_SW"]
        out += [p.name for p in self.prefix_params("NE_SW")
                if p.name != "NE_SW"]
        return out

    def prefix_families(self):
        return ["NE_SW"]

    def make_param(self, name):
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "NE_SW" and index >= 1:
            return prefixParameter(
                "float", name, units=f"cm^-3 / yr^{index}",
                par2dev=SECS_PER_YEAR ** -index)
        return None

    def validate(self):
        if self.SWM.value not in (None, 0.0, 1.0):
            raise ValueError(
                f"SWM={self.SWM.value} is not supported (only 0 or 1)")
        if self.SWM.value == 1.0 and self.SWP.value is not None \
                and self.SWP.value <= 1.0:
            raise ValueError("SWM=1 requires SWP > 1 (the path integral "
                             "diverges otherwise; reference raises too)")
        if len(self.ne_sw_names()) > 1 and self.SWEPOCH.value is None:
            if self._parent is None or self._parent.PEPOCH.value is None:
                raise ValueError("SWEPOCH required for NE_SW derivatives")

    @property
    def power_law(self) -> bool:
        return self.SWM.value == 1.0

    def epoch_name(self) -> str:
        return "SWEPOCH" if self.SWEPOCH.value is not None else "PEPOCH"

    def ne_sw_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        names = self.ne_sw_names()
        coeffs = [pv(p, n) for n in names]
        if len(names) == 1:
            return torch.broadcast_to(torch.as_tensor(coeffs[0]),
                                      (batch.ntoas,))
        day0 = epoch_days(p, self.epoch_name())
        dt_sec = (batch.tdb_day + batch.tdb_frac - day0) * 86400.0
        return taylor_horner(dt_sec, coeffs)

    def dm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        psr_dir = _astrometry_of(self).psr_dir(p, batch)
        if self.power_law:
            geom = solar_wind_geometry_p_pc(batch.obs_sun_pos_ls, psr_dir,
                                            pv(p, "SWP"))
        else:
            geom = solar_wind_geometry_pc(batch.obs_sun_pos_ls, psr_dir)
        return self.ne_sw_value(p, batch) * geom

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return dispersion_delay(self.dm_value(p, batch), batch.freq_mhz)


#: J2000 mean obliquity [rad]: the ecliptic pole for elongation extremes
ECL_POLE = (0.0, -0.3977771559319137, 0.9174820620691818)


def swx_norm(obs_sun_pos_ls, psr_dir):
    """(g - g_opp) / (g_conj - g_opp): the SWM=0 geometry scaled between
    its opposition and conjunction values at the pulsar's ecliptic
    latitude (r = 1 au), the per-row factor every SWXDM multiplies."""
    g = solar_wind_geometry_pc(obs_sun_pos_ls, psr_dir)
    sinb = torch.clamp(psr_dir[:, 0] * ECL_POLE[0]
                       + psr_dir[:, 1] * ECL_POLE[1]
                       + psr_dir[:, 2] * ECL_POLE[2], -1.0, 1.0)
    beta = torch.abs(torch.arcsin(sinb))
    beta = torch.clamp(beta, 1e-6, math.pi / 2)

    def geom_at(rho):
        return AU_LS * rho / torch.sin(rho) / PC_LS

    g_conj = geom_at(math.pi - beta)
    g_opp = geom_at(beta)
    return (g - g_opp) / (g_conj - g_opp)


class SolarWindDispersionX(DelayComponent):
    """Piecewise solar-wind DM amplitudes over MJD ranges (SWXDM_####/
    SWXP_####/SWXR1/SWXR2; :class:`pint_tpu.models.solar_wind.
    SolarWindDispersionX`, reference `solar_wind_dispersion.py:608`):

        DM(t) = SWXDM * (g(t) - g_opp) / (g_conj - g_opp)

    over each range, SWXP = 2 only."""

    register = True
    category = "solar_windx"

    def prefix_families(self):
        return ["SWXDM_", "SWXP_", "SWXR1_", "SWXR2_"]

    def swx_names(self):
        return [p.name for p in self.prefix_params("SWXDM_")]

    def add_swx_range(self, index: int, r1_mjd, r2_mjd, swxdm=0.0,
                      swxp=2.0, frozen=True):
        self.add_param(prefixParameter("float", f"SWXDM_{index:04d}",
                                       units="pc cm^-3", value=swxdm,
                                       frozen=frozen))
        self.add_param(prefixParameter("float", f"SWXP_{index:04d}",
                                       units="", value=swxp))
        self.add_param(prefixParameter("mjd", f"SWXR1_{index:04d}",
                                       value=r1_mjd))
        self.add_param(prefixParameter("mjd", f"SWXR2_{index:04d}",
                                       value=r2_mjd))

    def make_param(self, name):
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "SWXDM_":
            return prefixParameter("float", name, units="pc cm^-3")
        if prefix == "SWXP_":
            return prefixParameter("float", name, units="")
        if prefix in ("SWXR1_", "SWXR2_"):
            return prefixParameter("mjd", name)
        return None

    def validate(self):
        for n in self.swx_names():
            idx = n.split("_")[1]
            for stem in ("SWXR1_", "SWXR2_"):
                if f"{stem}{idx}" not in self.params:
                    raise ValueError(f"{n} needs {stem}{idx}")
            pp = self.params.get(f"SWXP_{idx}")
            if pp is not None and pp.value not in (None, 2.0):
                raise ValueError(
                    f"SWXP_{idx}={pp.value} is not supported (only p=2)")

    def mask_entries(self, toas):
        """Each range's TOA mask ``SWXDM_####__rangemask``, and the (N, 2)
        int32 ranges of each TOA (-1 for none) that the delay kernel
        reads, ``__swxidx__``, as DispersionDMX builds its bins: ranges
        are inclusive, so a TOA on a shared boundary lies in both; the
        index is left out where three ranges overlap on a TOA, and the
        kernel then refuses the model."""
        out = super().mask_entries(toas)
        names = self.swx_names()
        masks, index = range_entries(names, [
            (self.params[f"SWXR1_{n[6:]}"].mjd_float,
             self.params[f"SWXR2_{n[6:]}"].mjd_float) for n in names],
            toas.utc.mjd_float)
        out.update(masks)
        if index is not None:
            out[SWX_INDEX] = index
        return out

    def dm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        names = self.swx_names()
        if not names:
            return zeros_rows(batch)
        norm = swx_norm(batch.obs_sun_pos_ls,
                        _astrometry_of(self).psr_dir(p, batch))
        total = zeros_rows(batch)
        for n in names:
            mask = p["mask"].get(f"{n}__rangemask")
            if mask is None:
                continue
            total = total + pv(p, n) * norm * mask
        return total

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return dispersion_delay(self.dm_value(p, batch), batch.freq_mhz)
