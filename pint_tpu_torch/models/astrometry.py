"""Astrometry: Roemer delay, parallax, proper motion.

Port of :mod:`pint_tpu.models.astrometry` (equatorial frame; the ecliptic
frame is not ported yet).  The delay is

    Δ = -r_obs · L̂(t)  +  (|r_perp|² / 2L)        [s]

with r_obs the SSB→observatory vector in light-seconds, L̂(t) the unit
vector to the pulsar propagated linearly by proper motion from POSEPOCH
(reference `astrometry.py:636-676`), and L = 1 kpc / PX[mas].

The sky angles keep :mod:`pint_tpu`'s recipe: host-exact sin/cos of the
reference angles ride in the params dict (``<name>__sincos``) and device
trig is applied only to the small fit offsets.  The H100's float64 trig
would not need it; it is kept so the port reproduces the reference's
numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch.models.parameter import AngleParam, FloatParam, MJDParam
from pint_tpu_torch.models.timing_model import DelayComponent, dv, pv
from pint_tpu_torch.toabatch import TOABatch

SECS_PER_DAY = 86400.0
#: mas/yr -> rad/s
MASYR_TO_RADS = (math.pi / (180.0 * 3600.0 * 1000.0)) / (365.25 * 86400.0)
#: mas -> rad
MAS_TO_RAD = math.pi / (180.0 * 3600.0 * 1000.0)
#: 1 kpc in light-seconds
KPC_LS = 3.0856775814913673e19 / 299792458.0


def _epoch_dt_yr(p, batch: TOABatch, epoch_name: str):
    """(t - epoch) in julian years, f64 (proper-motion precision is ample)."""
    day0 = p["const"][epoch_name][0] + p["const"][epoch_name][1] \
        + p["delta"].get(epoch_name, 0.0)
    return (batch.tdb_day + batch.tdb_frac - day0) / 365.25


def _vec3(x, y, z, n: int):
    """(n, 3) rows from three scalar-or-(n,) components."""
    x, y, z = torch.broadcast_tensors(torch.as_tensor(x), torch.as_tensor(y),
                                      torch.as_tensor(z))
    return torch.broadcast_to(torch.stack([x, y, z], dim=-1), (n, 3))


class Astrometry(DelayComponent):
    """Shared Roemer/parallax machinery; subclasses provide L̂(t)."""

    category = "astrometry"
    #: the two sky-angle parameter names, in (lon, lat) order
    _angle_names = ()

    def derived_device_entries(self):
        """Host-exact sin/cos of the reference angles."""
        out = {}
        for nm in self._angle_names:
            par = self.params.get(nm)
            if par is not None and par.value is not None:
                v = float(par.device_value)
                out[nm + "__sincos"] = np.array([math.sin(v),
                                                 math.cos(v)])
        return out

    @staticmethod
    def _sincos(p: dict, name: str):
        """(sin, cos) of angle ``name`` = host-exact reference rotated by
        the fit offset (angle-addition identities)."""
        sc = p["const"][name + "__sincos"]
        d = torch.as_tensor(dv(p, name), dtype=torch.float64,
                            device=sc.device)
        sd_, cd_ = torch.sin(d), torch.cos(d)
        return sc[0] * cd_ + sc[1] * sd_, sc[1] * cd_ - sc[0] * sd_

    def __init__(self):
        super().__init__()
        self.add_param(MJDParam("POSEPOCH",
                                description="Epoch of the pulsar position"))
        self.add_param(FloatParam("PX", value=0.0, units="mas",
                                  description="Parallax"))

    def psr_dir(self, p: dict, batch: TOABatch) -> torch.Tensor:
        """Unit vector SSB→pulsar at each TOA, shape (N, 3)."""
        raise NotImplementedError

    def pos_epoch_name(self) -> str:
        if self.POSEPOCH.value is not None:
            return "POSEPOCH"
        if self._parent is not None and "PEPOCH" in self._parent \
                and self._parent.PEPOCH.value is not None:
            return "PEPOCH"
        return ""

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        L_hat = self.psr_dir(p, batch)
        r = batch.ssb_obs_pos_ls
        re_dot_L = torch.sum(r * L_hat, dim=1)
        out = -re_dot_L
        px = pv(p, "PX")
        re_sqr = torch.sum(r * r, dim=1)
        # guard the 0/0 at exactly-barycentric TOAs
        safe = torch.where(re_sqr > 0.0, re_sqr, 1.0)
        px_term = 0.5 * (re_sqr * px / KPC_LS) * (1.0 - re_dot_L**2 / safe)
        return out + torch.where(re_sqr > 0.0, px_term, 0.0)

    @staticmethod
    def _propagate(n0, e_lon, e_lat, pm_lon, pm_lat, dt_yr):
        """Linear proper-motion propagation of a unit vector."""
        dn = (e_lon * pm_lon[..., None] + e_lat * pm_lat[..., None])
        n = n0 + dn * dt_yr[:, None]
        return n / torch.linalg.norm(n, dim=1, keepdim=True)


class AstrometryEquatorial(Astrometry):
    """ICRS RAJ/DECJ astrometry (reference `astrometry.py:406`)."""

    register = True
    _angle_names = ("RAJ", "DECJ")
    _pm_names = ("PMRA", "PMDEC")

    def __init__(self):
        super().__init__()
        self.add_param(AngleParam("RAJ", units="H:M:S",
                                  description="Right ascension (J2000)",
                                  aliases=["RA"]))
        self.add_param(AngleParam("DECJ", units="D:M:S",
                                  description="Declination (J2000)",
                                  aliases=["DEC"]))
        self.add_param(FloatParam("PMRA", value=0.0, units="mas/yr",
                                  par2dev=1.0,
                                  description="Proper motion in RA*cos(DEC)"))
        self.add_param(FloatParam("PMDEC", value=0.0, units="mas/yr",
                                  par2dev=1.0,
                                  description="Proper motion in DEC"))

    def validate(self):
        self.require("RAJ", "DECJ")

    def psr_dir(self, p: dict, batch: TOABatch) -> torch.Tensor:
        n = batch.ntoas
        sa, ca = self._sincos(p, "RAJ")
        sd, cd = self._sincos(p, "DECJ")
        n0 = _vec3(cd * ca, cd * sa, sd, n)
        ep = self.pos_epoch_name()
        if not ep:
            return n0
        # local east/north unit vectors; PM in rad/yr (PMRA already *cosδ)
        e_ra = _vec3(-sa, ca, torch.zeros_like(sa), n)
        e_dec = _vec3(-sd * ca, -sd * sa, cd, n)
        pm_ra = pv(p, "PMRA") * MAS_TO_RAD
        pm_dec = pv(p, "PMDEC") * MAS_TO_RAD
        dt_yr = _epoch_dt_yr(p, batch, ep)
        return self._propagate(n0, e_ra, e_dec,
                               torch.broadcast_to(pm_ra, (n,)),
                               torch.broadcast_to(pm_dec, (n,)), dt_yr)
