"""Astrometry: Roemer delay, parallax, proper motion.

Port of :mod:`pint_tpu.models.astrometry` (the equatorial and ecliptic
frames, the Kopeikin inputs that BinaryDDK reads, and the host frame
conversion ``convert_astrometry``).  The delay is

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
#: IAU 2006 (IERS2010) mean obliquity of the ecliptic at J2000 [rad]
OBLIQUITY_IERS2010 = 84381.406 * math.pi / (180.0 * 3600.0)
_OBLIQUITY = {
    "IERS2010": OBLIQUITY_IERS2010,
    "IERS2003": 84381.4059 * math.pi / (180.0 * 3600.0),
    "DE405": 84381.412 * math.pi / (180.0 * 3600.0),
    "DE404": 84381.4227 * math.pi / (180.0 * 3600.0),
}


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

    #: (pm_lon_name, pm_lat_name) in this frame — set by subclasses
    _pm_names = ()

    def _obs_pos_frame(self, batch: TOABatch) -> torch.Tensor:
        """SSB→observatory vector [ls] in this astrometry's native frame
        (identity for equatorial; ecliptic subclass rotates)."""
        return batch.ssb_obs_pos_ls

    def kopeikin_frame(self, p: dict, batch: TOABatch):
        """The inputs of the Kopeikin (1995, 1996) annual-orbital-parallax
        and proper-motion corrections, in this astrometry's native frame
        (reference `DDK_model.psr_pos`/`obs_pos`,
        `src/pint/models/stand_alone_psr_binaries/DDK_model.py:106`):

        ``(sin_long, cos_long, sin_lat, cos_lat, mu_long, mu_lat,
        obs_pos)`` with the proper motions in rad/yr and obs_pos in
        light-seconds, shape (N, 3)."""
        lon_name, lat_name = self._angle_names
        sl, cl = self._sincos(p, lon_name)
        sb, cb = self._sincos(p, lat_name)
        mu_lon = pv(p, self._pm_names[0]) * MAS_TO_RAD
        mu_lat = pv(p, self._pm_names[1]) * MAS_TO_RAD
        return sl, cl, sb, cb, mu_lon, mu_lat, self._obs_pos_frame(batch)

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
        """Linear proper-motion propagation of a unit vector, normalised
        by the square root of its sum of squares (``jnp.linalg.norm``'s
        value; the delay kernel forms it in this order)."""
        dn = (e_lon * pm_lon[..., None] + e_lat * pm_lat[..., None])
        n = n0 + dn * dt_yr[:, None]
        return n / torch.sqrt(torch.sum(n * n, dim=1, keepdim=True))


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


class AstrometryEcliptic(Astrometry):
    """Ecliptic-coordinate astrometry (ELONG/ELAT; reference
    `astrometry.py:942`).  The ecliptic→ICRS transform is a rotation by the
    mean obliquity about the x-axis; the convention is selected by ECL
    (default IERS2010, from the reference's `ecliptic.dat`)."""

    register = True
    _angle_names = ("ELONG", "ELAT")
    _pm_names = ("PMELONG", "PMELAT")

    def __init__(self):
        super().__init__()
        self.add_param(AngleParam("ELONG", units="deg",
                                  description="Ecliptic longitude",
                                  aliases=["LAMBDA"]))
        self.add_param(AngleParam("ELAT", units="deg",
                                  description="Ecliptic latitude",
                                  aliases=["BETA"]))
        self.add_param(FloatParam("PMELONG", value=0.0, units="mas/yr",
                                  description="PM in ecliptic longitude*cos(lat)",
                                  aliases=["PMLAMBDA"]))
        self.add_param(FloatParam("PMELAT", value=0.0, units="mas/yr",
                                  description="PM in ecliptic latitude",
                                  aliases=["PMBETA"]))

    def validate(self):
        self.require("ELONG", "ELAT")

    def obliquity(self) -> float:
        ecl = "IERS2010"
        if self._parent is not None and self._parent.ECL.value:
            ecl = self._parent.ECL.value
        try:
            return _OBLIQUITY[ecl]
        except KeyError:
            raise ValueError(f"unknown ecliptic convention ECL={ecl}")

    def _obs_pos_frame(self, batch: TOABatch) -> torch.Tensor:
        """ssb_obs_pos rotated ICRS -> this model's ecliptic frame."""
        eps = self.obliquity()
        ce, se = math.cos(eps), math.sin(eps)
        r = batch.ssb_obs_pos_ls
        x = r[:, 0]
        y = ce * r[:, 1] + se * r[:, 2]
        z = -se * r[:, 1] + ce * r[:, 2]
        return torch.stack([x, y, z], dim=-1)

    def psr_dir(self, p: dict, batch: TOABatch) -> torch.Tensor:
        n_toas = batch.ntoas
        sl, cl = self._sincos(p, "ELONG")
        sb, cb = self._sincos(p, "ELAT")
        n0 = _vec3(cb * cl, cb * sl, sb, n_toas)
        e_lon = _vec3(-sl, cl, torch.zeros_like(sl), n_toas)
        e_lat = _vec3(-sb * cl, -sb * sl, cb, n_toas)
        ep = self.pos_epoch_name()
        if ep:
            pm_lon = pv(p, "PMELONG") * MAS_TO_RAD
            pm_lat = pv(p, "PMELAT") * MAS_TO_RAD
            dt_yr = _epoch_dt_yr(p, batch, ep)
            n = self._propagate(n0, e_lon, e_lat,
                                torch.broadcast_to(pm_lon, (n_toas,)),
                                torch.broadcast_to(pm_lat, (n_toas,)), dt_yr)
        else:
            n = n0
        # rotate ecliptic -> equatorial ICRS: R_x(-obliquity)
        eps = self.obliquity()
        ce, se = math.cos(eps), math.sin(eps)
        x = n[:, 0]
        y = n[:, 1] * ce - n[:, 2] * se
        z = n[:, 1] * se + n[:, 2] * ce
        return torch.stack([x, y, z], dim=-1)


# -- frame conversion ---------------------------------------------------------
def _rot_eq_to_ecl(eps: float) -> np.ndarray:
    """Equatorial -> ecliptic rotation (about x by +obliquity)."""
    c, s_ = math.cos(eps), math.sin(eps)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, s_], [0.0, -s_, c]])


def _sph_dir(lon: float, lat: float) -> np.ndarray:
    return np.array([math.cos(lat) * math.cos(lon),
                     math.cos(lat) * math.sin(lon), math.sin(lat)])


def _tangent_basis(lon: float, lat: float):
    """(e_lon, e_lat) unit vectors of the local tangent plane."""
    e_lon = np.array([-math.sin(lon), math.cos(lon), 0.0])
    e_lat = np.array([-math.sin(lat) * math.cos(lon),
                      -math.sin(lat) * math.sin(lon), math.cos(lat)])
    return e_lon, e_lat


def convert_astrometry(model, target: str, ecl: str = "IERS2010"):
    """Return a NEW model with the astrometry component converted between
    equatorial (RAJ/DECJ/PMRA/PMDEC) and ecliptic (ELONG/ELAT/PMELONG/
    PMELAT) parameterizations — or between ecliptic obliquity conventions
    (reference `Astrometry.as_ECL/as_ICRS`,
    `src/pint/models/astrometry.py:840-1540`).  Position and
    proper-motion vectors rotate exactly; uncertainties rotate by the
    tangent-basis position angle (diagonal approximation, like the
    reference's fake-proper-motion trick); PX and POSEPOCH carry over.
    """
    from pint_tpu_torch.models import get_model

    target = target.upper()
    if target not in ("ECL", "ICRS"):
        raise ValueError("target must be 'ECL' or 'ICRS'")
    is_ecl = "ELONG" in model
    if is_ecl:
        current_ecl = model.ECL.value or "IERS2010"
        if target == "ECL" and current_ecl == ecl:
            return get_model(model.as_parfile().splitlines())
        if target == "ECL":
            # convention change: route through the equatorial frame
            return convert_astrometry(
                convert_astrometry(model, "ICRS"), "ECL", ecl=ecl)
    elif target == "ICRS":
        return get_model(model.as_parfile().splitlines())

    if is_ecl:  # ECL -> ICRS
        lon, lat = float(model.ELONG.value), float(model.ELAT.value)
        pm_lon = float(model.PMELONG.value or 0.0)
        pm_lat = float(model.PMELAT.value or 0.0)
        R = _rot_eq_to_ecl(
            model.components["AstrometryEcliptic"].obliquity()).T
        drop = {"ELONG", "ELAT", "PMELONG", "PMELAT", "ECL"}
        src_names = ("ELONG", "ELAT", "PMELONG", "PMELAT")
        new_names = ("RAJ", "DECJ", "PMRA", "PMDEC")
    else:       # ICRS -> ECL
        lon, lat = float(model.RAJ.value), float(model.DECJ.value)
        pm_lon = float(model.PMRA.value or 0.0)
        pm_lat = float(model.PMDEC.value or 0.0)
        R = _rot_eq_to_ecl(_OBLIQUITY[ecl])
        drop = {"RAJ", "DECJ", "PMRA", "PMDEC"}
        src_names = ("RAJ", "DECJ", "PMRA", "PMDEC")
        new_names = ("ELONG", "ELAT", "PMELONG", "PMELAT")

    n = R @ _sph_dir(lon, lat)
    e_lon, e_lat = _tangent_basis(lon, lat)
    mu = R @ (e_lon * pm_lon + e_lat * pm_lat)
    lat2 = math.asin(max(-1.0, min(1.0, n[2])))
    lon2 = math.atan2(n[1], n[0]) % (2 * math.pi)
    e_lon2, e_lat2 = _tangent_basis(lon2, lat2)
    pm_lon2, pm_lat2 = float(mu @ e_lon2), float(mu @ e_lat2)
    # tangent-basis position angle between the frames at this sky point
    cos_chi = float((R @ e_lon) @ e_lon2)
    sin_chi = float((R @ e_lon) @ e_lat2)

    # serialize the new angles through AngleParam (carry-safe sexagesimal)
    units_of = {"RAJ": "H:M:S", "DECJ": "D:M:S",
                "ELONG": "deg", "ELAT": "deg"}
    vals = dict(zip(new_names, (lon2, lat2, pm_lon2, pm_lat2)))
    add = []
    for nm in new_names[:2]:
        par = AngleParam(nm, units=units_of[nm])
        par.value = vals[nm]
        add.append((nm, par.value_as_string()))
    add += [(new_names[2], f"{vals[new_names[2]]:.10f}"),
            (new_names[3], f"{vals[new_names[3]]:.10f}")]
    if target == "ECL":
        add.append(("ECL", ecl))

    lines = []
    for line in model.as_parfile().splitlines():
        key = line.split()[0].upper() if line.split() else ""
        if key in drop:
            continue
        lines.append(line)
    for (nm, valstr), src in zip(add, src_names + ("",)):
        flag = " 1" if (src and src in model and
                        not model[src].frozen) else ""
        lines.append(f"{nm} {valstr}{flag}")
    out = get_model(lines)

    # rotate uncertainties (diagonal approximation): tangent-plane sigmas
    # transform by the position angle chi; longitude coordinates carry
    # their cos(lat) metric factor in and out
    s_lon = model[src_names[0]].device_uncertainty
    s_lat = model[src_names[1]].device_uncertainty
    if s_lon is not None or s_lat is not None:
        s_lon = (s_lon or 0.0) * abs(math.cos(lat))
        s_lat = s_lat or 0.0
        s_lon2 = math.hypot(cos_chi * s_lon, sin_chi * s_lat)
        s_lat2 = math.hypot(sin_chi * s_lon, cos_chi * s_lat)
        out[new_names[0]].set_device_uncertainty(
            s_lon2 / max(abs(math.cos(lat2)), 1e-12))
        out[new_names[1]].set_device_uncertainty(s_lat2)
    s_pml = model[src_names[2]].uncertainty
    s_pmb = model[src_names[3]].uncertainty
    if s_pml is not None or s_pmb is not None:
        s_pml = s_pml or 0.0
        s_pmb = s_pmb or 0.0
        out[new_names[2]].uncertainty = math.hypot(cos_chi * s_pml,
                                                   sin_chi * s_pmb)
        out[new_names[3]].uncertainty = math.hypot(sin_chi * s_pml,
                                                   cos_chi * s_pmb)
    return out


def host_psr_dir(model) -> np.ndarray:
    """ICRS unit vector to the pulsar from the model's host parameter
    values (no proper-motion propagation) — for host-side consumers that
    stay numpy.  Reuses the module's spherical/rotation helpers so the
    convention cannot drift from the device path."""
    astro = next(c for c in model.components.values()
                 if isinstance(c, Astrometry))
    if isinstance(astro, AstrometryEcliptic):
        n_ecl = _sph_dir(float(model.ELONG.value), float(model.ELAT.value))
        return _rot_eq_to_ecl(astro.obliquity()).T @ n_ecl
    return _sph_dir(float(model.RAJ.value), float(model.DECJ.value))
