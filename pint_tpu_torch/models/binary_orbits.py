"""Shared orbital kinematics for binary components.

Port of the parts of :mod:`pint_tpu.models.binary_orbits` that the ELL1
family uses (reference `OrbitPB`/`OrbitFBX`,
`src/pint/models/stand_alone_psr_binaries/binary_orbits.py`):
orbit counts and frequency from PB/PBDOT or the FBn series, the ORBWAVE
Fourier variations, the straight-through saturation :func:`clip_unit`,
the plain Kepler solve :func:`kepler_E` and the continuous true anomaly.

:func:`kepler_E` here is the plain PyTorch version of the ``kepler_E``
CUDA kernel (``pint_tpu_torch/csrc/kepler.cu``); the DD family calls the
kernel's wrapper :func:`pint_tpu_torch.kernels.kepler.kepler_E_op`, which
carries pint_tpu's implicit-function tangent and runs this function on
CPU tensors.
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch.models.timing_model import pv
from pint_tpu_torch.utils import taylor_horner, taylor_horner_deriv


#: ceiling for saturating eccentricity/sin-inclination into [0, 1)
UNIT_MAX = 1.0 - 1e-9


class _ClipUnit(torch.autograd.Function):
    """clamp into [0, UNIT_MAX] with a straight-through tangent."""

    generate_vmap_rule = True

    @staticmethod
    def forward(v):
        return torch.clamp(v, 0.0, UNIT_MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, dv):
        return dv

    @staticmethod
    def backward(ctx, g):
        return g


def clip_unit(v):
    """Saturate e or sin(i) into [0, 1) with a straight-through gradient
    (:func:`pint_tpu.models.binary_orbits.clip_unit`): a trial step
    outside [0, 1) keeps a finite delay AND a live design-matrix column
    pointing back into the physical region."""
    return _ClipUnit.apply(torch.as_tensor(v, dtype=torch.float64))


#: Newton steps of the Kepler solve (each doubles the converged digits
#: from the E0 = M + e sin M start; ample for e < 0.95)
KEPLER_NEWTON_STEPS = 12


def kepler_E(M, e):
    """Solve E - e sin(E) = M for the eccentric anomaly by a fixed count of
    Newton steps in float64 (:func:`pint_tpu.models.binary_orbits.kepler_E`,
    its primal).  e is clipped into [0, 1 - 1e-9] first, so an unphysical
    eccentricity gives a finite answer instead of the hyperbolic NaN.
    Autodiff through this function differentiates the iteration; the
    kernel's wrapper gives the implicit-function tangent instead."""
    e = torch.clamp(e, 0.0, UNIT_MAX)
    E = M + e * torch.sin(M)
    for _ in range(KEPLER_NEWTON_STEPS):
        E = E - (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
    return E


def true_anomaly_continuous(E, e, orbits, M):
    """True anomaly, continuous across orbits (reference `nu`,
    `binary_generic.py:536`): the principal value from the half-angle
    form, unwrapped by the integer orbit count."""
    nu = 2.0 * torch.atan2(torch.sqrt(1.0 + e) * torch.sin(E / 2.0),
                           torch.sqrt(1.0 - e) * torch.cos(E / 2.0))
    nu = torch.where(nu < 0.0, nu + 2.0 * math.pi, nu)
    return 2.0 * math.pi * orbits + nu - M


def orbits_and_freq(p: dict, dt, fb_names):
    """(orbit count, instantaneous orbital frequency [1/s]) at
    dt = t - epoch, from either the FBn Taylor series or PB/PBDOT
    (reference `OrbitFBX.orbits`/`OrbitPB.orbits`)."""
    if fb_names:
        coeffs = [0.0] + [pv(p, n) for n in fb_names]
        return taylor_horner(dt, coeffs), taylor_horner_deriv(dt, coeffs, 1)
    pb = pv(p, "PB")
    pbdot = pv(p, "PBDOT")
    phase = dt / pb - 0.5 * pbdot * (dt / pb) ** 2
    freq = (1.0 - pbdot * (dt / pb)) / pb
    return phase, freq


def orbwave_delta(p, batch, delay_sec, c_names, s_names):
    """(delta_orbits, delta_freq [1/s]) of the ORBWAVE Fourier series for
    orbital-phase variations (reference `OrbitWaves._deltaPhi`,
    `stand_alone_psr_binaries/binary_orbits.py:243`; an alternative to
    the FBn Taylor expansion):

        dphi = sum_n [ C_n cos((n+1) OM tw) + S_n sin((n+1) OM tw) ]

    with tw = t_bary - ORBWAVE_EPOCH [s] (barycentric arrival time, i.e.
    TDB minus the accumulated delay, matching the reference's
    `OrbitWaves._tw`) and OM = ORBWAVE_OM [rad/s]."""
    om = pv(p, "ORBWAVE_OM")
    tw = (batch.tdb_day + batch.tdb_frac
          - pv(p, "ORBWAVE_EPOCH")) * 86400.0 - delay_sec
    dphi = torch.zeros_like(tw)
    dfreq = torch.zeros_like(tw)
    for k, (cn, sn) in enumerate(zip(c_names, s_names)):
        w = (k + 1.0) * om
        arg = w * tw
        cc, ss = torch.cos(arg), torch.sin(arg)
        C, S = pv(p, cn), pv(p, sn)
        dphi = dphi + C * cc + S * ss
        # d(orbits)/dt — dphi is already in orbit counts, plain chain rule
        dfreq = dfreq + w * (S * cc - C * ss)
    return dphi, dfreq


class OrbwaveMixin:
    """Shared ORBWAVE plumbing for the DD and ELL1 binary families:
    parameter creation, on-demand prefixed members, contiguity
    validation, and application to (orbits, frequency).

    Host classes call :meth:`_init_orbwave_params` from ``__init__``,
    include :meth:`_make_orbwave_param`'s result in ``make_param``,
    ``"ORBWAVEC"/"ORBWAVES"`` in ``prefix_families``,
    :meth:`_validate_orbwaves` in ``validate``, and
    :meth:`_apply_orbwaves` after the Taylor orbit computation."""

    def _init_orbwave_params(self):
        from pint_tpu_torch.models.parameter import FloatParam

        self.add_param(FloatParam(
            "ORBWAVE_OM", units="rad/s",
            description="ORBWAVE base angular frequency"))
        self.add_param(FloatParam(
            "ORBWAVE_EPOCH", units="d",
            description="ORBWAVE reference epoch"))

    @staticmethod
    def _make_orbwave_param(stem, name):
        from pint_tpu_torch.models.parameter import prefixParameter

        if stem in ("ORBWAVEC", "ORBWAVES"):
            return prefixParameter("float", name, units="",
                                   description_template=lambda i:
                                   f"ORBWAVE harmonic {i}")
        return None

    def orbwave_names(self):
        cs = sorted((q.index, q.name)
                    for q in self.prefix_params("ORBWAVEC")
                    if q.value is not None)
        ss = sorted((q.index, q.name)
                    for q in self.prefix_params("ORBWAVES")
                    if q.value is not None)
        return [n for _, n in cs], [n for _, n in ss]

    def _validate_orbwaves(self):
        cs, ss = self.orbwave_names()
        if len(cs) != len(ss):
            raise ValueError(
                f"ORBWAVE needs matching C/S pairs (got {len(cs)} C, "
                f"{len(ss)} S)")
        # harmonic number comes from the index: a gap would silently
        # shift every higher harmonic (reference OrbitWaves raises the
        # same way, binary_orbits.py:281)
        for i, (cn, sn) in enumerate(zip(cs, ss)):
            if cn != f"ORBWAVEC{i}" or sn != f"ORBWAVES{i}":
                raise ValueError(
                    "ORBWAVE indices must run 0..k without gaps "
                    f"(found {cn}/{sn} at position {i})")
        if cs and self.params["ORBWAVE_OM"].value is None:
            raise ValueError("ORBWAVEs require ORBWAVE_OM")
        if cs and self.params["ORBWAVE_EPOCH"].value is None:
            raise ValueError("ORBWAVEs require ORBWAVE_EPOCH")

    def _apply_orbwaves(self, p, batch, delay_sec, orbits, forb):
        cs, ss = self.orbwave_names()
        if not cs:
            return orbits, forb
        dphi, dfreq = orbwave_delta(p, batch, delay_sec, cs, ss)
        return orbits + dphi, forb + dfreq
