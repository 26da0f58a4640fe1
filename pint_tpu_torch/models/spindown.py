"""Spindown: Taylor-series pulse phase from F0, F1, ... Fn.

Port of :mod:`pint_tpu.models.spindown`.  The reference values of
(PEPOCH, F0..Fn) reach the device as exact quad-single words and the big
Taylor sum runs in QS (~90 bits); the differentiable fit offsets
contribute through a plain-f64 Taylor term that is exact at offset scales:
phase = QS(Σ F_k dt^{k+1}/(k+1)!) + f64(Σ δF_k dt^{k+1}/(k+1)!).

:func:`phase_frac_plain` is the plain PyTorch version of the whole phase
chain that the CUDA kernel ``pint_tpu_torch/csrc/qs_phase.cu`` fuses
(epoch difference, spin Taylor series, the other phase components, TZR
subtraction, nearest-pulse rounding); :mod:`pint_tpu_torch.kernels.qs_phase`
wraps both, and ``csrc/phase_chain.cu`` runs the same row function as the
epilogue of the delay chain (:mod:`pint_tpu_torch.kernels.phase_chain`).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from pint_tpu_torch import qs
from pint_tpu_torch.models.parameter import (
    MJDParam,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import (
    PhaseComponent,
    dv,
    mjd_parts,
    pqs,
)
from pint_tpu_torch.toabatch import TOABatch
from pint_tpu_torch.utils import taylor_horner

SECS_PER_DAY = 86400.0
F32, F64 = torch.float32, torch.float64


def _dt_days_qs(tdb_day, frac_w, day0, frac0_words):
    """(t_TDB - epoch) [days] as a QS, from the integer-day difference
    (exact in f32: |Δday| < 2^24, formed by an exact f64 subtraction
    first) and the exact frac words of both epochs."""
    dday = (tdb_day.to(F64) - day0).to(F32)
    z = torch.zeros_like(dday)
    dt_days = qs.QS(dday, frac_w[:, 0], frac_w[:, 1], z)
    dt_days = qs.add(dt_days, qs.QS(frac_w[:, 2], z, z, z))
    return qs.sub(dt_days, qs.QS(*[torch.broadcast_to(x, dday.shape)
                                   for x in frac0_words]))


def _dt_seconds(dt_days: qs.QS, shift) -> qs.QS:
    dt_sec = qs.mul_w(dt_days, qs.f32(SECS_PER_DAY, dt_days.w0))
    return qs.add(dt_sec, qs.from_f64_device(shift))


def dt_seconds_qs(p: dict, batch: TOABatch, delay, epoch_name: str):
    """(t_TDB - epoch - delay) in seconds, as a (QS, float64 collapse)
    pair (:func:`pint_tpu.models.spindown.dt_seconds_qs`, f64 view)."""
    day0, frac0_qs, ddays = mjd_parts(p, epoch_name)
    dt_days = _dt_days_qs(batch.tdb_day, batch.tdb_frac_w, day0,
                          frac0_qs.words)
    # delay [s] (f64, <= ~1e3 s) and the epoch fit-offset [days] enter at
    # f64 precision, ample at their scales
    dt_sec = _dt_seconds(dt_days, -delay - ddays * SECS_PER_DAY)
    return dt_sec, qs.to_f64(dt_sec)


def _spin_qs(dt_qs: qs.QS, dt64, f_words, dF) -> qs.QS:
    """QS(Σ F_k dt^{k+1}/(k+1)!) + from_f64(Σ δF_k dt^{k+1}/(k+1)!), as
    :meth:`pint_tpu.models.spindown.Spindown.phase` sums it."""
    zero32 = torch.zeros_like(dt_qs.w0)
    coeffs = [qs.zeros_like(zero32)] + [
        qs.QS(*[torch.broadcast_to(w[j], zero32.shape) for j in range(4)])
        for w in f_words]
    ph = qs.horner_taylor(dt_qs, coeffs)
    dph = taylor_horner(dt64, [0.0] + list(dF))
    return qs.add(ph, qs.from_f64_device(dph))


def phase_frac_plain(tdb_day, frac_w, pep_day, pep_w, f_w, shift, dF,
                     other=None, tzr_w=None, pulse_number=None,
                     mode: str = "nearest"):
    """The plain PyTorch version of the phase kernel ``qs_phase_frac``.

    Per TOA row: dt = (tdb_day - pep_day) + frac words - PEPOCH frac words
    [days] -> x86400 -> + ``shift`` [s] (QS); phase = QS Taylor-Horner
    over the F words + the f64 Taylor term of the offsets ``dF``; the
    total ``qs.add(zeros, spin) [+ from_f64(other)] [- TZR words]``; then
    by ``mode``: "nearest" -> the f64 fraction after nearest-integer
    rounding (:func:`pint_tpu.residuals.raw_phase_resids`); "use_pulse_numbers"
    -> phase minus the (nan -> 0) pulse numbers, in f64; "words" -> the
    (..., N, 4) float32 words of the unrounded total.

    Shapes: ``tdb_day`` (N,) int64, ``frac_w`` (N, 3) f32, ``pep_day``
    f64 scalar, ``pep_w`` (4,) f32, ``f_w`` (K, 4) f32, ``shift`` and
    ``other`` (..., N) f64, ``dF`` (..., K) f64, ``tzr_w`` (4,) f32,
    ``pulse_number`` (N,) f64.  Returns ``(out, slope, dt64)`` with
    ``dt64`` = dt [s] and ``slope`` the secant frequency
    Σ_k F_k dt^k/(k+1)! of the F words plus Σ_k δF_k dt^k/k! of the
    offsets' float64 term, both f64 (..., N): pint_tpu's word-level
    d out / d shift on a millisecond pulsar, kept for the card's checks
    (the tangent is :func:`phase_frac_jvp`).

    Autodiff flows through the words, as it does in :mod:`pint_tpu`.
    """
    dt_qs = _dt_seconds(_dt_days_qs(tdb_day, frac_w, pep_day, pep_w), shift)
    dt64 = qs.to_f64(dt_qs)
    K = f_w.shape[0]
    dFk = [dF[..., k, None] for k in range(K)]
    total = qs.add(qs.zeros_like(torch.zeros_like(tdb_day, dtype=F32)),
                   _spin_qs(dt_qs, dt64, list(f_w), dFk))
    if other is not None:
        total = qs.add(total, qs.from_f64_device(other))
    if tzr_w is not None:
        total = qs.sub(total, qs.QS(*[torch.broadcast_to(tzr_w[k],
                                                         total.w0.shape)
                                      for k in range(4)]))
    F = qs.to_f64(qs.QS(*[f_w[:, j] for j in range(4)]))
    sec = der = torch.zeros_like(dt64)
    for k in reversed(range(K)):
        sec = sec * dt64 / (k + 2.0) + F[k]
        der = der * dt64 / (k + 1.0) + dFk[k]
    if mode == "words":
        out = torch.stack(total.words, dim=-1)
    elif mode == "nearest":
        _, frac = qs.round_nearest(total)
        out = qs.to_f64(frac)
    elif mode == "use_pulse_numbers":
        pn = torch.where(torch.isnan(pulse_number), 0.0, pulse_number)
        out = qs.to_f64(qs.sub(total, qs.from_f64_device(pn)))
    else:
        raise ValueError(f"unknown phase mode {mode!r}")
    return out, sec + der, dt64


def phase_frac_jvp(tdb_day, frac_w, pep_day, pep_w, f_w, shift, dF, other,
                   tzr_w, pulse_number, mode, dshift, ddF, dother):
    """d out of :func:`phase_frac_plain` ("nearest" or
    "use_pulse_numbers") along the float64 tangents ``dshift``, ``ddF``
    and ``dother`` (None: zero), as pint_tpu's word-level forward mode
    forms it: each tangent enters the quad-single chain where its value
    does (``from_f64_device`` and ``add``), the float32 words carry their
    own tangents through every operation of :mod:`pint_tpu_torch.qs` in
    its order (the Taylor-Horner products, the renormalizations, the
    rounding's word subtractions; ``round`` has none), and ``to_f64``
    sums them.  On a young pulsar that tangent is the float32 rounding of
    the instantaneous frequency, not linear in ``dshift``; on a
    millisecond pulsar it is the primal's ``slope`` (the secant
    frequency) times ``dshift`` up to the words' last bits.  Forward mode
    of the plain version itself (``torch.func.jvp``), so the arithmetic
    is the primal's."""
    if mode == "words":
        raise NotImplementedError("the words mode carries no tangent")
    given = [(k, x, t) for k, x, t in (("shift", shift, dshift),
                                        ("dF", dF, ddF),
                                        ("other", other, dother))
             if x is not None and t is not None]
    if not given:
        return torch.zeros_like(shift)
    keys = [k for k, _, _ in given]

    def frac(*xs):
        a = dict(shift=shift, dF=dF, other=other)
        a.update(zip(keys, xs))
        return phase_frac_plain(tdb_day, frac_w, pep_day, pep_w, f_w,
                                a["shift"], a["dF"], a["other"], tzr_w,
                                pulse_number, mode)[0]

    return torch.func.jvp(frac, tuple(x for _, x, _ in given),
                          tuple(t for _, _, t in given))[1]


class Spindown(PhaseComponent):
    """Pulsar spin-down polynomial phase."""

    register = True
    category = "spindown"

    def __init__(self, max_order: int = 12):
        super().__init__()
        self.add_param(MJDParam("PEPOCH",
                                description="Epoch of spin measurements"))
        self.add_param(prefixParameter("float", "F0", units="Hz",
                                       description_template=lambda i:
                                       f"Spin frequency derivative {i}" if i
                                       else "Spin frequency",
                                       long_double=True))
        self._max_order = max_order

    def validate(self):
        self.require("F0")
        fs = self.f_names()
        for i, n in enumerate(fs):
            if n != f"F{i}":
                raise ValueError(f"non-contiguous spin sequence at {n}")
        if self.PEPOCH.value is None and len(fs) > 1:
            raise ValueError("PEPOCH is required when fitting derivatives")

    def f_names(self) -> List[str]:
        return [p.name for p in self.prefix_params("F")]

    def qs_param_names(self):
        return self.f_names()

    def add_f_term(self, index: int, value=0.0, frozen=True):
        return self.add_param(
            prefixParameter("float", f"F{index}",
                            units=f"Hz/s^{index}" if index else "Hz",
                            value=value, frozen=frozen, long_double=True))

    def make_param(self, name):
        prefix, index = split_prefix(name)
        if prefix == "F" and index <= self._max_order:
            return prefixParameter("float", name,
                                   units=f"Hz/s^{index}" if index else "Hz",
                                   long_double=True)
        return None

    def _require_epoch(self):
        if self.PEPOCH.value is None:
            raise NotImplementedError(
                "Spindown without PEPOCH is not ported (the model's "
                "validate() sets it from TZRMJD when AbsPhase is present)")

    def phase(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        """The plain QS phase (:meth:`pint_tpu.models.spindown.Spindown.phase`)."""
        self._require_epoch()
        names = self.f_names()
        dt_qs, dt64 = dt_seconds_qs(p, batch, delay, "PEPOCH")
        return _spin_qs(dt_qs, dt64, [torch.stack(pqs(p, n).words)
                                      for n in names],
                        [dv(p, n) for n in names])

    def spin_inputs(self, p: dict, batch: TOABatch):
        """``(pep_day, pep_w, f_w, dF, ddays)`` of the phase kernels:
        PEPOCH's integer day and frac words, the (K, 4) F words, the (K,)
        float64 offsets and PEPOCH's fit offset [days] (a tensor, or
        0.0 when PEPOCH carries none)."""
        self._require_epoch()
        names = self.f_names()
        day0, frac0_qs, ddays = mjd_parts(p, "PEPOCH")
        f_w = torch.stack([torch.stack(pqs(p, n).words) for n in names])
        dF = torch.stack([torch.as_tensor(dv(p, n), dtype=F64,
                                          device=batch.device)
                          for n in names])
        return day0, torch.stack(frac0_qs.words), f_w, dF, ddays

    def kernel_inputs(self, p: dict, batch: TOABatch, delay):
        """``(pep_day, pep_w, f_w, shift, dF)`` of the phase kernel
        ``qs_phase_frac``: :meth:`spin_inputs` with the f64 row shift
        ``-delay - δPEPOCH·86400`` [s] in place of δPEPOCH."""
        day0, pep_w, f_w, dF, ddays = self.spin_inputs(p, batch)
        shift = -delay - ddays * SECS_PER_DAY
        return day0, pep_w, f_w, shift, dF
