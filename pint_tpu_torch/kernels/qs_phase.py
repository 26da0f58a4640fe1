"""Wrapper of the ``qs_phase_frac`` CUDA kernel (``csrc/qs_phase.cu``).

:func:`qs_phase_frac` evaluates the quad-single pulse-phase chain of a
timing model — epoch difference, spin Taylor series, the other phase
components, TZR subtraction and nearest-pulse rounding — for every
(grid point, TOA) row in one launch.  Tensors on a CUDA device launch the
kernel (or raise); tensors on the CPU run its plain version,
:func:`pint_tpu_torch.models.spindown.phase_frac_plain`.  There is no
fallback from one to the other.

:class:`QSPhaseFrac` makes it a differentiable operation for
``torch.func``: forward mode through pint_tpu's word-level tangent
(:func:`pint_tpu_torch.models.spindown.phase_frac_jvp`: each float64
tangent enters the quad-single words where its value does and every word
operation carries its float32 tangent, in eager PyTorch on the inputs'
device), and a ``vmap`` rule that folds batched grid points into the
kernel's row axis, so ``torch.func.vmap`` over a grid still makes one
launch.  The kernel runs once per primal evaluation however many tangent
lanes ``torch.func.jacfwd`` pushes through the rule.  This unfused chain
is the card's reference for the fused ``phase_chain`` kernel, whose
tangent launch forms the same words lane by lane.

The kernel also returns ``dt`` and ``slope`` = Σ_k F_k dt^k/(k+1)! +
Σ_k δF_k dt^k/k!: pint_tpu's word-level tangent in the shift on a
millisecond pulsar (the *secant* frequency of the F words, to the last
bit), which a young pulsar's F1 resolves into the instantaneous one,
float32-rounded and not linear in the shift's tangent
(tests/test_torch_phase_family.py); no tangent reads it.

``QSPhaseFrac.launches`` counts kernel launches (plain runs do not count).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from pint_tpu_torch.models.spindown import phase_frac_jvp, phase_frac_plain

F32, F64 = torch.float32, torch.float64
MODES = {"nearest": 0, "use_pulse_numbers": 1, "words": 2}

_c_void_p, _c_int, _c_int64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@dataclasses.dataclass(frozen=True, eq=False)
class PhaseSpec:
    """The kernel's inputs that carry no tangent and no grid axis: the TOA
    epochs, PEPOCH, the spin-frequency words, the TZR words, the pulse
    numbers and the output mode."""

    tdb_day: torch.Tensor            # (N,) int64
    frac_w: torch.Tensor             # (N, 3) float32
    pep_day: torch.Tensor            # () float64, integer-valued
    pep_w: torch.Tensor              # (4,) float32
    f_w: torch.Tensor                # (K, 4) float32
    tzr_w: Optional[torch.Tensor]    # (4,) float32
    pulse_number: Optional[torch.Tensor]  # (N,) float64
    mode: str

    def values(self) -> tuple:
        """The fields in order (tensors not copied, unlike astuple)."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def plain(self, shift, dF, other):
        return phase_frac_plain(self.tdb_day, self.frac_w, self.pep_day,
                                self.pep_w, self.f_w, shift, dF, other,
                                self.tzr_w, self.pulse_number, self.mode)

    def jvp(self, shift, dF, other, dshift, ddF, dother):
        """The word-level tangent of ``out`` (:func:`phase_frac_jvp`),
        in eager PyTorch on the inputs' device."""
        return phase_frac_jvp(self.tdb_day, self.frac_w, self.pep_day,
                              self.pep_w, self.f_w, shift, dF, other,
                              self.tzr_w, self.pulse_number, self.mode,
                              dshift, ddF, dother)


def _lib():
    from pint_tpu_torch.kernels.build import load

    lib = load("qs_phase")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.qs_phase_frac.argtypes = (
        [_c_void_p] * 5 + [_c_int] + [_c_void_p] * 9
        + [_c_int64, _c_int64, _c_int, _c_void_p])
    lib.qs_phase_frac.restype = _c_int
    lib.qs_phase_error_string.argtypes = [_c_int]
    lib.qs_phase_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(spec: PhaseSpec, shift, dF, other):
    """Run the CUDA kernel on ``shift`` (..., N), ``dF`` (..., K) and
    ``other`` (..., N), broadcast over their leading axes."""
    dev = shift.device
    N, K = spec.tdb_day.shape[0], spec.f_w.shape[0]
    static = [spec.tdb_day, spec.frac_w, spec.pep_day, spec.pep_w, spec.f_w,
              spec.tzr_w, spec.pulse_number]
    for t in static + [dF, other]:
        if t is not None and t.device != dev:
            raise ValueError(
                f"qs_phase_frac: inputs on {t.device} and {dev}")
    want = {"tdb_day": ((N,), torch.int64), "frac_w": ((N, 3), F32),
            "pep_day": ((), F64), "pep_w": ((4,), F32), "f_w": ((K, 4), F32),
            "tzr_w": ((4,), F32), "pulse_number": ((N,), F64)}
    for name, (shape, dtype) in want.items():
        t = getattr(spec, name)
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype):
            raise ValueError(
                f"qs_phase_frac: {name} must be {dtype} of shape {shape}, "
                f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("shift", shift), ("dF", dF), ("other", other)):
        if t is not None and t.dtype != F64:
            raise ValueError(f"qs_phase_frac: {name} must be float64")
    if shift.shape[-1] != N or dF.shape[-1] != K or (
            other is not None and other.shape[-1] != N):
        raise ValueError("qs_phase_frac: row or term axis mismatch")
    lead = torch.broadcast_shapes(
        shift.shape[:-1], dF.shape[:-1],
        () if other is None else other.shape[:-1])
    G = 1
    for s in lead:
        G *= s
    shift = shift.expand(*lead, N).contiguous()
    dF = dF.expand(*lead, K).contiguous()
    if other is not None:
        other = other.expand(*lead, N).contiguous()
    static = [None if t is None else t.contiguous() for t in static]
    words = spec.mode == "words"
    out = torch.empty((*lead, N, 4) if words else (*lead, N),
                      dtype=F32 if words else F64, device=dev)
    slope = torch.empty((*lead, N), dtype=F64, device=dev)
    dt64 = torch.empty((*lead, N), dtype=F64, device=dev)
    tdb_day, frac_w, pep_day, pep_w, f_w, tzr_w, pn = static
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().qs_phase_frac(
        _ptr(tdb_day), _ptr(frac_w), _ptr(pep_day), _ptr(pep_w), _ptr(f_w),
        K, _ptr(tzr_w), _ptr(pn), _ptr(shift), _ptr(dF), _ptr(other),
        None if words else _ptr(out), _ptr(out) if words else None,
        _ptr(slope), _ptr(dt64), G, N, MODES[spec.mode], stream)
    if err != 0:
        raise RuntimeError("qs_phase_frac launch failed: "
                           + _lib().qs_phase_error_string(err).decode())
    QSPhaseFrac.launches += 1
    return out, slope, dt64


def run(spec: PhaseSpec, shift, dF, other):
    """``(out, slope, dt64)``: the kernel on CUDA tensors, the plain
    version on CPU tensors, and an error on anything else."""
    for t in (shift, dF, other, *spec.values()[:-1]):
        if t is not None and _is_wrapped(t):
            raise TypeError(
                "qs_phase_frac: an input is still wrapped by a torch.func "
                "transform; pass every tensor through QSPhaseFrac.apply")
    if shift.is_cuda:
        return _launch(spec, shift, dF, other)
    if shift.device.type == "cpu":
        return spec.plain(shift, dF, other)
    raise ValueError(f"qs_phase_frac: unsupported device {shift.device}")


def _is_wrapped(t) -> bool:
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


def _to_front(x, d, B):
    if x is None:
        return None
    if d is None:
        return x.expand(B, *x.shape)
    return x.movedim(d, 0)


class QSPhaseFrac(torch.autograd.Function):
    """``(shift, dF, other, *static, mode) -> (frac, slope, dt64)`` with
    the word-level forward-mode tangent of ``frac``; ``slope`` and
    ``dt64`` carry none.  ``static`` are the PhaseSpec tensors (tdb_day, frac_w,
    pep_day, pep_w, f_w, tzr_w, pulse_number): they pass through
    ``apply`` as arguments so that torch.func unwraps them before the
    kernel reads their pointers (``torch.func.jvp`` wraps every tensor
    argument of the function it differentiates, constants included)."""

    #: kernel launches in this process (plain CPU runs are not counted)
    launches = 0

    @staticmethod
    def forward(shift, dF, other, *static_and_mode):
        return run(PhaseSpec(*static_and_mode), shift, dF, other)

    @staticmethod
    def setup_context(ctx, inputs, output):
        shift, dF, other, *static_and_mode = inputs
        _, slope, dt64 = output
        ctx.mark_non_differentiable(slope, dt64)
        ctx.mode = static_and_mode[-1]
        ctx.save_for_forward(shift, dF, other, *static_and_mode[:-1])

    @staticmethod
    def jvp(ctx, dshift, ddF, dother, *_static_tangents):
        shift, dF, other, *static = ctx.saved_tensors
        spec = PhaseSpec(*static, ctx.mode)
        return spec.jvp(shift, dF, other, dshift, ddF, dother), None, None

    @staticmethod
    def vmap(info, in_dims, shift, dF, other, *static_and_mode):
        if any(d is not None for d in in_dims[3:]):
            raise NotImplementedError(
                "qs_phase_frac: only shift, dF and other may carry a vmap "
                "axis")
        B = info.batch_size
        ds, dd, do = in_dims[:3]
        out = QSPhaseFrac.apply(_to_front(shift, ds, B), _to_front(dF, dd, B),
                                _to_front(other, do, B), *static_and_mode)
        return out, (0, 0, 0)

    @staticmethod
    def call(spec: PhaseSpec, shift, dF, other):
        """``apply`` with the spec's tensors as arguments."""
        return QSPhaseFrac.apply(shift, dF, other, *spec.values())


def qs_phase_frac(tdb_day, frac_w, pep_day, pep_w, f_w, shift, dF,
                  other=None, tzr_w=None, pulse_number=None,
                  mode: str = "nearest"):
    """The phase chain of the kernel (see
    :func:`pint_tpu_torch.models.spindown.phase_frac_plain` for the
    inputs): for "nearest"/"use_pulse_numbers" the (..., N) float64
    phase, differentiable in ``shift``, ``dF`` and ``other``; for
    "words" the (..., N, 4) float32 words of the unrounded total phase
    (no tangent)."""
    if mode not in MODES:
        raise ValueError(f"unknown phase mode {mode!r}")
    spec = PhaseSpec(tdb_day, frac_w, torch.as_tensor(pep_day, dtype=F64,
                                                      device=shift.device),
                     pep_w, f_w, tzr_w, pulse_number, mode)
    if mode == "words":
        return run(spec, shift, dF, other)[0]
    return QSPhaseFrac.call(spec, shift, dF, other)[0]
