"""Wrapper of the ``phase_chain`` CUDA kernel (``csrc/phase_chain.cu``).

:func:`phase_frac` is the residual phase of a timing model
(:meth:`~pint_tpu_torch.models.timing_model.PhaseCalc.phase_frac`).  On a
CUDA batch the delay chain and the quad-single phase run fused: the
``delay_chain`` kernel's row function with the ``qs_phase_frac`` row
function as its epilogue, so a residual evaluation is one primal launch
and, under ``torch.func.jacfwd``, one tangent launch; the delay, the
row shift and the delay's tangents never reach device memory.  On a CPU
batch it is the plain composition, :func:`unfused` with the components'
own delays: :meth:`PhaseCalc.delay_plain`, the shift ``-delay -
δPEPOCH·86400`` in PyTorch, and
:func:`~pint_tpu_torch.models.spindown.phase_frac_plain` through
:class:`~pint_tpu_torch.kernels.qs_phase.QSPhaseFrac`'s tangent rule.
There is no fallback from one to the other: a failed build or launch
raises.

The kernel's θ is the delay chain's θ (:class:`ChainLayout`), followed
by the K spin offsets δF_k and PEPOCH's offset [days]; ``other``, the
float64 phase of the components after the Spindown (the phase JUMPs), and
its tangent are row inputs.  :class:`PhaseChain` makes it differentiable
in forward mode: ``jvp`` is one tangent launch, which reads the primal's
``slope`` and ``dt64`` and forms each lane's d frac in the order of
``QSPhaseFrac.jvp`` applied to the shift's forward rule,

    d frac = (0 + slope · d shift) + Σ_k dt^{k+1}/(k+1)! · d δF_k [+ d other],
    d shift = (-d delay) - d δPEPOCH · 86400,

so that it is bit-equal to the unfused chain (K4's tangent launch, the
shift's rule, QSPhaseFrac.jvp) up to the sign of a zero.  The ``vmap``
rules fold a batch of tangents of one θ into the launch's lane axis and a
batch of θ into its θ-set axis: a ``vmap`` over grid points of a
``jacfwd`` is one primal and one tangent launch.  There is no reverse
mode (QSPhaseFrac has none, and no path uses one).

``PhaseChain.launches`` counts primal launches and
``PhaseChainTangent.launches`` tangent ones (plain runs do not count).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.kernels import qs_phase
from pint_tpu_torch.kernels.qs_phase import MODES

F32, F64 = torch.float32, torch.float64


class PhaseCfg(ctypes.Structure):
    """csrc/phase_chain.cuh ``PhaseCfg``: the spin terms, the slots of
    the spin offsets and of PEPOCH's offset, θ's length and the mode."""

    _fields_ = [(n, ctypes.c_int32) for n in ("K", "o_spin", "o_pep", "P",
                                                "mode")]


@dataclasses.dataclass(frozen=True, eq=False)
class PhaseChainSpec:
    """The structure of one launch: the delay chain's layout, the number
    of spin terms and the output mode."""

    layout: dc.ChainLayout
    K: int
    mode: str

    @property
    def P(self) -> int:
        """The fused θ's length: the delay chain's slots, the K spin
        offsets and PEPOCH's offset."""
        return self.layout.P + self.K + 1

    def ctypes_cfg(self) -> PhaseCfg:
        P4 = self.layout.P
        return PhaseCfg(self.K, P4, P4 + self.K, self.P, MODES[self.mode])


#: the phase's tensors after the delay chain's rows (delay_chain.ROWS), in
#: the kernel's order; pulse_number and tzr_w may be None
CONSTS = ("pulse_number", "pep_day", "pep_w", "f_w", "tzr_w")


def _lib(spec: "PhaseChainSpec"):
    """The library that holds ``spec``'s kernels (one part of the
    source's build, kernels/build.py)."""
    from pint_tpu_torch.kernels.build import load, part_of

    lib = load(part_of("phase_chain", spec.layout.kernel_index))
    if getattr(lib, "_argtypes_set", False):
        return lib
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.phase_chain.argtypes = [vp] * (len(dc.ROWS) + 15) + [
        dc.ChainCfg, PhaseCfg, i64, i64, i64, i64, i64, i64, ctypes.c_int,
        vp]
    lib.phase_chain.restype = ctypes.c_int
    lib.phase_chain_error_string.argtypes = [ctypes.c_int]
    lib.phase_chain_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _check_consts(spec: PhaseChainSpec, consts, N: int, dev):
    want = {"pulse_number": ((N,), F64), "pep_day": ((), F64),
            "pep_w": ((4,), F32), "f_w": ((spec.K, 4), F32),
            "tzr_w": ((4,), F32)}
    for name, t in zip(CONSTS, consts):
        shape, dtype = want[name]
        if t is None:
            if name in ("pep_day", "pep_w", "f_w") or (
                    name == "pulse_number"
                    and spec.mode == "use_pulse_numbers"):
                raise ValueError(f"phase_chain: {name} is required")
            continue
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"phase_chain: {name} must be {dtype} of shape {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _rows_of(x, lead, tail, name, dev):
    """``x`` (..., *tail) as (pointer tensor, θ-set stride): a tensor of
    the trailing shape alone is shared by every θ set (stride 0), any
    other is broadcast to (*lead, *tail) (its leading axes aligned from
    the right, as in broadcasting) and made contiguous."""
    if x is None:
        return None, 0
    if x.dtype != F64 or x.device != dev:
        raise ValueError(f"phase_chain: {name} must be float64 on {dev}")
    size = 1
    for s in tail:
        size *= s
    if x.dim() == len(tail):
        if tuple(x.shape) != tuple(tail):
            raise ValueError(f"phase_chain: {name} must end in {tail}")
        return x.contiguous(), 0
    return x.expand(*lead, *tail).contiguous(), size


def _launch(spec: PhaseChainSpec, theta, other, tensors, dtheta=None,
            slope=None, dt64=None, dother=None, lanes: Optional[int] = None):
    """One launch on ``theta`` (..., P): the primal ``(out, slope, dt64)``
    with ``out`` the (..., N) phase or the (..., N, 4) words; or, with
    ``dtheta`` (..., K, P), the primal's ``slope`` and ``dt64`` and
    ``dother`` (..., K, N) or None, the (..., K, N) d frac of the K
    lanes, each thread carrying ``lanes`` of them (by default
    :func:`delay_chain.lanes_per_thread`)."""
    dev = theta.device
    rows, consts = list(tensors[:len(dc.ROWS)]), tensors[len(dc.ROWS):]
    N = dc._check_rows(rows, dev)
    _check_consts(spec, consts, N, dev)
    P = spec.P
    lead = theta.shape[:-1]
    if theta.dtype != F64 or theta.shape[-1] != P or (
            dtheta is not None and (
                dtheta.dtype != F64 or dtheta.device != dev
                or dtheta.dim() != theta.dim() + 1
                or dtheta.shape[:-2] != lead or dtheta.shape[-1] != P)):
        raise ValueError(f"phase_chain: theta must be float64 (..., {P}) "
                         f"on {dev} and its tangent (..., K, {P}) with the "
                         f"same leading axes, got {tuple(theta.shape)} and "
                         f"{None if dtheta is None else tuple(dtheta.shape)}")
    G = 1
    for s in lead:
        G *= s
    theta = theta.contiguous()
    rows = [t.contiguous() for t in rows]
    consts = [None if t is None else t.contiguous() for t in consts]
    cfg, pcfg = spec.layout.ctypes_cfg(), spec.ctypes_cfg()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dtheta is None:
        other, other_sg = _rows_of(other, lead, (N,), "other", dev)
        words = spec.mode == "words"
        out = torch.empty((*lead, N, 4) if words else (*lead, N),
                          dtype=F32 if words else F64, device=dev)
        slope = torch.empty((*lead, N), dtype=F64, device=dev)
        dt64 = torch.empty((*lead, N), dtype=F64, device=dev)
        if G == 0:
            return out, slope, dt64
        err = _lib(spec).phase_chain(
            *[_ptr(t) for t in rows + consts], theta.data_ptr(), None,
            _ptr(other), None, None, None, None if words else out.data_ptr(),
            out.data_ptr() if words else None, slope.data_ptr(),
            dt64.data_ptr(), cfg, pcfg, G, 0, N, other_sg, 0, 0, 0, stream)
        _raise(spec, err)
        PhaseChain.launches += 1
        return out, slope, dt64
    K = dtheta.shape[-2]
    if lanes is None:
        lanes = dc.lanes_per_thread(G, K)
    if lanes not in dc.KERNEL_LANES:
        raise ValueError(f"phase_chain: lanes per thread must be one of "
                         f"{dc.KERNEL_LANES}, got {lanes}")
    pair = []
    for name, t in (("slope", slope), ("dt64", dt64)):
        if t is None or t.dtype != F64 or t.device != dev:
            raise ValueError(f"phase_chain: the tangent launch needs the "
                             f"primal's float64 {name} on {dev}")
        pair.append(t.expand(*lead, N).contiguous())
    dother, dother_sg = _rows_of(dother, lead, (K, N), "dother", dev)
    dtheta = dtheta.contiguous()
    out = torch.empty((*lead, K, N), dtype=F64, device=dev)
    if G == 0 or K == 0:
        return out
    err = _lib(spec).phase_chain(
        *[_ptr(t) for t in rows + consts], theta.data_ptr(),
        dtheta.data_ptr(), None, _ptr(dother), pair[0].data_ptr(),
        pair[1].data_ptr(), out.data_ptr(), None, None, None, cfg, pcfg, G,
        K, N, 0, dother_sg, N, lanes, stream)
    _raise(spec, err)
    PhaseChainTangent.launches += 1
    return out


def _raise(spec: PhaseChainSpec, err: int) -> None:
    if err != 0:
        raise RuntimeError("phase_chain launch failed: "
                           + _lib(spec).phase_chain_error_string(err).decode())


def run(spec: PhaseChainSpec, theta, other, tensors, dtheta=None,
        slope=None, dt64=None, dother=None, lanes: Optional[int] = None):
    """The kernel on CUDA tensors; an error on anything else (the plain
    composition is :func:`unfused`, which :func:`phase_frac` takes for
    a CPU batch)."""
    for t in (theta, other, dtheta, slope, dt64, dother, *tensors):
        if t is not None and \
                torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise TypeError(
                "phase_chain: an input is still wrapped by a torch.func "
                "transform; pass every tensor through PhaseChain.apply")
    if not theta.is_cuda:
        raise ValueError(
            f"phase_chain: the kernel runs on CUDA tensors, not "
            f"{theta.device}; PhaseCalc.phase_frac takes the plain "
            "composition on the CPU")
    return _launch(spec, theta, other, tensors, dtheta, slope, dt64, dother,
                   lanes)


def _front(x, d, B):
    if x is None:
        return None
    return x.expand(B, *x.shape) if d is None else x.movedim(d, 0)


def _rows_front(x, d):
    """``other`` or ``dother`` with its vmap axis in front; unbatched, it
    stays as it is, read by every θ set through a stride of 0 (no copy of
    a (θ sets, lanes, N) tangent that is the same for every θ set)."""
    return x if x is None or d is None else x.movedim(d, 0)


def _lanes_front(x, d, B):
    """``x`` (..., K, tail) with the vmap axis ``d`` moved in front of K
    (expanded there if unbatched): (..., B, K, tail)."""
    if d is not None:
        return x.movedim(d, -3)
    return x.unsqueeze(-3).expand(*x.shape[:-2], B, *x.shape[-2:])


def _no_batched_tensors(in_dims):
    if any(d is not None for d in in_dims):
        raise NotImplementedError(
            "phase_chain: only theta, other and their tangents (and the "
            "primal's slope and dt64) may carry a vmap axis")


class PhaseChainTangent(torch.autograd.Function):
    """``(theta (..., P), dtheta (..., K, P), slope, dt64 (..., N), dother
    (..., K, N) or None, spec, *tensors) -> (..., K, N)`` d frac along the
    K lanes of ``dtheta``: the kernel's tangent launch."""

    #: tangent kernel launches in this process
    launches = 0

    @staticmethod
    def forward(theta, dtheta, slope, dt64, dother, spec, *tensors):
        return run(spec, theta, None, tensors, dtheta, slope, dt64, dother)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("phase_chain has no reverse mode")

    @staticmethod
    def vmap(info, in_dims, theta, dtheta, slope, dt64, dother, spec,
             *tensors):
        _no_batched_tensors(in_dims[6:])
        B = info.batch_size
        td, dd, sd, ed, od = in_dims[:5]
        if td is None and sd is None and ed is None:
            # tangents of one θ (jacfwd lanes): more lanes of each θ set
            d = _lanes_front(dtheta, dd, B)             # (..., B, K, P)
            K = d.shape[-2]
            o = None if dother is None else \
                _lanes_front(dother, od, B).flatten(-3, -2)
            out = PhaseChainTangent.apply(theta, d.flatten(-3, -2), slope,
                                          dt64, o, spec, *tensors)
            out = out.unflatten(-2, (B, K))             # (..., B, K, N)
            return out, out.dim() - 3
        # a batch of θ (grid points): more θ sets, each with its lanes
        return PhaseChainTangent.apply(
            _front(theta, td, B), _front(dtheta, dd, B), _front(slope, sd, B),
            _front(dt64, ed, B), _rows_front(dother, od), spec, *tensors), 0


class PhaseChain(torch.autograd.Function):
    """``(theta (..., P), other (..., N) or None, spec, *tensors) -> (out,
    slope, dt64)``: the kernel's primal launch, ``out`` differentiable in
    ``theta`` and ``other`` in forward mode (``jvp``: the tangent
    launch); ``slope`` and ``dt64`` carry no tangent.  ``tensors`` are
    the delay chain's rows (:data:`delay_chain.ROWS`) and the phase's
    (:data:`CONSTS`); they pass through ``apply`` so that torch.func
    unwraps them before the kernel reads their pointers."""

    #: primal kernel launches in this process (plain runs are not
    #: counted; the tangent launches are PhaseChainTangent.launches)
    launches = 0

    @staticmethod
    def forward(theta, other, spec, *tensors):
        return run(spec, theta, other, tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        theta, _, spec, *tensors = inputs
        _, slope, dt64 = output
        ctx.mark_non_differentiable(slope, dt64)
        ctx.spec = spec
        ctx.present = [t is not None for t in tensors]
        ctx.save_for_forward(theta, slope, dt64,
                             *[t for t in tensors if t is not None])

    @staticmethod
    def jvp(ctx, dtheta, dother, _spec, *_tensors):
        if ctx.spec.mode == "words":
            raise NotImplementedError(
                "phase_chain: the words mode carries no tangent")
        theta, slope, dt64, *given = ctx.saved_tensors
        it = iter(given)
        tensors = [next(it) if p else None for p in ctx.present]
        if dtheta is None:
            dtheta = torch.zeros_like(theta)
        d = PhaseChainTangent.apply(
            theta, dtheta.unsqueeze(-2), slope, dt64,
            None if dother is None else dother.unsqueeze(-2), ctx.spec,
            *tensors)
        return d.squeeze(-2), None, None

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("phase_chain has no reverse mode")

    @staticmethod
    def vmap(info, in_dims, theta, other, spec, *tensors):
        _no_batched_tensors(in_dims[3:])
        B = info.batch_size
        return PhaseChain.apply(_front(theta, in_dims[0], B),
                                _rows_front(other, in_dims[1]), spec,
                                *tensors), (0, 0, 0)


# -- the residual phase of a model ---------------------------------------------

def _other_phase(others: Sequence, p: dict, batch, delay):
    """The summed float64 phase of the components after the Spindown, or
    None.  ``delay`` None (the fused launch) refuses a component that
    reads it."""
    other = None
    for c in others:
        if delay is None and c.phase_f64_reads_delay:
            raise NotImplementedError(
                f"{type(c).__name__}: its float64 phase reads the delay, "
                "which the phase_chain kernel forms inside its launch")
        ph = c.phase_f64(p, batch, delay)
        if ph is not None:
            other = ph if other is None else other + ph
    return other


def _tzr(p: dict, subtract_tzr: bool):
    return p["const"].get("__tzrphase__") if subtract_tzr else None


def unfused_inputs(calc, p: dict, batch, mode: str,
                   subtract_tzr: bool = True, delay=None):
    """``(spec, shift, dF, other)`` of :func:`unfused`: ``delay(p,
    batch)`` (by default the plain component delays,
    :meth:`PhaseCalc.delay_plain`), the row shift in PyTorch, and the
    qs_phase_frac kernel's other inputs."""
    sd, others = calc._kernel_layout()
    d = (calc.delay_plain if delay is None else delay)(p, batch)
    pep_day, pep_w, f_w, shift, dF = sd.kernel_inputs(p, batch, d)
    spec = qs_phase.PhaseSpec(
        batch.tdb_day, batch.tdb_frac_w,
        torch.as_tensor(pep_day, dtype=F64, device=batch.device), pep_w,
        f_w, _tzr(p, subtract_tzr),
        batch.pulse_number if mode == "use_pulse_numbers" else None, mode)
    return spec, shift, dF, _other_phase(others, p, batch, d)


def unfused(calc, p: dict, batch, mode: str, subtract_tzr: bool = True,
            delay=None):
    """The phase chain as separate steps (:func:`unfused_inputs`), then
    the qs_phase_frac kernel with its tangent rule.  With the defaults on
    a CPU batch it is the plain composition; with ``delay=calc.delay`` on
    a CUDA batch it is the unfused card chain (the delay_chain kernel,
    the shift, the qs_phase_frac kernel) that the fused launches are
    held bit-equal to."""
    if mode not in MODES:
        raise ValueError(f"unknown phase mode {mode!r}")
    spec, shift, dF, other = unfused_inputs(calc, p, batch, mode,
                                            subtract_tzr, delay)
    if mode == "words":
        return qs_phase.run(spec, shift, dF, other)[0]
    return qs_phase.QSPhaseFrac.call(spec, shift, dF, other)[0]


def fused_inputs(calc, p: dict, batch, mode: str, subtract_tzr: bool = True):
    """``(spec, theta, other, tensors)`` of the fused launch: θ (P,) =
    the delay chain's θ, the spin offsets and PEPOCH's offset [days]."""
    if mode not in MODES:
        raise ValueError(f"unknown phase mode {mode!r}")
    sd, others = calc._kernel_layout()
    layout = calc.chain_layout
    pep_day, pep_w, f_w, dF, ddays = sd.spin_inputs(p, batch)
    dev = batch.device
    theta = torch.cat([layout.theta(p), dF, torch.as_tensor(
        ddays, dtype=F64, device=dev).reshape(1)])
    pn = batch.pulse_number if mode == "use_pulse_numbers" else None
    tensors = dc.row_inputs(layout, p, batch) + [
        pn, torch.as_tensor(pep_day, dtype=F64, device=dev), pep_w, f_w,
        _tzr(p, subtract_tzr)]
    return (PhaseChainSpec(layout, f_w.shape[0], mode), theta,
            _other_phase(others, p, batch, None), tensors)


def fused(calc, p: dict, batch, mode: str, subtract_tzr: bool = True):
    """The fused launch's output (see :func:`phase_frac`); the words mode
    carries no tangent."""
    spec, theta, other, tensors = fused_inputs(calc, p, batch, mode,
                                               subtract_tzr)
    if mode == "words":
        return run(spec, theta, other, tensors)[0]
    return PhaseChain.apply(theta, other, spec, *tensors)[0]


def phase_frac(calc, p: dict, batch, mode: str, subtract_tzr: bool = True):
    """The residual phase of ``calc``'s model: "nearest" -> the (N,)
    fractional phase [cycles] after nearest-pulse rounding;
    "use_pulse_numbers" -> phase minus the batch's pulse numbers; "words"
    -> the (N, 4) float32 words of the unrounded total phase.  The fused
    kernel on a CUDA batch, the plain composition on a CPU batch."""
    if batch.device.type == "cpu":
        return unfused(calc, p, batch, mode, subtract_tzr)
    if batch.device.type != "cuda":
        raise ValueError(f"phase_chain: unsupported device {batch.device}")
    return fused(calc, p, batch, mode, subtract_tzr)
