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
by the K spin offsets δF_k, PEPOCH's offset [days] and, where the model
has them, the slots of the phase family (:class:`PhaseFamily`: the
glitches, PiecewiseSpindown, WAVE and IFUNC, the phase components that
read the delay, which the launch adds right after forming it, their
constants in a small buffer and each TOA's PiecewiseSpindown groups in
a bit word); ``other``, the float64 phase of the other components after
the Spindown (the phase JUMPs, PHOFF), and its tangent are row inputs.
:class:`PhaseChain` makes it differentiable in forward mode: ``jvp`` is
one tangent launch, which recomputes each row's delay with its lanes'
tangents, the shift ``(-delay) - δPEPOCH·86400`` and the quad-single
phase row over float32 words that carry each lane's tangent: pint_tpu's
word-level tangent (``QSPhaseFrac.jvp``,
:func:`~pint_tpu_torch.models.spindown.phase_frac_jvp`), with ``other``
(the phase family's sum and the components' in PyTorch,
:func:`_other_phase`) and its tangent entering as its value does; so
that it is bit-equal to the unfused chain (K4's tangent launch, the
shift's rule, QSPhaseFrac.jvp) up to the sign of a zero.  The ``vmap``
rules fold a batch of tangents of one θ into the launch's lane axis and a
batch of θ into its θ-set axis: a ``vmap`` over grid points of a
``jacfwd`` is one primal and one tangent launch.  There is no reverse
mode (QSPhaseFrac has none, and no path uses one).

``PhaseChain.launches`` counts primal launches and
``PhaseChainTangent.launches`` tangent ones (plain runs do not count);
``PhaseFamilyPrimal.launches`` and ``PhaseFamilyTangent.launches`` count
those of them that ran the phase family's template values.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.kernels import qs_phase
from pint_tpu_torch.kernels.qs_phase import MODES
from pint_tpu_torch.models.piecewise import MAX_GROUPS, PW_BITS
from pint_tpu_torch.models.timing_model import pv, zeros_rows

F32, F64 = torch.float32, torch.float64


class PhaseCfg(ctypes.Structure):
    """csrc/phase_chain.cuh ``PhaseCfg``: the spin terms, the slots of
    the spin offsets and of PEPOCH's offset, θ's length and the mode."""

    _fields_ = [(n, ctypes.c_int32) for n in ("K", "o_spin", "o_pep", "P",
                                                "mode")]


#: the phase family's fields of csrc/delay_chain.cuh ``PhCfg``, after
#: ``OrbCfg``'s: the glitches, groups, WAVE harmonics and IFUNC points,
#: IFUNC's interpolation, the θ slots of F0 and of the blocks, the
#: offsets of the WAVE pairs and the IFUNC points in the constants
FAMILY_FIELDS = ("ngl", "npw", "nwave", "nif", "sifunc", "o_f0", "o_gl",
                 "o_pw", "o_wave", "c_wave", "c_if")


class PhCfg(ctypes.Structure):
    """csrc/delay_chain.cuh ``PhCfg``, which the C entry point takes: the
    delay chain's ``OrbCfg`` (:class:`delay_chain.ChainCfg`), then the
    phase family's counts, slots and offsets."""

    _fields_ = dc.ChainCfg._fields_ + [(n, ctypes.c_int32)
                                       for n in FAMILY_FIELDS]


#: the components of the phase family (their phase reads the delay), in
#: DEFAULT_ORDER, and the slots of a glitch and of a group (after its
#: epoch's), in csrc/delay_chain.cuh's order
FAMILY = ("Glitch", "PiecewiseSpindown", "Wave", "IFunc")
GLITCH_SLOTS = ("GLPH_", "GLF0_", "GLF1_", "GLF2_", "GLF0D_", "GLTD_")
GROUP_SLOTS = ("PWPH_", "PWF0_", "PWF1_", "PWF2_")


@dataclasses.dataclass(frozen=True, eq=False)
class PhaseFamily:
    """The phase family's part of the fused launch: its θ slots (per slot
    a getter of the params dict and the ``p["delta"]`` offset added to it,
    as :class:`delay_chain.ChainLayout`'s), its counts and block offsets
    (relative to the family's first slot), and the getters of its
    constants (the WAVE pairs, the IFUNC points)."""

    names: Tuple[str, ...]
    consts: Tuple[Optional[Callable], ...]
    deltas: Tuple[Optional[str], ...]
    counts: Tuple[int, ...]
    buffer: Tuple[Callable, ...]

    @property
    def P(self) -> int:
        return len(self.names)

    @property
    def nconst(self) -> int:
        """The constants' length: a pair per WAVE harmonic, two values per
        IFUNC point."""
        return 2 * self.counts[2] + 2 * self.counts[3]

    def cfg(self, first: int) -> dict:
        """PhCfg's phase-family fields, the family's first θ slot at
        ``first``."""
        ngl, npw, nwave, nif, sifunc, o_f0, o_gl, o_pw, o_wave, c_wave, \
            c_if = self.counts
        return dict(ngl=ngl, npw=npw, nwave=nwave, nif=nif, sifunc=sifunc,
                    o_f0=first + o_f0, o_gl=first + o_gl, o_pw=first + o_pw,
                    o_wave=first + o_wave, c_wave=c_wave, c_if=c_if)

    def theta(self, p: dict) -> torch.Tensor:
        """(P,) float64 slots = const + delta, as ChainLayout.theta."""
        return dc.slot_values(self.consts, self.deltas, p)

    def constants(self, p: dict, dev) -> torch.Tensor:
        """The WAVE pairs (A_k, B_k) and the IFUNC points' MJDs and values,
        float64, as the plain version forms them (``pv``)."""
        if not self.buffer:
            return torch.empty(0, dtype=F64, device=dev)
        return torch.cat([torch.as_tensor(g(p), dtype=F64, device=dev)
                          .reshape(-1) for g in self.buffer])

    @classmethod
    def from_components(cls, comps) -> Optional["PhaseFamily"]:
        """The family of the phase components ``comps`` after the Spindown
        whose phase reads the delay, or None if they add no term.  Raises
        ``NotImplementedError`` for such a component the kernel does not
        cover, or for more than ``piecewise.MAX_GROUPS`` groups (one bit
        word per TOA, csrc/delay_chain.cuh kMaxPWGroups)."""
        names, consts, deltas, buffer = [], [], [], []
        counts = dict(ngl=0, npw=0, nwave=0, nif=0, sifunc=0, o_f0=0,
                      o_gl=0, o_pw=0, o_wave=0, c_wave=0, c_if=0)
        nconst = [0]

        def slot(name, const, delta):
            names.append(name)
            consts.append(const)
            deltas.append(delta)

        def pv_slot(par):
            slot(par, lambda p, par=par: p["const"][par], par)

        def epoch_slot(ep):
            slot(f"{ep}__day", lambda p, ep=ep: p["const"][ep][0]
                 + p["const"][ep][1], ep)

        def const_block(getter, size):
            buffer.append(getter)
            nconst[0] += size

        comps = [c for c in comps if c.phase_f64_reads_delay]
        for c in comps:
            if type(c).__name__ not in FAMILY:
                raise NotImplementedError(
                    f"{type(c).__name__}: its float64 phase reads the delay, "
                    "which the phase_chain kernel forms inside its launch, "
                    "and its phase family does not cover it")
        by_kind = {type(c).__name__: c for c in comps}
        wave = by_kind.get("Wave")
        ifunc = by_kind.get("IFunc")
        if (wave is not None and wave.wave_names()) or (
                ifunc is not None and ifunc.ifunc_names()):
            counts["o_f0"] = len(names)
            pv_slot("F0")
        glitch = by_kind.get("Glitch")
        if glitch is not None and glitch.glitch_indices():
            counts["ngl"] = len(glitch.glitch_indices())
            counts["o_gl"] = len(names)
            for i in glitch.glitch_indices():
                epoch_slot(f"GLEP_{i}")
                for stem in GLITCH_SLOTS:
                    pv_slot(f"{stem}{i}")
        pw = by_kind.get("PiecewiseSpindown")
        if pw is not None and pw.group_indices():
            n = len(pw.group_indices())
            if n > MAX_GROUPS:
                raise NotImplementedError(
                    f"PiecewiseSpindown with {n} groups: the phase_chain "
                    f"kernel carries at most {MAX_GROUPS}")
            counts["npw"] = n
            counts["o_pw"] = len(names)
            for i in pw.group_indices():
                epoch_slot(f"PWEP_{i}")
                for stem in GROUP_SLOTS:
                    pv_slot(f"{stem}{i}")
        if wave is not None and wave.wave_names():
            wn = wave.wave_names()
            counts["nwave"] = len(wn)
            counts["o_wave"] = len(names)
            epoch_slot(wave.epoch_name())
            pv_slot("WAVE_OM")
            counts["c_wave"] = nconst[0]
            const_block(lambda p, wn=tuple(wn): torch.stack(
                [pv(p, n) for n in wn]), 2 * len(wn))
        if ifunc is not None and ifunc.ifunc_names():
            k = len(ifunc.ifunc_names())
            counts["nif"] = k
            counts["sifunc"] = int(ifunc.SIFUNC.value)
            counts["c_if"] = nconst[0]
            const_block(lambda p: ifunc.points(p).T, 2 * k)
        if not names:
            return None
        return cls(tuple(names), tuple(consts), tuple(deltas),
                   tuple(counts[n] for n in FAMILY_FIELDS), tuple(buffer))


@dataclasses.dataclass(frozen=True, eq=False)
class PhaseChainSpec:
    """The structure of one launch: the delay chain's layout, the number
    of spin terms, the output mode and the phase family (or None)."""

    layout: dc.ChainLayout
    K: int
    mode: str
    family: Optional[PhaseFamily] = None

    @property
    def P(self) -> int:
        """The fused θ's length: the delay chain's slots, the K spin
        offsets, PEPOCH's offset and the phase family's slots."""
        return self.layout.P + self.K + 1 + (
            0 if self.family is None else self.family.P)

    @property
    def flags(self) -> int:
        """The launch's ChainCfg flags: the delay chain's, with
        delay_chain.PHASE_TERMS where the phase family is in it."""
        return self.layout.flags | (
            0 if self.family is None else dc.PHASE_TERMS)

    @property
    def kernel_index(self) -> int:
        """The index of the kernels' template value
        (:func:`delay_chain.family_index`)."""
        return dc.family_index(self.flags, self.layout.cfg[1])

    def ctypes_cfg(self) -> PhaseCfg:
        P4 = self.layout.P
        return PhaseCfg(self.K, P4, P4 + self.K, self.P, MODES[self.mode])

    def chain_cfg(self) -> PhCfg:
        """The launch's ``PhCfg``: the delay chain's config and the phase
        family's."""
        base = self.layout.ctypes_cfg()
        c = PhCfg(**{n: getattr(base, n) for n, _ in dc.ChainCfg._fields_
                     if n != "fdj_order"})
        c.fdj_order[:] = base.fdj_order[:]
        c.flags = self.flags
        if self.family is not None:
            for n, v in self.family.cfg(self.layout.P + self.K + 1).items():
                setattr(c, n, v)
        return c


#: the phase's tensors after the delay chain's rows (delay_chain.ROWS), in
#: the kernel's order; pulse_number, tzr_w, pw_bits and fconst may be None
CONSTS = ("pulse_number", "pep_day", "pep_w", "f_w", "tzr_w", "pw_bits",
          "fconst")
#: the pointers the C entry point takes: the rows, CONSTS, theta, dtheta,
#: other, dother and the four outputs
N_POINTERS = len(dc.ROWS) + len(CONSTS) + 8


def _lib(spec: "PhaseChainSpec"):
    """The library that holds ``spec``'s kernels (one part of the
    source's build, kernels/build.py)."""
    from pint_tpu_torch.kernels.build import load, part_of

    lib = load(part_of("phase_chain", spec.kernel_index))
    if getattr(lib, "_argtypes_set", False):
        return lib
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.phase_chain.argtypes = [vp] * N_POINTERS + [
        PhCfg, PhaseCfg, i64, i64, i64, i64, i64, i64, ctypes.c_int, vp]
    lib.phase_chain.restype = ctypes.c_int
    lib.phase_chain_error_string.argtypes = [ctypes.c_int]
    lib.phase_chain_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _check_consts(spec: PhaseChainSpec, consts, N: int, dev):
    nconst = 0 if spec.family is None else spec.family.nconst
    want = {"pulse_number": ((N,), F64), "pep_day": ((), F64),
            "pep_w": ((4,), F32), "f_w": ((spec.K, 4), F32),
            "tzr_w": ((4,), F32), "pw_bits": ((N,), torch.int32),
            "fconst": ((nconst,), F64)}
    for name, t in zip(CONSTS, consts):
        shape, dtype = want[name]
        if t is None:
            if name in ("pep_day", "pep_w", "f_w") or (
                    name == "pulse_number"
                    and spec.mode == "use_pulse_numbers") or (
                    name == "fconst" and nconst):
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
            dother=None, lanes: Optional[int] = None):
    """One launch on ``theta`` (..., P) and ``other`` (..., N) or None:
    the primal ``(out, slope, dt64)`` with ``out`` the (..., N) phase or
    the (..., N, 4) words; or, with ``dtheta`` (..., K, P) and ``dother``
    (..., K, N) or None, the (..., K, N) d frac of the K lanes, each
    thread carrying ``lanes`` of them (by default
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
    cfg, pcfg = spec.chain_cfg(), spec.ctypes_cfg()
    stream = torch.cuda.current_stream(dev).cuda_stream
    other, other_sg = _rows_of(other, lead, (N,), "other", dev)
    if dtheta is None:
        words = spec.mode == "words"
        out = torch.empty((*lead, N, 4) if words else (*lead, N),
                          dtype=F32 if words else F64, device=dev)
        slope = torch.empty((*lead, N), dtype=F64, device=dev)
        dt64 = torch.empty((*lead, N), dtype=F64, device=dev)
        if G == 0:
            return out, slope, dt64
        err = _lib(spec).phase_chain(
            *[_ptr(t) for t in rows + consts], theta.data_ptr(), None,
            _ptr(other), None, None if words else out.data_ptr(),
            out.data_ptr() if words else None, slope.data_ptr(),
            dt64.data_ptr(), cfg, pcfg, G, 0, N, other_sg, 0, 0, 0, stream)
        _raise(spec, err)
        PhaseChain.launches += 1
        if spec.family is not None:
            PhaseFamilyPrimal.launches += 1
        return out, slope, dt64
    K = dtheta.shape[-2]
    if lanes is None:
        lanes = dc.lanes_per_thread(G, K)
    if lanes not in dc.KERNEL_LANES:
        raise ValueError(f"phase_chain: lanes per thread must be one of "
                         f"{dc.KERNEL_LANES}, got {lanes}")
    if spec.mode == "words":
        raise ValueError("phase_chain: the words mode carries no tangent")
    dother, dother_sg = _rows_of(dother, lead, (K, N), "dother", dev)
    dtheta = dtheta.contiguous()
    out = torch.empty((*lead, K, N), dtype=F64, device=dev)
    if G == 0 or K == 0:
        return out
    err = _lib(spec).phase_chain(
        *[_ptr(t) for t in rows + consts], theta.data_ptr(),
        dtheta.data_ptr(), _ptr(other), _ptr(dother), out.data_ptr(), None,
        None, None, cfg, pcfg, G, K, N, other_sg, dother_sg, N, lanes,
        stream)
    _raise(spec, err)
    PhaseChainTangent.launches += 1
    if spec.family is not None:
        PhaseFamilyTangent.launches += 1
    return out


class PhaseFamilyPrimal:
    """The primal launches of the phase family's template values
    (counted in ``PhaseChain.launches`` too)."""

    launches = 0


class PhaseFamilyTangent:
    """The tangent launches of the phase family's template values
    (counted in ``PhaseChainTangent.launches`` too)."""

    launches = 0


def _raise(spec: PhaseChainSpec, err: int) -> None:
    if err != 0:
        raise RuntimeError("phase_chain launch failed: "
                           + _lib(spec).phase_chain_error_string(err).decode())


def run(spec: PhaseChainSpec, theta, other, tensors, dtheta=None,
        dother=None, lanes: Optional[int] = None):
    """The kernel on CUDA tensors; an error on anything else (the plain
    composition is :func:`unfused`, which :func:`phase_frac` takes for
    a CPU batch)."""
    for t in (theta, other, dtheta, dother, *tensors):
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
    return _launch(spec, theta, other, tensors, dtheta, dother, lanes)


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
            "phase_chain: only theta, other and their tangents may carry a "
            "vmap axis")


class PhaseChainTangent(torch.autograd.Function):
    """``(theta (..., P), dtheta (..., K, P), other (..., N) or None,
    dother (..., K, N) or None, spec, *tensors) -> (..., K, N)`` d frac
    along the K lanes of ``dtheta``: the kernel's tangent launch."""

    #: tangent kernel launches in this process
    launches = 0

    @staticmethod
    def forward(theta, dtheta, other, dother, spec, *tensors):
        return run(spec, theta, other, tensors, dtheta, dother)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("phase_chain has no reverse mode")

    @staticmethod
    def vmap(info, in_dims, theta, dtheta, other, dother, spec, *tensors):
        _no_batched_tensors(in_dims[5:])
        B = info.batch_size
        td, dd, od, dod = in_dims[:4]
        if td is None and od is None:
            # tangents of one θ (jacfwd lanes): more lanes of each θ set
            d = _lanes_front(dtheta, dd, B)             # (..., B, K, P)
            K = d.shape[-2]
            o = None if dother is None else \
                _lanes_front(dother, dod, B).flatten(-3, -2)
            out = PhaseChainTangent.apply(theta, d.flatten(-3, -2), other, o,
                                          spec, *tensors)
            out = out.unflatten(-2, (B, K))             # (..., B, K, N)
            return out, out.dim() - 3
        # a batch of θ (grid points): more θ sets, each with its lanes
        return PhaseChainTangent.apply(
            _front(theta, td, B), _front(dtheta, dd, B),
            _rows_front(other, od), _rows_front(dother, dod), spec,
            *tensors), 0


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
        theta, other, spec, *tensors = inputs
        _, slope, dt64 = output
        ctx.mark_non_differentiable(slope, dt64)
        ctx.spec = spec
        ctx.present = [t is not None for t in [other, *tensors]]
        ctx.save_for_forward(theta,
                             *[t for t in [other, *tensors] if t is not None])

    @staticmethod
    def jvp(ctx, dtheta, dother, _spec, *_tensors):
        if ctx.spec.mode == "words":
            raise NotImplementedError(
                "phase_chain: the words mode carries no tangent")
        theta, *given = ctx.saved_tensors
        it = iter(given)
        other, *tensors = [next(it) if p else None for p in ctx.present]
        if dtheta is None:
            dtheta = torch.zeros_like(theta)
        d = PhaseChainTangent.apply(
            theta, dtheta.unsqueeze(-2), other,
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

def _other_phase(others: Sequence, p: dict, batch, delay,
                 is_tzr: bool = False):
    """The summed float64 phase of the components after the Spindown, or
    None: the phase family's (those that read the delay) summed from 0 in
    DEFAULT_ORDER, plus the others' sum.  With ``delay`` None (the fused
    launch, which forms the family's sum itself) the others' sum alone;
    a component that reads the delay and is not of the family
    (:data:`FAMILY`) is refused there."""
    fam = rest = None
    for c in others:
        if c.phase_f64_reads_delay:
            if delay is None:
                if type(c).__name__ not in FAMILY:
                    raise NotImplementedError(
                        f"{type(c).__name__}: its float64 phase reads the "
                        "delay, which the phase_chain kernel forms inside "
                        "its launch")
                continue
            ph = c.phase_f64(p, batch, delay, is_tzr=is_tzr)
            if ph is not None:
                fam = (zeros_rows(batch) if fam is None else fam) + ph
        else:
            ph = c.phase_f64(p, batch, delay, is_tzr=is_tzr)
            if ph is not None:
                rest = ph if rest is None else rest + ph
    if fam is None or rest is None:
        return rest if fam is None else fam
    return fam + rest


def _tzr(p: dict, subtract_tzr: bool):
    return p["const"].get("__tzrphase__") if subtract_tzr else None


def unfused_inputs(calc, p: dict, batch, mode: str,
                   subtract_tzr: bool = True, delay=None,
                   is_tzr: bool = False):
    """``(spec, shift, dF, other)`` of :func:`unfused`: ``delay(p,
    batch)`` (by default the plain component delays,
    :meth:`PhaseCalc.delay_plain`), the row shift in PyTorch, and the
    qs_phase_frac kernel's other inputs (``is_tzr``: the batch is the
    TZR TOA's, where PHOFF adds nothing)."""
    sd, others = calc._kernel_layout()
    d = (calc.delay_plain if delay is None else delay)(p, batch)
    pep_day, pep_w, f_w, shift, dF = sd.kernel_inputs(p, batch, d)
    spec = qs_phase.PhaseSpec(
        batch.tdb_day, batch.tdb_frac_w,
        torch.as_tensor(pep_day, dtype=F64, device=batch.device), pep_w,
        f_w, _tzr(p, subtract_tzr),
        batch.pulse_number if mode == "use_pulse_numbers" else None, mode)
    return spec, shift, dF, _other_phase(others, p, batch, d, is_tzr)


def unfused(calc, p: dict, batch, mode: str, subtract_tzr: bool = True,
            delay=None, is_tzr: bool = False):
    """The phase chain as separate steps (:func:`unfused_inputs`), then
    the qs_phase_frac kernel with its tangent rule.  With the defaults on
    a CPU batch it is the plain composition; with ``delay=calc.delay`` on
    a CUDA batch it is the unfused card chain (the delay_chain kernel,
    the shift, the qs_phase_frac kernel) that the fused launches are
    held bit-equal to."""
    if mode not in MODES:
        raise ValueError(f"unknown phase mode {mode!r}")
    spec, shift, dF, other = unfused_inputs(calc, p, batch, mode,
                                            subtract_tzr, delay,
                                            is_tzr=is_tzr)
    if mode == "words":
        return qs_phase.run(spec, shift, dF, other)[0]
    return qs_phase.QSPhaseFrac.call(spec, shift, dF, other)[0]


def fused_inputs(calc, p: dict, batch, mode: str, subtract_tzr: bool = True,
                 is_tzr: bool = False):
    """``(spec, theta, other, tensors)`` of the fused launch: θ (P,) =
    the delay chain's θ, the spin offsets, PEPOCH's offset [days] and the
    phase family's slots; the family's groups per TOA and its constants
    ride after the phase's tensors."""
    if mode not in MODES:
        raise ValueError(f"unknown phase mode {mode!r}")
    sd, others = calc._kernel_layout()
    layout, family = calc.chain_layout, calc.phase_family
    pep_day, pep_w, f_w, dF, ddays = sd.spin_inputs(p, batch)
    dev = batch.device
    parts = [layout.theta(p), dF, torch.as_tensor(
        ddays, dtype=F64, device=dev).reshape(1)]
    bits = fconst = None
    if family is not None:
        parts.append(family.theta(p))
        if family.counts[1]:
            bits = p["mask"].get(PW_BITS)
        fconst = family.constants(p, dev)
    pn = batch.pulse_number if mode == "use_pulse_numbers" else None
    tensors = dc.row_inputs(layout, p, batch) + [
        pn, torch.as_tensor(pep_day, dtype=F64, device=dev), pep_w, f_w,
        _tzr(p, subtract_tzr), bits, fconst]
    return (PhaseChainSpec(layout, f_w.shape[0], mode, family),
            torch.cat(parts), _other_phase(others, p, batch, None, is_tzr),
            tensors)


def fused(calc, p: dict, batch, mode: str, subtract_tzr: bool = True,
          is_tzr: bool = False):
    """The fused launch's output (see :func:`phase_frac`); the words mode
    carries no tangent."""
    spec, theta, other, tensors = fused_inputs(calc, p, batch, mode,
                                               subtract_tzr, is_tzr=is_tzr)
    if mode == "words":
        return run(spec, theta, other, tensors)[0]
    return PhaseChain.apply(theta, other, spec, *tensors)[0]


def phase_frac(calc, p: dict, batch, mode: str, subtract_tzr: bool = True,
               is_tzr: bool = False):
    """The residual phase of ``calc``'s model: "nearest" -> the (N,)
    fractional phase [cycles] after nearest-pulse rounding;
    "use_pulse_numbers" -> phase minus the batch's pulse numbers; "words"
    -> the (N, 4) float32 words of the unrounded total phase (``is_tzr``:
    of the TZR TOA).  The fused kernel on a CUDA batch, the plain
    composition on a CPU batch."""
    if batch.device.type == "cpu":
        return unfused(calc, p, batch, mode, subtract_tzr,
                       is_tzr=is_tzr)
    if batch.device.type != "cuda":
        raise ValueError(f"phase_chain: unsupported device {batch.device}")
    return fused(calc, p, batch, mode, subtract_tzr, is_tzr=is_tzr)
