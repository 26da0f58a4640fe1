"""Wrapper of the ``delay_chain`` CUDA kernel (``csrc/delay_chain.cu``).

:func:`delay_chain` evaluates the whole delay chain of a timing model —
astrometry (equatorial, PM, PX), the Sun's Shapiro delay, DM (with its
Taylor terms) and DMX, delay jumps, the binary (ELL1, or DD/BT with the
Kepler solve) and FD — in DEFAULT_ORDER for every TOA in one launch.  On
a CUDA batch it launches the kernel (or raises); on a CPU batch it runs
the plain version, the components' own delay functions
(:meth:`pint_tpu_torch.models.timing_model.PhaseCalc.delay_plain`).  There
is no fallback from one to the other: a model with a delay component or
an option the kernel does not cover raises ``NotImplementedError`` on
CUDA, naming it.

The parameters reach the kernel as one float64 vector θ, packed from the
params dict by :class:`ChainLayout` in a fixed layout (``const + delta``
per slot, as :func:`~pint_tpu_torch.models.timing_model.pv` forms them);
the per-TOA data are the batch's columns plus the int32 DMX bins of each
TOA (two: inclusive ranges that share a boundary both hold a TOA on it)
and int32 DelayJump bits, built once on the host from the masks.

:class:`DelayChain` makes it differentiable in θ: ``jvp`` is the kernel's
tangent launch (a dual-number instantiation of the same row function),
``backward`` the tangent launch with unit tangents reduced against the
incoming gradient, and the ``vmap`` rules fold batched θ (grid points)
and batched tangents (jacfwd lanes) into the kernel's θ-set axis, so a
jacfwd over any number of parameters costs one primal and one tangent
launch.

``DelayChain.launches`` counts kernel launches, primal and tangent (plain
runs do not count).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

F32, F64, I32 = torch.float32, torch.float64, torch.int32

#: component flags and binary families of csrc/delay_chain.cuh
ASTRO, PM, SHAPIRO, DM, DMX, JUMP, FD = 1, 2, 4, 8, 16, 32, 64
BIN_SHAPIRO, OMEGA_FROM_NU, ABERRATION = 128, 256, 512
NO_BINARY, ELL1, DD = 0, 1, 2

#: the mask entries the kernel reads (built by DispersionDMX/DelayJump)
DMX_INDEX = "__dmxidx__"
JUMP_BITS = "__delayjumpbits__"

#: DelayJump members the int32 bit mask can carry
MAX_JUMPS = 31


class ChainCfg(ctypes.Structure):
    """csrc/delay_chain.cuh ``ChainCfg``: flags, binary family, θ length,
    block sizes and block offsets."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "flags", "binary", "P", "ndm", "ndmx", "njump", "nfd",
        "o_astro", "o_dm", "o_dmx", "o_jump", "o_fd", "o_bin")]


Getter = Callable[[dict], torch.Tensor]


def _const(name: str, idx=None) -> Getter:
    def get(p):
        v = p["const"][name]
        return v if idx is None else v[idx]
    return get


def _epoch_day(name: str) -> Getter:
    """c[0] + c[1] of an MJD parameter (its delta rides in the slot)."""
    def get(p):
        c = p["const"][name]
        return c[0] + c[1]
    return get


def _word(name: str, k: int) -> Getter:
    def get(p):
        return p["const"][name + "__fracqs"][k].to(F64)
    return get


@dataclasses.dataclass(frozen=True, eq=False)
class ChainLayout:
    """The θ layout of one model structure: per slot a constant getter (or
    None for zero) and the name of the ``p["delta"]`` offset added to it
    (or None), and the kernel's :class:`ChainCfg` fields."""

    names: Tuple[str, ...]
    consts: Tuple[Optional[Getter], ...]
    deltas: Tuple[Optional[str], ...]
    cfg: Tuple[int, ...]

    @property
    def P(self) -> int:
        return len(self.names)

    @property
    def dmx(self) -> bool:
        return bool(self.cfg[0] & DMX)

    @property
    def jumps(self) -> bool:
        return bool(self.cfg[0] & JUMP)

    def ctypes_cfg(self) -> ChainCfg:
        return ChainCfg(*self.cfg)

    def theta(self, p: dict) -> torch.Tensor:
        """(P,) float64 θ = const + delta per slot, differentiable in
        ``p["delta"]`` (and batched where it is)."""
        dev = next(iter(p["const"].values())).device
        zero = torch.zeros((), dtype=F64, device=dev)
        c = torch.stack([zero if g is None else
                         torch.as_tensor(g(p), dtype=F64, device=dev)
                         for g in self.consts])
        d = torch.stack([zero if n is None else
                         torch.as_tensor(p["delta"][n], dtype=F64)
                         for n in self.deltas])
        return c + d

    def unpack(self, theta: torch.Tensor) -> dict:
        """{slot name: θ entry}: the inverse of :meth:`theta`'s layout."""
        return {n: theta[..., i] for i, n in enumerate(self.names)}

    @classmethod
    def from_components(cls, comps) -> "ChainLayout":
        """The layout of a model's delay components (DEFAULT_ORDER).
        Raises ``NotImplementedError`` naming a component or option the
        kernel does not cover."""
        names: List[str] = []
        consts: List[Getter] = []
        deltas: List[Optional[str]] = []

        def slot(name, const, delta=None):
            names.append(name)
            consts.append(const)
            deltas.append(delta)

        def pv_slot(par):
            slot(par, _const(par), par)

        flags = 0
        binary = NO_BINARY
        ndm = ndmx = njump = nfd = 0
        offs = dict(o_astro=0, o_dm=0, o_dmx=0, o_jump=0, o_fd=0, o_bin=0)
        order = ("AstrometryEquatorial", "DelayJump", "SolarSystemShapiro",
                 "DispersionDM", "DispersionDMX", "BinaryELL1", "BinaryDD",
                 "BinaryBT", "FD")
        last = -1
        for comp in comps:
            kind = type(comp).__name__
            if kind not in order:
                raise NotImplementedError(
                    f"{kind} is not covered by the delay_chain kernel")
            pos = order.index(kind)
            if pos <= last:
                raise NotImplementedError(
                    f"{kind} out of the delay_chain kernel's order")
            last = pos
            if kind == "AstrometryEquatorial":
                flags |= ASTRO
                offs["o_astro"] = len(names)
                for ang in ("RAJ", "DECJ"):
                    slot(f"{ang}__sin", _const(ang + "__sincos", 0))
                    slot(f"{ang}__cos", _const(ang + "__sincos", 1))
                    slot(f"{ang}__offset", None, ang)
                for n in ("PMRA", "PMDEC", "PX"):
                    pv_slot(n)
                ep = comp.pos_epoch_name()
                if ep:
                    flags |= PM
                    slot(f"{ep}__day", _epoch_day(ep), ep)
                else:
                    slot("POSEPOCH__day", None)
            elif kind == "DelayJump":
                js = [jp.name for jp in comp.jumps if jp.value is not None]
                if len(js) > MAX_JUMPS:
                    raise NotImplementedError(
                        f"DelayJump with {len(js)} members: the "
                        f"delay_chain kernel carries at most {MAX_JUMPS}")
                if js:
                    flags |= JUMP
                    njump = len(js)
                    offs["o_jump"] = len(names)
                    for n in js:
                        pv_slot(n)
            elif kind == "SolarSystemShapiro":
                if comp.PLANET_SHAPIRO.value:
                    raise NotImplementedError(
                        "SolarSystemShapiro with PLANET_SHAPIRO: the "
                        "delay_chain kernel covers the Sun only")
                flags |= SHAPIRO
            elif kind == "DispersionDM":
                flags |= DM
                dms = comp.dm_names()
                ndm = len(dms)
                offs["o_dm"] = len(names)
                if ndm > 1:
                    ep = "DMEPOCH" if comp.DMEPOCH.value is not None \
                        else "PEPOCH"
                    slot(f"{ep}__day", _epoch_day(ep), ep)
                else:
                    slot("DMEPOCH__day", None)
                for n in dms:
                    pv_slot(n)
            elif kind == "DispersionDMX":
                bins = comp.dmx_names()
                if bins:
                    flags |= DMX
                    ndmx = len(bins)
                    offs["o_dmx"] = len(names)
                    for n in bins:
                        pv_slot(n)
            elif kind == "FD":
                fds = comp.fd_names()
                if fds:
                    flags |= FD
                    nfd = len(fds)
                    offs["o_fd"] = len(names)
                    for n in fds:
                        pv_slot(n)
            else:
                binary, bflags = _binary_slots(comp, slot, pv_slot, offs,
                                               len(names))
                flags |= bflags
        if not names:
            slot("__empty__", None)
        cfg = (flags, binary, len(names), ndm, ndmx, njump, nfd,
               offs["o_astro"], offs["o_dm"], offs["o_dmx"], offs["o_jump"],
               offs["o_fd"], offs["o_bin"])
        return cls(tuple(names), tuple(consts), tuple(deltas), cfg)


def _binary_slots(comp, slot, pv_slot, offs, start):
    """The binary block of θ (csrc/delay_chain.cuh b* offsets)."""
    kind = type(comp).__name__
    if comp.fb_names():
        raise NotImplementedError(
            f"{kind} with an FBn orbit: the delay_chain kernel covers the "
            "PB/PBDOT orbit only")
    if comp.orbwave_names()[0]:
        raise NotImplementedError(
            f"{kind} with ORBWAVEs is not covered by the delay_chain kernel")
    offs["o_bin"] = start
    ep = "TASC" if kind == "BinaryELL1" else "T0"
    slot(f"{ep}__day0", _const(ep, 0))
    for k in range(4):
        slot(f"{ep}__word{k}", _word(ep, k))
    slot(f"{ep}__ddays", None, ep)
    for n in ("PB", "PBDOT", "A1", "A1DOT"):
        pv_slot(n)
    has_shapiro = comp.M2.value is not None and comp.SINI.value is not None \
        if "M2" in comp.params else False
    flags = BIN_SHAPIRO if has_shapiro else 0

    def pv_or_zero(n):
        if n in comp.params and comp.params[n].value is not None:
            pv_slot(n)
        else:
            slot(n, None)

    if kind == "BinaryELL1":
        for n in ("EPS1", "EPS2", "EPS1DOT", "EPS2DOT", "M2", "SINI"):
            pv_or_zero(n)
        return ELL1, flags
    for n in ("ECC", "EDOT", "OM", "OMDOT", "GAMMA", "M2", "SINI", "DR",
              "DTH", "A0", "B0"):
        pv_or_zero(n)
    if comp.omega_from_nu:
        flags |= OMEGA_FROM_NU
    if kind == "BinaryDD":
        flags |= ABERRATION
    return DD, flags


# -- the library ---------------------------------------------------------------

_c_void_p, _c_int64 = ctypes.c_void_p, ctypes.c_int64


def _lib():
    from pint_tpu_torch.kernels.build import load

    lib = load("delay_chain")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.delay_chain.argtypes = [_c_void_p] * 12 + [ChainCfg, _c_int64,
                                                   _c_int64, _c_void_p]
    lib.delay_chain.restype = ctypes.c_int
    lib.delay_chain_error_string.argtypes = [ctypes.c_int]
    lib.delay_chain_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def _ptr(t: torch.Tensor):
    return t.data_ptr() if t.numel() else None


#: the per-TOA inputs, in the kernel's order: name, dtype, trailing shape
ROWS = (("tdb_day", torch.int64, ()), ("tdb_frac", F64, ()),
        ("frac_w", F32, (3,)), ("pos", F64, (3,)), ("sun", F64, (3,)),
        ("freq", F64, ()), ("dmx", I32, (2,)), ("jbits", I32, ()))


def _check_rows(rows, dev):
    N = rows[0].shape[0]
    for (name, dtype, tail), t in zip(ROWS, rows):
        if name in ("dmx", "jbits") and t.numel() == 0:
            continue
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (N, *tail):
            raise ValueError(
                f"delay_chain: {name} must be {dtype} of shape {(N, *tail)} "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return N


def _launch(layout: ChainLayout, theta, dtheta, rows, aux: bool = False):
    """One launch on ``theta`` (..., P) [and ``dtheta`` (..., P)]: the
    (..., N) delay, or with ``dtheta`` its (..., N) tangent; with ``aux``
    also the (3, ..., N) M, e, E of a DD/BT binary."""
    dev = theta.device
    N = _check_rows(rows, dev)
    P = layout.P
    if theta.dtype != F64 or theta.shape[-1] != P or (
            dtheta is not None and (dtheta.dtype != F64
                                    or dtheta.device != dev
                                    or dtheta.shape[-1] != P)):
        raise ValueError(f"delay_chain: theta and its tangent must be "
                         f"float64 (..., {P}) on {dev}")
    lead = theta.shape[:-1] if dtheta is None else torch.broadcast_shapes(
        theta.shape[:-1], dtheta.shape[:-1])
    G = 1
    for s in lead:
        G *= s
    theta = theta.expand(*lead, P).contiguous()
    if dtheta is not None:
        dtheta = dtheta.expand(*lead, P).contiguous()
    rows = [t.contiguous() for t in rows]
    out = torch.empty((*lead, N), dtype=F64, device=dev)
    aux_t = torch.empty((3, *lead, N), dtype=F64, device=dev) if aux \
        else None
    if G == 0:
        return out, aux_t
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().delay_chain(
        *[_ptr(t) for t in rows], theta.data_ptr(),
        None if dtheta is None else dtheta.data_ptr(), out.data_ptr(),
        None if aux_t is None else aux_t.data_ptr(), layout.ctypes_cfg(),
        G, N, stream)
    if err != 0:
        raise RuntimeError("delay_chain launch failed: "
                           + _lib().delay_chain_error_string(err).decode())
    DelayChain.launches += 1
    return out, aux_t


def run(layout: ChainLayout, theta, dtheta, rows):
    """The kernel on CUDA tensors; an error on anything else (the plain
    version is the components', which :func:`delay_chain` takes for a
    CPU batch)."""
    for t in (theta, dtheta, *rows):
        if t is not None and torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise TypeError(
                "delay_chain: an input is still wrapped by a torch.func "
                "transform; pass every tensor through DelayChain.apply")
    if not theta.is_cuda:
        raise ValueError(
            f"delay_chain: the kernel runs on CUDA tensors, not "
            f"{theta.device}; PhaseCalc.delay takes the plain version on "
            "the CPU")
    return _launch(layout, theta, dtheta, rows)[0]


def _front(x, d, B):
    return x.expand(B, *x.shape) if d is None else x.movedim(d, 0)


def _no_batched_rows(in_dims, name):
    if any(d is not None for d in in_dims):
        raise NotImplementedError(
            f"{name}: only theta and its tangent may carry a vmap axis")


class DelayChainTangent(torch.autograd.Function):
    """``(theta, dtheta, layout, *rows) -> (..., N)`` tangent of the delay
    along ``dtheta``: the kernel's tangent launch."""

    @staticmethod
    def forward(theta, dtheta, layout, *rows):
        return run(layout, theta, dtheta, rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, theta, dtheta, layout, *rows):
        _no_batched_rows(in_dims[2:], "delay_chain")
        B = info.batch_size
        return DelayChainTangent.apply(_front(theta, in_dims[0], B),
                                       _front(dtheta, in_dims[1], B),
                                       layout, *rows), 0


class DelayChain(torch.autograd.Function):
    """``(theta, layout, *rows) -> (..., N)`` delay [s], differentiable in
    ``theta`` in forward mode (``jvp``: the tangent launch) and reverse
    mode (``backward``: the tangent launch with unit tangents, reduced
    against the incoming gradient).  ``rows`` are the per-TOA tensors of
    :data:`ROWS`; they pass through ``apply`` so that torch.func unwraps
    them before the kernel reads their pointers."""

    #: kernel launches in this process, primal and tangent (plain runs
    #: are not counted)
    launches = 0

    @staticmethod
    def forward(theta, layout, *rows):
        return run(layout, theta, None, rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        theta, layout, *rows = inputs
        ctx.layout = layout
        ctx.save_for_forward(theta, *rows)
        ctx.save_for_backward(theta, *rows)

    @staticmethod
    def jvp(ctx, dtheta, _layout, *_rows):
        theta, *rows = ctx.saved_tensors
        if dtheta is None:
            return None
        return DelayChainTangent.apply(theta, dtheta, ctx.layout, *rows)

    @staticmethod
    def backward(ctx, g):
        theta, *rows = ctx.saved_tensors
        P = theta.shape[-1]
        eye = torch.eye(P, dtype=F64, device=theta.device)
        lead = theta.shape[:-1]
        J = DelayChainTangent.apply(
            theta[..., None, :].expand(*lead, P, P),
            eye.expand(*lead, P, P), ctx.layout, *rows)   # (..., P, N)
        return (torch.matmul(J, g[..., :, None])[..., 0], None,
                *[None] * len(rows))

    @staticmethod
    def vmap(info, in_dims, theta, layout, *rows):
        _no_batched_rows(in_dims[1:], "delay_chain")
        return DelayChain.apply(_front(theta, in_dims[0], info.batch_size),
                                layout, *rows), 0


def row_inputs(layout: ChainLayout, p: dict, batch) -> list:
    """The kernel's per-TOA tensors (:data:`ROWS`) for ``batch``: its
    columns plus the DMX bin index and DelayJump bits of ``p["mask"]``
    (empty where the model has none)."""
    empty = torch.empty(0, dtype=I32, device=batch.device)
    dmx = jb = empty
    if layout.dmx:
        dmx = p["mask"].get(DMX_INDEX)
        if dmx is None:
            raise ValueError(
                "delay_chain: no DMX bin index in the params dict: three "
                "DMX ranges overlap on a TOA (the kernel takes at most two "
                "bins per TOA)")
    if layout.jumps:
        jb = p["mask"].get(JUMP_BITS)
        if jb is None:
            raise ValueError("delay_chain: no DelayJump bits in the params "
                             "dict")
    return [batch.tdb_day, batch.tdb_frac, batch.tdb_frac_w,
            batch.ssb_obs_pos_ls, batch.obs_sun_pos_ls, batch.freq_mhz,
            dmx, jb]


def delay_chain(calc, p: dict, batch) -> torch.Tensor:
    """The total delay [s] of ``calc``'s delay components: the kernel on a
    CUDA batch (differentiable through :class:`DelayChain`), the plain
    component delays on a CPU batch."""
    if batch.device.type == "cpu":
        return calc.delay_plain(p, batch)
    if batch.device.type != "cuda":
        raise ValueError(f"delay_chain: unsupported device {batch.device}")
    layout = calc.chain_layout
    return DelayChain.apply(layout.theta(p), layout,
                            *row_inputs(layout, p, batch))


def delay_chain_aux(calc, p: dict, batch):
    """``(delay, aux)`` of one primal launch on a CUDA batch, ``aux`` the
    (3, N) M, e and E of a DD/BT binary's Kepler solve (no tangent)."""
    layout = calc.chain_layout
    with torch.no_grad():
        rows = [t.contiguous() for t in row_inputs(layout, p, batch)]
        return _launch(layout, layout.theta(p), None, rows, aux=True)
