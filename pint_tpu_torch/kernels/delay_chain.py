"""Wrapper of the ``delay_chain`` CUDA kernel (``csrc/delay_chain.cu``).

:func:`delay_chain` evaluates the whole delay chain of a timing model —
astrometry (equatorial or ecliptic, PM, PX), delay jumps, the
troposphere, the Shapiro delays of the Sun and (PLANET_SHAPIRO) the
planets, the solar wind (NE_SW with SWM 0 or 1, and SWX), DM (with its
Taylor terms), DMX and FDJUMPDM, DMWaveX, the chromatic delays (CM with
its Taylor terms, CMX, CMWaveX, exponential dips, chromatic Gaussian
events), the binary (ELL1, ELL1H, ELL1k, or DD/BT, DDS, DDH, DDK, DDGR
with the Kepler solve, and BT_PIECEWISE; each orbit from PB/PBDOT or an
FBn series, with ORBWAVE's Fourier terms), FD, FDJUMP and WaveX — in
DEFAULT_ORDER for every TOA in one launch (DMJUMP has no delay).  On
a CUDA batch it launches the kernel (or raises); on a CPU batch it runs
the plain version, the components' own delay functions
(:meth:`pint_tpu_torch.models.timing_model.PhaseCalc.delay_plain`).  There
is no fallback from one to the other: a model with a delay component or
an option the kernel does not cover raises ``NotImplementedError`` on
CUDA, naming it.

The parameters reach the kernel as one float64 vector θ, packed from the
params dict by :class:`ChainLayout` in a fixed layout (``const + delta``
per slot, as :func:`~pint_tpu_torch.models.timing_model.pv` forms them;
a quantity that depends on the parameters alone, as DDS's sin i or
DDGR's post-Keplerian values, is formed in PyTorch by the component's
own code and rides in a slot of its own, its tangent by torch's forward
mode);
the per-TOA data are the batch's columns plus the int32 DMX bins of each
TOA (two: inclusive ranges that share a boundary both hold a TOA on it),
the SWX and CMX ranges likewise, int32 member bits of DelayJump, FDJumpDM
and FDJump, the troposphere's float64 delay, built once on the host
from the masks, the planets' positions (PLANET_SHAPIRO) and each TOA's
BT_PIECEWISE piece.

:class:`DelayChain` makes it differentiable in θ: ``jvp`` is the kernel's
tangent launch (the same row function over a number type that carries
one value and several tangents), ``backward`` the tangent launch with
the P unit tangents reduced against the incoming gradient.  The tangent
launch takes θ ``(G, P)`` and its tangents ``(G, K, P)``: G θ sets (grid
points), each with K tangent lanes that share it (jacfwd lanes), so the
primal work is done once per θ set and row and each thread carries
several lanes (:func:`lanes_per_thread`).  The ``vmap`` rules fold a
batched θ into the θ-set axis and a batch of tangents of one θ into the
lane axis, so a jacfwd over any number of parameters costs one primal
and one tangent launch.

``DelayChain.launches`` counts the primal kernel's launches and
``DelayChainTangent.launches`` the tangent kernel's (plain runs do not
count).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch

from pint_tpu_torch.models.timing_model import pv

F32, F64, I32 = torch.float32, torch.float64, torch.int32

#: component flags and binary families of csrc/delay_chain.cuh
ASTRO, PM, SHAPIRO, DM, DMX, JUMP, FD = 1, 2, 4, 8, 16, 32, 64
BIN_SHAPIRO, OMEGA_FROM_NU, ABERRATION = 128, 256, 512
ECLIPTIC, K96, STIGMA = 1024, 2048, 4096
SOLAR_WIND, SWM1, SWX, FDJUMPDM, FDJUMP = 8192, 16384, 32768, 65536, 131072
CM, CMX, CMWAVEX, DMWAVEX, WAVEX = 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22
EXPDIP, CHROMGAUSS, TROPO = 1 << 23, 1 << 24, 1 << 25
FB_ORBIT, ORBWAVE, BT_PIECES, PLANET_SHAPIRO = (1 << 26, 1 << 27, 1 << 28,
                                                1 << 29)
#: the flags of the terms compiled only into the template values with the
#: DM, the chromatic and the orbit family (csrc/delay_chain.cuh
#: kDMFamilyFlags, kChromFamilyFlags, kOrbitFamilyFlags)
DM_FAMILY_FLAGS = SOLAR_WIND | SWX | FDJUMPDM | FDJUMP
CHROM_FAMILY_FLAGS = (CM | CMX | CMWAVEX | DMWAVEX | WAVEX | EXPDIP
                      | CHROMGAUSS | TROPO)
ORBIT_FAMILY_FLAGS = FB_ORBIT | ORBWAVE | BT_PIECES | PLANET_SHAPIRO
#: the phase chain's layout holds a term of the phase family
#: (kernels/phase_chain.py PhaseFamily; csrc/delay_chain.cuh kPhaseTerms):
#: never set in a delay_chain launch
PHASE_TERMS = 1 << 30
NO_BINARY, ELL1, DD, DDK, DDTM2, ELL1H, ELL1K = 0, 1, 2, 3, 4, 5, 6
#: the binary families that run the Kepler solve
DD_FAMILY = (DD, DDK, DDTM2)

#: the mask entries the kernel reads (built by DispersionDMX, DelayJump,
#: SolarWindDispersionX, FDJumpDM, FDJump, ChromaticCMX, TroposphereDelay
#: and BinaryBTPiecewise)
DMX_INDEX = "__dmxidx__"
JUMP_BITS = "__delayjumpbits__"
SWX_INDEX = "__swxidx__"
FDJUMPDM_BITS = "__fdjumpdmbits__"
FDJUMP_BITS = "__fdjumpbits__"
CMX_INDEX = "__cmxidx__"
TROPO_DELAY = "__tropo_delay__"
BTPW_INDEX = "__btpwidx__"
#: the planets of PLANET_SHAPIRO, in the kernel's order (the order of
#: SolarSystemShapiro's sum)
PLANETS = ("jupiter", "saturn", "venus", "uranus", "neptune")

#: the members of a mask family (DelayJump, FDJumpDM, FDJump) that one
#: int32 bit word per row can carry
MAX_JUMPS = 31

#: tangent lanes per thread of the tangent launch that csrc/delay_chain.cu
#: compiles (1 is the single-lane kernel the others are held bit-equal to)
KERNEL_LANES = (1, 2, 4)


def family_index(flags: int, binary: int) -> int:
    """The index of the kernels' template value of a layout's ``flags``
    and binary family (csrc/delay_chain.cuh kernel_family, family_index):
    the binary family, plus 7 for the DM family's terms, 14 for the
    chromatic family's (with the DM family's), 21 for the orbit family's
    (with both) and 28 for the phase family's (with all three; the
    phase_chain kernels only)."""
    level = 4 if flags & PHASE_TERMS else 3 if flags & ORBIT_FAMILY_FLAGS \
        else 2 if flags & CHROM_FAMILY_FLAGS \
        else 1 if flags & DM_FAMILY_FLAGS else 0
    return 7 * level + binary


def lanes_per_thread(G: int, K: int) -> int:
    """The lanes each thread of a tangent launch over G θ sets of K lanes
    carries: 4, or 2 where G K < 64 (one θ set's ten nonlinear lanes),
    whose launch would hold too few threads to fill the card (PERF.md,
    K4)."""
    return 4 if G * K >= 64 else 2


#: the int32 fields of csrc/delay_chain.cuh ``ChainCfg``, in order
CFG_FIELDS = ("flags", "binary", "P", "ndm", "ndmx", "njump", "nfd",
              "o_astro", "o_dm", "o_dmx", "o_jump", "o_fd", "o_bin", "nharm",
              "nsw", "nswx", "nfdm", "nfdj", "o_sw", "o_swx", "o_fdm",
              "o_fdj", "ncm", "ncmx", "ncmwx", "ndmwx", "nwx", "ndip",
              "ngauss", "o_cm", "o_cmx", "o_cmwx", "o_dmwx", "o_wx", "o_dip",
              "o_gauss", "nfb", "norbw", "npiece", "o_fb", "o_orbw",
              "o_piece")


#: CFG_FIELDS of ``ChainCfg``; then ``ChromCfg``'s own, then ``OrbCfg``'s
N_BASE_FIELDS = CFG_FIELDS.index("ncm")


class ChainCfg(ctypes.Structure):
    """csrc/delay_chain.cuh ``OrbCfg``, which the C entry points take:
    ``ChainCfg`` (flags, binary family, θ length, block sizes, block
    offsets, ELL1H's highest harmonic, the order k of each FD<k>JUMP
    member), then the chromatic family's block sizes and offsets
    (``ChromCfg``), then the orbit family's (``OrbCfg``)."""

    _fields_ = [(n, ctypes.c_int32) for n in CFG_FIELDS[:N_BASE_FIELDS]] + [
        ("fdj_order", ctypes.c_int8 * (MAX_JUMPS + 1))] + [
        (n, ctypes.c_int32) for n in CFG_FIELDS[N_BASE_FIELDS:]]


Getter = Callable[[dict], torch.Tensor]


def slot_values(consts, deltas, p: dict) -> torch.Tensor:
    """θ slots of a layout: const + delta per slot (``consts`` getters of
    the params dict, None for zero; ``deltas`` the names of the
    ``p["delta"]`` offsets, or None), stacked, differentiable in
    ``p["delta"]``."""
    dev = next(iter(p["const"].values())).device
    zero = torch.zeros((), dtype=F64, device=dev)
    c = torch.stack([zero if g is None else
                     torch.as_tensor(g(p), dtype=F64, device=dev)
                     for g in consts])
    d = torch.stack([zero if n is None else
                     torch.as_tensor(p["delta"][n], dtype=F64)
                     for n in deltas])
    return c + d


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


def _number(x: float) -> Getter:
    """A constant of the model structure (a host float)."""
    return lambda p: x


@dataclasses.dataclass(frozen=True, eq=False)
class ChainLayout:
    """The θ layout of one model structure: per slot a getter of the
    params dict (a constant, or a quantity of the parameters alone; None
    for zero) and the name of the ``p["delta"]`` offset added to it (or
    None), and the kernel's :class:`ChainCfg` fields.  ``prepare``,
    if set, maps the params dict before the slots read it (DDGR injects
    its derived values as offsets, as its plain version does)."""

    names: Tuple[str, ...]
    consts: Tuple[Optional[Getter], ...]
    deltas: Tuple[Optional[str], ...]
    cfg: Tuple[int, ...]
    prepare: Optional[Callable[[dict], dict]] = None
    #: the order k of each FD<k>JUMP member, in bit order
    fdj_order: Tuple[int, ...] = ()

    @property
    def P(self) -> int:
        return len(self.names)

    @property
    def flags(self) -> int:
        return self.cfg[0]

    @property
    def jumps(self) -> bool:
        return bool(self.flags & JUMP)

    @property
    def kernel_index(self) -> int:
        """The index of the delay_chain kernels' template value
        (:func:`family_index`)."""
        return family_index(self.flags, self.cfg[1])

    def ctypes_cfg(self) -> ChainCfg:
        c = ChainCfg(**dict(zip(CFG_FIELDS, self.cfg)))
        for j, k in enumerate(self.fdj_order):
            c.fdj_order[j] = k
        return c

    def theta(self, p: dict) -> torch.Tensor:
        """(P,) float64 θ = const + delta per slot, differentiable in
        ``p["delta"]`` (and batched where it is)."""
        if self.prepare is not None:
            p = self.prepare(p)
        return slot_values(self.consts, self.deltas, p)

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
        count = dict(ndm=0, ndmx=0, njump=0, nfd=0, nharm=0, nsw=0, nswx=0,
                     nfdm=0, nfdj=0, ncm=0, ncmx=0, ncmwx=0, ndmwx=0, nwx=0,
                     ndip=0, ngauss=0, nfb=0, norbw=0, npiece=0)
        offs = dict(o_astro=0, o_dm=0, o_dmx=0, o_jump=0, o_fd=0, o_bin=0,
                    o_sw=0, o_swx=0, o_fdm=0, o_fdj=0, o_cm=0, o_cmx=0,
                    o_cmwx=0, o_dmwx=0, o_wx=0, o_dip=0, o_gauss=0, o_fb=0,
                    o_orbw=0, o_piece=0)
        prepare = None
        fdj_order: Tuple[int, ...] = ()

        def mask_block(comp, flag, n_key, o_key):
            """The slots of a mask family's members (those with a value),
            one bit each in the row's word of ``flag``."""
            nonlocal flags
            ms = comp.members()
            if len(ms) > MAX_JUMPS:
                raise NotImplementedError(
                    f"{type(comp).__name__} with {len(ms)} members: the "
                    f"delay_chain kernel carries at most {MAX_JUMPS}")
            if ms:
                flags |= flag
                count[n_key] = len(ms)
                offs[o_key] = len(names)
                for par in ms:
                    pv_slot(par.name)
            return ms

        def epoch_slot(ep):
            slot(f"{ep}__day", _epoch_day(ep), ep)

        def wave_block(comp, flag, n_key, o_key):
            """A sinusoid family's block: its epoch, then the modes'
            frequencies, SIN and COS amplitudes."""
            nonlocal flags
            modes = comp.mode_names()
            if modes:
                flags |= flag
                count[n_key] = len(modes)
                offs[o_key] = len(names)
                epoch_slot(comp.epoch_name())
                for k in range(3):
                    for mode in modes:
                        pv_slot(mode[k])

        def needs(flag, kind, what):
            if not flags & flag:
                raise AttributeError(f"{kind} needs {what}")

        order = (("AstrometryEquatorial", "AstrometryEcliptic"),
                 ("DelayJump",), ("TroposphereDelay",),
                 ("SolarSystemShapiro",),
                 ("SolarWindDispersion",), ("SolarWindDispersionX",),
                 ("DispersionDM",), ("DispersionDMX",), ("DispersionJump",),
                 ("FDJumpDM",), ("DMWaveX",), ("ChromaticCM",),
                 ("ChromaticCMX",), ("CMWaveX",), ("SimpleExponentialDip",),
                 ("ChromaticGaussianEvent",), tuple(BINARIES), ("FD",),
                 ("FDJump",), ("WaveX",))
        last = -1
        for comp in comps:
            kind = type(comp).__name__
            pos = next((i for i, kinds in enumerate(order)
                        if kind in kinds), None)
            if pos is None:
                raise NotImplementedError(
                    f"{kind} is not covered by the delay_chain kernel")
            if pos <= last:
                raise NotImplementedError(
                    f"{kind} out of the delay_chain kernel's order")
            last = pos
            if pos == 0:
                flags |= ASTRO
                if kind == "AstrometryEcliptic":
                    flags |= ECLIPTIC
                offs["o_astro"] = len(names)
                lon, lat = comp._angle_names
                for ang in (lon, lat):
                    slot(f"{ang}__sin", _const(ang + "__sincos", 0))
                    slot(f"{ang}__cos", _const(ang + "__sincos", 1))
                    slot(f"{ang}__offset", None, ang)
                for n in comp._pm_names + ("PX",):
                    pv_slot(n)
                ep = comp.pos_epoch_name()
                if ep:
                    flags |= PM
                    epoch_slot(ep)
                else:
                    slot("POSEPOCH__day", None)
                if flags & ECLIPTIC:
                    # the reference's math.cos / math.sin of the obliquity
                    eps = comp.obliquity()
                    slot("ECL__cos", _number(math.cos(eps)))
                    slot("ECL__sin", _number(math.sin(eps)))
            elif kind == "DelayJump":
                mask_block(comp, JUMP, "njump", "o_jump")
            elif kind == "SolarSystemShapiro":
                flags |= SHAPIRO
                if comp.PLANET_SHAPIRO.value:
                    flags |= PLANET_SHAPIRO   # one row input, no slot
            elif kind == "SolarWindDispersion":
                if not flags & ASTRO:
                    raise AttributeError(
                        "SolarWindDispersion needs an astrometry component")
                flags |= SOLAR_WIND
                nes = comp.ne_sw_names()
                count["nsw"] = len(nes)
                offs["o_sw"] = len(names)
                if len(nes) > 1:
                    epoch_slot(comp.epoch_name())
                else:
                    slot("SWEPOCH__day", None)
                for nm in nes:
                    pv_slot(nm)
                if comp.power_law:
                    # SWP, and its functions alone: the half range (its
                    # derivative is digamma's, which CUDA's libm lacks)
                    # and AU_LS^SWP, by the component's own code
                    from pint_tpu_torch.models.solar_wind import (AU_LS,
                                                                   half_range)

                    flags |= SWM1
                    pv_slot("SWP")
                    slot("SW__half", lambda p: half_range(pv(p, "SWP")))
                    slot("SW__au_p", lambda p: AU_LS ** pv(p, "SWP"))
            elif kind == "SolarWindDispersionX":
                if not flags & ASTRO:
                    raise AttributeError(
                        "SolarWindDispersionX needs an astrometry component")
                ranges = comp.swx_names()
                if ranges:
                    flags |= SWX
                    count["nswx"] = len(ranges)
                    offs["o_swx"] = len(names)
                    for nm in ranges:
                        pv_slot(nm)
            elif kind == "DispersionJump":
                pass  # DMJUMP offsets the measured DMs: no delay, no slot
            elif kind == "TroposphereDelay":
                if comp.CORRECT_TROPOSPHERE.value:
                    flags |= TROPO   # one row input, no slot
            elif kind == "DMWaveX":
                wave_block(comp, DMWAVEX, "ndmwx", "o_dmwx")
            elif kind == "ChromaticCM":
                flags |= CM
                cms = comp.cm_names()
                count["ncm"] = len(cms)
                offs["o_cm"] = len(names)
                if len(cms) > 1:
                    epoch_slot(comp.epoch_name())
                else:
                    slot("CMEPOCH__day", None)
                pv_slot("TNCHROMIDX")
                for nm in cms:
                    pv_slot(nm)
            elif kind == "ChromaticCMX":
                ranges = comp.cmx_names()
                if ranges:
                    needs(CM, kind, "a ChromaticCM component (TNCHROMIDX)")
                    flags |= CMX
                    count["ncmx"] = len(ranges)
                    offs["o_cmx"] = len(names)
                    for nm in ranges:
                        pv_slot(nm)
            elif kind == "CMWaveX":
                if comp.mode_names():
                    needs(CM, kind, "a ChromaticCM component (TNCHROMIDX)")
                wave_block(comp, CMWAVEX, "ncmwx", "o_cmwx")
            elif kind == "WaveX":
                wave_block(comp, WAVEX, "nwx", "o_wx")
            elif kind == "SimpleExponentialDip":
                dips = comp.dip_indices()
                if dips:
                    flags |= EXPDIP
                    count["ndip"] = len(dips)
                    offs["o_dip"] = len(names)
                    pv_slot("EXPDIPEPS")
                    pv_slot("EXPDIPFREF")
                    for i in dips:
                        epoch_slot(f"EXPDIPEP_{i}")
                        for stem in ("EXPDIPAMP_", "EXPDIPIDX_",
                                     "EXPDIPTAU_"):
                            pv_slot(f"{stem}{i}")
                        # the peak normalization, a function of TAU and
                        # EPS alone, by the component's own code
                        slot(f"EXPDIP_{i}__norm",
                             lambda p, c=comp, i=i: c.peak_norm(p, i))
            elif kind == "ChromaticGaussianEvent":
                events = comp.event_indices()
                if events:
                    flags |= CHROMGAUSS
                    count["ngauss"] = len(events)
                    offs["o_gauss"] = len(names)
                    pv_slot("CHROMGAUSSFREF")
                    for i in events:
                        epoch_slot(f"CHROMGAUSS_EPOCH_{i}")
                        # 10^LOGAMP and 10^LOGSIG, by the component's code
                        for k, what in enumerate(("amp", "sigma")):
                            slot(f"CHROMGAUSS_{i}__{what}",
                                 lambda p, c=comp, i=i, k=k:
                                 c.amp_sigma(p, i)[k])
                        pv_slot(f"CHROMGAUSS_SIGN_{i}")
                        pv_slot(f"CHROMGAUSS_CHROMIDX_{i}")
            elif kind == "FDJumpDM":
                mask_block(comp, FDJUMPDM, "nfdm", "o_fdm")
            elif kind == "FDJump":
                fdj_order = tuple(
                    comp.fd_order(par.prefix or par.name)
                    for par in mask_block(comp, FDJUMP, "nfdj", "o_fdj"))
            elif kind == "DispersionDM":
                flags |= DM
                dms = comp.dm_names()
                count["ndm"] = len(dms)
                offs["o_dm"] = len(names)
                if len(dms) > 1:
                    epoch_slot("DMEPOCH" if comp.DMEPOCH.value is not None
                               else "PEPOCH")
                else:
                    slot("DMEPOCH__day", None)
                for nm in dms:
                    pv_slot(nm)
            elif kind == "DispersionDMX":
                bins = comp.dmx_names()
                if bins:
                    flags |= DMX
                    count["ndmx"] = len(bins)
                    offs["o_dmx"] = len(names)
                    for nm in bins:
                        pv_slot(nm)
            elif kind == "FD":
                fds = comp.fd_names()
                if fds:
                    flags |= FD
                    count["nfd"] = len(fds)
                    offs["o_fd"] = len(names)
                    for nm in fds:
                        pv_slot(nm)
            else:
                if kind == "BinaryDDK" and not flags & ASTRO:
                    raise AttributeError(
                        "BinaryDDK needs an astrometry component")
                binary, bflags, prepare = _binary_slots(
                    comp, slot, pv_slot, count, offs, names)
                flags |= bflags
        if not names:
            slot("__empty__", None)
        fields = dict(flags=flags, binary=binary, P=len(names), **count,
                      **offs)
        cfg = tuple(fields[f] for f in CFG_FIELDS)
        return cls(tuple(names), tuple(consts), tuple(deltas), cfg, prepare,
                   fdj_order)


#: the binary components the kernel covers, by family
BINARIES = {"BinaryELL1": ELL1, "BinaryELL1H": ELL1H, "BinaryELL1k": ELL1K,
            "BinaryDD": DD, "BinaryBT": DD, "BinaryBTPiecewise": DD,
            "BinaryDDGR": DD, "BinaryDDK": DDK, "BinaryDDS": DDTM2,
            "BinaryDDH": DDTM2}


def _value(comp, n: str) -> bool:
    return n in comp.params and comp.params[n].value is not None


def _binary_slots(comp, slot, pv_slot, count, offs, names):
    """The binary block of θ (csrc/delay_chain.cuh b* offsets), then the
    orbit family's blocks of an FBn orbit, ORBWAVEs and BT_PIECEWISE's
    pieces (their counts and offsets set in ``count`` and ``offs``):
    ``(family, flags, the params dict's map or None)``."""
    kind = type(comp).__name__
    offs["o_bin"] = len(names)

    def pv_or_zero(n):
        if _value(comp, n):
            pv_slot(n)
        else:
            slot(n, None)

    family, flags, prepare = _binary_block(comp, kind, slot, pv_slot,
                                           pv_or_zero, count)
    fbs = comp.fb_names()
    if fbs:
        # taylor_horner's coefficients [0, FB0, FB1, ...]: the orbit count
        # over all of them, the frequency over FB0 on
        flags |= FB_ORBIT
        count["nfb"] = len(fbs)
        offs["o_fb"] = len(names)
        slot("FB__zero", None)
        for n in fbs:
            pv_slot(n)
    cs, ss = comp.orbwave_names()
    if cs:
        flags |= ORBWAVE
        count["norbw"] = len(cs)
        offs["o_orbw"] = len(names)
        pv_slot("ORBWAVE_OM")
        pv_slot("ORBWAVE_EPOCH")
        for cn, sn in zip(cs, ss):
            pv_slot(cn)
            pv_slot(sn)
    if kind == "BinaryBTPiecewise" and comp.piece_indices():
        flags |= BT_PIECES
        pieces = comp.piece_indices()
        count["npiece"] = len(pieces)
        offs["o_piece"] = len(names)
        # per piece: its t - T0 shift [s], whether it sets T0X, its A1X
        # [ls], whether it sets A1X (csrc/delay_chain.cuh piece* slots)
        for i in pieces:
            if comp.has_piece_value("T0X_", i):
                # the reference's own (T0 - T0X) * 86400, by its code
                slot(f"T0X_{i:04d}__shift",
                     lambda p, i=i: comp.piece_shift(p, i))
                slot(f"T0X_{i:04d}__set", _number(1.0))
            else:
                slot(f"T0X_{i:04d}__shift", None)
                slot(f"T0X_{i:04d}__set", None)
            if comp.has_piece_value("A1X_", i):
                pv_slot(f"A1X_{i:04d}")
                slot(f"A1X_{i:04d}__set", _number(1.0))
            else:
                slot(f"A1X_{i:04d}", None)
                slot(f"A1X_{i:04d}__set", None)
    return family, flags, prepare


def _binary_block(comp, kind, slot, pv_slot, pv_or_zero, count):
    """The binary block proper: ``(family, flags, the params dict's map
    or None)``, ELL1H's highest harmonic in ``count["nharm"]``."""
    family = BINARIES[kind]
    ep = "TASC" if family in (ELL1, ELL1H, ELL1K) else "T0"
    slot(f"{ep}__day0", _const(ep, 0))
    for k in range(4):
        slot(f"{ep}__word{k}", _word(ep, k))
    slot(f"{ep}__ddays", None, ep)
    # PB is unset under an FBn orbit (its slot then holds 0, unread)
    pv_or_zero("PB")
    for n in ("PBDOT", "A1", "A1DOT"):
        pv_slot(n)

    if family in (ELL1, ELL1K):
        flags = BIN_SHAPIRO if _value(comp, "M2") and _value(comp, "SINI") \
            else 0
        dots = ("OMDOT", "LNEDOT") if family == ELL1K \
            else ("EPS1DOT", "EPS2DOT")
        for n in ("EPS1", "EPS2") + dots + ("M2", "SINI"):
            pv_or_zero(n)
        return family, flags, None
    if family == ELL1H:
        for n in ("EPS1", "EPS2", "EPS1DOT", "EPS2DOT"):
            pv_or_zero(n)
        # the slots of BinaryELL1H.shapiro_delay that depend on the
        # parameters alone, formed by its own code
        if comp.STIGMA.value is not None:
            for i, n in enumerate(("factor", "a", "b", "d")):
                slot(f"H__{n}", lambda p, i=i: comp.stigma_factors(p)[i])
            return ELL1H, BIN_SHAPIRO | STIGMA, None
        slot("H__factor", lambda p: -2.0 * pv(p, "H3"))
        count["nharm"] = nharm = comp.nharms()
        for k in range(3, nharm + 1):
            slot(f"H__w{k}", lambda p, k=k: comp.harmonic_weights(p)[k - 3])
        return ELL1H, BIN_SHAPIRO, None
    for n in ("ECC", "EDOT", "OM", "OMDOT", "GAMMA"):
        pv_or_zero(n)
    flags = OMEGA_FROM_NU if comp.omega_from_nu else 0
    prepare = None
    if kind not in ("BinaryBT", "BinaryBTPiecewise"):
        flags |= ABERRATION
    if family == DDTM2:
        # DDS, DDH: _tm2_sini's TM2 [s] and sin i, unclipped
        if kind == "BinaryDDH" or (_value(comp, "M2")
                                   and _value(comp, "SHAPMAX")):
            flags |= BIN_SHAPIRO
            slot("TM2", lambda p: comp._tm2_sini(p, None, None)[0])
            slot("SINI", lambda p: comp._tm2_sini(p, None, None)[1])
        else:
            slot("TM2", None)
            slot("SINI", None)
    elif family == DDK:
        flags |= BIN_SHAPIRO if _value(comp, "M2") else 0
        if comp.K96.value:
            flags |= K96
        pv_or_zero("M2")
        pv_slot("KIN")
    elif kind == "BinaryDDGR":
        # _with_gr's offsets, and _gr_pk's sin i (clipped by the kernel)
        flags |= BIN_SHAPIRO
        prepare = lambda p: comp._with_gr(p)[0]  # noqa: E731
        pv_slot("M2")
        slot("SINI", lambda p: comp._gr_pk(p)["sini"])
    else:
        flags |= BIN_SHAPIRO if _value(comp, "M2") and _value(comp, "SINI") \
            else 0
        pv_or_zero("M2")
        pv_or_zero("SINI")
    for n in ("DR", "DTH", "A0", "B0"):
        pv_or_zero(n)
    if family == DDK:
        slot("KOM__sin", lambda p: torch.sin(pv(p, "KOM")))
        slot("KOM__cos", lambda p: torch.cos(pv(p, "KOM")))
    return family, flags, prepare


# -- the library ---------------------------------------------------------------

_c_void_p, _c_int64 = ctypes.c_void_p, ctypes.c_int64


def _lib(layout: "ChainLayout"):
    """The library that holds ``layout``'s kernels (one part of the
    source's build, kernels/build.py)."""
    from pint_tpu_torch.kernels.build import load, part_of

    lib = load(part_of("delay_chain", layout.kernel_index))
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.delay_chain.argtypes = [_c_void_p] * (len(ROWS) + 4) + [
        ChainCfg, _c_int64, _c_int64, _c_int64, ctypes.c_int, _c_void_p]
    lib.delay_chain.restype = ctypes.c_int
    lib.delay_chain_orbital_phase.argtypes = [_c_void_p] * (
        len(ROWS) + 2) + [ChainCfg, _c_int64, _c_int64, _c_void_p]
    lib.delay_chain_orbital_phase.restype = ctypes.c_int
    lib.delay_chain_error_string.argtypes = [ctypes.c_int]
    lib.delay_chain_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def _ptr(t: torch.Tensor):
    return t.data_ptr() if t.numel() else None


#: the per-TOA inputs, in the kernel's order: name, dtype, trailing shape
ROWS = (("tdb_day", torch.int64, ()), ("tdb_frac", F64, ()),
        ("frac_w", F32, (3,)), ("pos", F64, (3,)), ("sun", F64, (3,)),
        ("freq", F64, ()), ("dmx", I32, (2,)), ("jbits", I32, ()),
        ("swx", I32, (2,)), ("fdmbits", I32, ()), ("fdjbits", I32, ()),
        ("cmx", I32, (2,)), ("tropo", F64, ()),
        ("planets", F64, (len(PLANETS), 3)), ("btpiece", I32, ()))
#: the inputs that a model without the component passes empty, by the
#: flag that reads them and the mask entry that holds them
MASK_ROWS = (("dmx", DMX, DMX_INDEX), ("jbits", JUMP, JUMP_BITS),
             ("swx", SWX, SWX_INDEX), ("fdmbits", FDJUMPDM, FDJUMPDM_BITS),
             ("fdjbits", FDJUMP, FDJUMP_BITS), ("cmx", CMX, CMX_INDEX),
             ("tropo", TROPO, TROPO_DELAY), ("btpiece", BT_PIECES, BTPW_INDEX))


def _check_rows(rows, dev):
    N = rows[0].shape[0]
    optional = {name for name, _, _ in MASK_ROWS} | {"planets"}
    for (name, dtype, tail), t in zip(ROWS, rows):
        if name in optional and t.numel() == 0:
            continue
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (N, *tail):
            raise ValueError(
                f"delay_chain: {name} must be {dtype} of shape {(N, *tail)} "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return N


def _launch(layout: ChainLayout, theta, dtheta, rows, aux: bool = False,
            lanes: Optional[int] = None):
    """One launch on ``theta`` (..., P): the (..., N) delay (with ``aux``
    also the (3, ..., N) M, e, E of a DD/BT binary); or, with ``dtheta``
    (..., K, P), the (..., K, N) tangents of its K lanes, each thread
    carrying ``lanes`` of them (by default :func:`lanes_per_thread`)."""
    dev = theta.device
    N = _check_rows(rows, dev)
    P = layout.P
    lead = theta.shape[:-1]
    if theta.dtype != F64 or theta.shape[-1] != P or (
            dtheta is not None and (
                dtheta.dtype != F64 or dtheta.device != dev
                or dtheta.dim() != theta.dim() + 1
                or dtheta.shape[:-2] != lead or dtheta.shape[-1] != P)):
        raise ValueError(f"delay_chain: theta must be float64 (..., {P}) "
                         f"on {dev} and its tangent (..., K, {P}) with the "
                         f"same leading axes, got {tuple(theta.shape)} and "
                         f"{None if dtheta is None else tuple(dtheta.shape)}")
    G = 1
    for s in lead:
        G *= s
    K = 0 if dtheta is None else dtheta.shape[-2]
    if lanes is None:
        lanes = lanes_per_thread(G, K)
    if lanes not in KERNEL_LANES:
        raise ValueError(f"delay_chain: lanes per thread must be one of "
                         f"{KERNEL_LANES}, got {lanes}")
    theta = theta.contiguous()
    rows = [t.contiguous() for t in rows]
    if dtheta is None:
        out = torch.empty((*lead, N), dtype=F64, device=dev)
    else:
        dtheta = dtheta.contiguous()
        out = torch.empty((*lead, K, N), dtype=F64, device=dev)
    aux_t = torch.empty((3, *lead, N), dtype=F64, device=dev) if aux \
        else None
    if G == 0 or (dtheta is not None and K == 0):
        return out, aux_t
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib(layout)
    err = lib.delay_chain(
        *[_ptr(t) for t in rows], theta.data_ptr(),
        None if dtheta is None else dtheta.data_ptr(), out.data_ptr(),
        None if aux_t is None else aux_t.data_ptr(), layout.ctypes_cfg(),
        G, K, N, lanes, stream)
    if err != 0:
        raise RuntimeError("delay_chain launch failed: "
                           + lib.delay_chain_error_string(err).decode())
    if dtheta is None:
        DelayChain.launches += 1
    else:
        DelayChainTangent.launches += 1
    return out, aux_t


def run(layout: ChainLayout, theta, dtheta, rows,
        lanes: Optional[int] = None):
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
    return _launch(layout, theta, dtheta, rows, lanes=lanes)[0]


def _front(x, d, B):
    return x.expand(B, *x.shape) if d is None else x.movedim(d, 0)


def _no_batched_rows(in_dims, name):
    if any(d is not None for d in in_dims):
        raise NotImplementedError(
            f"{name}: only theta and its tangent may carry a vmap axis")


class DelayChainTangent(torch.autograd.Function):
    """``(theta (..., P), dtheta (..., K, P), layout, *rows) -> (..., K,
    N)`` tangents of the delay along the K lanes of ``dtheta``: the
    kernel's tangent launch."""

    #: tangent kernel launches in this process
    launches = 0

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
        td, dd = in_dims[:2]
        if td is None and dd is not None:
            # tangents of one θ (jacfwd lanes): more lanes of each θ set
            d = dtheta.movedim(dd, -3)                  # (..., B, K, P)
            out = DelayChainTangent.apply(theta, d.flatten(-3, -2), layout,
                                          *rows)         # (..., B K, N)
            out = out.unflatten(-2, (B, d.shape[-2]))   # (..., B, K, N)
            return out, out.dim() - 3
        # a batch of θ (grid points): more θ sets, each with its lanes
        return DelayChainTangent.apply(_front(theta, td, B),
                                       _front(dtheta, dd, B),
                                       layout, *rows), 0


class DelayChain(torch.autograd.Function):
    """``(theta, layout, *rows) -> (..., N)`` delay [s], differentiable in
    ``theta`` in forward mode (``jvp``: the tangent launch) and reverse
    mode (``backward``: the tangent launch with unit tangents, reduced
    against the incoming gradient).  ``rows`` are the per-TOA tensors of
    :data:`ROWS`; they pass through ``apply`` so that torch.func unwraps
    them before the kernel reads their pointers."""

    #: primal kernel launches in this process (plain runs are not
    #: counted; the tangent launches are DelayChainTangent.launches)
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
        return DelayChainTangent.apply(theta, dtheta.unsqueeze(-2),
                                       ctx.layout, *rows).squeeze(-2)

    @staticmethod
    def backward(ctx, g):
        theta, *rows = ctx.saved_tensors
        P = theta.shape[-1]
        eye = torch.eye(P, dtype=F64, device=theta.device)
        J = DelayChainTangent.apply(
            theta, eye.expand(*theta.shape[:-1], P, P), ctx.layout,
            *rows)                                       # (..., P, N)
        return (torch.matmul(J, g[..., :, None])[..., 0], None,
                *[None] * len(rows))

    @staticmethod
    def vmap(info, in_dims, theta, layout, *rows):
        _no_batched_rows(in_dims[1:], "delay_chain")
        return DelayChain.apply(_front(theta, in_dims[0], info.batch_size),
                                layout, *rows), 0


def row_inputs(layout: ChainLayout, p: dict, batch) -> list:
    """The kernel's per-TOA tensors (:data:`ROWS`) for ``batch``: its
    columns plus the DMX bins, SWX and CMX ranges, member bits, the
    troposphere's delay and the BT_PIECEWISE pieces of ``p["mask"]``, and
    the planets' positions (N, 5, 3) [ls] (each empty where the model has
    none).  A range index left out by its component (three ranges
    overlapping on a TOA) raises, and so do TOAs without the planets'
    positions under PLANET_SHAPIRO."""
    empty = torch.empty(0, dtype=I32, device=batch.device)
    masks = []
    for name, flag, entry in MASK_ROWS:
        t = empty
        if layout.flags & flag:
            t = p["mask"].get(entry)
            if t is None:
                raise ValueError(
                    f"delay_chain: no {entry} in the params dict: three "
                    "ranges overlap on a TOA (the kernel takes at most two "
                    "per TOA)" if name in ("dmx", "swx", "cmx") else
                    f"delay_chain: no {entry} in the params dict")
        masks.append(t)
    planets = empty.to(F64)
    if layout.flags & PLANET_SHAPIRO:
        missing = [pl for pl in PLANETS if pl not in batch.obs_planet_pos_ls]
        if missing:
            raise KeyError(f"planet positions {missing} missing: load TOAs "
                           "with planets=True for PLANET_SHAPIRO")
        planets = torch.stack([batch.obs_planet_pos_ls[pl]
                               for pl in PLANETS], dim=1)
    return [batch.tdb_day, batch.tdb_frac, batch.tdb_frac_w,
            batch.ssb_obs_pos_ls, batch.obs_sun_pos_ls, batch.freq_mhz,
            *masks[:-1], planets, masks[-1]]


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


class OrbitalPhase:
    """The orbital-phase entry of the delay kernel
    (``delay_chain_orbital_phase``): the chain up to the binary and its
    orbit, no tangent."""

    #: orbital-phase kernel launches in this process
    launches = 0


def orbital_phase_launch(layout: ChainLayout, theta, rows) -> torch.Tensor:
    """One orbital-phase launch on CUDA ``theta`` (..., P): the (..., N)
    fractional orbital phase of ``layout``'s binary."""
    if layout.cfg[1] == NO_BINARY:
        raise ValueError("orbital_phase requires a binary model (no BINARY "
                         "in the par file)")
    dev = theta.device
    N = _check_rows(rows, dev)
    lead = theta.shape[:-1]
    if theta.dtype != F64 or theta.shape[-1] != layout.P:
        raise ValueError(f"delay_chain: theta must be float64 (..., "
                         f"{layout.P}), got {tuple(theta.shape)}")
    G = math.prod(lead)
    out = torch.empty((*lead, N), dtype=F64, device=dev)
    if G == 0:
        return out
    theta = theta.detach().contiguous()
    rows = [t.contiguous() for t in rows]
    lib = _lib(layout)
    err = lib.delay_chain_orbital_phase(
        *[_ptr(t) for t in rows], theta.data_ptr(), out.data_ptr(),
        layout.ctypes_cfg(), G, N, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("delay_chain orbital-phase launch failed: "
                           + lib.delay_chain_error_string(err).decode())
    OrbitalPhase.launches += 1
    return out


def orbital_phase(calc, p: dict, batch) -> torch.Tensor:
    """The (N,) fractional orbital phase in [0, 1) of ``calc``'s binary
    (:meth:`pint_tpu_torch.models.timing_model.TimingModel.orbital_phase`):
    the kernel's orbital-phase entry on a CUDA batch, the plain version
    (the delay before the binary, then the binary's ``orbital_phase``) on
    a CPU batch.  No tangent."""
    binary = [c for c in calc.delay_components
              if c.category == "pulsar_system"]
    if not binary:
        raise ValueError("orbital_phase requires a binary model (no BINARY "
                         "in the par file)")
    if batch.device.type == "cpu":
        d = calc.delay_plain(p, batch, upto="pulsar_system")
        return binary[0].orbital_phase(p, batch, d)
    if batch.device.type != "cuda":
        raise ValueError(f"delay_chain: unsupported device {batch.device}")
    return orbital_phase_kernel(calc, p, batch)


def orbital_phase_kernel(calc, p: dict, batch) -> torch.Tensor:
    """One launch of the orbital-phase entry for ``calc``'s layout on
    ``batch``'s rows."""
    layout = calc.chain_layout
    with torch.no_grad():
        # θ without the layout's ``prepare``: DDGR's orbit reads the par's
        # PBDOT, not its derived one, as the binary's orbital_phase does
        theta = slot_values(layout.consts, layout.deltas, p)
        return orbital_phase_launch(layout, theta,
                                    row_inputs(layout, p, batch))


def delay_chain_aux(calc, p: dict, batch):
    """``(delay, aux)`` of one primal launch on a CUDA batch, ``aux`` the
    (3, N) M, e and E of a DD/BT binary's Kepler solve (no tangent)."""
    layout = calc.chain_layout
    with torch.no_grad():
        rows = [t.contiguous() for t in row_inputs(layout, p, batch)]
        return _launch(layout, layout.theta(p), None, rows, aux=True)
