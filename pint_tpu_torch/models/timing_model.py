"""TimingModel and the component framework.

Port of :mod:`pint_tpu.models.timing_model`.  A model is an ordered
collection of registered components — each a DelayComponent (seconds) or
PhaseComponent (cycles) owning typed parameters — plus top-level metadata
parameters (reference `TimingModel`,
`src/pint/models/timing_model.py:161`).

Every component implements a pure function ``delay(p, batch, delay)`` /
``phase(p, batch, delay)`` of a params dict ``p`` (nested dicts of tensors:
``const``/``delta``/``mask``, as :meth:`TimingModel.build_pdict` builds
it) and a :class:`~pint_tpu_torch.toabatch.TOABatch`.  No mutation and no
data-dependent Python control flow, so the composition runs under
``torch.func.vmap``/``jvp``/``jacfwd``: the design matrix is forward-mode
autodiff of the residual function, as in :mod:`pint_tpu`.

The delay chain runs as one CUDA kernel (:meth:`PhaseCalc.delay`,
:mod:`pint_tpu_torch.kernels.delay_chain`; the components' own delays are
its plain version), and the residual phase (:meth:`PhaseCalc.phase_frac`)
as the delay chain with the spin phase, TZR subtraction and pulse
rounding as its epilogue, one primal and one tangent launch
(:mod:`pint_tpu_torch.kernels.phase_chain`); :meth:`PhaseCalc.phase`
keeps the plain quad-single form of the same sum.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pint_tpu_torch.exceptions import (
    MissingParameter,
    TimingModelError,
    UnknownParameter,
)
from pint_tpu_torch.models.parameter import (
    AngleParam,
    MaskParam,
    MJDParam,
    Param,
    StrParam,
)
from pint_tpu_torch.toabatch import TOABatch
from pint_tpu_torch.utils import resolve_device

__all__ = ["Component", "DelayComponent", "PhaseComponent", "TimingModel",
           "DEFAULT_ORDER", "PhaseCalc"]

#: evaluation order of delay/phase contributions, by component category
#: (the reference's DEFAULT_ORDER,
#: `src/pint/models/timing_model.py:119`)
DEFAULT_ORDER = [
    "astrometry",
    "jump_delay",
    "troposphere",
    "solar_system_shapiro",
    "solar_wind",
    "solar_windx",
    "dispersion_constant",
    "dispersion_dmx",
    "dispersion_jump",
    "fdjumpdm",
    "dmwavex",
    "chromatic_constant",
    "chromatic_cmx",
    "cmwavex",
    "expdip",
    "chromgauss",
    "pulsar_system",
    "frequency_dependent",
    "fdjump",
    "absolute_phase",
    "spindown",
    "glitch",
    "piecewise_spindown",
    "phase_jump",
    "wave",
    "wavex",
    "ifunc",
    "phase_offset",
]


def pv(p: dict, name: str):
    """Current f64 value of a parameter: reference + offset."""
    return p["const"][name] + p["delta"].get(name, 0.0)


def dv(p: dict, name: str):
    """Just the (differentiable) offset of a parameter."""
    return p["delta"].get(name, 0.0)


def pqs(p: dict, name: str):
    """Reference value as a QS (exact, non-differentiated)."""
    from pint_tpu_torch import qs

    w = p["const"][name + "__qs"]
    return qs.QS(w[..., 0], w[..., 1], w[..., 2], w[..., 3])


def mjd_parts(p: dict, name: str):
    """(day:f64, frac_qs:QS, delta_days:f64) of an MJD parameter."""
    from pint_tpu_torch import qs

    c = p["const"][name]
    w = p["const"][name + "__fracqs"]
    return (c[0], qs.QS(w[..., 0], w[..., 1], w[..., 2], w[..., 3]),
            dv(p, name))


def epoch_days(p: dict, name: str):
    """Current f64 MJD of an epoch parameter: day + frac + fit offset."""
    c = p["const"][name]
    return c[0] + c[1] + p["delta"].get(name, 0.0)


def mask_of(p: dict, param: MaskParam):
    return p["mask"][param.mask_pytree_name]


def member_bits(members, masks: dict, ntoas: int):
    """int32 bits per TOA, bit j set where the j-th of ``members`` (mask
    parameters with a value, their masks in ``masks``) selects the TOA:
    the delay kernel's per-row word of a mask family (DelayJump,
    FDJumpDM, FDJump), or None beyond 31 members (the kernel then
    refuses the model)."""
    if len(members) > 31:
        return None
    bits = np.zeros(ntoas, np.int32)
    for j, par in enumerate(members):
        bits |= masks[par.mask_pytree_name].astype(bool).astype(
            np.int32) << j
    return bits


def range_entries(names, bounds, mjd: np.ndarray):
    """(masks, index) of a family of inclusive MJD ranges (DMX, SWX, CMX):
    ``masks`` maps ``<name>__rangemask`` to each range's float64 TOA mask
    (the plain version's), ``index`` is the (N, 2) int32 ranges of each
    TOA (-1 for none) that the delay kernel reads: a TOA on the boundary
    two ranges share lies in both.  ``index`` is None where three ranges
    overlap on a TOA, and the kernel then refuses the model."""
    masks = {}
    index = np.full((len(mjd), 2), -1, np.int32)
    fits = True
    for i, (n, (r1, r2)) in enumerate(zip(names, bounds)):
        sel = (mjd >= r1) & (mjd <= r2)
        masks[f"{n}__rangemask"] = sel.astype(np.float64)
        fits = fits and not np.any(sel & (index[:, 1] >= 0))
        second = sel & (index[:, 0] >= 0)
        index[second, 1] = i
        index[sel & ~second, 0] = i
    return masks, (index if fits else None)


def zeros_rows(batch: TOABatch) -> torch.Tensor:
    """(N,) float64 zeros on the batch's device."""
    return torch.zeros(batch.ntoas, dtype=torch.float64, device=batch.device)


class Component:
    """Base component: owns parameters, auto-registers subclasses."""

    #: subclass name -> class, for every class with ``register = True``
    component_types: Dict[str, type] = {}
    register = False
    category = ""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.__dict__.get("register", cls.register):
            Component.component_types[cls.__name__] = cls

    def __init__(self):
        self.params: Dict[str, Param] = {}
        self._parent: Optional["TimingModel"] = None

    # -- parameter management --------------------------------------------
    def add_param(self, p: Param):
        self.params[p.name] = p
        return p

    def remove_param(self, name: str):
        del self.params[name]

    def __getattr__(self, name):
        params = self.__dict__.get("params")
        if params is not None and name in params:
            return params[name]
        raise AttributeError(
            f"{type(self).__name__} has no attribute/parameter {name!r}")

    @property
    def free_params_component(self) -> List[str]:
        return [p.name for p in self.params.values() if not p.frozen]

    def prefix_params(self, prefix: str) -> List[Param]:
        """All params of a prefix family, sorted by index."""
        out = [p for p in self.params.values() if p.prefix == prefix]
        return sorted(out, key=lambda p: (p.index is None, p.index))

    # -- lifecycle --------------------------------------------------------
    def setup(self):
        """Post-parse hook (build prefix lists etc.)."""

    def validate(self):
        """Raise on inconsistent parameters."""

    def require(self, *names):
        for n in names:
            p = self.params.get(n)
            if p is None or p.value is None:
                raise MissingParameter(
                    f"{type(self).__name__} requires parameter {n}")

    # -- params dict ------------------------------------------------------
    def derived_device_entries(self) -> Dict[str, np.ndarray]:
        """Extra constants computed from parameter values (host side)."""
        return {}

    def mask_entries(self, toas) -> Dict[str, np.ndarray]:
        """Host-computed TOA-mask arrays for this component's MaskParams."""
        out = {}
        for p in self.params.values():
            if isinstance(p, MaskParam) and p.value is not None:
                out[p.mask_pytree_name] = p.select_mask(toas).astype(np.float64)
        return out

    def qs_param_names(self) -> List[str]:
        """Parameters whose reference values must reach the device in exact
        quad-single words (phase-level precision).  Default: none."""
        return []

    def linear_params(self) -> List[str]:
        """Parameters whose delay/phase contribution is EXACTLY linear in
        the parameter value: their design-matrix columns are cacheable
        across Gauss-Newton iterations (see
        :func:`pint_tpu_torch.fitter.build_whitened_assembly`)."""
        return []


class DelayComponent(Component):
    """A time-delay contribution [seconds]."""

    def delay(self, p: dict, batch: TOABatch,
              delay: torch.Tensor) -> torch.Tensor:
        """This component's delay [s] given the accumulated delay so far."""
        raise NotImplementedError


class PhaseComponent(Component):
    """A pulse-phase contribution [cycles], as a quad-single
    (:class:`pint_tpu_torch.qs.QS`)."""

    #: whether :meth:`phase_f64` reads the accumulated delay: the fused
    #: phase kernel forms the delay inside its launch and takes ``other``
    #: as an input, so it refuses a component whose float64 phase needs
    #: the delay
    phase_f64_reads_delay = True

    def phase(self, p: dict, batch: TOABatch, delay: torch.Tensor,
              is_tzr: bool = False):
        raise NotImplementedError

    def phase_f64(self, p: dict, batch: TOABatch, delay: torch.Tensor):
        """This component's phase [cycles] as float64 rows, for components
        whose quad-single phase is ``qs.from_f64_device`` of an f64 value;
        None for a component that adds no phase.  The phase kernel takes
        these as its ``other`` input."""
        raise NotImplementedError(
            f"{type(self).__name__} has no float64 phase form; the phase "
            "kernel cannot evaluate this model")


class PhaseCalc:
    """The pure functions of a frozen model structure: bound methods close
    over the component list; numeric state flows through the params dict."""

    def __init__(self, delay_components: Sequence[DelayComponent],
                 phase_components: Sequence[PhaseComponent]):
        self.delay_components = list(delay_components)
        self.phase_components = list(phase_components)
        self._chain_layout = None

    def delay(self, p: dict, batch: TOABatch) -> torch.Tensor:
        """Total delay [s], accumulated in DEFAULT_ORDER: the
        ``delay_chain`` kernel on a CUDA batch, :meth:`delay_plain` on a
        CPU batch (:func:`pint_tpu_torch.kernels.delay_chain.delay_chain`).
        Differentiable (forward mode) in everything that ``p["delta"]``
        reaches."""
        from pint_tpu_torch.kernels.delay_chain import delay_chain

        return delay_chain(self, p, batch)

    def delay_plain(self, p: dict, batch: TOABatch) -> torch.Tensor:
        """The plain PyTorch version of the delay kernel: each component's
        delay, given the delay accumulated before it."""
        d = zeros_rows(batch)
        for comp in self.delay_components:
            d = d + comp.delay(p, batch, d)
        return d

    @property
    def chain_layout(self):
        """The delay kernel's θ layout of these components (built once);
        raises ``NotImplementedError`` for a component it does not
        cover."""
        if self._chain_layout is None:
            from pint_tpu_torch.kernels.delay_chain import ChainLayout

            self._chain_layout = ChainLayout.from_components(
                self.delay_components)
        return self._chain_layout

    def phase(self, p: dict, batch: TOABatch,
              subtract_tzr: bool = True, is_tzr: bool = False):
        """Total absolute phase [cycles] as a quad-single, in plain PyTorch
        (:meth:`pint_tpu.models.timing_model.PhaseCalc.phase`): the TZR
        reference phase rides in ``p["const"]["__tzrphase__"]`` and is
        subtracted as data."""
        from pint_tpu_torch import qs

        delay = self.delay(p, batch)
        total = qs.zeros_like(torch.zeros(batch.ntoas, dtype=torch.float32,
                                          device=batch.device))
        for comp in self.phase_components:
            total = qs.add(total, comp.phase(p, batch, delay, is_tzr=is_tzr))
        tw = p["const"].get("__tzrphase__") if subtract_tzr else None
        if tw is not None:
            total = qs.sub(total, qs.QS(*[
                torch.broadcast_to(tw[..., k], total.w0.shape)
                for k in range(4)]))
        return total

    def _kernel_layout(self):
        """(spindown, f64-phase components) for the phase kernel, which
        evaluates ``qs.add(zeros, Spindown.phase)`` then adds the float64
        phase of the components after it.  Components before the
        Spindown must add no phase (AbsPhase)."""
        sd = [c for c in self.phase_components if c.category == "spindown"]
        if len(sd) != 1:
            raise NotImplementedError(
                "the phase kernel needs exactly one Spindown component")
        i = self.phase_components.index(sd[0])
        for c in self.phase_components[:i]:
            if c.category != "absolute_phase":
                raise NotImplementedError(
                    f"{type(c).__name__} before Spindown: not supported by "
                    "the phase kernel")
        return sd[0], self.phase_components[i + 1:]

    def phase_frac(self, p: dict, batch: TOABatch, mode: str,
                   subtract_tzr: bool = True):
        """The phase chain's output for this model: ``mode`` "nearest" ->
        (N,) fractional phase [cycles] after nearest-pulse rounding;
        "use_pulse_numbers" -> phase minus the batch's pulse numbers;
        "words" -> (N, 4) float32 words of the unrounded total phase.
        On a CUDA batch the delay chain and the phase run fused in the
        ``phase_chain`` kernel's launches; on a CPU batch as the plain
        composition (:func:`pint_tpu_torch.kernels.phase_chain.phase_frac`).
        Differentiable (forward mode) in everything that ``p["delta"]``
        reaches, through the kernels' analytic tangent rules."""
        from pint_tpu_torch.kernels.phase_chain import phase_frac

        return phase_frac(self, p, batch, mode, subtract_tzr)


class TimingModel:
    """A timing model: components + top-level metadata parameters.

    Attribute access forwards to parameters (``model.F0`` is the Param;
    ``model.F0.value`` its par-units value)."""

    def __init__(self, name: str = "", components: Sequence[Component] = ()):
        self.name = name
        self.components: Dict[str, Component] = {}
        self.top_params: Dict[str, Param] = {}
        for p in _top_level_params():
            self.top_params[p.name] = p
        for c in components:
            self.add_component(c, setup=False)
        self.tzr_batch: Optional[TOABatch] = None
        self.meta: Dict[str, str] = {}

    # -- structure --------------------------------------------------------
    def add_component(self, comp: Component, setup=True, validate=False):
        name = type(comp).__name__
        if name in self.components:
            raise TimingModelError(f"component {name} already present")
        comp._parent = self
        self.components[name] = comp
        from pint_tpu_torch.models.parameter import funcParameter
        for par in comp.params.values():
            if isinstance(par, funcParameter):
                par.bind(self)
        self._sort_components()
        if setup:
            comp.setup()
        if validate:
            comp.validate()

    def remove_component(self, name: str):
        """Drop component ``name``.  What the port derives from the
        component list goes with it: the chain layout (each
        :attr:`calc` forms its own) and the TZR state, which the next
        residuals rebuild."""
        self.components.pop(name)._parent = None
        self.tzr_batch = None

    def _sort_components(self):
        def key(item):
            cat = item[1].category
            return DEFAULT_ORDER.index(cat) if cat in DEFAULT_ORDER else \
                len(DEFAULT_ORDER)

        self.components = dict(sorted(self.components.items(), key=key))

    @property
    def delay_components(self) -> List[DelayComponent]:
        return [c for c in self.components.values()
                if isinstance(c, DelayComponent)]

    @property
    def phase_components(self) -> List[PhaseComponent]:
        return [c for c in self.components.values()
                if isinstance(c, PhaseComponent)]

    def setup(self):
        for c in self.components.values():
            c.setup()

    def validate(self):
        # F0-only models may omit PEPOCH, but TZR-referenced absolute phase
        # must not mix two implicit origins: anchor it at TZRMJD then
        sd = self.components.get("Spindown")
        if (sd is not None and sd.PEPOCH.value is None
                and "AbsPhase" in self.components
                and self.TZRMJD.value is not None):
            sd.PEPOCH.value = self.TZRMJD.value
        for c in self.components.values():
            c.validate()

    # -- parameter access -------------------------------------------------
    def __getattr__(self, name):
        tp = self.__dict__.get("top_params")
        if tp and name in tp:
            return tp[name]
        comps = self.__dict__.get("components")
        if comps:
            for c in comps.values():
                if name in c.params:
                    return c.params[name]
        raise AttributeError(f"timing model has no parameter {name!r}")

    def __getitem__(self, name) -> Param:
        try:
            return getattr(self, name)
        except AttributeError:
            raise UnknownParameter(name)

    def __contains__(self, name) -> bool:
        try:
            self[name]
            return True
        except UnknownParameter:
            return False

    def param_component(self, name: str) -> Optional[str]:
        for cname, c in self.components.items():
            if name in c.params:
                return cname
        return None

    @property
    def params(self) -> List[str]:
        out = list(self.top_params)
        for c in self.components.values():
            out.extend(c.params)
        return out

    @property
    def free_params(self) -> List[str]:
        """Unfrozen *device-representable* parameters, in model order."""
        out = []
        for c in self.components.values():
            for p in c.params.values():
                if not p.frozen and p.on_device and p.value is not None:
                    out.append(p.name)
        return out

    @free_params.setter
    def free_params(self, names):
        names = set(names)
        for c in self.components.values():
            for p in c.params.values():
                if p.on_device:
                    p.frozen = p.name not in names
        missing = names - set(self.params)
        if missing:
            raise UnknownParameter(f"cannot free unknown parameters {missing}")

    def get_params_dict(self, which="free") -> Dict[str, Param]:
        """The free parameters (``which="free"``) or all of them, by
        name."""
        names = self.free_params if which == "free" else self.params
        return {n: self[n] for n in names}

    @property
    def linear_param_names(self) -> List[str]:
        """Every scalar on-device parameter some component declares
        delay/phase-LINEAR (see :meth:`Component.linear_params`)."""
        out = []
        for c in self.components.values():
            for n in c.linear_params():
                par = c.params.get(n)
                if par is None or not par.on_device or par.value is None:
                    continue
                if np.ndim(par.device_value) != 0:
                    continue
                out.append(n)
        return out

    def partition_linear_params(
            self, names: Sequence[str]) -> Tuple[List[str], List[str]]:
        """Split ``names`` into ``(linear, nonlinear)``, order preserved
        within each block."""
        linear = set(self.linear_param_names)
        lin = [n for n in names if n in linear]
        nl = [n for n in names if n not in linear]
        return lin, nl

    # -- params dict ------------------------------------------------------
    #
    # Precision architecture (as pint_tpu.models.timing_model):
    #   p["const"]: host-prepared reference values — float64 for
    #       delay-level parameters; exact quad-single f32 word arrays
    #       ``<name>__qs`` for phase-level parameters (F0..Fn); MJD params
    #       as [day, frac] plus ``<name>__fracqs`` words.
    #   p["delta"]: float64 offsets from the reference values in device
    #       units, all zero as built: the only leaves fits differentiate.
    #   p["mask"]: host-computed per-TOA selection arrays for MaskParams.
    def values_key(self) -> tuple:
        """Every parameter's value as it stands (the device value's bytes
        where it has one) with the selection of each mask parameter: a
        params dict built when the key was equal still holds the model."""
        return tuple(
            (name, par.name,
             np.asarray(par.device_value, np.float64).tobytes()
             if par.on_device and par.value is not None else repr(par.value),
             getattr(par, "key", None), repr(getattr(par, "key_value", None)))
            for name, c in self.components.items()
            for par in c.params.values())

    def build_pdict_numpy(self, toas=None, tzr_toas=None):
        """(params dict of numpy leaves, TZR mask dict): everything of
        :meth:`build_pdict` except the TZR phase, on the host."""
        from pint_tpu_torch import qs

        const: Dict[str, np.ndarray] = {}
        delta: Dict[str, np.ndarray] = {}
        mask: Dict[str, np.ndarray] = {}
        tzr_mask: Dict[str, np.ndarray] = {}
        for c in self.components.values():
            qs_names = set(c.qs_param_names())
            for par in c.params.values():
                if not (par.on_device and par.value is not None):
                    continue
                dval = par.device_value
                const[par.name] = dval
                if isinstance(par, MJDParam):
                    w = qs.from_f64_host(np.float64(dval[1]))
                    const[par.name + "__fracqs"] = np.stack(
                        [np.float32(x) for x in w.words])
                    delta[par.name] = np.float64(0.0)  # days
                else:
                    if par.name in qs_names:
                        w = qs.from_f64_host(np.float64(dval))
                        const[par.name + "__qs"] = np.stack(
                            [np.float32(x) for x in w.words])
                    delta[par.name] = np.zeros_like(
                        np.asarray(dval, np.float64))
            const.update(c.derived_device_entries())
            if toas is not None:
                mask.update(c.mask_entries(toas))
                if getattr(c, "introduces_correlated_errors", False):
                    const.update(c.basis_entries(toas))
            if tzr_toas is not None:
                tzr_mask.update(c.mask_entries(tzr_toas))
        return {"const": const, "delta": delta, "mask": mask}, tzr_mask

    def build_pdict(self, toas=None, tzr_toas=None, device=None) -> dict:
        """The params dict on ``device`` (default ``"cuda"``), with the TZR
        reference phase ``const["__tzrphase__"]`` computed by the phase
        kernel in its words mode on the 1-row TZR batch (plain version on
        the CPU)."""
        from pint_tpu_torch.convert import pdict_from_numpy

        dev = resolve_device(device)
        host, tzr_mask = self.build_pdict_numpy(toas, tzr_toas)
        p = pdict_from_numpy(host, dev)
        if self.tzr_batch is not None and "AbsPhase" in self.components:
            if self.tzr_batch.device != dev:
                raise ValueError(
                    f"TZR batch lives on {self.tzr_batch.device}, the "
                    f"params dict on {dev}: call attach_tzr(device=...)")
            # the phase chain never reads the noise-basis blocks
            basis = {c.basis_pytree_name
                     for c in self.correlated_noise_components}
            p_tzr = {"const": {k: v for k, v in p["const"].items()
                               if k not in basis},
                     "delta": p["delta"],
                     "mask": pdict_from_numpy({"mask": tzr_mask},
                                              dev)["mask"]}
            with torch.no_grad():
                w = self.calc.phase_frac(p_tzr, self.tzr_batch, "words",
                                         subtract_tzr=False)
            p["const"]["__tzrphase__"] = w[0].detach().clone()
        return p

    def apply_deltas(self, p: dict):
        """Fold the (post-fit) offsets of ``p["delta"]`` back into the host
        parameters and zero them (:meth:`pint_tpu.models.timing_model.
        TimingModel.apply_deltas`).  Tensor leaves come to the host in one
        batched transfer; host float64 arithmetic is exact at offset
        scales.  An MJD parameter moves its fraction by the offset [days]."""
        delta = p["delta"]
        tkeys = [k for k, v in delta.items() if isinstance(v, torch.Tensor)]
        host_delta = {}
        if tkeys:
            parts = [delta[k].detach().reshape(-1).to(torch.float64)
                     for k in tkeys]
            packed = torch.cat([t.to(parts[0].device) for t in parts])
            packed = packed.cpu().numpy()
            off = 0
            for k, t in zip(tkeys, parts):
                n = t.numel()
                host_delta[k] = packed[off:off + n].reshape(
                    tuple(delta[k].shape))
                off += n
        for c in self.components.values():
            for par in c.params.values():
                if not (par.on_device and par.name in delta):
                    continue
                d = host_delta.get(par.name)
                if d is None:
                    d = np.asarray(delta[par.name], np.float64)
                if not np.any(d):
                    continue
                if isinstance(par, MJDParam):
                    dv_ = par.device_value
                    par.set_device_value([dv_[0], dv_[1] + float(d)])
                else:
                    par.set_device_value(np.asarray(par.device_value) + d)
                delta[par.name] = np.zeros_like(d)

    # free-vector <-> delta mapping (device units; offsets from const).
    def x0(self, p: dict, names: Optional[Sequence[str]] = None) -> torch.Tensor:
        names = self.free_params if names is None else names
        return torch.stack([torch.as_tensor(p["delta"][n], dtype=torch.float64)
                            for n in names])

    def with_x(self, p: dict, x, names: Optional[Sequence[str]] = None) -> dict:
        names = self.free_params if names is None else names
        delta = dict(p["delta"])
        for i, n in enumerate(names):
            delta[n] = x[i]
        out = dict(p)
        out["delta"] = delta
        return out

    def fit_units(self, names: Optional[Sequence[str]] = None) -> List[float]:
        """d(device)/d(par-file unit) per free parameter (or per name of
        ``names``): for reporting uncertainties and matching the
        reference's design-matrix units."""
        out = []
        for n in (self.free_params if names is None else names):
            par = self[n]
            if isinstance(par, MJDParam):
                out.append(1.0)  # fraction of a day: the par unit is days
            elif isinstance(par, AngleParam):
                # device radians per par-file unit (the uncertainty
                # conventions of AngleParam)
                if par.units == "H:M:S":
                    out.append(math.pi / (12 * 3600))
                elif par.units == "D:M:S":
                    out.append(math.pi / (180 * 3600))
                else:
                    out.append(math.pi / 180.0)
            else:
                out.append(par.par2dev)
        return out

    # -- noise -------------------------------------------------------------
    @property
    def noise_components(self):
        return [c for c in self.components.values()
                if getattr(c, "is_noise", False)]

    @property
    def has_correlated_errors(self) -> bool:
        return any(c.introduces_correlated_errors
                   for c in self.noise_components)

    def scaled_toa_uncertainty(self, p: dict, batch: TOABatch):
        """Per-TOA uncertainties [us] after white-noise rescaling
        (EFAC/EQUAD; reference ``scaled_toa_uncertainty``,
        `src/pint/models/noise_model.py:79`)."""
        sigma = batch.error_us
        for c in self.noise_components:
            sigma = c.scaled_sigma_us(p, batch, sigma)
        return sigma

    @property
    def correlated_noise_components(self):
        return [c for c in self.noise_components
                if c.introduces_correlated_errors]

    def noise_basis(self, p: dict):
        """(ntoas, K) concatenated noise basis (reference
        ``noise_model_designmatrix``,
        `src/pint/models/timing_model.py:1844`) on the params dict's
        device; None without correlated components.  The per-component
        blocks ride in ``p["const"]`` (host-built by :meth:`build_pdict`)."""
        mats = [p["const"][c.basis_pytree_name]
                for c in self.correlated_noise_components
                if c.basis_pytree_name in p["const"]]
        return torch.cat(mats, dim=1) if mats else None

    def noise_weights(self, p: dict):
        """(K,) prior variances [s^2] matching :meth:`noise_basis`'s
        columns (reference ``noise_model_basis_weight``, ibid:1922),
        differentiable in the noise parameters."""
        ws = [c.noise_weights(p) for c in self.correlated_noise_components
              if c.basis_pytree_name in p["const"]]
        return torch.cat(ws) if ws else None

    def ecorr_block(self, p: dict):
        """(lo, hi) column range of a verified-disjoint ECORR block within
        :meth:`noise_basis`, or None.  Disjointness (every TOA in at most
        one quantization epoch) makes the block's Gram matrix exactly
        diagonal, so GLS solves eliminate it in closed form and chi2 uses
        the per-epoch Sherman-Morrison (``utils.woodbury_dot_split``).
        One device reduction and one scalar read per block."""
        sl = None
        off = 0
        for c in self.correlated_noise_components:
            nm = c.basis_pytree_name
            if nm not in p["const"]:
                continue
            Ub = torch.as_tensor(p["const"][nm])
            w = Ub.shape[1]
            if (getattr(c, "diag_gram", False) and w and sl is None
                    and int(torch.max(torch.sum(Ub != 0.0, dim=1))) <= 1):
                sl = (off, off + w)
            off += w
        return sl

    # -- physics ----------------------------------------------------------
    def scaled_dm_uncertainty(self, p: dict, batch: TOABatch, dm_error):
        """Per-TOA wideband DM uncertainties [pc cm^-3] after DMEFAC/DMEQUAD
        rescaling (reference ``scaled_dm_uncertainty``,
        `src/pint/models/timing_model.py:1802`)."""
        sigma = dm_error
        for c in self.noise_components:
            f = getattr(c, "scaled_dm_sigma", None)
            if f is not None:
                sigma = f(p, batch, sigma)
        return sigma

    def total_dm(self, p: dict, batch: TOABatch) -> torch.Tensor:
        """Model DM at each TOA [pc cm^-3]: the sum over every component
        with a ``dm_value`` (reference ``TimingModel.total_dm``,
        `src/pint/models/timing_model.py:1714`), in plain PyTorch on the
        batch's device and differentiable: the DM block of the wideband
        design matrix is its jacfwd."""
        dm = zeros_rows(batch)
        for c in self.components.values():
            f = getattr(c, "dm_value", None)
            if f is not None:
                dm = dm + f(p, batch)
        return dm

    @property
    def calc(self) -> PhaseCalc:
        return PhaseCalc(self.delay_components, self.phase_components)

    def delay(self, p: dict, batch: TOABatch) -> torch.Tensor:
        return self.calc.delay(p, batch)

    def phase(self, p: dict, batch: TOABatch, abs_phase=True):
        return self.calc.phase(p, batch, subtract_tzr=abs_phase)

    @property
    def F0_value(self) -> float:
        return float(self.F0.value)

    @property
    def planets_flag(self) -> bool:
        return bool(self.PLANET_SHAPIRO.value) \
            if "PLANET_SHAPIRO" in self else False

    # -- TZR --------------------------------------------------------------
    def make_tzr_toas_or_none(self):
        """The prepared 1-row TZR host TOAs, or None without AbsPhase."""
        ab = self.components.get("AbsPhase")
        if ab is None:
            return None
        return ab.make_tzr_toas(ephem=self.EPHEM.value or "DE421",
                                planets=self.planets_flag)

    def attach_tzr(self, toas=None, device=None):
        """Materialize the TZR reference TOA batch on ``device``."""
        ab = self.components.get("AbsPhase")
        if ab is None:
            self.tzr_batch = None
        else:
            self.tzr_batch = ab.make_tzr_batch(
                ephem=self.EPHEM.value or "DE421",
                planets=self.planets_flag,
                toas=toas, device=device)
        return self.tzr_batch

    # -- frames and par output ---------------------------------------------
    def as_ECL(self, ecl: str = "IERS2010") -> "TimingModel":
        """New model with ecliptic astrometry (reference `as_ECL`,
        `src/pint/models/astrometry.py:858`)."""
        from pint_tpu_torch.models.astrometry import convert_astrometry

        return convert_astrometry(self, "ECL", ecl=ecl)

    def as_ICRS(self, ecl: str = "IERS2010") -> "TimingModel":
        """New model with equatorial astrometry (reference `as_ICRS`,
        `src/pint/models/astrometry.py:840`)."""
        from pint_tpu_torch.models.astrometry import convert_astrometry

        return convert_astrometry(self, "ICRS", ecl=ecl)

    def as_parfile(self, comment: Optional[str] = None) -> str:
        lines = []
        if comment:
            for ln in comment.splitlines():
                lines.append(f"# {ln}\n")
        for p in self.top_params.values():
            lines.append(p.as_parfile_line())
        for c in self.components.values():
            for p in c.params.values():
                lines.append(p.as_parfile_line())
        return "".join(lines)

    def write_parfile(self, path, **kw):
        with open(path, "w") as f:
            f.write(self.as_parfile(**kw))

    def compare(self, other: "TimingModel") -> str:
        """A textual diff of two models' values (reference
        `TimingModel.compare`, `src/pint/models/timing_model.py:2521`)."""
        rows = [f"{'PARAM':12s} {'THIS':>25s} {'OTHER':>25s}"]
        names = dict.fromkeys(list(self.params) + list(other.params))
        for n in names:
            a = self[n].value if n in self else None
            b = other[n].value if n in other else None
            if a is None and b is None:
                continue
            av = self[n].value_as_string() if a is not None else "--"
            bv = other[n].value_as_string() if b is not None else "--"
            if av != bv:
                rows.append(f"{n:12s} {av:>25s} {bv:>25s}")
        return "\n".join(rows)

    def __repr__(self):  # pragma: no cover
        return (f"TimingModel({self.PSR.value or self.name}: "
                f"{', '.join(self.components)})")


def _top_level_params() -> List[Param]:
    """Model-level metadata parameters (as
    :func:`pint_tpu.models.timing_model._top_level_params`)."""
    return [
        StrParam("PSR", description="Source name", aliases=["PSRJ", "PSRB"]),
        StrParam("EPHEM", description="Solar-system ephemeris"),
        StrParam("CLOCK", description="Timescale realization, e.g. TT(BIPM2021)",
                 aliases=["CLK"]),
        StrParam("UNITS", description="Units (TDB/TCB)"),
        StrParam("TIMEEPH", description="Time ephemeris (FB90/IF99)"),
        StrParam("T2CMETHOD", description="terrestrial-celestial method"),
        StrParam("BINARY", description="Binary model name"),
        StrParam("DILATEFREQ", description="tempo compat flag"),
        StrParam("INFO", description="info string"),
        StrParam("ECL", description="Ecliptic obliquity convention"),
        StrParam("DMDATA", description="wideband DM data in use",
                 aliases=[]),
        StrParam("TRACK", description="tempo2 phase-tracking mode "
                 "(-2 enables pulse-number tracking)"),
        StrParam("TRES", description="tempo residual RMS record"),
        StrParam("MODE", description="tempo MODE record"),
        StrParam("NTOA", description="number-of-TOAs record"),
        StrParam("CHI2", description="fit chi2 record"),
        StrParam("CHI2R", description="reduced chi2 record"),
        StrParam("START", description="data span start"),
        StrParam("FINISH", description="data span end"),
    ]
