"""Par-file parsing and model construction.

Reference: `ModelBuilder` / `get_model` / `parse_parfile`
(`src/pint/models/model_builder.py:96,775,53`).  The selection
algorithm is the reference's: translate aliases to canonical names, select
every component that owns a parameter present in the par file (plus
SolarSystemShapiro whenever astrometry is present), instantiate prefix/mask
family members on demand, then setup + validate.
"""

from __future__ import annotations

import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple, Union

from pint_tpu_torch.exceptions import (
    AliasConflict,
    MissingParameter,
    TimingModelError,
    UnknownParameter,
)
from pint_tpu_torch.models.parameter import (
    MaskParam,
    Param,
    make_prefixed_name,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import Component, TimingModel

__all__ = ["parse_parfile", "ModelBuilder", "get_model", "get_model_and_toas"]

#: tempo bookkeeping records dropped on read, exactly as the reference
#: (`src/pint/models/timing_model.py:107,114`:
#: ignore_params / ignore_prefix)
IGNORE_PARAMS = {"NITS", "IBOOT", "EPHVER", "DMMODEL", "GAIN"}
IGNORE_PREFIXES = ("DMXF1_", "DMXF2_", "DMXEP_")

#: the components that pint_tpu registers and this package does not yet
#: have: (parameter names, prefix stems) by component.  A par file that
#: names one of these parameters is refused, where dropping it would give
#: residuals that silently differ from pint_tpu's.  Empty: every
#: component of pint_tpu is ported; a component pint_tpu adds comes here
#: until the port has it.
UNPORTED: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {}


def unported_component(name: str) -> Optional[str]:
    """The component of :data:`UNPORTED` that owns the par-file parameter
    ``name``, or None."""
    try:
        stem = split_prefix(name)[0]
    except ValueError:
        stem = None
    for comp, (names, stems) in UNPORTED.items():
        if name in names or stem in stems:
            return comp
    return None


def parse_parfile(parfile: Union[str, Sequence[str]]) -> Dict[str, List[List[str]]]:
    """Parse a par file into ``{NAME: [field-list, ...]}`` preserving
    repeated lines (JUMP/EFAC...), cf. reference `parse_parfile`
    (`src/pint/models/model_builder.py:53`)."""
    if isinstance(parfile, str):
        with open(parfile) as f:
            lines = f.readlines()
    else:
        lines = list(parfile)
    out: Dict[str, List[List[str]]] = defaultdict(list)
    for raw in lines:
        line = raw.split("#")[0].strip()
        if not line or line.startswith(("C ", "c ")):
            continue
        fields = line.split()
        key = fields[0].upper()
        out[key].append(fields)
    return dict(out)


class AllComponents:
    """One instance of every registered component + alias maps (reference
    `AllComponents`, `src/pint/models/timing_model.py:4026`)."""

    def __init__(self):
        self.components: Dict[str, Component] = {
            name: cls() for name, cls in Component.component_types.items()}
        # canonical param name -> component names that own it (several for
        # shared params like POSEPOCH/PX, reference "conflict components")
        self.param_owner: Dict[str, List[str]] = defaultdict(list)
        # alias (incl. canonical) -> canonical param name
        self.alias_map: Dict[str, str] = {}
        # prefix stem -> owning component names
        self.prefix_owner: Dict[str, List[str]] = defaultdict(list)
        for cname, comp in self.components.items():
            for pname, par in comp.params.items():
                self.param_owner[pname].append(cname)
                for alias in [pname] + par.aliases:
                    existing = self.alias_map.get(alias)
                    if existing is not None and existing != pname:
                        raise AliasConflict(
                            f"alias {alias} maps to both {existing} and {pname}")
                    self.alias_map[alias] = pname
                if par.prefix:
                    if cname not in self.prefix_owner[par.prefix]:
                        self.prefix_owner[par.prefix].append(cname)
        # mask-parameter families (JUMP/EFAC/...) are also prefix families
        for cname, comp in self.components.items():
            for hook in getattr(comp, "mask_families", lambda: [])():
                self.prefix_owner[hook].append(cname)
        # declared prefix families whose members exist only on demand
        # (DMX_/GLEP_/WXFREQ_...; the reference declares a first member in
        # __init__ instead — here an explicit hook keeps prototypes empty)
        for cname, comp in self.components.items():
            for stem in getattr(comp, "prefix_families", lambda: [])():
                if cname not in self.prefix_owner[stem]:
                    self.prefix_owner[stem].append(cname)

    def resolve(self, name: str) -> Optional[Tuple[List[str], str]]:
        """par-file name -> (candidate components, canonical name), creating
        prefixed params on demand; None if unknown."""
        if name in self.alias_map:
            canon = self.alias_map[name]
            return self.param_owner[canon], canon
        # bare mask-family names (every JUMP/EFAC line spells the same name)
        if name in self.prefix_owner:
            return self.prefix_owner[name], name
        # try prefix families: F2, DMX_0003, DMXR1_0003...
        try:
            stem, index = split_prefix(name)
        except ValueError:
            return None
        # alias stems: e.g. "DMX_" canonical; aliases of member 1 (e.g. "F")
        if stem in self.prefix_owner:
            return self.prefix_owner[stem], name
        if stem in self.alias_map:
            canon0 = self.alias_map[stem]
            try:
                canon_stem, _ = split_prefix(canon0)
            except ValueError:
                return None
            return self.param_owner[canon0], make_prefixed_name(canon_stem,
                                                                index)
        return None


class ModelBuilder:
    def __init__(self):
        self.all = AllComponents()

    def __call__(self, parfile, name: str = "") -> TimingModel:
        pars = parse_parfile(parfile) if not isinstance(parfile, dict) \
            else parfile
        model = TimingModel(name=name or str(parfile))

        # -- top-level metadata params
        used = set()
        for tname, tpar in model.top_params.items():
            for key in [tname] + tpar.aliases:
                if key in pars:
                    tpar.set_from_string(" ".join(pars[key][0][1:])
                                         if tname == "PSR"
                                         else pars[key][0][1])
                    used.add(key)

        # -- select components: unique owners first, then resolve shared
        # params (POSEPOCH/PX...) onto an already-selected owner (the
        # reference's "conflict components" pass)
        selected: Dict[str, List[Tuple[str, List[str]]]] = defaultdict(list)
        deferred: List[Tuple[List[str], str, List[str]]] = []
        unknown = []
        for key, occurrences in pars.items():
            if key in used:
                continue
            if key in IGNORE_PARAMS or key.startswith(IGNORE_PREFIXES):
                continue
            hit = self.all.resolve(key)
            if hit is None:
                unknown.append(key)
                continue
            candidates, canon = hit
            for fields in occurrences:
                if len(candidates) == 1:
                    selected[candidates[0]].append((canon, fields))
                else:
                    deferred.append((candidates, canon, fields))
        # the BINARY value selects its component BEFORE the shared-param
        # pass: binary parameters (PB/A1/...) are owned by every binary
        # model class and resolve onto the selected one
        binary = pars.get("BINARY", [[None, None]])[0][1]
        stray_binaries = [c for c in selected
                          if self.all.components[c].category
                          == "pulsar_system"]
        if binary is not None:
            from pint_tpu_torch.models import binary_models

            chosen = binary_models.component_for(binary)
            # a leftover parameter unique to a different binary model must
            # not co-select a second binary component (it would make every
            # shared binary param "ambiguous")
            for c in stray_binaries:
                if c != chosen:
                    dropped = [canon for canon, _ in selected.pop(c)]
                    warnings.warn(
                        f"par file declares BINARY {binary} but contains "
                        f"{dropped} belonging to {c}; those lines are "
                        "ignored")
            selected.setdefault(chosen, [])
        else:
            # orbital parameters without a BINARY line: shared binary
            # params are all-deferred (every binary class owns them),
            # unique ones land in stray_binaries — either way, error out
            # rather than silently dropping the orbit
            binary_only = [canon for cands, canon, _ in deferred
                           if all(self.all.components[c].category
                                  == "pulsar_system" for c in cands)]
            if stray_binaries or binary_only:
                raise TimingModelError(
                    f"binary parameters {binary_only or stray_binaries} "
                    "present but the par file has no BINARY line")

        for candidates, canon, fields in deferred:
            hits = [c for c in candidates if c in selected]
            if len(hits) == 1:
                selected[hits[0]].append((canon, fields))
            elif not hits:
                warnings.warn(f"{canon} is shared by {candidates}, none of "
                              "which is selected by its unique parameters; "
                              "line ignored")
            else:
                raise TimingModelError(
                    f"{canon} is ambiguous among selected components {hits}")

        if any(self.all.components[c].category == "astrometry"
               for c in selected):
            selected.setdefault("SolarSystemShapiro", [])

        refused = sorted({unported_component(k) for k in unknown} - {None})
        if refused:
            raise NotImplementedError(
                f"par-file parameters of {', '.join(refused)}, which "
                "pint_tpu_torch does not implement yet: "
                f"{sorted(k for k in unknown if unported_component(k))}")
        if unknown:
            warnings.warn(
                f"unrecognized par-file parameters ignored: {sorted(unknown)}")

        # -- instantiate fresh components and load values
        from pint_tpu_torch.models.timing_model import Component as _C

        for cname, entries in selected.items():
            comp = _C.component_types[cname]()
            model.add_component(comp, setup=False)
            for canon, fields in entries:
                par = comp.params.get(canon)
                if par is None or (isinstance(par, MaskParam)
                                   and par.value is not None):
                    # unknown names are family members created on demand;
                    # repeated mask lines (JUMP/EFAC...) auto-index
                    par = self._instantiate_member(comp, canon)
                par.from_parfile_line(fields)
            comp.setup()

        model.setup()
        model.validate()
        return model

    def _instantiate_member(self, comp: Component, canon: str) -> Param:
        """Create a prefix/mask family member on its component."""
        maker = getattr(comp, "make_param", None)
        if maker is not None:
            par = maker(canon)
            if par is not None:
                return comp.add_param(par)
        raise UnknownParameter(
            f"{type(comp).__name__} cannot create parameter {canon}")


def get_model(parfile, name: str = "",
              allow_tcb: bool = False) -> TimingModel:
    """Build a TimingModel from a par file (reference `get_model`,
    `src/pint/models/model_builder.py:775`).

    ``allow_tcb``: a par file with UNITS TCB is refused unless this is
    set, in which case it is converted to TDB on load (approximately —
    re-fit the result), as in the reference."""
    model = ModelBuilder()(parfile, name=name)
    if (model.UNITS.value or "TDB").upper() == "TCB":
        if not allow_tcb:
            raise TimingModelError(
                "par file is in TCB units; pass allow_tcb=True to convert "
                "it to TDB on load (approximate; re-fit afterwards)")
        from pint_tpu_torch.models.tcb_conversion import convert_tcb_tdb

        convert_tcb_tdb(model)
    return model


def get_model_and_toas(parfile, timfile, allow_tcb: bool = False, **kw):
    """Reference `get_model_and_toas`
    (`src/pint/models/model_builder.py:858`)."""
    from pint_tpu_torch.toa import get_TOAs

    model = get_model(parfile, allow_tcb=allow_tcb)
    toas = get_TOAs(timfile, model=model, **kw)
    return model, toas
