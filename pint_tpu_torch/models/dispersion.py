"""Dispersion delay: DM polynomial (DM, DM1, ...), DMX piecewise offsets,
and the system offsets DMJUMP and FDJUMPDM.

Port of :mod:`pint_tpu.models.dispersion` (reference `DispersionDM` /
`DispersionDMX` / `DispersionJump` / `FDJumpDM`,
`src/pint/models/dispersion_model.py:129,307,727,808`).
Delay = K · DM(t) / ν²  with K the tempo-convention dispersion constant
and ν the observing frequency [MHz].  DMX is a dense masked sum: each
range's TOA mask is precomputed on the host into the params dict.
DMJUMP offsets the *measured* wideband DMs and has zero delay.
"""

from __future__ import annotations

import torch

from pint_tpu_torch import DMconst
from pint_tpu_torch.models.parameter import (
    FloatParam,
    MaskParam,
    MJDParam,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import (
    DelayComponent,
    epoch_days,
    member_bits,
    pv,
    range_entries,
    zeros_rows,
)
from pint_tpu_torch.toabatch import TOABatch
from pint_tpu_torch.utils import taylor_horner

SECS_PER_YEAR = 365.25 * 86400.0
#: the delay kernel's DMX bin index (kernels/delay_chain.py DMX_INDEX)
DMX_INDEX = "__dmxidx__"
#: the delay kernel's FDJUMPDM bits (kernels/delay_chain.py FDJUMPDM_BITS)
FDJUMPDM_BITS = "__fdjumpdmbits__"



def dispersion_delay(dm, freq_mhz):
    """K * dm / f^2 [s] with infinite-frequency (barycentered) rows zeroed."""
    finite = torch.isfinite(freq_mhz)
    f = torch.where(finite, freq_mhz, 1.0)
    return torch.where(finite, DMconst * dm / f**2, 0.0)


class DispersionDM(DelayComponent):
    """Cold-plasma dispersion from a DM Taylor polynomial."""

    register = True
    category = "dispersion_constant"

    def __init__(self):
        super().__init__()
        # DM is the 0th member of the DM prefix family but is spelled "DM"
        dm = FloatParam("DM", value=0.0, units="pc cm^-3",
                        description="Dispersion measure")
        dm.prefix, dm.index = "DM", 0
        self.add_param(dm)
        self.add_param(MJDParam("DMEPOCH", description="DM reference epoch"))

    def dm_names(self):
        return [p.name for p in self.prefix_params("DM")]

    def add_dm_deriv(self, index: int, value=0.0, frozen=True):
        self.add_param(prefixParameter(
            "float", f"DM{index}", units=f"pc cm^-3 yr^-{index}",
            value=value, frozen=frozen,
            par2dev=SECS_PER_YEAR ** -index))

    def make_param(self, name):
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "DM" and index >= 1:
            return prefixParameter("float", name,
                                   units=f"pc cm^-3 yr^-{index}",
                                   par2dev=SECS_PER_YEAR ** -index)
        return None

    def validate(self):
        if len(self.dm_names()) > 1 and self.DMEPOCH.value is None:
            if self._parent is None or self._parent.PEPOCH.value is None:
                raise ValueError("DMEPOCH required for DM derivatives")

    def dm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        names = self.dm_names()
        coeffs = [pv(p, n) for n in names]
        if len(names) == 1:
            return torch.broadcast_to(coeffs[0], (batch.ntoas,))
        ep = "DMEPOCH" if self.DMEPOCH.value is not None else "PEPOCH"
        day0 = epoch_days(p, ep)
        dt_sec = (batch.tdb_day + batch.tdb_frac - day0) * 86400.0
        return taylor_horner(dt_sec, coeffs)

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return dispersion_delay(self.dm_value(p, batch), batch.freq_mhz)


class DispersionDMX(DelayComponent):
    """Piecewise-constant DM offsets over MJD ranges (DMX_####/DMXR1/DMXR2).

    Host side: each range's TOA mask lands in the params dict as
    ``DMX_####__rangemask``; device side: one dense weighted sum."""

    register = True
    category = "dispersion_dmx"

    def __init__(self):
        super().__init__()
        self.add_param(FloatParam("DMX", value=0.0, units="pc cm^-3",
                                  description="(unused) DMX amplitude scale"))

    def add_dmx_range(self, index: int, r1_mjd, r2_mjd, value=0.0,
                      frozen=True):
        self.add_param(prefixParameter("float", f"DMX_{index:04d}",
                                       units="pc cm^-3", value=value,
                                       frozen=frozen))
        self.add_param(prefixParameter("mjd", f"DMXR1_{index:04d}",
                                       value=r1_mjd))
        self.add_param(prefixParameter("mjd", f"DMXR2_{index:04d}",
                                       value=r2_mjd))

    def dmx_names(self):
        return [p.name for p in self.prefix_params("DMX_")]

    def prefix_families(self):
        return ["DMX_", "DMXR1_", "DMXR2_"]

    def make_param(self, name):
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "DMX_":
            return prefixParameter("float", name, units="pc cm^-3")
        if prefix in ("DMXR1_", "DMXR2_"):
            return prefixParameter("mjd", name)
        return None

    def validate(self):
        for n in self.dmx_names():
            idx = n.split("_")[1]
            if f"DMXR1_{idx}" not in self.params or \
                    f"DMXR2_{idx}" not in self.params:
                raise ValueError(f"{n} needs DMXR1_{idx} and DMXR2_{idx}")

    def mask_entries(self, toas):
        """Each range's TOA mask ``DMX_####__rangemask`` (the plain
        version's), and the (N, 2) int32 bins of each TOA (-1 for none)
        that the delay kernel reads, ``__dmxidx__``: ranges are inclusive,
        so a TOA on the boundary two ranges share lies in both.  The index
        is left out where three ranges overlap on a TOA, and the kernel
        then refuses the model."""
        out = super().mask_entries(toas)
        names = self.dmx_names()
        masks, index = range_entries(names, [
            (self.params[f"DMXR1_{n[4:]}"].mjd_float,
             self.params[f"DMXR2_{n[4:]}"].mjd_float) for n in names],
            toas.utc.mjd_float)
        out.update(masks)
        if index is not None:
            out[DMX_INDEX] = index
        return out

    def linear_params(self):
        # delay = K * DMX_i * rangemask_i / f^2: exactly linear per bin
        return self.dmx_names()

    def dm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        names = self.dmx_names()
        if not names:
            return zeros_rows(batch)
        masks = torch.stack([p["mask"][f"{n}__rangemask"] for n in names])
        vals = torch.stack([torch.as_tensor(pv(p, n)) for n in names])
        return vals @ masks

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return dispersion_delay(self.dm_value(p, batch), batch.freq_mhz)


class DispersionJump(DelayComponent):
    """System-dependent offsets to the *measured* wideband DM values
    (DMJUMP mask parameters; :class:`pint_tpu.models.dispersion.
    DispersionJump`, reference `dispersion_model.py:727`): each DMJUMP
    subtracts its value from the model DM over its TOA selection and
    contributes **zero** time delay."""

    register = True
    category = "dispersion_jump"

    def mask_families(self):
        return ["DMJUMP"]

    @property
    def dm_jumps(self):
        return [par for par in self.params.values()
                if isinstance(par, MaskParam)]

    def add_dmjump(self, index=None, key=None, key_value=(), value=0.0,
                   frozen=True) -> MaskParam:
        if index is None:
            index = 1 + max([par.index or 0 for par in self.dm_jumps],
                            default=0)
        par = MaskParam("DMJUMP", index=index, key=key,
                        key_value=key_value, value=value, frozen=frozen,
                        units="pc cm^-3")
        return self.add_param(par)

    def make_param(self, name):
        if name == "DMJUMP":
            idx = 1 + max([par.index or 0 for par in self.dm_jumps],
                          default=0)
            return MaskParam("DMJUMP", index=idx, units="pc cm^-3")
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "DMJUMP":
            return MaskParam("DMJUMP", index=index, units="pc cm^-3")
        return None

    def linear_params(self):
        # dm_value = -sum DMJUMP_i * mask_i: exactly linear (zero delay)
        return [par.name for par in self.dm_jumps]

    def dm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        total = zeros_rows(batch)
        for par in self.dm_jumps:
            m = p["mask"].get(par.mask_pytree_name)
            if m is None:
                continue
            total = total - pv(p, par.name) * m
        return total

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return zeros_rows(batch)


class FDJumpDM(DelayComponent):
    """System-dependent DM offsets for narrowband data (``FDJUMPDM`` mask
    parameters; :class:`pint_tpu.models.dispersion.FDJumpDM`, reference
    `dispersion_model.py:808`): unlike DMJUMP, a real dispersion delay
    over its TOA selection, with the reference's negative sign."""

    register = True
    category = "fdjumpdm"

    def mask_families(self):
        return ["FDJUMPDM"]

    @property
    def fdjumps(self):
        return [par for par in self.params.values()
                if isinstance(par, MaskParam)]

    def members(self):
        """The members the delay kernel carries (those with a value), in
        bit order."""
        return [par for par in self.fdjumps if par.value is not None]

    def add_fdjumpdm(self, index=None, key=None, key_value=(), value=0.0,
                     frozen=True) -> MaskParam:
        if index is None:
            index = 1 + max([par.index or 0 for par in self.fdjumps],
                            default=0)
        par = MaskParam("FDJUMPDM", index=index, key=key,
                        key_value=key_value, value=value, frozen=frozen,
                        units="pc cm^-3")
        return self.add_param(par)

    def make_param(self, name):
        if name == "FDJUMPDM":
            idx = 1 + max([par.index or 0 for par in self.fdjumps],
                          default=0)
            return MaskParam("FDJUMPDM", index=idx, units="pc cm^-3")
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "FDJUMPDM":
            return MaskParam("FDJUMPDM", index=index, units="pc cm^-3")
        return None

    def linear_params(self):
        # delay = K * (-FDJUMPDM_i * mask_i) / f^2: exactly linear
        return [par.name for par in self.fdjumps]

    def mask_entries(self, toas):
        """The members' TOA masks, and their bits per TOA (bit j for the
        j-th member with a value) that the delay kernel reads."""
        out = super().mask_entries(toas)
        bits = member_bits(self.members(), out, toas.ntoas)
        if bits is not None:
            out[FDJUMPDM_BITS] = bits
        return out

    def dm_value(self, p: dict, batch: TOABatch) -> torch.Tensor:
        total = zeros_rows(batch)
        for par in self.fdjumps:
            m = p["mask"].get(par.mask_pytree_name)
            if m is None:
                continue
            # negative, as the reference's `fdjump_dm`
            # (dispersion_model.py:877) and DMJUMP: par files are
            # interchangeable only with this sign
            total = total - pv(p, par.name) * m
        return total

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        return dispersion_delay(self.dm_value(p, batch), batch.freq_mhz)
