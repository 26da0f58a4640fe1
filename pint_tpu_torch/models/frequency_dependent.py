"""Frequency-dependent (FD) profile-evolution delays.

Port of the ``FD`` component of :mod:`pint_tpu.models.frequency_dependent`
(reference `FD`, `src/pint/models/frequency_dependent.py:13`):

    delay = sum_k FDk * ln(f / 1 GHz)^k        k = 1..n

(Zhu et al. 2015 eq. 2), and ``FDJump`` (reference `FDJump`,
`src/pint/models/fdjump.py:15`): the same log-polynomial terms as
system-dependent mask parameters ``FD1JUMP/FD2JUMP/...``.
"""

from __future__ import annotations

import re
from typing import List

import torch

from pint_tpu_torch.models.parameter import (
    MaskParam,
    prefixParameter,
    split_prefix,
)
from pint_tpu_torch.models.timing_model import (
    DelayComponent,
    member_bits,
    pv,
    zeros_rows,
)
from pint_tpu_torch.toabatch import TOABatch


def _log_freq_ghz(batch: TOABatch):
    """ln(f/1 GHz) with infinite-frequency rows masked to 0 contribution."""
    finite = torch.isfinite(batch.freq_mhz)
    f = torch.where(finite, batch.freq_mhz, 1000.0)
    return torch.where(finite, torch.log(f / 1000.0), 0.0), finite


class FD(DelayComponent):
    """FD polynomial in log observing frequency."""

    register = True
    category = "frequency_dependent"

    def fd_names(self) -> List[str]:
        return [p.name for p in self.prefix_params("FD")]

    def add_fd_term(self, index: int, value=0.0, frozen=True):
        return self.add_param(prefixParameter(
            "float", f"FD{index}", units="s", value=value, frozen=frozen))

    def prefix_families(self):
        return ["FD"]

    def make_param(self, name):
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "FD" and index >= 1:
            return prefixParameter("float", name, units="s")
        return None

    def validate(self):
        names = self.fd_names()
        for i, n in enumerate(names):
            if n != f"FD{i + 1}":
                raise ValueError(f"non-contiguous FD sequence at {n}")

    def linear_params(self):
        # delay = sum FDk * ln(f/1GHz)^k: exactly linear per coefficient
        return self.fd_names()

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        names = self.fd_names()
        if not names:
            return zeros_rows(batch)
        lf, finite = _log_freq_ghz(batch)
        out = zeros_rows(batch)
        term = torch.ones_like(lf)
        for n in names:
            term = term * lf
            out = out + pv(p, n) * term
        return torch.where(finite, out, 0.0)


_FDJUMP_RE = re.compile(r"^FD(\d+)JUMP(\d*)$")
#: the delay kernel's FD<k>JUMP bits (kernels/delay_chain.py FDJUMP_BITS)
FDJUMP_BITS = "__fdjumpbits__"


class FDJump(DelayComponent):
    """System-dependent FD offsets: ``FD<k>JUMP<i>`` mask parameters, each
    adding ``value * ln(f/1GHz)^k`` over its TOA selection
    (:class:`pint_tpu.models.frequency_dependent.FDJump`, reference
    `src/pint/models/fdjump.py:15`; the log convention, FDJUMPLOG=Y,
    only)."""

    register = True
    category = "fdjump"

    #: highest FD order accepted, as in the reference
    #: (`src/pint/models/fdjump.py:12` fdjump_max_index=20)
    max_fd_order = 20

    def mask_families(self):
        return [f"FD{k}JUMP" for k in range(1, self.max_fd_order + 1)]

    @property
    def fdjumps(self):
        return [par for par in self.params.values()
                if isinstance(par, MaskParam)]

    def members(self):
        """The members the delay kernel carries (those with a value), in
        bit order."""
        return [par for par in self.fdjumps if par.value is not None]

    def fd_order(self, name: str) -> int:
        m = _FDJUMP_RE.match(name)
        if not m:
            raise ValueError(f"{name!r} is not an FDJUMP parameter")
        return int(m.group(1))

    def add_fdjump(self, order: int, index=None, key=None, key_value=(),
                   value=0.0, frozen=True) -> MaskParam:
        if index is None:
            index = 1 + max(
                [par.index or 0 for par in self.fdjumps
                 if self.fd_order(par.prefix or par.name) == order],
                default=0)
        par = MaskParam(f"FD{order}JUMP", index=index, key=key,
                        key_value=key_value, value=value, frozen=frozen,
                        units="s")
        return self.add_param(par)

    def make_param(self, name):
        m = _FDJUMP_RE.match(name)
        if not m:
            return None
        order = int(m.group(1))
        if m.group(2):
            return MaskParam(f"FD{order}JUMP", index=int(m.group(2)),
                             units="s")
        idx = 1 + max(
            [par.index or 0 for par in self.fdjumps
             if self.fd_order(par.prefix or par.name) == order], default=0)
        return MaskParam(f"FD{order}JUMP", index=idx, units="s")

    def linear_params(self):
        return [par.name for par in self.fdjumps]

    def mask_entries(self, toas):
        """The members' TOA masks, and their bits per TOA (bit j for the
        j-th member with a value) that the delay kernel reads."""
        out = super().mask_entries(toas)
        bits = member_bits(self.members(), out, toas.ntoas)
        if bits is not None:
            out[FDJUMP_BITS] = bits
        return out

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        lf, finite = _log_freq_ghz(batch)
        out = zeros_rows(batch)
        for par in self.fdjumps:
            m = p["mask"].get(par.mask_pytree_name)
            if m is None:
                continue
            k = self.fd_order(par.prefix or par.name)
            out = out + pv(p, par.name) * lf**k * m
        return torch.where(finite, out, 0.0)
