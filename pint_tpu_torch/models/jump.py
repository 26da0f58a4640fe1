"""Phase and delay jumps over TOA subsets (JUMP mask parameters).

Port of :mod:`pint_tpu.models.jump` (reference `DelayJump`/`PhaseJump`,
`src/pint/models/jump.py:11,78`).  PhaseJump (the
registered default) adds ``+JUMPn * F0`` cycles to the selected TOAs;
DelayJump subtracts the value as a delay.  Selections are host-computed
masks in the params dict, so the device side is one dense masked sum.
"""

from __future__ import annotations

import torch

from pint_tpu_torch import qs
from pint_tpu_torch.models.parameter import MaskParam
from pint_tpu_torch.models.timing_model import (
    DelayComponent,
    PhaseComponent,
    member_bits,
    pv,
    zeros_rows,
)
from pint_tpu_torch.toabatch import TOABatch

#: the delay kernel's DelayJump bits (kernels/delay_chain.py JUMP_BITS)
JUMP_BITS = "__delayjumpbits__"


class PhaseJump(PhaseComponent):
    register = True
    category = "phase_jump"
    phase_f64_reads_delay = False

    def add_jump(self, index=None, key=None, key_value=(), value=0.0,
                 frozen=True) -> MaskParam:
        if index is None:
            index = 1 + max([p.index or 0 for p in self.params.values()],
                            default=0)
        p = MaskParam("JUMP", index=index, key=key, key_value=key_value,
                      value=value, frozen=frozen, units="s")
        return self.add_param(p)

    @property
    def jumps(self):
        return [p for p in self.params.values() if isinstance(p, MaskParam)]

    def mask_families(self):
        return ["JUMP"]

    def make_param(self, name):
        from pint_tpu_torch.models.parameter import split_prefix

        if name == "JUMP":
            idx = 1 + max([par.index or 0 for par in self.params.values()],
                          default=0)
            return MaskParam("JUMP", index=idx, units="s")
        try:
            prefix, index = split_prefix(name)
        except ValueError:
            return None
        if prefix == "JUMP":
            return MaskParam("JUMP", index=index, units="s")
        return None

    def linear_params(self):
        # phase = JUMP_i * F0 * mask_i, residual [s] = phase/F0: the
        # column is exactly the mask, independent of every other param
        return [jp.name for jp in self.jumps]

    def phase_f64(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        total = zeros_rows(batch)
        f0 = pv(p, "F0")
        for jp in self.jumps:
            m = p["mask"].get(jp.mask_pytree_name)
            if m is None:  # mask set not built for this batch
                continue
            total = total + pv(p, jp.name) * f0 * m
        return total

    def phase(self, p: dict, batch: TOABatch, delay, is_tzr=False):
        return qs.from_f64_device(self.phase_f64(p, batch, delay))


class DelayJump(DelayComponent):
    """Registered off by default, as in the reference (`jump.py:25`)."""

    register = False
    category = "jump_delay"

    def add_jump(self, index=None, key=None, key_value=(), value=0.0,
                 frozen=True) -> MaskParam:
        if index is None:
            index = 1 + max([p.index or 0 for p in self.params.values()],
                            default=0)
        p = MaskParam("JUMP", index=index, key=key, key_value=key_value,
                      value=value, frozen=frozen, units="s")
        return self.add_param(p)

    @property
    def jumps(self):
        return [p for p in self.params.values() if isinstance(p, MaskParam)]

    def members(self):
        """The jumps the delay kernel carries (those with a value), in bit
        order."""
        return [jp for jp in self.jumps if jp.value is not None]

    def linear_params(self):
        return [jp.name for jp in self.jumps]

    def mask_entries(self, toas):
        """The jumps' TOA masks, and their membership bits per TOA (bit j
        for the j-th jump with a value) that the delay kernel reads."""
        out = super().mask_entries(toas)
        bits = member_bits(self.members(), out, toas.ntoas)
        if bits is not None:
            out[JUMP_BITS] = bits
        return out

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        total = zeros_rows(batch)
        for jp in self.jumps:
            m = p["mask"].get(jp.mask_pytree_name)
            if m is None:
                continue
            total = total - pv(p, jp.name) * m
        return total
