"""Solar-system Shapiro delay (Sun + optionally planets).

Port of :mod:`pint_tpu.models.solar_system_shapiro` (reference
`SolarSystemShapiro`, `src/pint/models/solar_system_shapiro.py:22`),
Backer & Hellings (1986) eq. 4.6 with γ=1:

    Δ = -2 T_obj · ln( (r - r·L̂) / AU )

with r the observatory→object vector (light-seconds), L̂ the pulsar
direction, T_obj = GM/c³.
"""

from __future__ import annotations

import torch

from pint_tpu_torch import (
    AU,
    Tjupiter,
    Tneptune,
    Tsaturn,
    Tsun,
    Turanus,
    Tvenus,
    c as C,
)
from pint_tpu_torch.models.parameter import BoolParam
from pint_tpu_torch.models.timing_model import DelayComponent
from pint_tpu_torch.toabatch import TOABatch

AU_LS = AU / C

_T_PLANET = {"jupiter": Tjupiter, "saturn": Tsaturn, "venus": Tvenus,
             "uranus": Turanus, "neptune": Tneptune}


def shapiro_delay(obj_pos_ls: torch.Tensor, psr_dir: torch.Tensor,
                  t_obj: float) -> torch.Tensor:
    r = torch.linalg.norm(obj_pos_ls, dim=1)
    rcostheta = torch.sum(obj_pos_ls * psr_dir, dim=1)
    # barycentric TOAs have r == 0; mask them to zero delay
    arg = torch.where(r > 0.0, (r - rcostheta) / AU_LS, 1.0)
    return -2.0 * t_obj * torch.log(arg)


class SolarSystemShapiro(DelayComponent):
    register = True
    category = "solar_system_shapiro"

    def __init__(self):
        super().__init__()
        self.add_param(BoolParam("PLANET_SHAPIRO", value=False,
                                 description="Include planetary Shapiro delays"))

    def _astrometry(self):
        for comp in self._parent.components.values():
            if hasattr(comp, "psr_dir"):
                return comp
        raise AttributeError(
            "SolarSystemShapiro needs an astrometry component for the pulsar "
            "direction")

    def delay(self, p: dict, batch: TOABatch, delay) -> torch.Tensor:
        psr_dir = self._astrometry().psr_dir(p, batch)
        d = shapiro_delay(batch.obs_sun_pos_ls, psr_dir, Tsun)
        if self.PLANET_SHAPIRO.value:
            for pl, t_pl in _T_PLANET.items():
                if pl not in batch.obs_planet_pos_ls:
                    raise KeyError(
                        f"planet position {pl!r} missing: load TOAs with "
                        "planets=True for PLANET_SHAPIRO")
                d = d + shapiro_delay(batch.obs_planet_pos_ls[pl], psr_dir,
                                      t_pl)
        return d
