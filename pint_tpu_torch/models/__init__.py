"""Timing-model framework: parameters, components, model builder.

Port of :mod:`pint_tpu.models`: a
:class:`~pint_tpu_torch.models.timing_model.TimingModel` is an ordered set
of registered *components*, each owning typed *parameters*; models are
built from ``.par`` files by parameter ownership.  Every component that
pint_tpu registers is registered here; a par file naming the parameters
of a component that pint_tpu has and the port does not (none today:
``model_builder.UNPORTED``) is refused (``NotImplementedError``), and one
naming parameters that no component owns warns that they are
unrecognized.
"""

from pint_tpu_torch.models.parameter import (  # noqa: F401
    AngleParam,
    BoolParam,
    FloatParam,
    IntParam,
    MaskParam,
    MJDParam,
    PairParam,
    Param,
    StrParam,
    funcParameter,
    maskParameter,
    prefixParameter,
)
from pint_tpu_torch.models.timing_model import (  # noqa: F401
    Component,
    DelayComponent,
    PhaseComponent,
    TimingModel,
)

# importing the component modules populates the registry
from pint_tpu_torch.models import (  # noqa: F401  isort:skip
    absolute_phase,
    astrometry,
    binary_dd,
    binary_ell1,
    chromatic,
    dispersion,
    frequency_dependent,
    glitch,
    ifunc,
    jump,
    noise_model,
    phase_offset,
    piecewise,
    solar_system_shapiro,
    solar_wind,
    spindown,
    transient_events,
    troposphere,
    wave,
)
from pint_tpu_torch.models.model_builder import (  # noqa: F401  isort:skip
    get_model,
    get_model_and_toas,
    parse_parfile,
)
