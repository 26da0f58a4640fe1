"""Timing-model framework: parameters, components, model builder.

Port of :mod:`pint_tpu.models`: a
:class:`~pint_tpu_torch.models.timing_model.TimingModel` is an ordered set
of registered *components*, each owning typed *parameters*; models are
built from ``.par`` files by parameter ownership.  Only the components
ported so far are registered (see ROADMAP.md); a par file naming another
component's parameters warns that they are unrecognized.
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
    dispersion,
    frequency_dependent,
    jump,
    noise_model,
    solar_system_shapiro,
    solar_wind,
    spindown,
)
from pint_tpu_torch.models.model_builder import (  # noqa: F401  isort:skip
    get_model,
    get_model_and_toas,
    parse_parfile,
)
