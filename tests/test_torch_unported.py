"""A par file that names parameters of a component pint_tpu has and
pint_tpu_torch does not yet is refused by the port's model builder
(``NotImplementedError`` naming the component), where dropping the lines
would give residuals that silently differ from pint_tpu's.  On the DD
set's par, pint_tpu builds each such component; parameters that no
component owns still only warn, in both packages.  The chromatic family
and the binary family's rest (BT_PIECEWISE, FBn, ORBWAVE) that this port
now has load in both.
"""

import warnings

import pytest

import torch_port_data as data
from pint_tpu.models import get_model as jax_get_model
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.model_builder import UNPORTED

#: par lines of each component the port refuses, by its name
LINES = {
    "Glitch": ["GLEP_1 55000", "GLF0_1 1e-8"],
    "Wave": ["WAVE_OM 0.01", "WAVEEPOCH 55000", "WAVE1 1e-6 -2e-6"],
    "IFunc": ["SIFUNC 2", "IFUNC1 54000 1e-6", "IFUNC2 56000 -1e-6"],
    "PiecewiseSpindown": ["PWEP_1 55000", "PWSTART_1 54500",
                          "PWSTOP_1 55500", "PWF0_1 1e-9"],
    "PhaseOffset": ["PHOFF 0.01"],
}


def _par(lines):
    return data.dd_par_lines() + lines


@pytest.mark.parametrize("comp", sorted(LINES))
def test_reference_builds_and_port_refuses(comp):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_get_model(_par(LINES[comp]))
    assert comp in ref.components
    with pytest.raises(NotImplementedError, match=comp):
        get_model(_par(LINES[comp]))


def test_refusal_names_every_component():
    lines = LINES["Glitch"] + LINES["Wave"] + ["CM 0.1", "TNCHROMIDX 4"]
    with pytest.raises(NotImplementedError) as err:
        get_model(_par(lines))
    msg = str(err.value)
    assert "Glitch" in msg and "Wave" in msg and "GLEP_1" in msg
    assert "ChromaticCM" not in msg


def test_refusal_list_names_only_unported_components():
    """Every component of the list is one pint_tpu registers and the port
    does not."""
    from pint_tpu.models.timing_model import Component as JC
    from pint_tpu_torch.models.timing_model import Component as TC

    for comp in UNPORTED:
        assert comp in JC.component_types and comp not in TC.component_types


def test_unknown_parameters_still_warn():
    with pytest.warns(UserWarning, match="unrecognized"):
        model = get_model(_par(["NOTAPARAM 1.0"]))
    with pytest.warns(UserWarning, match="unrecognized"):
        jax_get_model(_par(["NOTAPARAM 1.0"]))
    assert "BinaryDD" in model.components


def test_ported_chromatic_lines_load():
    lines = ["CM 0.1", "TNCHROMIDX 4", "EXPDIPEP_1 55000",
             "EXPDIPAMP_1 1e-6", "EXPDIPTAU_1 30", "CORRECT_TROPOSPHERE N"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model = get_model(_par(lines))
    assert {"ChromaticCM", "SimpleExponentialDip",
            "TroposphereDelay"} <= set(model.components)
    assert not model.CORRECT_TROPOSPHERE.value


def test_ported_orbit_lines_load():
    """BT_PIECEWISE's pieces, an FBn orbit and ORBWAVEs load in both
    packages (BinaryBTPiecewise left the list with the orbit family)."""
    assert "BinaryBTPiecewise" not in UNPORTED
    bt = [ln.replace("BINARY DD", "BINARY BT_PIECEWISE")
          for ln in data.dd_par_lines()
          if not ln.startswith(("M2 ", "SINI ", "OMDOT "))]
    lines = bt + ["XR1_0001 53000", "XR2_0001 54000", "T0X_0001 55000.2001",
                  "ORBWAVE_OM 1e-8", "ORBWAVE_EPOCH 55000",
                  "ORBWAVEC0 1e-4", "ORBWAVES0 -1e-4"]
    for gm in (get_model, jax_get_model):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            model = gm(lines)
        comp = model.components["BinaryBTPiecewise"]
        assert comp.piece_indices() == [1]
        assert comp.orbwave_names() == (["ORBWAVEC0"], ["ORBWAVES0"])
