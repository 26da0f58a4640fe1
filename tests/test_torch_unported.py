"""The port's model builder against pint_tpu's for the components that
came last (Glitch, Wave, IFunc, PiecewiseSpindown, PhaseOffset): both
packages load each one's par lines on the DD set's par and agree on its
parameters.  A par file that names parameters of a component pint_tpu has
and pint_tpu_torch does not is refused (``NotImplementedError`` naming
the component), where dropping the lines would give residuals that
silently differ from pint_tpu's: no component is left in
``model_builder.UNPORTED``, so the refusal is held with entries
monkeypatched into it.  Parameters that no component owns still only
warn, in both packages.  The chromatic family and the binary family's
rest (BT_PIECEWISE, FBn, ORBWAVE) load in both.
"""

import warnings

import numpy as np
import pytest

import torch_port_data as data
from pint_tpu.models import get_model as jax_get_model
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models import model_builder
from pint_tpu_torch.models.model_builder import UNPORTED

#: par lines of each of the components that came last, by its name
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


def _values(comp):
    """{name: value} of a component's parameters that have one (an MJD's
    as its float MJD)."""
    out = {}
    for n, par in comp.params.items():
        v = par.value
        if v is None:
            continue
        out[n] = float(par.mjd_float) if par.kind == "mjd" else v
    return out


@pytest.mark.parametrize("comp", sorted(LINES))
def test_reference_and_port_build(comp):
    """Both packages build the component from its lines, with the same
    parameters (names, values, frozen flags)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model = get_model(_par(LINES[comp]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_get_model(_par(LINES[comp]))
    assert comp in ref.components and comp in model.components
    mine, theirs = (_values(m.components[comp]) for m in (model, ref))
    assert set(mine) == set(theirs)
    for n, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(mine[n], np.float64),
                                      np.asarray(v, np.float64), err_msg=n)
        assert model[n].frozen == ref[n].frozen, n


#: two components the port would not have: their parameters and stems
FAKE_UNPORTED = {"FakeGlitchy": (("FAKEPH",), ("FAKEEP_",)),
                 "FakeWavy": (("FAKEOM",), ("FAKEW",))}


def test_refusal_names_every_component(monkeypatch):
    """A par naming parameters of two unported components is refused,
    naming both and their parameters, and not the ported ones beside
    them."""
    monkeypatch.setattr(model_builder, "UNPORTED", FAKE_UNPORTED)
    lines = ["FAKEEP_1 55000", "FAKEOM 0.01", "CM 0.1", "TNCHROMIDX 4"]
    with pytest.raises(NotImplementedError) as err:
        get_model(_par(lines))
    msg = str(err.value)
    assert "FakeGlitchy" in msg and "FakeWavy" in msg and "FAKEEP_1" in msg
    assert "ChromaticCM" not in msg


def test_refusal_list_names_only_unported_components():
    """The list is empty: every component pint_tpu registers, the five
    that came last among them, is registered in the port too."""
    from pint_tpu.models.timing_model import Component as JC
    from pint_tpu_torch.models.timing_model import Component as TC

    assert not UNPORTED
    assert set(LINES) <= set(TC.component_types)
    missing = {c for c, cls in JC.component_types.items()
               if getattr(cls, "register", False)} - set(TC.component_types)
    assert not missing, missing


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
