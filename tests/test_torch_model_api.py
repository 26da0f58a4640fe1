"""pint_tpu_torch's ``TimingModel`` API against pint_tpu's.

On the pars of the stored 200-TOA sets (``tests/torch_port_data.py``),
each loaded by both packages:

* ``write_parfile``: the text equal, line for line;
* ``fit_units``, ``get_params_dict`` (free and all) and ``F0_value``
  equal;
* ``compare`` of two models: the text equal;
* after ``remove_component("FD")`` on the committed J0740-class set, the
  port's residuals within 1 ns of pint_tpu's after the same removal
  (stored in ``tests/data/j0740_sim_refs.json`` by ``python
  tests/torch_port_data.py sim_refs``); FD1-4 are nonzero, so that the
  residuals move by their delay.
"""

import json
import warnings

import numpy as np
import pytest

import torch_port_data as data
from pint_tpu.models import get_model as j_get_model
from pint_tpu_torch.models import get_model as t_get_model
from pint_tpu_torch.residuals import Residuals as TResiduals

RESID_TOL_S = 1e-9

#: the pars of the stored 200-TOA sets
PARS = {"j0740": data.par_lines, "dd": data.dd_par_lines,
        "gls": data.dd_gls_par_lines, "ddk": data.ddk_par_lines,
        "noisefit": data.noisefit_par_lines, "wb": data.wb_par_lines,
        "chrom": data.chrom_par_lines, "wavex": data.wavex_full_par_lines,
        "spider": data.spider_par_lines, "btpw": data.btpw_par_lines}


def _models(lines):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return j_get_model(lines), t_get_model(lines)


@pytest.mark.parametrize("label", list(PARS))
def test_write_parfile_and_units_match(label, tmp_path):
    jm, tm = _models(PARS[label]())
    jm.write_parfile(str(tmp_path / "j.par"))
    tm.write_parfile(str(tmp_path / "t.par"))
    with open(tmp_path / "j.par") as f, open(tmp_path / "t.par") as g:
        jl, tl = f.read().splitlines(), g.read().splitlines()
    assert tl == jl, [(a, b) for a, b in zip(tl, jl) if a != b][:3]
    assert tm.fit_units() == jm.fit_units()
    assert tm.F0_value == jm.F0_value
    for which in ("free", "all"):
        jd, td = jm.get_params_dict(which), tm.get_params_dict(which)
        assert list(td) == list(jd), which
        assert [p.value for p in td.values()] == \
            [p.value for p in jd.values()], which


@pytest.mark.parametrize("pair", [("j0740", "dd"), ("dd", "ddk"),
                                  ("spider", "btpw")])
def test_compare_matches(pair):
    (ja, ta), (jb, tb) = (_models(PARS[k]()) for k in pair)
    ja.F0.value += 1e-9
    ta.F0.value += 1e-9
    want = ja.compare(jb)
    assert ta.compare(tb) == want
    assert "F0" in want and len(want.splitlines()) > 2


def test_remove_component_residuals_match():
    with open(data.SIM_REF_JSON) as f:
        want = np.asarray(json.load(f)["remove_fd_resid_s"])
    jm, tm = _models(data.par_lines())
    _, tt = data.load_torch(data.REF_TIM)
    before = TResiduals(tt, tm, device="cpu").time_resids
    jm.remove_component("FD")
    tm.remove_component("FD")
    assert list(tm.components) == list(jm.components)
    assert "FD1" not in tm and tm.tzr_batch is None
    tr = TResiduals(tt, tm, device="cpu").time_resids
    gap = float(np.max(np.abs(tr - want)))
    assert gap <= RESID_TOL_S, f"after remove_component: {gap:.3e} s " \
        "(bar 1 ns)"
    assert float(np.max(np.abs(tr - before))) > 1e-7
