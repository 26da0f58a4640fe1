"""pint_tpu_torch's ``WLSFitter.fit_toas`` vs pint_tpu's, on the DDK set
in ecliptic coordinates.

The committed 200-TOA set (``tests/data/ddk_ecl_sim_200.tim``, the par
of ``ddk_ecliptic_realistic_par(dmx_bins=8)``: ELONG/ELAT free, frozen
proper motion and parallax, the DDK binary with KIN and KOM free) and
pint_tpu's eager ``fit_toas(maxiter=6)`` from a perturbed start (by 6
iterations the fit sits at its fixed point), stored beside it
(``ddk_ecl_sim_200_fit.json``, written by ``python
tests/torch_port_data.py``).  With the port on the CPU, the eager
``fit_toas`` and the fused loop (``build_fused_fit``, which ``fit_toas``
takes on CUDA) against pint_tpu's eager fit: values within 1e-3 sigma,
uncertainties within 1e-3 relative, chi2 within 1e-6 relative, the same
FitStatus and iterations; and the committed files are what
``torch_port_data`` writes today.
"""

import json
import warnings

import numpy as np
import pytest

import torch_port_data as data
from pint_tpu_torch.fitter import WLSFitter

FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
CHI2_TOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    with open(data.DDK_REF_JSON) as f:
        return json.load(f)


def _start(ref):
    """The port's (model, toas) at the reference fit's start."""
    model, toas = data.load_torch(data.DDK_REF_TIM, par=data.ddk_par_lines())
    data.perturb(model, data.DDK_PERTURB)
    assert data.device_values(model, ref["fit_params"]) == ref["start"]
    return model, toas


def _gaps(model, ref):
    dev = max(abs(float(np.sum(np.asarray(model[n].device_value)
                               - np.asarray(v))))
              / ref["uncertainties"][n] for n, v in ref["values"].items())
    unc = max(abs(model[n].device_uncertainty / u - 1.0)
              for n, u in ref["uncertainties"].items())
    return dev, unc


@pytest.mark.parametrize("rung", ["eager", "fused"])
def test_ddk_fit_matches_jax(ref, rung):
    model, toas = _start(ref)
    fitter = WLSFitter(toas, model, device="cpu")
    assert fitter.fit_params == ref["fit_params"]
    assert {"AstrometryEcliptic", "BinaryDDK"} <= set(model.components)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = (fitter.fit_toas(maxiter=ref["maxiter"]) if rung == "eager"
                else fitter._fit_fused(ref["maxiter"], None))
    dev, unc = _gaps(model, ref)
    gap = abs(chi2 - ref["chi2"]) / ref["chi2"]
    fr = fitter.fitresult
    print(f"{rung}: {dev:.3e} sigma (bar {FIT_SIGMA_TOL}), unc {unc:.3e} "
          f"(bar {UNC_TOL}), chi2 {chi2:.9f} vs {ref['chi2']:.9f} ({gap:.3e}, "
          f"bar {CHI2_TOL}); {fr.status.name} after {fr.iterations}")
    assert dev <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
    assert (fr.status.name, fr.iterations, fr.rung) == \
        (ref["status"], ref["iterations"], rung)


def test_committed_ddk_reference_is_current(tmp_path_factory, ref):
    """tests/data holds the DDK tim text torch_port_data writes today and
    pint_tpu's eager fit on it."""
    d = tmp_path_factory.mktemp("torch_port_ddk")
    tim = data.write_ddk_sim_tim(str(d / "ddk.tim"))
    with open(tim) as f, open(data.DDK_REF_TIM) as g:
        assert f.read() == g.read()
    fresh = data.jax_ddk_fit(data.DDK_REF_TIM)
    assert fresh["fit_params"] == ref["fit_params"]
    assert fresh["start"] == ref["start"]
    assert (fresh["status"], fresh["iterations"]) == \
        (ref["status"], ref["iterations"])
    np.testing.assert_allclose(fresh["chi2"], ref["chi2"], rtol=1e-12)
    for n, v in ref["values"].items():
        np.testing.assert_allclose(fresh["values"][n], v, rtol=0,
                                   atol=1e-6 * ref["uncertainties"][n])
        np.testing.assert_allclose(fresh["uncertainties"][n],
                                   ref["uncertainties"][n], rtol=1e-9)
