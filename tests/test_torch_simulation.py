"""pint_tpu_torch's J0740-class simulators and random models against
pint_tpu's.

pint_tpu's outputs on the same seeded inputs are stored in
``tests/data/j0740_sim_refs.json`` (``python tests/torch_port_data.py
sim_refs``); the port runs on the CPU:

* ``examples.simulate_j0740_class(ntoas=40)``,
  ``examples.simulate_j0740_realistic(ntoas=300, seed=0)`` and
  ``simulation.make_fake_toas_fromtim`` on ``tests/data/j0740_sim_200.tim``
  (white noise from seed 3): UTC within 1 ns of pint_tpu's, frequencies,
  errors, sites and flags equal, and the port's residuals on its TOAs
  within 1 ns of pint_tpu's on its own;
* ``simulation.calculate_random_models`` on the model pint_tpu fitted to
  that set, given pint_tpu's covariance and its names: the draws
  bit-equal, the phase deviations within F0 x 1e-9 s (the residual bar,
  in cycles), and the time deviations (``return_time``) within 1 ns;
* the random models' scatter over the covariance's prediction on two
  fits of the 300-TOA realistic set, against pint_tpu's on its own
  (``torch_port_data.scatter_ratio``): on the headline's fit, given
  pint_tpu's fitted par, covariance and names, and on the fit with FD1-4
  and DM frozen, the port's own; within 1e-6 relative.  pint_tpu's
  ratios are a witness of the draw itself: its headline fit's far
  from 1 (its draws move along the degenerate FD/DM/JUMP directions),
  the frozen fit's near 1;
* ``simulation.update_fake_toa_errors``.
"""

import functools
import json
import warnings

import numpy as np
import pytest

import torch_port_data as data
from pint_tpu_torch import examples, simulation
from pint_tpu_torch.fitter import WLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import get_TOAs

RESID_TOL_S = 1e-9
UTC_TOL_S = 1e-9
#: the port's scatter ratio against pint_tpu's on the same fit (relative)
SCATTER_TOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    with open(data.SIM_REF_JSON) as f:
        return json.load(f)


def _fromtim():
    model, _ = data.load_torch(data.REF_TIM)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        toas = simulation.make_fake_toas_fromtim(
            data.REF_TIM, model, add_noise=True, seed=data.FROMTIM_SEED,
            device="cpu")
    return model, toas


@functools.lru_cache(maxsize=None)
def _realistic_300():
    """The port's 300-TOA realistic set, made once for the file's tests;
    they read its TOAs and leave its model as it is."""
    return examples.simulate_j0740_realistic(ntoas=300, seed=0,
                                             device="cpu")


#: the port's simulated sets, made as the reference's were
SETS = {"class_40": lambda: examples.simulate_j0740_class(
            ntoas=40, device="cpu"),
        "realistic_300": _realistic_300,
        "fromtim_200": _fromtim}


@pytest.mark.parametrize("label", list(SETS))
def test_simulated_toas_match_pint_tpu(ref, label):
    model, toas = SETS[label]()
    want = ref[label]
    utc_gap = float(np.max(np.abs(
        (toas.utc.day - np.asarray(want["utc_day"])) * 86400.0
        + (toas.utc.frac - np.asarray(want["utc_frac"])) * 86400.0)))
    assert utc_gap <= UTC_TOL_S, f"UTC {utc_gap:.3e} s (bar 1 ns)"
    np.testing.assert_array_equal(toas.freq_mhz, want["freq_mhz"])
    np.testing.assert_array_equal(toas.error_us, want["error_us"])
    assert [str(o) for o in toas.obs] == want["obs"]
    assert [dict(f) for f in toas.flags] == want["flags"]
    r = Residuals(toas, model, device="cpu").time_resids
    gap = float(np.max(np.abs(r - np.asarray(want["resid_s"]))))
    assert gap <= RESID_TOL_S, f"residuals {gap:.3e} s (bar 1 ns)"


def test_random_models_match_pint_tpu(ref):
    want = ref["random_models"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(want["par"].splitlines())
        toas = get_TOAs(data.REF_TIM, model=model)
    fitter = WLSFitter(toas, model, device="cpu")
    fitter.parameter_covariance_matrix = np.asarray(want["covariance"])
    fitter.covariance_params = list(want["names"])
    dphase, draws = simulation.calculate_random_models(
        fitter, toas, Nmodels=want["nmodels"], seed=want["seed"])
    dt, draws_t = simulation.calculate_random_models(
        fitter, toas, Nmodels=want["nmodels"], seed=want["seed"],
        return_time=True)
    np.testing.assert_array_equal(draws, want["draws"],
                                  err_msg="draws not bit-equal")
    np.testing.assert_array_equal(draws_t, want["draws"])
    f0 = float(model.F0.value)
    gap = float(np.max(np.abs(dphase - np.asarray(want["dphase"]))))
    assert dphase.shape == (want["nmodels"], toas.ntoas)
    assert gap <= f0 * RESID_TOL_S, \
        f"dphase {gap:.3e} cycles (bar F0 x 1e-9 = {f0 * RESID_TOL_S:.3e})"
    gap_t = float(np.max(np.abs(dt - np.asarray(want["dt_s"]))))
    assert gap_t <= RESID_TOL_S, f"dt {gap_t:.3e} s (bar 1 ns)"


@pytest.mark.parametrize("label", ["headline", "frozen"])
def test_random_models_scatter_matches_pint_tpu(ref, label):
    want = ref["random_models_scatter"][label]
    sc = ref["random_models_scatter"]
    _, toas = _realistic_300()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if label == "headline":
            model = get_model(want["par"].splitlines())
        else:
            model = get_model(examples.j0740_realistic_par().splitlines())
            for n in want["frozen"]:
                model[n].frozen = True
        fitter = WLSFitter(toas, model, device="cpu")
        if label == "headline":
            fitter.parameter_covariance_matrix = np.asarray(
                want["covariance"])
            fitter.covariance_params = list(want["names"])
        else:
            fitter.fit_toas(maxiter=sc["maxiter"])
    assert list(fitter.covariance_params) == want["names"]
    dphase, _ = simulation.calculate_random_models(
        fitter, toas, Nmodels=sc["nmodels"], seed=sc["rm_seed"])
    got = data.scatter_ratio(fitter, toas, dphase)
    for key in ("ratio", "ratio_cov"):
        gap = abs(got[key] / want[key] - 1.0)
        assert gap <= SCATTER_TOL, (
            f"{label} {key} {got[key]:.9g} against pint_tpu's "
            f"{want[key]:.9g}: {gap:.3e} (bar 1e-6 relative)")


def test_random_models_follow_model_edits(ref):
    """On the fit's own TOAs the random models reuse the fitter's
    residuals: an edit of the model after the fit makes them stale, and
    the draws are then evaluated around the edited values, bit-equal to
    residuals built afresh from the edited model."""
    want = ref["random_models"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(want["par"].splitlines())
        toas = get_TOAs(data.REF_TIM, model=model)

    def fitter_of(m):
        f = WLSFitter(toas, m, device="cpu")
        f.parameter_covariance_matrix = np.asarray(want["covariance"])
        f.covariance_params = list(want["names"])
        return f

    def draws(f):
        return simulation.calculate_random_models(
            f, toas, Nmodels=want["nmodels"], seed=want["seed"])[0]

    fitter = fitter_of(model)
    assert not fitter.resids.stale
    before = draws(fitter)
    model.A1.value += 1e-3
    assert fitter.resids.stale
    edited = draws(fitter)
    assert not fitter.resids.stale
    np.testing.assert_array_equal(edited, draws(fitter_of(model)))
    assert float(np.max(np.abs(edited - before))) > 0.0


def test_update_fake_toa_errors():
    _, toas = SETS["class_40"]()
    simulation.update_fake_toa_errors(toas, 2.5)
    np.testing.assert_array_equal(toas.error_us, np.full(toas.ntoas, 2.5))
    errs = np.linspace(0.5, 3.0, toas.ntoas)
    simulation.update_fake_toa_errors(toas, errs)
    np.testing.assert_array_equal(toas.error_us, errs)
    assert toas.error_us is not errs
