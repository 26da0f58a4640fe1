"""pint_tpu_torch's LMFitter and PowellFitter, and the degradation chain's
LM rung, vs pint_tpu's.

With the port on the CPU and JAX on the CPU:

* ``LMFitter.fit_toas()`` and ``PowellFitter.fit_toas()`` on the
  committed DD set from the perturbed start against pint_tpu's stored
  fits (``tests/data/dd_sim_200_fitters.json``; LM's evaluated op by op,
  ``torch_port_data.jax_fitters``; Powell with only the five
  parameters the perturbation moves free, ``torch_port_data.
  POWELL_PARAMS``): LM's values within 1e-3 sigma, uncertainties within
  1e-3 relative, chi2 within 1e-6 relative; Powell's uncertainties and
  chi2 at the same bars and its values within 1e-2 sigma (Powell compares
  chi2 values, and the chi2 of 200 TOAs carries ~1e-6 of rounding from
  the quad-single phase, so two implementations stop ~1e-3 sigma
  apart); the same status, rung and convergence;
* LM and Powell against WLS, as pint_tpu's ``tests/test_fitter.py``
  ``TestPowellAndLM`` holds them;
* the degradation chain with the WLS solve poisoned (NaN steps from
  finite inputs) in both packages: the port's chain ends on the LM rung
  with the same ``rung_statuses`` as pint_tpu's, chi2 within 1e-6
  relative and values within 1e-3 sigma of pint_tpu's LM from the same
  start (the stored record), and within 1e-2 sigma of pint_tpu's chain
  run here under jit (chi2 and uncertainties at the same bars as
  above), a ``FitDegradedWarning`` at each
  hand-off; with NaN uncertainties every rung fails and the
  ``ConvergenceFailure`` carries all three statuses.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu import faultinject
from pint_tpu.fitter import FitStatus as JFitStatus
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu_torch import fitter as tfitter
from pint_tpu_torch.exceptions import ConvergenceFailure
from pint_tpu_torch.fitter import (FitDegradedWarning, FitStatus, LMFitter,
                                   PowellFitter, WLSFitter, damped_solve)

FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
CHI2_TOL = 1e-6
#: Powell's values (see the module docstring)
POWELL_SIGMA_TOL = 1e-2
#: the degraded chain's values against pint_tpu's jitted chain, which
#: XLA:CPU's compile lands ~1.7e-3 sigma from its op-by-op LM along the
#: DD set's near-degenerate DM/FD/JUMP direction (``chip_smoke.py``'s
#: trajectory bar)
TRAJECTORY_SIGMA_TOL = 1e-2


@pytest.fixture(scope="module")
def ref():
    with open(data.FITTERS_REF_JSON) as f:
        return json.load(f)


def _dd_start():
    model, toas = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    data.perturb_dd(model)
    return model, toas


def _fit(cls, subset=False, **kw):
    model, toas = _dd_start()
    if subset:
        data.powell_subset(model)
    fitter = cls(toas, model, device="cpu")
    start = data.device_values(model, fitter.fit_params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(**kw)
    return fitter, chi2, start


@pytest.fixture(scope="module")
def lm_fit():
    return _fit(LMFitter)


@pytest.fixture(scope="module")
def powell_fit():
    return _fit(PowellFitter, subset=True)


def _check_against(label, fitter, chi2, start, rec, sigma_tol):
    fr = fitter.fitresult
    sig, unc = data.fit_gaps(fitter.model, rec["values"],
                             rec["uncertainties"])
    gap = abs(chi2 / rec["chi2"] - 1.0)
    print(f"{label} vs pint_tpu: {sig:.3e} sigma (bar {sigma_tol}), "
          f"uncertainties {unc:.3e} (bar {UNC_TOL}), chi2 {gap:.3e} (bar "
          f"{CHI2_TOL}); {fr.iterations} iterations ({rec['iterations']})")
    assert start == rec["start"] and fitter.fit_params == rec["fit_params"]
    assert (fr.status.name, fr.rung, fr.converged) == (
        rec["status"], rec["rung"], rec["converged"])
    assert sig <= sigma_tol and unc <= UNC_TOL and gap <= CHI2_TOL


def test_lm_matches_pint_tpu(lm_fit, ref):
    _check_against("LMFitter", *lm_fit, ref["lm"], FIT_SIGMA_TOL)


def test_powell_matches_pint_tpu(powell_fit, ref):
    fitter = powell_fit[0]
    assert tuple(fitter.fit_params) == tuple(
        n for n in ref["powell"]["fit_params"]) and set(
        fitter.fit_params) == set(data.POWELL_PARAMS)
    _check_against("PowellFitter", *powell_fit, ref["powell"],
                   POWELL_SIGMA_TOL)
    print(f"Powell chi2 evaluations: {fitter.fit_info['chi2_evaluations']}")


def _wls_reference(subset=False):
    model, toas = _dd_start()
    if subset:
        data.powell_subset(model)
    f = WLSFitter(toas, model, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f.fit_toas(maxiter=3)
    return f


def test_lm_matches_wls(lm_fit):
    """As pint_tpu's TestPowellAndLM.test_lm_matches_wls: LM converges to
    WLS's chi2 (1e-6 relative) and F0 within 5 sigma of WLS's."""
    f_ref = _wls_reference()
    fitter, chi2, _ = lm_fit
    assert fitter.fitresult.converged
    assert chi2 == pytest.approx(f_ref.fitresult.chi2, rel=1e-6)
    m, mr = fitter.model, f_ref.model
    assert float(m.F0.value) == pytest.approx(
        float(mr.F0.value), abs=5 * float(mr.F0.uncertainty))


def test_powell_matches_wls(powell_fit):
    """As pint_tpu's TestPowellAndLM.test_powell_matches_wls: Powell's chi2
    within 1e-3 relative of WLS's on the same free parameters, every
    value within 3 sigma."""
    f_ref = _wls_reference(subset=True)
    fitter, chi2, _ = powell_fit
    assert chi2 == pytest.approx(f_ref.fitresult.chi2, rel=1e-3)
    for n in f_ref.fit_params:
        u = float(f_ref.model[n].uncertainty)
        assert abs(float(fitter.model[n].value)
                   - float(f_ref.model[n].value)) < 3 * u


def test_damped_solve_undamped_is_the_wls_step():
    """lam = 0: LM's damped solve is the Gauss-Newton step of the WLS
    normal-equations solve (``fit_wls_eigh``) on the same assembly, to
    1e-12 of the step's uncertainty (both eigendecompose the same
    normal matrix; only their cutoffs differ, and neither drops a
    direction here)."""
    model, toas = _dd_start()
    fitter = WLSFitter(toas, model, device="cpu")
    names = fitter.fit_params
    asm = tfitter.build_whitened_assembly(model, fitter.resids.batch, names,
                                          fitter.track_mode, True)
    with torch.no_grad():
        r, M, sigma, offc = asm.inline(torch.zeros(len(names),
                                                   dtype=torch.float64),
                                       fitter.resids.pdict)
        dx, chi2 = damped_solve(r, M, sigma, offc, 0.0, len(names))
        out = tfitter.wls_solve(r, M, sigma, offc, tfitter.fit_wls_eigh,
                                len(names))
    sd = np.sqrt(np.diag(tfitter.denormalize_covariance(out["Sigma_n"],
                                                        out["norms"])))
    gap = float(np.max(np.abs(dx.numpy() - out["dx"].numpy()) / sd))
    print(f"undamped LM step vs WLS step: {gap:.3e} sigma")
    assert gap <= 1e-12 and int(out["n_bad"]) == 0
    assert float(chi2) == pytest.approx(float(out["chi2"]), rel=1e-12)


# -- the degradation chain's LM rung ------------------------------------------

def _nan_step(kern):
    """A WLS solve kernel returning NaN steps from finite inputs, as
    pint_tpu's ``faultinject.nan_wls_solver`` poisons its own."""
    def bad(M, r_sec, sigma_sec, threshold=None):
        dpars, Sigma_n, norms, n_bad = kern(M, r_sec, sigma_sec, threshold)
        return dpars * float("nan"), Sigma_n, norms, n_bad
    return bad


@pytest.fixture(scope="module")
def degraded():
    """Both packages' WLSFitter on the DD set, driven through the
    degradation chain after a NONFINITE fused rung with the WLS solve
    poisoned."""
    jm, jt = data.load_jax(data.DD_REF_TIM, par=data.dd_par_lines())
    data.perturb_dd(jm)
    with faultinject.nan_wls_solver(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf = JWLSFitter(jt, jm)
        jchi2 = jf._degraded_fit(JFitStatus.NONFINITE, 4, None, 1e-8)
    model, toas = _dd_start()
    mp = pytest.MonkeyPatch()
    try:
        for k in ("fit_wls_svd", "fit_wls_eigh"):
            mp.setattr(tfitter, k, _nan_step(getattr(tfitter, k)))
        tf = WLSFitter(toas, model, device="cpu")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tchi2 = tf._degraded_fit(FitStatus.NONFINITE, 4, None, 1e-8)
    finally:
        mp.undo()
    return jf, jchi2, tf, tchi2, w


def test_poisoned_solve_recovers_through_lm_rung(degraded):
    jf, jchi2, tf, tchi2, w = degraded
    assert np.isfinite(tchi2)
    assert tf.fitresult.rung == jf.fitresult.rung == "lm"
    assert tf.fitresult.status.name == jf.fitresult.status.name
    assert tf.fitresult.converged == jf.fitresult.converged
    assert tf.model.fit_provenance["rung_statuses"] == \
        jf.model.fit_provenance["rung_statuses"] == {
            "fused": "NONFINITE", "eager": "NONFINITE",
            "lm": tf.fitresult.status.name}
    assert tf.fitresult.status.name in ("CONVERGED", "MAXITER")
    degr = [x for x in w if isinstance(x.message, FitDegradedWarning)]
    assert len(degr) >= 2   # fused -> eager and eager -> LM


def test_poisoned_solve_matches_pint_tpu(degraded, ref):
    """The chain's LM rung, an LMFitter from the perturbed start (the
    fused and eager rungs leave the model there), against pint_tpu's
    LMFitter from that start evaluated op by op (the stored ``lm``
    record) at the LM bars.  pint_tpu's own chain, run here under jit,
    reaches the same rung with the same statuses
    (``test_poisoned_solve_recovers_through_lm_rung``); XLA:CPU's compile
    lands its LM rung 1.7e-3 sigma away along the set's near-degenerate
    DM/FD/JUMP direction, as it does its LMFitter
    (``torch_port_data.jax_fitters``)."""
    jf, jchi2, tf, tchi2, _ = degraded
    rec = ref["lm"]
    names = tf.fit_params
    assert names == jf.fit_params == rec["fit_params"]
    sig, unc = data.fit_gaps(tf.model, rec["values"], rec["uncertainties"])
    gap = abs(tchi2 / rec["chi2"] - 1.0)
    jsig, _ = data.fit_gaps(jf.model, rec["values"], rec["uncertainties"])
    live = data.fit_record(jf.model, names)
    lsig, lunc = data.fit_gaps(tf.model, live["values"],
                               live["uncertainties"])
    lgap = abs(tchi2 / jchi2 - 1.0)
    print(f"degraded chain (LM rung) vs pint_tpu: {sig:.3e} sigma, "
          f"uncertainties {unc:.3e}, chi2 {gap:.3e} (pint_tpu's jitted "
          f"chain {jsig:.3e} sigma from its eager LM); vs the jitted "
          f"chain: {lsig:.3e} sigma, uncertainties {lunc:.3e}, "
          f"chi2 {lgap:.3e}")
    assert sig <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
    assert lsig <= TRAJECTORY_SIGMA_TOL and lunc <= UNC_TOL \
        and lgap <= CHI2_TOL


def test_nan_sigma_fails_whole_chain_typed():
    """NaN uncertainties poison every rung: the chain raises
    ConvergenceFailure carrying the three statuses, with the model left
    as it was."""
    model, toas = _dd_start()
    f0_before = float(model.F0.value)
    f = WLSFitter(toas, model, device="cpu")
    err = f.resids.batch.error_us.clone()
    err[[0, 3]] = float("nan")
    f.resids.batch = f.resids.batch.replace(error_us=err)
    with pytest.raises(ConvergenceFailure) as ei, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f._degraded_fit(FitStatus.NONFINITE, 4, None, 1e-8)
    e = ei.value
    assert e.rung_statuses == {"fused": FitStatus.NONFINITE,
                               "eager": FitStatus.NONFINITE,
                               "lm": FitStatus.NONFINITE}
    assert e.status is FitStatus.NONFINITE
    assert "not ported" not in str(e)
    assert float(model.F0.value) == f0_before
