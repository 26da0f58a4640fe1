"""pint_tpu_torch's downhill fitters and maximum-likelihood noise fit vs
pint_tpu's.

With the port on the CPU and JAX on the CPU, on the committed sets:

* ``build_noise_lnlike`` on the 200-TOA noise-fitting set
  (``tests/data/dd_noisefit_sim_200.tim``, every one of the 11 noise
  parameters of ``dd_noise_fit_par`` free) at five seeded points, on
  the residuals of pint_tpu's jitted likelihood: the likelihood within
  1e-10 relative of pint_tpu's, the gradient (torch autograd against
  ``jax.grad``) within 1e-8 relative per component; end to end, each on
  its own residuals (XLA:CPU's jit moves pint_tpu's by 8.5e-14 s),
  within 1e-9 and 1e-5;
* the residuals inside the likelihood carry no grad, so its gradient
  never reaches the phase kernel (which has no reverse mode);
* ``DownhillGLSFitter.fit_toas()`` with the white-noise parameters free
  against pint_tpu's stored fit (``dd_noisefit_sim_200_fit.json``):
  timing values within 1e-3 sigma, uncertainties within 1e-3 relative,
  noise values within 1e-2 of their uncertainty and their uncertainties
  within 1e-2 relative, chi2 within 1e-3 relative (what noise values
  inside their bar allow), the same status, rung and convergence; and
  the timing fit at pint_tpu's fitted noise values within 1e-3 sigma,
  1e-3 in the uncertainties and 1e-6 in chi2;
* ``DownhillWLSFitter.fit_toas()`` on the DD set against pint_tpu's
  stored fit (``dd_sim_200_fitters.json``) at the same timing bars;
* pint_tpu's ``tests/test_noisefit.py``, ported: EFAC and EQUAD
  recovered from simulated TOAs with errors that vary, and the downhill
  fitters' ``fit_params`` not warning about the noise parameters they
  fit.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.fitter import build_noise_lnlike as j_lnlike
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu.residuals import raw_phase_resids as j_raw_phase_resids
from pint_tpu_torch import fitter as tfitter
from pint_tpu_torch.examples import NOISE_FIT_PARAMS, dd_noise_fit_par
from pint_tpu_torch.fitter import (DownhillGLSFitter, DownhillWLSFitter,
                                   build_noise_lnlike)
from pint_tpu_torch.residuals import Residuals as TResiduals

LNLIKE_TOL = 1e-10
GRAD_TOL = 1e-8
#: each package on its own residuals (see test_noise_lnlike_end_to_end)
END_TO_END_LNLIKE_TOL = 1e-9
END_TO_END_GRAD_TOL = 1e-5
FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
CHI2_TOL = 1e-6
NOISE_SIGMA_TOL = 1e-2
NOISE_UNC_TOL = 1e-2
#: the noise fit's chi2: L-BFGS-B stops within ~3e-3 sigma of the
#: likelihood's maximum (its default tolerance on ~2,400), and the two
#: packages' searches part there (pint_tpu's jitted residuals are 8.5e-14
#: s off its eager ones); chi2 goes as EFAC^-2, so noise values within
#: NOISE_SIGMA_TOL of pint_tpu's move it by up to ~4e-3 relative (EFAC's
#: uncertainty is 18% of its value here).  The timing fit at pint_tpu's
#: noise values is held at CHI2_TOL.
NOISEFIT_CHI2_TOL = 1e-3
F64 = torch.float64
#: offsets [device units] of the five likelihood points, per parameter
#: family: EFAC, EQUAD [us], ECORR [us], TNREDAMP, TNREDGAM
POINT_SCALE = {"EFAC": 0.1, "EQUAD": 0.2, "ECORR": 0.2, "TNREDAMP": 0.3,
               "TNREDGAM": 0.3}


def _all_free_par():
    return dd_noise_fit_par(data.DMX_BINS, data.SPAN_DAYS,
                            data.CENTER_MJD).splitlines()


@pytest.fixture(scope="module")
def lnlike_pair():
    par = _all_free_par()
    jm, jt = data.load_jax(data.NOISEFIT_REF_TIM, par=par)
    tm, tt = data.load_torch(data.NOISEFIT_REF_TIM, par=par)
    jr = JResiduals(jt, jm)
    tr = TResiduals(tt, tm, device="cpu")
    names = list(NOISE_FIT_PARAMS)
    jl = j_lnlike(jm, jr.batch, names, jr.track_mode)
    tl = build_noise_lnlike(tm, tr.batch, names, tr.track_mode)
    rng = np.random.default_rng(20261017)
    scale = np.array([POINT_SCALE[n.rstrip("0123456789")] for n in names])
    points = [rng.standard_normal(len(names)) * scale for _ in range(5)]
    return dict(jl=jl, tl=tl, jp=jr.pdict, tp=tr.pdict, names=names,
                points=points, jm=jm, jbatch=jr.batch, tm=tm,
                tbatch=tr.batch)


def _lnlike_gaps(s):
    """(worst likelihood gap, worst gradient gap per component), both
    relative, of the port's likelihood against pint_tpu's over the five
    points."""
    jgrad = jax.jit(jax.grad(s["jl"]))
    tgrad = tfitter._noise_grad(s["tl"])
    worst_l, worst_g = 0.0, 0.0
    for x in s["points"]:
        want_l = float(s["jl"](jnp.asarray(x), s["jp"]))
        want_g = np.asarray(jgrad(jnp.asarray(x), s["jp"]))
        assert np.all(want_g != 0.0)
        xt = torch.as_tensor(x, dtype=F64)
        with torch.no_grad():
            got_l = float(s["tl"](xt, s["tp"]))
        got_g = tgrad(xt, s["tp"]).numpy()
        worst_l = max(worst_l, abs(got_l / want_l - 1.0))
        worst_g = max(worst_g, float(np.max(np.abs(got_g / want_g - 1.0))))
    return worst_l, worst_g


def test_noise_lnlike_matches_pint_tpu(lnlike_pair, monkeypatch):
    """The likelihood and its gradient on the residuals pint_tpu's jitted
    likelihood forms (the port's residual function returns them; they do
    not depend on the noise parameters): what the noise model, the
    Woodbury form and autograd add, at the likelihood's bars."""
    s = lnlike_pair
    j_cyc = torch.as_tensor(np.asarray(jax.jit(
        lambda p: j_raw_phase_resids(s["jm"].calc, p, s["jbatch"], "nearest",
                                     subtract_mean=False,
                                     use_weights=False))(s["jp"])))
    monkeypatch.setattr(tfitter, "raw_phase_resids",
                        lambda *a, **k: j_cyc)
    worst_l, worst_g = _lnlike_gaps(s)
    print(f"noise lnlike vs pint_tpu on pint_tpu's residuals, 5 points: "
          f"{worst_l:.3e} relative (bar {LNLIKE_TOL}); gradient "
          f"{worst_g:.3e} relative per component (bar {GRAD_TOL})")
    assert worst_l <= LNLIKE_TOL and worst_g <= GRAD_TOL


def test_noise_lnlike_end_to_end(lnlike_pair):
    """Each package on its own residuals.  The port's equal pint_tpu's
    eager residuals bit for bit here, but pint_tpu's likelihood is jitted,
    and XLA:CPU's compilation of the quad-single phase moves its
    residuals by up to 8.5e-14 s (the rewrite pint_tpu's
    ``Fitter._fused_ok`` describes): that moves the likelihood by ~1e-10
    relative and the gradient by up to ~4e-7 relative in a component
    whose terms cancel, so the bars are END_TO_END_LNLIKE_TOL and
    END_TO_END_GRAD_TOL."""
    worst_l, worst_g = _lnlike_gaps(lnlike_pair)
    print(f"noise lnlike vs pint_tpu end to end, 5 points: {worst_l:.3e} "
          f"relative (bar {END_TO_END_LNLIKE_TOL}); gradient {worst_g:.3e} "
          f"relative per component (bar {END_TO_END_GRAD_TOL})")
    assert worst_l <= END_TO_END_LNLIKE_TOL and \
        worst_g <= END_TO_END_GRAD_TOL


def test_lnlike_residuals_carry_no_grad(lnlike_pair, monkeypatch):
    """The residuals inside the likelihood do not depend on the noise
    parameters: under autograd they carry no grad, so the gradient cannot
    reach the phase kernel's missing reverse mode."""
    s = lnlike_pair
    seen = []
    real = tfitter.raw_phase_resids

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out.requires_grad)
        return out

    monkeypatch.setattr(tfitter, "raw_phase_resids", spy)
    g = tfitter._noise_grad(s["tl"])(
        torch.as_tensor(s["points"][0], dtype=F64), s["tp"])
    assert seen == [False]
    assert torch.all(torch.isfinite(g)) and torch.all(g != 0.0)


def test_lnlike_refuses_wideband(lnlike_pair):
    """Given wideband DMs, the likelihood takes their Gaussian term: it
    is the narrowband likelihood plus -(chi2_dm + 2 sum ln sigma_dm +
    n ln 2pi) / 2 over the DM rows (no DMEFAC here: sigma_dm is -pp_dme)."""
    s = lnlike_pair
    tm, batch = s["tm"], s["tbatch"]
    n = batch.ntoas
    idx = np.arange(0, n, 2)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        model_dm = tm.total_dm(s["tp"], batch).numpy()[idx]
    dme = rng.uniform(1e-4, 3e-4, len(idx))
    dm = model_dm + rng.standard_normal(len(idx)) * dme
    wb = build_noise_lnlike(tm, batch, s["names"], "nearest", dm_index=idx,
                            dm_data=dm, dm_error=dme)
    x = torch.from_numpy(s["points"][0])
    with torch.no_grad():
        got = float(wb(x, s["tp"])) - float(s["tl"](x, s["tp"]))
    r = (dm - model_dm) / dme
    want = -0.5 * (np.sum(r**2) + 2.0 * np.sum(np.log(dme))
                   + len(idx) * np.log(2.0 * np.pi))
    print(f"the DM term: {got:.12g} against {want:.12g}")
    assert abs(got / want - 1.0) <= 1e-9


@pytest.fixture(scope="module")
def noisefit():
    with open(data.NOISEFIT_REF_JSON) as f:
        ref = json.load(f)
    model, toas = data.load_torch(data.NOISEFIT_REF_TIM,
                                  par=data.noisefit_par_lines())
    data.noisefit_start(model)
    fitter = DownhillGLSFitter(toas, model, device="cpu")
    assert data.device_values(
        model, fitter.fit_params + list(data.NOISEFIT_FREE)) == ref["start"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas()
    return fitter, chi2, ref


def test_downhill_gls_noise_fit_matches_pint_tpu(noisefit):
    fitter, chi2, ref = noisefit
    model = fitter.model
    fr = fitter.fitresult
    assert fitter.fit_params == ref["fit_params"]
    assert fitter.free_noise_params == ref["noise_params"]
    sig, unc = data.fit_gaps(model, ref["values"], ref["uncertainties"])
    nsig, nunc = data.fit_gaps(model, ref["noise_values"],
                               ref["noise_uncertainties"])
    gap = abs(chi2 / ref["chi2"] - 1.0)
    print(f"DownhillGLSFitter noise fit vs pint_tpu: timing {sig:.3e} "
          f"sigma (bar {FIT_SIGMA_TOL}), uncertainties {unc:.3e} (bar "
          f"{UNC_TOL}), chi2 {gap:.3e} (bar {NOISEFIT_CHI2_TOL}); noise "
          f"{nsig:.3e} "
          f"sigma (bar {NOISE_SIGMA_TOL}), uncertainties {nunc:.3e} (bar "
          f"{NOISE_UNC_TOL}); L-BFGS-B evaluations "
          f"{[i['nfev'] for i in fitter.noise_fit_info]}")
    assert (fr.status.name, fr.rung, fr.converged) == (
        ref["status"], ref["rung"], ref["converged"])
    assert all(ref["noise_uncertainties"][n] is not None
               for n in ref["noise_params"])
    assert sig <= FIT_SIGMA_TOL and unc <= UNC_TOL
    assert gap <= NOISEFIT_CHI2_TOL
    assert nsig <= NOISE_SIGMA_TOL and nunc <= NOISE_UNC_TOL
    assert len(fitter.noise_fit_info) == 2
    assert model.fit_provenance["fitter"] == "DownhillGLSFitter"


def test_downhill_gls_timing_at_pint_tpu_noise(noisefit):
    """The last stage of the fit, the timing fit at fixed noise
    parameters, from the port's solution with the noise parameters set
    to pint_tpu's: pint_tpu's timing solution and chi2 at the fit bars."""
    fitter, _, ref = noisefit
    model = fitter.model
    for n, v in ref["noise_values"].items():
        model[n].value = v
    fitter.resids.update()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter._fit_timing()
    sig, unc = data.fit_gaps(model, ref["values"], ref["uncertainties"])
    gap = abs(chi2 / ref["chi2"] - 1.0)
    print(f"timing fit at pint_tpu's noise values: {sig:.3e} sigma (bar "
          f"{FIT_SIGMA_TOL}), uncertainties {unc:.3e} (bar {UNC_TOL}), chi2 "
          f"{gap:.3e} (bar {CHI2_TOL})")
    assert fitter.fitresult.status.name == "CONVERGED"
    assert sig <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL


def test_downhill_gls_reduced_chi2(noisefit):
    fitter, _, ref = noisefit
    assert fitter.resids.reduced_chi2 == pytest.approx(
        ref["reduced_chi2"], rel=CHI2_TOL)


def test_downhill_wls_matches_pint_tpu():
    with open(data.FITTERS_REF_JSON) as f:
        ref = json.load(f)["downhill_wls"]
    model, toas = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    data.perturb_dd(model)
    fitter = DownhillWLSFitter(toas, model, device="cpu")
    assert data.device_values(model, fitter.fit_params) == ref["start"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas()
    fr = fitter.fitresult
    sig, unc = data.fit_gaps(model, ref["values"], ref["uncertainties"])
    gap = abs(chi2 / ref["chi2"] - 1.0)
    print(f"DownhillWLSFitter vs pint_tpu: {sig:.3e} sigma, uncertainties "
          f"{unc:.3e}, chi2 {gap:.3e}; {fr.iterations} iterations")
    assert (fr.status.name, fr.rung, fr.converged, fr.iterations) == (
        ref["status"], ref["rung"], ref["converged"], ref["iterations"])
    assert sig <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
    # no noise parameters: one timing fit, no noise fit
    assert fitter.noise_fit_info == []


# -- pint_tpu's tests/test_noisefit.py, ported --------------------------------

PAR = """
PSR FAKE
F0 61.485476554 1
F1 -1.18e-15 1
PEPOCH 53750
DM 12.4
TZRMJD 53750.1
TZRFRQ 1400
TZRSITE @
EFAC tel @ 1.0
EQUAD tel @ 0.0
"""

EFAC_TRUE = 1.3
EQUAD_TRUE = 2.5   # us


@pytest.fixture(scope="module")
def fitted():
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m_true = get_model(PAR.strip().splitlines())
        m_true.EFAC1.value = EFAC_TRUE
        m_true.EQUAD1.value = EQUAD_TRUE
        # heterogeneous per-TOA errors: with a single uniform error,
        # EFAC and EQUAD are exactly degenerate (one effective sigma)
        rng = np.random.default_rng(7)
        errs = rng.uniform(0.5, 4.0, 400)
        toas = make_fake_toas_uniform(53000, 54500, 400, m_true, obs="@",
                                      error_us=errs, add_noise=True,
                                      seed=42, device="cpu")
        m = get_model(PAR.strip().splitlines())
        m.EFAC1.frozen = False
        m.EQUAD1.frozen = False
        f = DownhillWLSFitter(toas, m, device="cpu")
        f.fit_toas(maxiter=15)
    return f, m


def test_recovers_efac_equad(fitted):
    f, m = fitted
    assert m.EFAC1.uncertainty is not None
    assert m.EQUAD1.uncertainty is not None
    pull_efac = (m.EFAC1.value - EFAC_TRUE) / m.EFAC1.uncertainty
    pull_equad = (m.EQUAD1.value - EQUAD_TRUE) / m.EQUAD1.uncertainty
    assert abs(pull_efac) < 4, (m.EFAC1.value, m.EFAC1.uncertainty)
    assert abs(pull_equad) < 4, (m.EQUAD1.value, m.EQUAD1.uncertainty)


def test_timing_params_still_fit(fitted):
    f, m = fitted
    assert f.fitresult.converged
    assert m.F0.uncertainty is not None
    # post-fit reduced chi2 is ~1 with the recovered noise
    assert f.resids.reduced_chi2 == pytest.approx(1.0, abs=0.25)


def test_no_noise_warning_from_downhill():
    """The 'not fit by this fitter' warning must not fire for the
    downhill family, which fits them; the WLS fitter still warns."""
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = get_model(PAR.strip().splitlines())
        m.EFAC1.frozen = False
        toas = make_fake_toas_uniform(53000, 53100, 30, m, obs="@",
                                      error_us=1.5, device="cpu")
    f = DownhillWLSFitter(toas, m, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        names = f.fit_params
    assert "EFAC1" not in names
    assert "EFAC1" in f.free_noise_params
    with pytest.warns(UserWarning, match="downhill fitter"):
        WLSFitter(toas, m, device="cpu").fit_params
