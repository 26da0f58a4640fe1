"""pint_tpu_torch's wideband fit against pint_tpu's, on the CPU.

On the committed 200-TOA wideband set (``tests/data/wb_sim_200.tim``:
``wideband_nanograv_par(dmx_bins=8)``, the GLS set's model and epochs
with NE_SW, two DMJUMPs, DMEFAC/DMEQUAD per receiver and a wideband DM
on every TOA; ``python tests/torch_port_data.py wb_sim_200`` writes it
with pint_tpu), the port on the CPU against pint_tpu (JAX on the CPU,
float64):

* ``build_wideband_assembly``: the combined residuals (TOA rows within
  1 ns, DM rows within 1e-12 pc cm^-3), the combined design matrix
  within 1e-10 relative per column and the row uncertainties, at a
  seeded offset from the start, against pint_tpu's;
* ``build_noise_lnlike`` with the DM term, on the same seeded DMEFAC
  values: the likelihood and its DMEFAC gradient at the end-to-end bars
  of ``tests/test_torch_downhill.py`` (each package on its own
  residuals);
* ``WidebandTOAFitter.fit_toas(maxiter=3)`` and
  ``WidebandDownhillFitter.fit_toas()`` against pint_tpu's stored fits
  (``wb_sim_200_fit.json``): timing values within 1e-3 sigma,
  uncertainties within 1e-3 relative, chi2 within 1e-6 (the GLS fit) or
  1e-3 (the downhill fit, whose noise fit stops where L-BFGS-B decides,
  as in ``tests/test_torch_downhill.py``); the DMEFACs within 1e-2 of
  their uncertainty and their uncertainties within 1e-2 relative;
* ``WidebandLMFitter.fit_toas()`` at the LM bars of
  ``tests/test_torch_lm_powell.py`` (values within 1e-2 sigma: each
  step is decided by comparing chi2 values);
* ``Fitter.auto`` picks the wideband fitters; narrowband TOAs raise in
  ``WidebandTOAResiduals`` with pint_tpu's error; a non-finite -pp_dme
  raises under the default policy and is downweighted under "warn";
  the dense-covariance wideband step agrees with the basis one.
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
from pint_tpu.fitter import build_wideband_assembly as j_assembly
from pint_tpu.residuals import WidebandTOAResiduals as JWideband
from pint_tpu_torch.examples import WB_NOISE_FREE
from pint_tpu_torch.exceptions import InvalidTOAs
from pint_tpu_torch.fitter import (Fitter, WidebandDownhillFitter,
                                   WidebandLMFitter, WidebandTOAFitter,
                                   build_noise_lnlike,
                                   build_wideband_assembly)
from pint_tpu_torch.residuals import WidebandTOAResiduals

RESID_TOL_S = 1e-9
DM_TOL = 1e-12
COL_TOL = 1e-10
FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
CHI2_TOL = 1e-6
#: the downhill fit's chi2 and noise values (tests/test_torch_downhill.py)
NOISEFIT_CHI2_TOL = 1e-3
NOISE_SIGMA_TOL = 1e-2
NOISE_UNC_TOL = 1e-2
#: LM decides each step by comparing chi2 values (tests/test_torch_lm_powell)
LM_SIGMA_TOL = 1e-2
#: the likelihood and its gradient, each package on its own residuals
LNLIKE_TOL = 1e-9
GRAD_TOL = 1e-5
F64 = torch.float64


@pytest.fixture(scope="module")
def ref():
    with open(data.WB_REF_JSON) as f:
        return json.load(f)


def _torch(free=(), start=True, fitter=WidebandTOAFitter):
    model, toas = data.load_torch(data.WB_REF_TIM, par=data.wb_par_lines(free))
    if start:
        data.wb_start(model)
    return fitter(toas, model, device="cpu")


@pytest.fixture(scope="module")
def fitters():
    model, toas = data.load_jax(data.WB_REF_TIM, par=data.wb_par_lines(()))
    data.wb_start(model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr = JWideband(toas, model)
    return {"jm": model, "jr": jr, "tf": _torch()}


def _rel_cols(a, b):
    scale = np.maximum(np.max(np.abs(b), axis=0), 1e-300)
    return float(np.max(np.max(np.abs(a - b), axis=0) / scale))


def test_wideband_assembly_matches_pint_tpu(fitters):
    jm, jr, tf = fitters["jm"], fitters["jr"], fitters["tf"]
    names = tf.fit_params
    wb = tf.resids
    jasm = j_assembly(jm, jr.batch, jr.dm_index, jr.dm_data, jr.dm_error,
                      names, tf.track_mode, include_offset=True)
    tasm = build_wideband_assembly(tf.model, wb.batch, wb.dm_index,
                                   wb.dm_data, wb.dm_error, names,
                                   tf.track_mode, include_offset=True)
    nt = wb.batch.ntoas
    # a seeded offset from the perturbed start, in the step's units
    x = np.random.default_rng(8).standard_normal(len(names)) * np.asarray(
        [1e-3 * (tf.model[n].device_uncertainty or 1e-9) for n in names])
    jr_, jM, js, joff = (np.asarray(v) for v in jasm.inline(
        jnp.asarray(x), jr.pdict))
    with torch.no_grad():
        tr_, tM, ts, toff = (v.numpy() for v in tasm.inline(
            torch.from_numpy(x), wb.pdict))
    assert tM.shape == jM.shape == (2 * nt, len(names) + 1)
    rt = float(np.max(np.abs(tr_[:nt] - jr_[:nt])))
    rd = float(np.max(np.abs(tr_[nt:] - jr_[nt:])))
    rel = _rel_cols(tM, jM)
    print(f"wideband assembly: TOA rows {rt:.3e} s, DM rows {rd:.3e} pc "
          f"cm^-3, {tM.shape[1]} columns {rel:.3e} relative (bar "
          f"{COL_TOL:.0e}), sigma {np.max(np.abs(ts / js - 1)):.3e}")
    assert rt <= RESID_TOL_S and rd <= DM_TOL and rel <= COL_TOL
    np.testing.assert_allclose(ts, js, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(toff, joff)
    # the DMJUMP columns live in the DM rows only, the FD ones in the TOA
    # rows only
    j = names.index("DMJUMP1")
    assert not np.any(tM[:nt, j]) and np.any(tM[nt:, j])
    j = names.index("FD1")
    assert np.any(tM[:nt, j]) and not np.any(tM[nt:, j])


def test_noise_lnlike_dm_term_matches_pint_tpu():
    model, toas = data.load_jax(data.WB_REF_TIM, par=data.wb_par_lines())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr = JWideband(toas, model)
    tf = _torch(WB_NOISE_FREE, start=False, fitter=WidebandDownhillFitter)
    wb = tf.resids
    names = list(WB_NOISE_FREE)
    jl = j_lnlike(model, jr.batch, names, "nearest", dm_index=jr.dm_index,
                  dm_data=jr.dm_data, dm_error=jr.dm_error)
    jg = jax.jit(jax.grad(jl))
    tl = build_noise_lnlike(tf.model, wb.batch, names, "nearest",
                            dm_index=wb.dm_index, dm_data=wb.dm_data,
                            dm_error=wb.dm_error)
    rng = np.random.default_rng(11)
    worst_l = worst_g = 0.0
    for _ in range(3):
        x = rng.uniform(-0.3, 0.3, len(names))
        a = float(jl(jnp.asarray(x), jr.pdict))
        ga = np.asarray(jg(jnp.asarray(x), jr.pdict))
        xt = torch.from_numpy(x).requires_grad_(True)
        b = tl(xt, wb.pdict)
        (gb,) = torch.autograd.grad(b, xt)
        worst_l = max(worst_l, abs(float(b) / a - 1.0))
        worst_g = max(worst_g, float(np.max(np.abs(gb.numpy() - ga)
                                            / np.abs(ga))))
    print(f"wideband likelihood: {worst_l:.3e} relative (bar {LNLIKE_TOL}), "
          f"DMEFAC gradient {worst_g:.3e} (bar {GRAD_TOL})")
    assert worst_l <= LNLIKE_TOL and worst_g <= GRAD_TOL


def _check_fit(fitter, rec, sigma_tol, chi2_tol, chi2):
    sig, unc = data.fit_gaps(fitter.model, rec["values"],
                             rec["uncertainties"])
    gap = abs(chi2 - rec["chi2"]) / rec["chi2"]
    print(f"{type(fitter).__name__} vs pint_tpu: {sig:.3e} sigma (bar "
          f"{sigma_tol}), uncertainties {unc:.3e} (bar {UNC_TOL}), chi2 "
          f"{gap:.3e} (bar {chi2_tol}); {fitter.fitresult.status.name} "
          f"after {fitter.fitresult.iterations}")
    assert fitter.fit_params == rec["fit_params"]
    assert fitter.resids.dof == rec["dof"]
    assert fitter.fitresult.status.name == rec["status"]
    assert sig <= sigma_tol and unc <= UNC_TOL and gap <= chi2_tol


def test_wideband_gls_fit_matches_pint_tpu(ref):
    f = _torch()
    chi2 = f.fit_toas(maxiter=data.WB_MAXITER)
    _check_fit(f, ref["wideband_gls"], FIT_SIGMA_TOL, CHI2_TOL, chi2)


def test_wideband_downhill_fit_matches_pint_tpu(ref):
    f = _torch(WB_NOISE_FREE, fitter=WidebandDownhillFitter)
    assert f.free_noise_params == list(WB_NOISE_FREE)
    chi2 = f.fit_toas()
    rec = ref["wideband_downhill"]
    _check_fit(f, rec, FIT_SIGMA_TOL, NOISEFIT_CHI2_TOL, chi2)
    nsig, nunc = data.fit_gaps(f.model, rec["noise_values"],
                               rec["noise_uncertainties"])
    print(f"DMEFAC vs pint_tpu: {nsig:.3e} sigma (bar {NOISE_SIGMA_TOL}), "
          f"uncertainties {nunc:.3e} (bar {NOISE_UNC_TOL}); "
          f"{len(f.noise_fit_info)} noise fits")
    assert nsig <= NOISE_SIGMA_TOL and nunc <= NOISE_UNC_TOL
    assert len(f.noise_fit_info) == 2


def test_wideband_lm_fit_matches_pint_tpu(ref):
    f = _torch(fitter=WidebandLMFitter)
    chi2 = f.fit_toas()
    _check_fit(f, ref["wideband_lm"], LM_SIGMA_TOL, CHI2_TOL, chi2)


def test_fitter_auto_picks_the_wideband_fitters():
    model, toas = data.load_torch(data.WB_REF_TIM, par=data.wb_par_lines())
    assert toas.is_wideband
    assert type(Fitter.auto(toas, model, device="cpu")) is \
        WidebandDownhillFitter
    assert type(Fitter.auto(toas, model, downhill=False,
                            device="cpu")) is WidebandTOAFitter


def test_narrowband_toas_raise_as_pint_tpu():
    from pint_tpu.residuals import WidebandTOAResiduals as J

    msgs = []
    for load, cls in ((data.load_jax, J), (data.load_torch,
                                           WidebandTOAResiduals)):
        model, toas = load(data.GLS_REF_TIM, par=data.dd_gls_par_lines())
        with pytest.raises(ValueError) as e:
            cls(toas, model)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_dm_error_policy():
    model, toas = data.load_torch(data.WB_REF_TIM, par=data.wb_par_lines())
    toas.flags[3]["pp_dme"] = "nan"
    with pytest.raises(InvalidTOAs, match="DM uncertainties"):
        WidebandTOAResiduals(toas, model, device="cpu")
    with pytest.warns(Warning, match="downweighting 1 wideband DM"):
        wb = WidebandTOAResiduals(toas, model, policy="warn", device="cpu")
    assert wb.dm_error[3] == 1e12 and np.isfinite(wb.calc_chi2())


def test_full_cov_step_matches_basis_step():
    """The dense-covariance wideband step (C over the TOA rows, the DM
    rows uncorrelated) against the Woodbury basis step, at the start."""
    f = _torch()
    names = f.fit_params
    basis = f._make_step(names, None, True)
    f.full_cov = True
    dense = f._make_step(names, None, True)
    x = np.zeros(len(names))
    a, b = basis(x, f.resids.pdict), dense(x, f.resids.pdict)
    sa = np.sqrt(np.diag(a["Sigma_n"].numpy())) / a["norms"].numpy()
    sb = np.sqrt(np.diag(b["Sigma_n"].numpy())) / b["norms"].numpy()
    dx = float(np.max(np.abs(a["dx"].numpy() - b["dx"].numpy()) / sa))
    print(f"wideband full-cov vs basis step: {dx:.3e} sigma, "
          f"uncertainties {np.max(np.abs(sb / sa - 1)):.3e}, chi2 "
          f"{abs(float(b['chi2']) / float(a['chi2']) - 1):.3e}")
    assert dx <= FIT_SIGMA_TOL and np.max(np.abs(sb / sa - 1)) <= UNC_TOL
    assert abs(float(b["chi2"]) / float(a["chi2"]) - 1) <= CHI2_TOL
