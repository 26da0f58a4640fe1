"""pint_tpu_torch's chromatic family against pint_tpu's, on the CPU.

``ChromaticCM`` (CM with Taylor terms, TNCHROMIDX 4), ``ChromaticCMX``,
``SimpleExponentialDip``, ``ChromaticGaussianEvent``, ``PLChromNoise`` and
``PLSWNoise`` on the committed 200-TOA chromatic set
(``tests/data/chrom_sim_200.tim``: ``examples.chromatic_j1713_par
(dmx_bins=8)``, 50 epochs of four sub-band TOAs on 430, 820 and 1400
MHz); the same inputs go through both packages (JAX on the CPU,
float64):

* each component's delay within 1e-12 s, the TZR row's phase words
  (the dip reaches it) and an infinite-frequency row (the dip's and
  the event's frequency factor is 1 there, CM's delay 0);
* the residuals within 1 ns, and the design matrix's columns within
  1e-10 relative;
* the PLChromNoise and PLSWNoise bases and weights;
* the noise likelihood and its gradient in TNCHROMAMP, TNCHROMGAM and
  TNSWAMP at the bars of ``tests/test_torch_downhill.py``;
* ``DownhillGLSFitter.fit_toas()`` against pint_tpu's stored fit
  (``chrom_sim_200_fit.json``) at those bars;
* CMX ranges that share a boundary (a TOA on it lies in both) and the
  delay kernel's layout of the family.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.fitter import build_noise_lnlike as j_lnlike
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu.residuals import raw_phase_resids as j_raw_phase_resids
from pint_tpu_torch import fitter as tfitter
from pint_tpu_torch.examples import CHROM_NOISE_FREE
from pint_tpu_torch.fitter import (DownhillGLSFitter, WLSFitter,
                                   build_noise_lnlike)
from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.residuals import Residuals as TResiduals

DELAY_TOL_S = 1e-12
RESID_TOL_S = 1e-9
COLUMN_TOL = 1e-10
BASIS_TOL = 1e-15
WEIGHT_TOL = 1e-14
#: the likelihood bars of tests/test_torch_downhill.py (on pint_tpu's
#: residuals) and the noise fit's
LNLIKE_TOL = 1e-10
GRAD_TOL = 1e-8
FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
NOISE_SIGMA_TOL = 1e-2
NOISE_UNC_TOL = 1e-2
NOISEFIT_CHI2_TOL = 1e-3
COMPONENTS = ("ChromaticCM", "SimpleExponentialDip",
              "ChromaticGaussianEvent")
#: CMX lines over the chromatic set: three ranges, the first two sharing
#: the boundary MJD 54000
CMX_LINES = ("CMX_0001 0.3 1", "CMXR1_0001 52000", "CMXR2_0001 54000",
             "CMX_0002 -0.2 1", "CMXR1_0002 54000", "CMXR2_0002 56000",
             "CMX_0003 0.1 1", "CMXR1_0003 56000.5", "CMXR2_0003 58000")
F64 = torch.float64


def _load(extra=()):
    par = data.chrom_par_lines() + list(extra)
    jm, jt = data.load_jax(data.CHROM_REF_TIM, par=par)
    tm, tt = data.load_torch(data.CHROM_REF_TIM, par=par)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr = JResiduals(jt, jm)
    tr = TResiduals(tt, tm, device="cpu")
    return (jm, jt, jr), (tm, tt, tr)


@pytest.fixture(scope="module")
def pair():
    return _load(CMX_LINES)


def _delay_gap(jc, tc, jr, tr, jb=None, tb=None):
    jb = jr.batch if jb is None else jb
    tb = tr.batch if tb is None else tb
    jd = np.asarray(jc.delay(jr.pdict, jb, jnp.zeros(jb.freq_mhz.shape)))
    with torch.no_grad():
        td = tc.delay(tr.pdict, tb, torch.zeros(tb.ntoas, dtype=F64)).numpy()
    return float(np.max(np.abs(td - jd))), jd, td


@pytest.mark.parametrize("name", COMPONENTS + ("ChromaticCMX",))
def test_component_delay_matches_pint_tpu(pair, name):
    (jm, _, jr), (tm, _, tr) = pair
    gap, jd, _ = _delay_gap(jm.components[name], tm.components[name], jr, tr)
    print(f"{name}: delay {gap:.3e} s of {np.max(np.abs(jd)):.3e} s (bar "
          f"{DELAY_TOL_S})")
    assert np.any(jd) and gap <= DELAY_TOL_S


def test_infinite_frequency_rows(pair):
    """A barycentred row (infinite frequency): CM's and CMX's delay is 0,
    the dip's and the event's frequency factor 1."""
    (jm, _, jr), (tm, _, tr) = pair
    f = np.asarray(jr.batch.freq_mhz).copy()
    f[::7] = np.inf
    jb = jr.batch._replace(freq_mhz=jnp.asarray(f))
    tb = tr.batch.replace(freq_mhz=torch.from_numpy(f))
    for name in COMPONENTS + ("ChromaticCMX",):
        gap, jd, td = _delay_gap(jm.components[name], tm.components[name],
                                 jr, tr, jb, tb)
        print(f"{name} with infinite-frequency rows: {gap:.3e} s")
        assert gap <= DELAY_TOL_S
        if name.startswith("ChromaticCM"):
            assert not np.any(td[::7])
    dip = tm.components["SimpleExponentialDip"]
    with torch.no_grad():
        at_fref = dip.delay(tr.pdict, tr.batch.replace(
            freq_mhz=torch.full_like(tb.freq_mhz, 1400.0)), None)
        at_inf = dip.delay(tr.pdict, tb, None)
    assert torch.equal(at_inf[::7], at_fref[::7])


def test_tzr_phase_and_residuals_match(pair):
    """The TZR row's phase words (the dip, the event and the troposphere
    reach it) and the residuals."""
    (jm, _, jr), (tm, _, tr) = pair
    jw = np.asarray(jr.pdict["const"]["__tzrphase__"], np.float64)
    tw = tr.pdict["const"]["__tzrphase__"].numpy().astype(np.float64)
    tzr_gap = abs(float(np.sum(tw) - np.sum(jw)))
    rgap = float(np.max(np.abs(np.asarray(tr.time_resids)
                               - np.asarray(jr.time_resids))))
    print(f"TZR phase {tzr_gap:.3e} cycles; residuals {rgap:.3e} s (bar "
          f"{RESID_TOL_S})")
    assert tzr_gap <= 1e-9 * float(tm.F0.value) and rgap <= RESID_TOL_S


def test_design_matrix_matches_pint_tpu(pair):
    (jm, jt, _), (tm, tt, _) = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Mj, nj = JWLSFitter(jt, jm).get_designmatrix()
    Mt, nt = WLSFitter(tt, tm, device="cpu").get_designmatrix()
    assert nt == nj
    assert {"CM1", "CM2", "EXPDIPAMP_1", "EXPDIPTAU_1",
            "CHROMGAUSS_LOGAMP_1", "CMX_0002"} <= set(nt)
    Mj = np.asarray(Mj)
    gap = float(np.max(np.max(np.abs(Mt - Mj), axis=0)
                       / np.max(np.abs(Mj), axis=0)))
    print(f"design matrix ({len(nt)} columns) vs pint_tpu: {gap:.3e} per "
          f"column (bar {COLUMN_TOL})")
    assert gap <= COLUMN_TOL


@pytest.mark.parametrize("name", ["PLChromNoise", "PLSWNoise"])
def test_noise_basis_and_weights(pair, name):
    (jm, _, jr), (tm, _, tr) = pair
    jc, tc = jm.components[name], tm.components[name]
    Uj = np.asarray(jr.pdict["const"][jc.basis_pytree_name])
    Ut = tr.pdict["const"][tc.basis_pytree_name].numpy()
    wj = np.asarray(jc.noise_weights(jr.pdict))
    wt = tc.noise_weights(tr.pdict).numpy()
    bgap = float(np.max(np.abs(Ut - Uj)) / np.max(np.abs(Uj)))
    wgap = float(np.max(np.abs(wt / wj - 1.0)))
    print(f"{name}: basis {Uj.shape} {bgap:.3e} relative (bar "
          f"{BASIS_TOL}), weights {wgap:.3e} relative (bar {WEIGHT_TOL})")
    assert Ut.shape == (tr.batch.ntoas, 60)
    assert bgap <= BASIS_TOL and wgap <= WEIGHT_TOL
    if name == "PLChromNoise":
        assert tc.chromatic_alpha() == 4.0


def test_noise_lnlike_and_gradient(pair, monkeypatch):
    """The likelihood and its gradient in the three noise parameters at
    five seeded points, on pint_tpu's residuals (as
    tests/test_torch_downhill.py holds it)."""
    (jm, _, jr), (tm, _, tr) = pair
    names = list(CHROM_NOISE_FREE)
    jl = j_lnlike(jm, jr.batch, names, jr.track_mode)
    tl = build_noise_lnlike(tm, tr.batch, names, tr.track_mode)
    j_cyc = torch.as_tensor(np.asarray(jax.jit(
        lambda p: j_raw_phase_resids(jm.calc, p, jr.batch, "nearest",
                                     subtract_mean=False,
                                     use_weights=False))(jr.pdict)))
    monkeypatch.setattr(tfitter, "raw_phase_resids", lambda *a, **k: j_cyc)
    jgrad = jax.jit(jax.grad(jl))
    tgrad = tfitter._noise_grad(tl)
    rng = np.random.default_rng(20261017)
    worst_l = worst_g = 0.0
    for _ in range(5):
        x = rng.standard_normal(len(names)) * 0.3
        want_l = float(jl(jnp.asarray(x), jr.pdict))
        want_g = np.asarray(jgrad(jnp.asarray(x), jr.pdict))
        xt = torch.as_tensor(x, dtype=F64)
        with torch.no_grad():
            got_l = float(tl(xt, tr.pdict))
        got_g = tgrad(xt, tr.pdict).numpy()
        worst_l = max(worst_l, abs(got_l / want_l - 1.0))
        worst_g = max(worst_g, float(np.max(np.abs(got_g / want_g - 1.0))))
    print(f"chromatic noise lnlike vs pint_tpu, 5 points: {worst_l:.3e} "
          f"(bar {LNLIKE_TOL}); gradient {worst_g:.3e} (bar {GRAD_TOL})")
    assert worst_l <= LNLIKE_TOL and worst_g <= GRAD_TOL


def test_cmx_shared_boundary(pair):
    (jm, jt, _), (tm, tt, _) = pair
    comp = tm.components["ChromaticCMX"]
    m = tt.utc.mjd_float
    on = float(m[np.argmin(np.abs(m - 54000.0))])
    for model in (jm, tm):
        model.CMXR2_0001.set_value(on)
        model.CMXR1_0002.set_value(on)
    masks = comp.mask_entries(tt)
    jmask = jm.components["ChromaticCMX"].mask_entries(jt)
    for n in comp.cmx_names():
        np.testing.assert_array_equal(masks[f"{n}__rangemask"],
                                      jmask[f"{n}__rangemask"])
    row = int(np.argmin(np.abs(m - on)))
    assert list(masks[dc.CMX_INDEX][row]) == [0, 1]


def test_layout_of_the_chromatic_family(pair):
    _, (tm, _, tr) = pair
    lay = tm.calc.chain_layout
    want = dc.CM | dc.CMX | dc.EXPDIP | dc.CHROMGAUSS | dc.TROPO
    assert lay.flags & want == want
    cfg = dict(zip(dc.CFG_FIELDS, lay.cfg))
    assert (cfg["ncm"], cfg["ncmx"], cfg["ndip"], cfg["ngauss"]) == \
        (3, 3, 1, 1)
    theta = lay.theta(tr.pdict)
    for n in ("TNCHROMIDX", "CM1", "CMX_0002", "EXPDIPTAU_1"):
        assert float(theta[lay.names.index(n)]) == tm[n].device_value
    dip = tm.components["SimpleExponentialDip"]
    assert float(theta[lay.names.index("EXPDIP_1__norm")]) == \
        float(dip.peak_norm(tr.pdict, 1))
    assert float(theta[lay.names.index("CHROMGAUSS_1__amp")]) == \
        10.0 ** tm.CHROMGAUSS_LOGAMP_1.value
    rows = dc.row_inputs(lay, tr.pdict, tr.batch)
    tropo = rows[[r[0] for r in dc.ROWS].index("tropo")]
    assert tropo.dtype == F64 and torch.all(tropo > 0)


@pytest.fixture(scope="module")
def chrom_fit():
    with open(data.CHROM_REF_JSON) as f:
        ref = json.load(f)
    model, toas = data.load_torch(data.CHROM_REF_TIM,
                                  par=data.chrom_par_lines())
    data.chrom_start(model)
    fitter = DownhillGLSFitter(toas, model, device="cpu")
    assert data.device_values(
        model, fitter.fit_params + list(CHROM_NOISE_FREE)) == ref["start"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas()
    return fitter, chi2, ref


def test_downhill_gls_chromatic_fit_matches_pint_tpu(chrom_fit):
    fitter, chi2, ref = chrom_fit
    model = fitter.model
    fr = fitter.fitresult
    assert fitter.fit_params == ref["fit_params"]
    assert fitter.free_noise_params == ref["noise_params"]
    sig, unc = data.fit_gaps(model, ref["values"], ref["uncertainties"])
    nsig, nunc = data.fit_gaps(model, ref["noise_values"],
                               ref["noise_uncertainties"])
    gap = abs(chi2 / ref["chi2"] - 1.0)
    print(f"chromatic DownhillGLSFitter fit vs pint_tpu: timing {sig:.3e} "
          f"sigma (bar {FIT_SIGMA_TOL}), uncertainties {unc:.3e} (bar "
          f"{UNC_TOL}), chi2 {gap:.3e} (bar {NOISEFIT_CHI2_TOL}); noise "
          f"{nsig:.3e} sigma (bar {NOISE_SIGMA_TOL}), uncertainties "
          f"{nunc:.3e} (bar {NOISE_UNC_TOL}); L-BFGS-B evaluations "
          f"{[i['nfev'] for i in fitter.noise_fit_info]}")
    assert (fr.status.name, fr.rung, fr.converged) == (
        ref["status"], ref["rung"], ref["converged"])
    assert sig <= FIT_SIGMA_TOL and unc <= UNC_TOL
    assert gap <= NOISEFIT_CHI2_TOL
    assert nsig <= NOISE_SIGMA_TOL and nunc <= NOISE_UNC_TOL
