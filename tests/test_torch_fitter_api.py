"""pint_tpu_torch's user-facing fitter API vs pint_tpu's: ``Fitter.auto``,
the ``Fitter`` extras, the residuals' diagnostics and the grid wrappers.

With the port on the CPU and JAX on the CPU, on the committed sets:

* ``Fitter.auto`` picks the class pint_tpu picks for a WLS set (the DD
  set), a GLS set (the GLS set) and either with ``downhill=False``; on a
  wideband set pint_tpu picks ``WidebandDownhillFitter`` and the port
  raises ``NotImplementedError`` (no narrowband fitter stands in);
  ``device=`` passes through, and with no card the default (CUDA)
  raises instead of falling back to the CPU;
* ``get_designmatrix`` within 1e-10 of pint_tpu's per column (relative
  to the column's largest entry), on the DD and GLS sets;
* after the eager WLS fit of the DD set, ``parameter_correlation_matrix``
  within 1e-8 of pint_tpu's; ``get_summary``'s layout, names and counts
  as pint_tpu's;
* ``calc_whitened_resids`` on the same residuals within 1e-9 absolute of
  pint_tpu's (the DD set, white noise only, and the GLS set), and
  ``normality`` the same KS statistic and p-value (1e-9 relative) and
  Anderson-Darling statistic; end to end, each on its own residuals
  (pint_tpu's are XLA:CPU's jit of the phase, 8.5e-14 s from its eager
  ones, which the port's equal), within 1e-6;
* ``grid_chisq``, ``grid_chisq_derived`` (identity functions) and
  ``tuple_chisq`` over the bench's 3x3 M2/SINI grid on the J0740 set:
  bit-equal to ``grid_chisq_flat`` on the same points, and within 1e-6
  relative of pint_tpu's three.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.fitter import Fitter as JFitter
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.fitter import Fitter, WLSFitter
from pint_tpu_torch.residuals import Residuals as TResiduals

COLUMN_TOL = 1e-10
CORR_TOL = 1e-8
WHITE_TOL = 1e-9
WHITE_END_TO_END_TOL = 1e-6
STAT_TOL = 1e-9
GRID_TOL = 1e-6


def _sets():
    return {"wls": (data.DD_REF_TIM, data.dd_par_lines()),
            "gls": (data.GLS_REF_TIM, data.dd_gls_par_lines())}


def _wideband(toas):
    """``toas`` with a wideband DM measurement on every TOA."""
    for f in toas.flags:
        f["pp_dm"] = "10.25"
        f["pp_dme"] = "1e-4"
    return toas


@pytest.mark.parametrize("kind", ["wls", "gls"])
@pytest.mark.parametrize("downhill", [True, False])
def test_auto_picks_pint_tpus_class(kind, downhill):
    tim, par = _sets()[kind]
    jm, jt = data.load_jax(tim, par=par)
    tm, tt = data.load_torch(tim, par=par)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = type(JFitter.auto(jt, jm, downhill=downhill)).__name__
        got = Fitter.auto(tt, tm, downhill=downhill, device="cpu")
    assert type(got).__name__ == want
    assert got.device.type == "cpu"
    print(f"Fitter.auto on the {kind} set (downhill={downhill}): {want}")


def test_auto_wideband_raises_where_pint_tpu_picks_wideband():
    """Wideband TOAs: the port picks pint_tpu's wideband class, downhill
    or not, and raises nothing."""
    tim, par = _sets()["wls"]
    jm, jt = data.load_jax(tim, par=par)
    tm, tt = data.load_torch(tim, par=par)
    for downhill in (True, False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = type(JFitter.auto(_wideband(jt), jm,
                                     downhill=downhill)).__name__
        got = Fitter.auto(_wideband(tt), tm, downhill=downhill, device="cpu")
        assert type(got).__name__ == want == (
            "WidebandDownhillFitter" if downhill else "WidebandTOAFitter")


def test_auto_defaults_to_the_card():
    """No ``device=``: the fitter is built on CUDA, and without a card
    that raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tm, tt = data.load_torch(*_sets()["wls"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Fitter.auto(tt, tm)


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_designmatrix_matches_pint_tpu(kind):
    tim, par = _sets()[kind]
    jm, jt = data.load_jax(tim, par=par)
    tm, tt = data.load_torch(tim, par=par)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Mj, nj = JWLSFitter(jt, jm).get_designmatrix()
        Mt, nt = WLSFitter(tt, tm, device="cpu").get_designmatrix()
    assert nt == nj and Mt.shape == Mj.shape == (tt.ntoas, len(nt))
    scale = np.max(np.abs(Mj), axis=0)
    gap = float(np.max(np.max(np.abs(Mt - Mj), axis=0) / scale))
    print(f"design matrix ({kind}, {len(nt)} columns) vs pint_tpu: {gap:.3e} "
          f"per column (bar {COLUMN_TOL})")
    assert gap <= COLUMN_TOL


@pytest.fixture(scope="module")
def dd_fits():
    jm, jt = data.load_jax(data.DD_REF_TIM, par=data.dd_par_lines())
    tm, tt = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    data.perturb_dd(jm)
    data.perturb_dd(tm)
    jf, tf = JWLSFitter(jt, jm), WLSFitter(tt, tm, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf.fit_toas(maxiter=data.DD_MAXITER)
        tf.fit_toas(maxiter=data.DD_MAXITER)
    return jf, tf


def test_correlation_matrix_matches_pint_tpu(dd_fits):
    jf, tf = dd_fits
    Cj, Ct = jf.parameter_correlation_matrix, tf.parameter_correlation_matrix
    assert tf.covariance_params == jf.covariance_params
    gap = float(np.max(np.abs(Ct - Cj)))
    print(f"correlation matrix vs pint_tpu: {gap:.3e} (bar {CORR_TOL})")
    assert gap <= CORR_TOL
    assert np.allclose(np.diag(Ct), 1.0, rtol=0, atol=1e-14)
    assert float(np.max(np.abs(Ct - Ct.T))) <= 1e-14
    assert WLSFitter(tf.toas, tf.model, device="cpu") \
        .parameter_correlation_matrix is None


def test_summary_layout_matches_pint_tpu(dd_fits):
    jf, tf = dd_fits
    js, ts = jf.get_summary().splitlines(), tf.get_summary().splitlines()
    assert len(ts) == len(js) == 5 + len(tf.fit_params)
    assert ts[0] == js[0] and ts[3] == js[3] and ts[4] == js[4]
    assert [ln.split()[0] for ln in ts[5:]] == tf.fit_params
    assert all(len(ln.split()) == 3 for ln in ts[5:])
    assert ts[1].split()[:3] == js[1].split()[:3]


def _resid_pair(kind):
    tim, par = _sets()[kind]
    jm, jt = data.load_jax(tim, par=par)
    tm, tt = data.load_torch(tim, par=par)
    return JResiduals(jt, jm), TResiduals(tt, tm, device="cpu")


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_whitened_resids_match_pint_tpu(kind):
    jr, tr = _resid_pair(kind)
    end_to_end = float(np.max(np.abs(tr.calc_whitened_resids()
                                     - np.asarray(jr.calc_whitened_resids()))))
    # the same residuals: pint_tpu's, in the port's residual cache
    tr._phase_resids = np.asarray(jr.phase_resids, np.float64)
    wj = np.asarray(jr.calc_whitened_resids())
    wt = tr.calc_whitened_resids()
    gap = float(np.max(np.abs(wt - wj)))
    print(f"whitened residuals ({kind}) vs pint_tpu: {gap:.3e} on the same "
          f"residuals (bar {WHITE_TOL}), {end_to_end:.3e} end to end (bar "
          f"{WHITE_END_TO_END_TOL}); rms {np.std(wt):.4f}")
    assert gap <= WHITE_TOL and end_to_end <= WHITE_END_TO_END_TOL
    ks_j, ks_t = jr.normality("ks"), tr.normality("ks")
    assert ks_t == pytest.approx(ks_j, rel=STAT_TOL)
    ad_j, ad_t = jr.normality("ad"), tr.normality("ad")
    assert ad_t[0] == pytest.approx(ad_j[0], rel=STAT_TOL)
    assert np.allclose(ad_t[1], ad_j[1], rtol=STAT_TOL, atol=0)
    print(f"KS {ks_t}, AD {ad_t[0]}")
    with pytest.raises(ValueError):
        tr.normality("chi2")


@pytest.fixture(scope="module")
def grid_pair():
    jm, jt = data.load_jax(data.REF_TIM, grid=True)
    tm, tt = data.load_torch(data.REF_TIM, grid=True)
    return JWLSFitter(jt, jm), WLSFitter(tt, tm, device="cpu")


M2S = np.array([0.23, 0.25, 0.27])
SINIS = np.array([0.97, 0.99, 0.995])


def _identity(i):
    return lambda *pt: pt[i]


def test_grid_wrappers_match_flat_and_pint_tpu(grid_pair):
    from pint_tpu import gridutils as jg
    from pint_tpu_torch import gridutils as tg

    jf, tf = grid_pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        flat = tg.grid_chisq_flat(tf, data.GRID, maxiter=2)
        g, grids = tg.grid_chisq(tf, ["M2", "SINI"], [M2S, SINIS])
        d, pvals = tg.grid_chisq_derived(
            tf, ["M2", "SINI"], [_identity(0), _identity(1)], [M2S, SINIS])
        pts = list(zip(data.GRID["M2"], data.GRID["SINI"]))
        t, dof = tg.tuple_chisq(tf, ["M2", "SINI"], pts)
        jgrid, _ = jg.grid_chisq(jf, ["M2", "SINI"], [M2S, SINIS])
        jd, _ = jg.grid_chisq_derived(
            jf, ["M2", "SINI"], [_identity(0), _identity(1)], [M2S, SINIS])
        jt, jdof = jg.tuple_chisq(jf, ["M2", "SINI"], pts)
    # the bench grid's flat order is the outer product's row-major order
    assert np.array_equal(grids[0].ravel(), data.GRID["M2"])
    assert np.array_equal(grids[1].ravel(), data.GRID["SINI"])
    assert g.shape == d.shape == (3, 3) and t.shape == (9,)
    assert np.array_equal(g.ravel(), flat)
    assert np.array_equal(d.ravel(), flat)
    assert np.array_equal(t, flat)
    assert np.array_equal(pvals[0], grids[0]) and \
        np.array_equal(pvals[1], grids[1])
    assert dof == jdof == tf.resids.dof
    gaps = [float(np.max(np.abs(a.ravel() / np.asarray(b).ravel() - 1.0)))
            for a, b in ((g, jgrid), (d, jd), (t, jt))]
    with open(data.REF_JSON) as f:
        stored = np.asarray(json.load(f)["chi2"])
    print(f"grid_chisq / grid_chisq_derived / tuple_chisq vs pint_tpu's: "
          f"{gaps} (bar {GRID_TOL}); vs the stored grid "
          f"{float(np.max(np.abs(flat / stored - 1.0))):.3e}")
    assert max(gaps) <= GRID_TOL
