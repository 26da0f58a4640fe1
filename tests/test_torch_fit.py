"""pint_tpu_torch design matrix, WLS solve and chi2 grid vs pint_tpu.

On the small simulated J0740-class set of :mod:`torch_port_data` (the
par of ``j0740_realistic_par(dmx_bins=8)``, 200 TOAs), with the port on
the CPU:

* design-matrix columns: the port's word-level autodiff through its
  plain quad-single phase, and its fit path (whose phase tangent is the
  kernel's float64 rule with pint_tpu's secant spin frequency, ROADMAP.md
  queue C), are both <= 1e-10 relative to pint_tpu's;
* the port's split and full assembly paths agree to <= 1e-12 (the bar
  of tests/test_design_split.py);
* one WLS solve on the same inputs: offsets within 1e-3 sigma and
  covariance within 1e-3 relative (the fit-parity bars of ROADMAP.md);
* the bench's 3x3 M2/SINI ``grid_chisq_flat`` chi2 is <= 1e-6 relative
  to ``pint_tpu.gridutils.grid_chisq_flat``, through either WLS kernel;
* the committed copy of the set and of pint_tpu's grid chi2 on it
  (``tests/data/``, which ``chip_smoke.py`` holds the card against) are
  what pint_tpu computes today.
"""

import json

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.fitter import build_whitened_assembly as j_assembly
from pint_tpu.fitter import fit_wls_eigh as j_eigh
from pint_tpu.fitter import fit_wls_svd as j_svd
from pint_tpu.gridutils import grid_chisq_flat as j_grid
from pint_tpu_torch import qs as tqs
from pint_tpu_torch.fitter import WLSFitter as TWLSFitter
from pint_tpu_torch.fitter import build_whitened_assembly as t_assembly
from pint_tpu_torch.fitter import fit_wls_eigh as t_eigh
from pint_tpu_torch.fitter import fit_wls_svd as t_svd
from pint_tpu_torch.gridutils import grid_chisq_flat as t_grid
from pint_tpu_torch.models.timing_model import pv

COL_TOL = 1e-10
SPLIT_FULL_TOL = 1e-12
FIT_SIGMA_TOL = 1e-3
CHI2_TOL = 1e-6
F64 = torch.float64


@pytest.fixture(scope="module")
def fitters(tmp_path_factory):
    tim = data.sim_tim(tmp_path_factory)
    jm, jt = data.load_jax(tim, grid=True)
    tm, tt = data.load_torch(tim, grid=True)
    return dict(tim=tim, jf=JWLSFitter(jt, jm),
                tf=TWLSFitter(tt, tm, device="cpu"))


@pytest.fixture(scope="module")
def jax_design(fitters):
    """pint_tpu's (r, M, sigma) at x = 0, split path (one JAX build)."""
    import jax.numpy as jnp

    jf = fitters["jf"]
    asm = j_assembly(jf.model, jf.resids.batch, jf.fit_params,
                     jf.track_mode, include_offset=True,
                     design_matrix="split")
    out = asm.inline(jnp.zeros(len(jf.fit_params)), jf.resids.pdict)
    return tuple(np.asarray(v) for v in out[:3])


@pytest.fixture(scope="module")
def jax_grid_chi2(fitters):
    return j_grid(fitters["jf"], data.GRID, maxiter=2, kernel=j_svd)


def _port_design(tf, mode):
    asm = t_assembly(tf.model, tf.resids.batch, tf.fit_params,
                     tf.track_mode, include_offset=True, design_matrix=mode)
    r, M, sigma, _ = asm.inline(torch.zeros(len(tf.fit_params), dtype=F64),
                                tf.resids.pdict)
    return r.numpy(), M.numpy(), sigma.numpy()


def _word_design(tf):
    """-d(resid)/dx by torch.func.jacfwd through the plain quad-single
    phase (:meth:`PhaseCalc.phase`): word-level autodiff, as pint_tpu."""
    model, batch, names = tf.model, tf.resids.batch, tf.fit_params
    calc = model.calc

    def resid_sec(x, p):
        p2 = model.with_x(p, x, names)
        _, frac = tqs.round_nearest(calc.phase(p2, batch))
        return tqs.to_f64(frac) / pv(p2, "F0")

    x0 = torch.zeros(len(names), dtype=F64)
    return -torch.func.jacfwd(resid_sec)(x0, tf.resids.pdict).numpy()


def _rel_cols(a, b):
    """max over columns of max|a - b| / max|b|."""
    scale = np.maximum(np.max(np.abs(b), axis=0), 1e-300)
    return float(np.max(np.max(np.abs(a - b), axis=0) / scale))


def test_word_autodiff_columns_match_jax(fitters, jax_design):
    """Like for like: word-level autodiff in both packages."""
    Mw = _word_design(fitters["tf"])
    jM = jax_design[1][:, :Mw.shape[1]]
    rel = _rel_cols(Mw, jM)
    print(f"word autodiff: {Mw.shape[1]} columns, max relative gap "
          f"{rel:.3e} (bar {COL_TOL:.0e})")
    assert rel <= COL_TOL


@pytest.mark.parametrize("mode", ["split", "full"])
def test_design_matrix_matches_jax(fitters, jax_design, mode):
    """The fit path's design matrix (offset column included), residuals
    and sigma against pint_tpu's."""
    tf = fitters["tf"]
    assert tf.fit_params == fitters["jf"].fit_params
    jr, jM, js = jax_design
    tr, tM, ts = _port_design(tf, mode)
    assert tM.shape == jM.shape
    rel = _rel_cols(tM, jM)
    print(f"{mode}: {tM.shape[1]} columns, max relative gap {rel:.3e} "
          f"(bar {COL_TOL:.0e}); residual gap "
          f"{np.max(np.abs(tr - jr)):.3e} s")
    assert rel <= COL_TOL
    assert np.max(np.abs(tr - jr)) <= 1e-9
    np.testing.assert_array_equal(ts, js)


def test_split_vs_full(fitters):
    """The port's split assembly (cached linear columns + nonlinear
    jacfwd) against one jacfwd over every parameter."""
    _, Ms, _ = _port_design(fitters["tf"], "split")
    _, Mf, _ = _port_design(fitters["tf"], "full")
    rel = _rel_cols(Ms, Mf)
    print(f"split vs full: max relative gap {rel:.3e} "
          f"(bar {SPLIT_FULL_TOL:.0e})")
    assert rel <= SPLIT_FULL_TOL


@pytest.mark.parametrize("kernel", ["svd", "eigh"])
def test_wls_solve_matches_jax(jax_design, kernel):
    """One whitened WLS solve on the same (r, M, sigma)."""
    import jax.numpy as jnp

    jr, jM, js = jax_design
    jk, tk = (j_svd, t_svd) if kernel == "svd" else (j_eigh, t_eigh)
    jd, jS, jn, jbad = jk(jnp.asarray(jM), jnp.asarray(jr), jnp.asarray(js))
    td, tS, tn, tbad = tk(*(torch.as_tensor(a) for a in (jM, jr, js)))
    jS = np.asarray(jS)
    sig = np.sqrt(np.diag(jS)) / np.asarray(jn)
    dev = float(np.max(np.abs(td.numpy() - np.asarray(jd)) / sig))
    cov = float(np.max(np.abs(tS.numpy() - jS)) / np.max(np.abs(jS)))
    print(f"{kernel}: max |d dx| = {dev:.3e} sigma; covariance gap "
          f"{cov:.3e} of its largest entry; n_bad {int(tbad)}")
    assert int(tbad) == int(jbad)
    assert dev <= FIT_SIGMA_TOL
    assert cov <= FIT_SIGMA_TOL


@pytest.mark.parametrize("kernel", ["svd", "eigh"])
def test_grid_chisq_matches_jax(fitters, jax_grid_chi2, kernel):
    """The 3x3 M2/SINI grid, maxiter=2: SVD is what both packages pick on
    the CPU, eigh what the port picks on CUDA."""
    kern = t_svd if kernel == "svd" else t_eigh
    chi2 = t_grid(fitters["tf"], data.GRID, maxiter=2, kernel=kern)
    rel = float(np.max(np.abs(chi2 - jax_grid_chi2) / jax_grid_chi2))
    print(f"grid chi2 ({kernel}) {np.round(chi2, 6).tolist()}; max relative "
          f"gap {rel:.3e} (bar {CHI2_TOL:.0e})")
    assert chi2.shape == (9,) and np.all(np.isfinite(chi2))
    assert rel <= CHI2_TOL


def test_committed_reference_is_current(fitters, jax_grid_chi2):
    """tests/data holds the tim text torch_port_data writes today and
    pint_tpu's grid chi2 on it."""
    with open(fitters["tim"]) as f, open(data.REF_TIM) as g:
        assert f.read() == g.read()
    with open(data.REF_JSON) as f:
        ref = json.load(f)
    assert ref["grid"] == {k: v.tolist() for k, v in data.GRID.items()}
    assert ref["fit_params"] == fitters["jf"].fit_params
    np.testing.assert_allclose(ref["chi2"], jax_grid_chi2, rtol=1e-12)
