"""pint_tpu_torch's noise model vs pint_tpu's, on the committed GLS set.

The GLS set (``tests/data/dd_gls_sim_200.tim``, the par of
``dd_noise_realistic_par(dmx_bins=8)``: EFAC/EQUAD/ECORR on three
receivers and power-law red noise, 50 epochs of four TOAs) is loaded by
both packages; with the port on the CPU and JAX on the CPU:

* the scaled uncertainties (EFAC/EQUAD) within 1e-12 relative;
* the ECORR epochs and quantization basis, the Fourier basis and its
  frequencies bit-equal; the prior weights within 1e-12 relative; the
  same ECORR column block; the same for PLDMNoise;
* the converted pint_tpu params dict gives the port's noise basis,
  weights and ECORR block; the host solve's basis (``_host_noise_basis``)
  equals pint_tpu's bit for bit;
* the Woodbury chi2 and log-determinant on the same residuals within
  1e-10 relative, and the residuals' chi2 and log-likelihood end to end
  within 1e-6 (the fit's chi2 bar);
* the Woodbury, Sherman-Morrison, split-Woodbury and ECORR-inverse
  products against dense algebra (1e-10 relative) and against pint_tpu's
  numpy versions;
* ``add_correlated_noise`` with the same seed shifts the TOAs as
  pint_tpu's does, within 1 ns.
"""

import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.residuals import Residuals as TResiduals

SIGMA_TOL = 1e-12
WEIGHT_TOL = 1e-12
CHI2_TOL = 1e-10
FIT_CHI2_TOL = 1e-6
DENSE_TOL = 1e-10
TOA_TOL_S = 1e-9
F64 = torch.float64


@pytest.fixture(scope="module")
def gls_pair():
    par = data.dd_gls_par_lines()
    jm, jt = data.load_jax(data.GLS_REF_TIM, par=par)
    tm, tt = data.load_torch(data.GLS_REF_TIM, par=par)
    return dict(jm=jm, jt=jt, tm=tm, tt=tt, jr=JResiduals(jt, jm),
                tr=TResiduals(tt, tm, device="cpu"))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_noise_components_match(gls_pair):
    jm, tm = gls_pair["jm"], gls_pair["tm"]
    names = [type(c).__name__ for c in tm.noise_components]
    assert names == [type(c).__name__ for c in jm.noise_components] == [
        "ScaleToaError", "EcorrNoise", "PLRedNoise"]
    assert tm.has_correlated_errors and jm.has_correlated_errors
    assert [type(c).__name__ for c in tm.correlated_noise_components] == [
        "EcorrNoise", "PLRedNoise"]


def test_scaled_sigma_matches_jax(gls_pair):
    want = np.asarray(gls_pair["jr"].get_data_error())
    got = gls_pair["tr"].get_data_error()
    rel = float(np.max(np.abs(got / want - 1.0)))
    print(f"scaled sigma: max relative gap {rel:.3e} (bar {SIGMA_TOL}); "
          f"range {want.min():.4f}-{want.max():.4f} us")
    assert rel <= SIGMA_TOL
    assert not np.allclose(want, 1.0)   # EFAC/EQUAD took effect


def test_ecorr_epochs_match_jax():
    from pint_tpu.models.noise_model import ecorr_epochs as j_epochs
    from pint_tpu_torch.models.noise_model import ecorr_epochs as t_epochs

    rng = np.random.default_rng(5)
    t = np.concatenate([rng.uniform(0, 1e5, 40),
                        (rng.uniform(0, 1e5, 40)[:, None]
                         + rng.uniform(0, 0.9, (40, 3))).ravel()])
    rng.shuffle(t)
    j, tt = j_epochs(t), t_epochs(t)
    assert len(j) == len(tt) and len(j) >= 40
    for a, b in zip(j, tt):
        np.testing.assert_array_equal(a, b)


def test_noise_leaves_match_jax(gls_pair):
    """The basis blocks, frequencies and column maps: bit-equal."""
    jp, tp = gls_pair["jr"].pdict, gls_pair["tr"].pdict
    keys = [k for k in jp["const"] if k.startswith("__noise")]
    assert sorted(keys) == sorted(k for k in tp["const"]
                                  if k.startswith("__noise"))
    assert len(keys) == 4
    for k in keys:
        a, b = np.asarray(jp["const"][k]), _np(tp["const"][k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    U = _np(gls_pair["tm"].noise_basis(tp))
    print(f"noise basis {U.shape}: ECORR columns "
          f"{np.asarray(jp['const']['__noisebasis_EcorrNoise__']).shape[1]}")
    assert U.shape == (data.NTOAS, data.NTOAS // 4 + 60)


def test_noise_weights_match_jax(gls_pair):
    jm, tm = gls_pair["jm"], gls_pair["tm"]
    want = np.asarray(jm.noise_weights(gls_pair["jr"].pdict))
    got = _np(tm.noise_weights(gls_pair["tr"].pdict))
    rel = float(np.max(np.abs(got / want - 1.0)))
    print(f"noise weights ({len(want)}): max relative gap {rel:.3e} "
          f"(bar {WEIGHT_TOL})")
    assert rel <= WEIGHT_TOL


def test_ecorr_block_matches_jax(gls_pair):
    jb = gls_pair["jm"].ecorr_block(gls_pair["jr"].pdict)
    tb = gls_pair["tm"].ecorr_block(gls_pair["tr"].pdict)
    assert tuple(tb) == tuple(jb) == (0, data.NTOAS // 4)


def test_host_noise_basis_matches_jax(gls_pair):
    """The host solve's basis from a params dict: pint_tpu's, bit for
    bit, and the port's device basis."""
    from pint_tpu.fitter import _host_noise_basis as j_host
    from pint_tpu_torch.fitter import _host_noise_basis as t_host

    tp = gls_pair["tr"].pdict
    got = t_host(gls_pair["tm"], tp)
    np.testing.assert_array_equal(got, j_host(gls_pair["jm"],
                                              gls_pair["jr"].pdict))
    np.testing.assert_array_equal(got, _np(gls_pair["tm"].noise_basis(tp)))


def test_converted_pdict_gives_the_same_noise(gls_pair):
    """pdict_from_numpy of pint_tpu's params dict carries the basis
    blocks, frequencies and column maps across: the port's noise basis,
    weights and ECORR block from it equal those from its own build."""
    from pint_tpu_torch.convert import pdict_from_numpy

    tm, tp = gls_pair["tm"], gls_pair["tr"].pdict
    conv = pdict_from_numpy(data.tree_numpy(gls_pair["jr"].pdict),
                            device="cpu")
    assert torch.equal(tm.noise_basis(conv), tm.noise_basis(tp))
    assert torch.equal(tm.noise_weights(conv), tm.noise_weights(tp))
    assert tm.ecorr_block(conv) == tm.ecorr_block(tp)
    cm = "__noisecolmap_EcorrNoise__"
    assert conv["const"][cm].dtype == torch.int32


def test_pldm_noise_matches_jax():
    par = data.dd_gls_par_lines() + ["TNDMAMP -13.2", "TNDMGAM 2.5",
                                     "TNDMC 10"]
    jm, jt = data.load_jax(data.GLS_REF_TIM, par=par)
    tm, tt = data.load_torch(data.GLS_REF_TIM, par=par)
    jp = JResiduals(jt, jm).pdict
    tp = TResiduals(tt, tm, device="cpu").pdict
    k = "__noisebasis_PLDMNoise__"
    np.testing.assert_array_equal(np.asarray(jp["const"][k]),
                                  _np(tp["const"][k]))
    want = np.asarray(jm.noise_weights(jp))
    got = _np(tm.noise_weights(tp))
    assert got.shape == (20 + 60 + data.NTOAS // 4,)
    rel = float(np.max(np.abs(got / want - 1.0)))
    print(f"with PLDMNoise: weights max relative gap {rel:.3e}")
    assert rel <= WEIGHT_TOL


def test_residual_chi2_and_lnlikelihood_match_jax(gls_pair):
    """The Woodbury quadratic and log-determinant on pint_tpu's residuals
    within 1e-10 relative; the residuals' own chi2 and log-likelihood
    end to end within the fit's chi2 bar (each side's residuals carry
    ~1e-13 s of rounding, which moves chi2 at ~1e-8 relative)."""
    jr, tr = gls_pair["jr"], gls_pair["tr"]
    r = np.asarray(jr.time_resids)
    want = jr._gaussian_quadratic(r)
    got = tr._gaussian_quadratic(r)
    for what, a, b in zip(("r^T C^-1 r", "logdet C"), got, want):
        rel = abs(float(a) / float(b) - 1.0)
        print(f"{what} on the same residuals: relative gap {rel:.3e} "
              f"(bar {CHI2_TOL})")
        assert rel <= CHI2_TOL
    for what in ("calc_chi2", "lnlikelihood"):
        want = float(getattr(jr, what)())
        got = float(getattr(tr, what)())
        rel = abs(got / want - 1.0)
        print(f"{what}: port {got!r}, pint_tpu {want!r}, relative gap "
              f"{rel:.3e} (bar {FIT_CHI2_TOL})")
        assert rel <= FIT_CHI2_TOL


def _dense_system(seed=3, n=120, k_ecorr=25, k_red=12):
    """White noise, a disjoint ECORR block and a dense Fourier-like
    block, and the dense covariance."""
    rng = np.random.default_rng(seed)
    N = rng.uniform(0.5, 2.0, n) ** 2
    Ue = np.zeros((n, k_ecorr))
    for j, rows in enumerate(np.array_split(rng.permutation(n)[:100],
                                            k_ecorr)):
        Ue[rows, j] = 1.0
    Uf = rng.standard_normal((n, k_red))
    phie = rng.uniform(0.1, 2.0, k_ecorr)
    phif = rng.uniform(0.1, 5.0, k_red)
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    C = np.diag(N) + (Ue * phie) @ Ue.T + (Uf * phif) @ Uf.T
    return N, Ue, phie, Uf, phif, x, y, C


def test_woodbury_products_match_dense_and_jax():
    import pint_tpu.utils as ju
    import pint_tpu_torch.utils as tu

    N, Ue, phie, Uf, phif, x, y, C = _dense_system()
    U = np.concatenate([Ue, Uf], axis=1)
    phi = np.concatenate([phie, phif])
    dot_d = x @ np.linalg.solve(C, y)
    logdet_d = np.linalg.slogdet(C)[1]
    t = torch.from_numpy
    got = {
        "woodbury_dot": tu.woodbury_dot(t(N), t(U), t(phi), t(x), t(y)),
        "woodbury_dot_split": tu.woodbury_dot_split(
            t(N), t(Ue), t(phie), t(Uf), t(phif), t(x), t(y)),
    }
    ref = {
        "woodbury_dot": ju.woodbury_dot(N, U, phi, x, y),
        "woodbury_dot_split": ju.woodbury_dot_split(N, Ue, phie, Uf, phif,
                                                    x, y),
    }
    for name, (dot, logdet) in got.items():
        gaps = (abs(float(dot) / dot_d - 1.0),
                abs(float(logdet) / logdet_d - 1.0),
                abs(float(dot) / float(ref[name][0]) - 1.0),
                abs(float(logdet) / float(ref[name][1]) - 1.0))
        print(f"{name}: vs dense {gaps[0]:.2e}/{gaps[1]:.2e}, vs pint_tpu "
              f"{gaps[2]:.2e}/{gaps[3]:.2e} (bar {DENSE_TOL})")
        assert max(gaps) <= DENSE_TOL
    # Sherman-Morrison: the ECORR block alone, one weight
    Ce = np.diag(N) + 0.7 * Ue @ Ue.T
    dot, logdet = tu.sherman_morrison_dot(t(N), t(Ue), 0.7, t(x), t(y))
    jd, jl = ju.sherman_morrison_dot(N, Ue, 0.7, x, y)
    assert abs(float(dot) / (x @ np.linalg.solve(Ce, y)) - 1.0) <= DENSE_TOL
    assert abs(float(logdet) / np.linalg.slogdet(Ce)[1] - 1.0) <= DENSE_TOL
    assert abs(float(dot) / jd - 1.0) <= DENSE_TOL
    assert abs(float(logdet) / jl - 1.0) <= DENSE_TOL
    # the ECORR inverse applied to a vector and to a matrix
    Ce = np.diag(N) + (Ue * phie) @ Ue.T
    X = np.stack([x, y], axis=1)
    want = np.linalg.solve(Ce, X)
    for arg, w in ((X, want), (x, want[:, 0])):
        out = tu.ecorr_ninv_apply(t(N), t(Ue), t(phie), t(arg)).numpy()
        assert np.max(np.abs(out - w)) <= DENSE_TOL * np.max(np.abs(w))
        np.testing.assert_allclose(
            out, ju.ecorr_ninv_apply(N, Ue, phie, arg), rtol=1e-12,
            atol=1e-14 * np.max(np.abs(w)))


def test_add_correlated_noise_matches_jax():
    """The same TOAs shifted by the same seed's realization."""
    from pint_tpu.models import get_model as jget
    from pint_tpu.simulation import add_correlated_noise as j_add
    from pint_tpu.toa import get_TOAs as jtoas
    from pint_tpu_torch.mjd import diff_sec
    from pint_tpu_torch.models import get_model as tget
    from pint_tpu_torch.simulation import add_correlated_noise as t_add
    from pint_tpu_torch.toa import get_TOAs as ttoas

    par = data.dd_gls_par_lines()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, tm = jget(par), tget(par)
        jt = j_add(jtoas(data.GLS_REF_TIM, model=jm), jm, seed=9)
        tt = t_add(ttoas(data.GLS_REF_TIM, model=tm), tm, seed=9,
                   device="cpu")
    d = diff_sec(tt.utc, jt.utc)
    gap = float(np.max(np.abs(np.asarray(d.hi) + np.asarray(d.lo))))
    print(f"add_correlated_noise: max TOA gap {gap:.3e} s (bar "
          f"{TOA_TOL_S})")
    assert gap <= TOA_TOL_S


def test_epoch_toas_layout():
    """The GLS set's epochs: four sub-bands within ECORR's 1 s window, one
    receiver per epoch, receivers in turn."""
    from pint_tpu_torch.examples import RECEIVERS, epoch_toas

    mjds, band, freqs = epoch_toas(40)
    ep = mjds.reshape(10, 4)
    assert np.all((ep[:, -1] - ep[:, 0]) * 86400.0 < 1.0)
    assert np.all(np.diff(ep[:, 0]) > 1.0)
    b = band.reshape(10, 4)
    assert np.all(b == b[:, :1])
    assert list(b[:3, 0]) == list(RECEIVERS)
    with pytest.raises(ValueError):
        epoch_toas(41)
