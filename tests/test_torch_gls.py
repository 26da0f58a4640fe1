"""pint_tpu_torch's GLS fit vs pint_tpu's, on the committed GLS set.

The GLS set (``tests/data/dd_gls_sim_200.tim``, ``dd_noise_realistic_par(
dmx_bins=8)``) and pint_tpu's eager ``GLSFitter.fit_toas(maxiter=3)``
from the perturbed DD start, stored beside it
(``dd_gls_sim_200_gls_fit.json``, with its per-component noise
realizations).  With the port on the CPU:

* ``gls_solve`` with and without the ECORR Schur elimination: against
  an independent dense SVD solve of the same system (step within 1e-6
  of its uncertainty, uncertainties within 1e-8 relative); against
  pint_tpu's (its numpy ``xp``) on the same assembly within pint_tpu's
  conditioning bound, 10 eps x condition: ~1e-6 with DM frozen, ~5e-2
  on the full system, whose DM/offset/FD direction pint_tpu's
  normal-matrix eigh resolves only to ~1e-3; chi2 within 1e-10
  relative;
* the dense full-covariance step against the basis step: the same step
  (1e-6 sigma), uncertainties (1e-8 relative) and chi2 (1e-10);
* ``GLSFitter.fit_toas(maxiter=3)`` against the stored fit: values within
  1e-3 sigma, uncertainties within 1e-3 relative, chi2 within 1e-6
  relative (the bars of ``test_cpu_tpu_fit_parity``); the same status,
  iterations and rung;
* the fit's ``noise_resids`` within 1e-4 of the realizations' rms;
* without correlated noise the GLS fit equals the WLS fit at the fit
  bars (the two solve by eigenvalues and by SVD respectively).
"""

import json
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu_torch.fitter import (GLSFitter, WLSFitter,
                                   build_gls_fullcov_step, build_gls_step,
                                   build_whitened_assembly, gls_solve)

STEP_SIGMA_TOL = 1e-6
COV_TOL = 1e-8
SOLVE_CHI2_TOL = 1e-10
FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
CHI2_TOL = 1e-6
#: the noise realizations share the offset direction (the ECORR epochs'
#: columns sum to the offset column), which lies in the near-degenerate
#: DM/offset/FD subspace that pint_tpu's eigh resolves to ~1e-3 sigma
NOISE_TOL = 1e-4
F64 = torch.float64


@pytest.fixture(scope="module")
def ref():
    with open(data.GLS_REF_JSON) as f:
        return json.load(f)


def _start(ref=None):
    model, toas = data.load_torch(data.GLS_REF_TIM,
                                  par=data.dd_gls_par_lines())
    data.perturb_dd(model)
    if ref is not None:
        assert data.device_values(model, ref["fit_params"]) == ref["start"]
    return model, toas


def _system(freeze=()):
    """The port's whitened assembly at the fit's start, and the noise
    basis, weights and ECORR block, on the CPU (``freeze``: parameters
    held out of the fit)."""
    model, toas = _start()
    for n in freeze:
        model[n].frozen = True
    fitter = GLSFitter(toas, model, device="cpu")
    names = fitter.fit_params
    p = fitter.resids.pdict
    asm = build_whitened_assembly(model, fitter.resids.batch, names,
                                  fitter.track_mode, include_offset=True)
    with torch.no_grad():
        r, M, sigma, offc = asm.inline(torch.zeros(len(names), dtype=F64), p)
        U, phi = model.noise_basis(p), model.noise_weights(p)
    return dict(model=model, fitter=fitter, names=names, p=p, r=r, M=M,
                sigma=sigma, offc=offc, U=U, phi=phi,
                esl=model.ecorr_block(p))


@pytest.fixture(scope="module")
def system():
    return _system()


def _dense_truth(s):
    """The same GLS step by an independent route: numpy's SVD least
    squares of the whitened, column-normalized [M | U] stacked on the
    square root of the prior (no Schur elimination)."""
    a = {k: s[k].numpy() for k in ("r", "M", "sigma", "U", "phi")}
    Mf = np.concatenate([a["M"], a["U"]], axis=1) / a["sigma"][:, None]
    norms = np.sqrt(np.sum(Mf**2, axis=0))
    ntm = a["M"].shape[1]
    prior = np.concatenate([np.zeros(ntm), 1.0 / a["phi"]]) / norms**2
    B = np.concatenate([Mf / norms, np.diag(np.sqrt(prior))])
    rhs = np.concatenate([a["r"] / a["sigma"], np.zeros(len(norms))])
    u, sv, vt = np.linalg.svd(B, full_matrices=False)
    npar = len(s["names"])
    x = (vt.T @ ((u.T @ rhs) / sv)) / norms
    cov = (vt.T / sv**2) @ vt / np.outer(norms, norms)
    return {"dx": x[:npar], "sd": np.sqrt(np.diag(cov))[:npar],
            "kappa": float(sv[0]**2 / sv[-1]**2)}


def _sd(out):
    Sn = np.asarray(out["Sigma_n"], np.float64)
    return np.sqrt(np.diag(Sn)) / np.asarray(out["norms"], np.float64)


def _compare(a, b, label):
    """(step gap in b's sigma, covariance diagonal gap, chi2 gap)."""
    sd_a, sd_b = _sd(a), _sd(b)
    dx = np.max(np.abs(np.asarray(a["dx"]) - np.asarray(b["dx"])) / sd_b)
    cov = np.max(np.abs(sd_a**2 / sd_b**2 - 1.0))
    chi2 = abs(float(a["chi2"]) / float(b["chi2"]) - 1.0)
    print(f"{label}: step {dx:.3e} sigma, covariance diagonal {cov:.3e}, "
          f"chi2 {chi2:.3e}")
    return dx, cov, chi2


@pytest.mark.parametrize("schur", [True, False])
def test_gls_solve_matches_dense_truth(system, schur):
    """On the full system the port's solve is the well-conditioned one:
    within 1e-6 sigma (step) and 1e-8 (uncertainties) of an independent
    dense SVD solve."""
    s = system
    npar = len(s["names"])
    with torch.no_grad():
        got = gls_solve(s["r"], s["M"], s["sigma"], s["offc"], s["U"],
                        s["phi"], s["esl"] if schur else None, npar)
    t = _dense_truth(s)
    dx = float(np.max(np.abs(got["dx"].numpy() - t["dx"]) / t["sd"]))
    unc = float(np.max(np.abs(_sd(got) / t["sd"] - 1.0)))
    print(f"gls_solve (schur={schur}) vs dense SVD: step {dx:.3e} sigma, "
          f"uncertainties {unc:.3e}; normal-matrix condition "
          f"{t['kappa']:.3e}")
    assert dx <= STEP_SIGMA_TOL and unc <= COV_TOL


@pytest.mark.parametrize("schur", [True, False])
@pytest.mark.parametrize("case", ["well_conditioned", "full"])
def test_gls_solve_matches_jax(system, schur, case):
    """Against pint_tpu's gls_solve (numpy xp) on the same inputs, held
    to 10 eps x the normal matrix's condition (printed): pint_tpu
    eigendecomposes the normal matrix, which is good to ~eps x condition.
    With DM frozen the condition is ~5e8 (bar ~1e-6); on the full system
    it is ~2e13 (DM, the offset and FD1-4 over three receivers)."""
    from pint_tpu.fitter import gls_solve as j_gls_solve

    s = system if case == "full" else _system(freeze=("DM",))
    esl = s["esl"] if schur else None
    assert s["esl"] == (0, data.NTOAS // 4)
    npar = len(s["names"])
    with torch.no_grad():
        got = gls_solve(s["r"], s["M"], s["sigma"], s["offc"], s["U"],
                        s["phi"], esl, npar)
    a = {k: s[k].numpy() for k in ("r", "M", "sigma", "offc", "U", "phi")}
    want = j_gls_solve(np, a["r"], a["M"], a["sigma"], a["offc"], a["U"],
                       a["phi"], esl, npar)
    kappa = _dense_truth(s)["kappa"]
    bound = 10.0 * np.finfo(np.float64).eps * kappa
    dx, cov, chi2 = _compare(got, want, f"{case}: gls_solve "
                             f"(schur={schur}) vs pint_tpu, condition "
                             f"{kappa:.2e}, bar {bound:.1e}")
    assert int(got["n_bad"]) == int(want["n_bad"])
    assert dx <= bound and cov <= bound and chi2 <= SOLVE_CHI2_TOL


def test_schur_path_matches_full_path(system):
    s = system
    npar = len(s["names"])
    args = (s["r"], s["M"], s["sigma"], s["offc"], s["U"], s["phi"])
    with torch.no_grad():
        schur = gls_solve(*args, s["esl"], npar)
        full = gls_solve(*args, None, npar)
    dx, cov, chi2 = _compare(schur, full, "Schur vs full")
    assert dx <= STEP_SIGMA_TOL and cov <= COV_TOL and chi2 <= SOLVE_CHI2_TOL
    amp = schur["noise_ampls"] - full["noise_ampls"]
    assert float(torch.max(torch.abs(amp))) <= 1e-6 * float(
        torch.max(torch.abs(full["noise_ampls"])))


def test_fullcov_step_matches_basis_step(system):
    s = system
    fitter = s["fitter"]
    kw = dict(fit_params=s["names"], track_mode=fitter.track_mode)
    x = np.zeros(len(s["names"]))
    basis = build_gls_step(s["model"], fitter.resids.batch, **kw)(x, s["p"])
    dense = build_gls_fullcov_step(s["model"], fitter.resids.batch,
                                   **kw)(x, s["p"])
    assert "noise_ampls" in basis and "noise_ampls" not in dense
    dx, cov, chi2 = _compare(dense, basis, "full-cov vs basis step")
    assert dx <= STEP_SIGMA_TOL and cov <= COV_TOL and chi2 <= SOLVE_CHI2_TOL


@pytest.fixture(scope="module")
def fitted(ref):
    model, toas = _start(ref)
    fitter = GLSFitter(toas, model, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=data.DD_MAXITER)
    return model, fitter, chi2


def test_gls_fit_matches_jax(ref, fitted):
    model, fitter, chi2 = fitted
    assert fitter.fit_params == ref["fit_params"]
    dev = max(abs(float(np.sum(np.asarray(model[n].device_value)
                               - np.asarray(v))))
              / ref["uncertainties"][n] for n, v in ref["values"].items())
    unc = max(abs(model[n].device_uncertainty / u - 1.0)
              for n, u in ref["uncertainties"].items())
    gap = abs(chi2 / ref["chi2"] - 1.0)
    fr = fitter.fitresult
    print(f"GLS fit: {dev:.3e} sigma, uncertainties {unc:.3e}, chi2 "
          f"{chi2!r} vs {ref['chi2']!r} ({gap:.3e}); {fr.status.name} "
          f"after {fr.iterations} on {fr.rung}; seconds "
          f"{fitter.fit_info['seconds']}")
    assert dev <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
    assert (fr.status.name, fr.iterations, fr.rung) == (
        ref["status"], ref["iterations"], ref["rung"])
    assert set(fitter.fit_info["seconds"]) == {"steps", "assemble", "solve",
                                               "write_back"}
    # the written-back model records the Woodbury chi2 of its residuals
    # (to the four decimals of the par record)
    assert model.CHI2.value == f"{fitter.resids.calc_chi2():.4f}"


def test_noise_resids_match_jax(ref, fitted):
    _, fitter, _ = fitted
    assert set(fitter.noise_resids) == set(ref["noise_resids"])
    for name, want in ref["noise_resids"].items():
        want = np.asarray(want)
        got = fitter.noise_resids[name]
        gap = float(np.max(np.abs(got - want)) / np.std(want))
        print(f"{name}: realization rms {np.std(want) * 1e6:.4f} us, max "
              f"gap {gap:.3e} of it (bar {NOISE_TOL})")
        assert gap <= NOISE_TOL
        assert fitter.noise_ampls[name].shape == (
            (data.NTOAS // 4,) if name == "EcorrNoise" else (60,))


def test_gls_without_correlated_noise_is_wls():
    """GLSFitter on the DD set (no noise components) gives WLSFitter's
    eager fit."""
    out = {}
    for cls in (GLSFitter, WLSFitter):
        model, toas = data.load_torch(data.DD_REF_TIM,
                                      par=data.dd_par_lines())
        data.perturb_dd(model)
        f = cls(toas, model, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out[cls.__name__] = (f.fit_toas(maxiter=2), {
                n: model[n].device_uncertainty for n in f.fit_params})
        assert f.noise_resids == {}
    (cg, ug), (cw, uw) = out["GLSFitter"], out["WLSFitter"]
    print(f"no correlated noise: GLS chi2 {cg!r}, WLS chi2 {cw!r}")
    assert abs(cg / cw - 1.0) <= CHI2_TOL
    assert max(abs(ug[n] / uw[n] - 1.0) for n in uw) <= UNC_TOL


@pytest.mark.slow
def test_committed_gls_reference_is_current(tmp_path, ref):
    """Re-simulate the GLS set and re-fit it with pint_tpu: the committed
    files are what ``python tests/torch_port_data.py`` writes."""
    tim = data.write_dd_gls_sim_tim(str(tmp_path / "gls.tim"))
    with open(tim) as a, open(data.GLS_REF_TIM) as b:
        assert a.read() == b.read()
    rec = data.jax_gls_fit(tim)
    assert rec["chi2"] == ref["chi2"]
    assert rec["values"] == ref["values"]
