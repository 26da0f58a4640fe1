"""pint_tpu_torch's CUDA kernels on the card (skipped without one).

These tests import neither jax nor pint_tpu, so they run on a machine
that has only PyTorch for CUDA; the root conftest imports jax, so run
them with it switched off, from the repository root::

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

* ``qs_phase_frac``: frac, slope, dt64 and words bit-identical to the
  plain version in every mode, one launch per call, no fallback;
* ``torch.func.vmap`` over ``jacfwd`` through ``QSPhaseFrac`` on the card
  gives the CPU plain version's values, one launch per primal;
* the chi2 grid on the card on the committed 200-TOA set within 1e-6
  relative of pint_tpu's stored chi2;
* ``kepler_E``: E within 1e-13 rad of the plain version, one launch per
  call, ``vmap(jacfwd)`` one launch per primal, no fallback;
* ``fit_toas`` on the card (the fused loop) on the committed 200-TOA DD
  set within the fit-parity bars of pint_tpu's stored eager fit;
* ``delay_chain``: the delay within 1e-12 s and its jacfwd columns within
  1e-10 relative of the plain component delays on the ELL1 and DD sets,
  one primal and one tangent launch per jacfwd, the DD orbit's E
  bit-equal to ``kepler_E``'s; refused inputs and components raise;
* ``GLSFitter.fit_toas`` on the card on the committed GLS set within the
  fit-parity bars of pint_tpu's stored GLS fit.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu_torch import qs as tqs
from pint_tpu_torch.kernels.qs_phase import PhaseSpec, QSPhaseFrac
from pint_tpu_torch.toabatch import split_f64_words

pytestmark = pytest.mark.cuda
N_ROWS, G_PTS = 4000, 3
F0, F1 = 346.53199992, -1.46e-15


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _words(x):
    return np.stack([np.float32(w) for w in
                     tqs.from_f64_host(np.float64(x)).words])


@pytest.fixture(scope="module")
def inputs():
    """Seeded J0740-scale rows: epochs over 4550 days, +-500 s shifts,
    spin offsets, other-phase rows, TZR words, pulse numbers."""
    rng = np.random.default_rng(20261016)
    t = torch.from_numpy
    spec = dict(tdb_day=t(rng.integers(52700, 57251, N_ROWS)),
                frac_w=t(split_f64_words(rng.uniform(-0.5, 0.5, N_ROWS))),
                pep_day=torch.tensor(55000.0, dtype=torch.float64),
                pep_w=t(_words(0.0)),
                f_w=t(np.stack([_words(F0), _words(F1)])),
                tzr_w=t(np.array([1.2345e6, 0.03125, 1e-9, 0.0], np.float32)),
                pulse_number=t(np.round(rng.uniform(-1e11, 1e11, N_ROWS))))
    cols = dict(shift=t(rng.uniform(-500, 500, (G_PTS, N_ROWS))),
                dF=t(rng.standard_normal((G_PTS, 2)) * np.array([1e-10,
                                                                 1e-20])),
                other=t(rng.uniform(-1e-2, 1e-2, (G_PTS, N_ROWS))))
    return spec, cols


def _spec(spec, mode, dev):
    return PhaseSpec(**{k: v.to(dev) for k, v in spec.items()}, mode=mode)


def test_kernel_bit_identical_to_plain(inputs):
    dev = _card()
    spec, cols = inputs
    c = [cols[k].to(dev) for k in ("shift", "dF", "other")]
    for mode in ("nearest", "use_pulse_numbers", "words"):
        s = _spec(spec, mode, dev)
        before = QSPhaseFrac.launches
        k = QSPhaseFrac.call(s, *c)
        torch.cuda.synchronize()
        assert QSPhaseFrac.launches == before + 1
        p = s.plain(*c)
        for name, a, b in zip(("out", "slope", "dt64"), k, p):
            assert torch.equal(a, b), (mode, name)


def test_no_fallback_on_card(inputs):
    dev = _card()
    spec, cols = inputs
    s = _spec(spec, "nearest", dev)
    with pytest.raises(ValueError):      # float32 rows: refused, not run
        QSPhaseFrac.call(s, cols["shift"].to(dev, torch.float32),
                         cols["dF"].to(dev), cols["other"].to(dev))
    with pytest.raises(ValueError):      # rows on another device
        QSPhaseFrac.call(s, cols["shift"].to(dev), cols["dF"],
                         cols["other"].to(dev))


def test_vmap_jacfwd_on_card(inputs):
    dev = _card()
    spec, cols = inputs
    s_cpu, s_dev = _spec(spec, "nearest", "cpu"), _spec(spec, "nearest", dev)

    def jac(s, sh, dF, ot):
        return torch.func.vmap(torch.func.jacfwd(
            lambda b, a, c: QSPhaseFrac.call(s, a, b, c)[0]))(dF, sh, ot)

    before = QSPhaseFrac.launches
    j_dev = jac(s_dev, *(cols[k].to(dev) for k in ("shift", "dF", "other")))
    torch.cuda.synchronize()
    assert QSPhaseFrac.launches == before + 1
    j_cpu = jac(s_cpu, cols["shift"], cols["dF"], cols["other"])
    assert torch.equal(j_dev.cpu(), j_cpu)


def test_grid_on_card_matches_reference():
    dev = _card()
    from pint_tpu_torch.examples import j0740_realistic_par
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.gridutils import grid_chisq_flat
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with open(data.REF_JSON) as f:
        ref = json.load(f)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(j0740_realistic_par(
            dmx_bins=data.DMX_BINS).splitlines())
        toas = get_TOAs(data.REF_TIM, model=model)
    model.M2.frozen = True
    model.SINI.frozen = True
    fitter = WLSFitter(toas, model)
    assert fitter.device.type == dev.type
    before = QSPhaseFrac.launches
    chi2 = grid_chisq_flat(fitter, {k: np.asarray(v) for k, v in
                                    ref["grid"].items()},
                           maxiter=ref["maxiter"])
    assert QSPhaseFrac.launches > before
    rel = float(np.max(np.abs(chi2 - ref["chi2"]) / np.asarray(ref["chi2"])))
    print(f"card grid chi2 vs pint_tpu: max relative gap {rel:.3e}")
    assert rel <= 1e-6


def _kepler_inputs(dev):
    rng = np.random.default_rng(20261017)
    M = torch.from_numpy(rng.uniform(0.0, 2.0 * np.pi, (5, 4096))).to(dev)
    e = torch.tensor([0.0, 1e-5, 0.1, 0.5, 0.9], dtype=torch.float64,
                     device=dev)[:, None]
    return M, e


def test_kepler_kernel_matches_plain():
    dev = _card()
    from pint_tpu_torch.kernels.kepler import KeplerE, kepler_E_op
    from pint_tpu_torch.models.binary_orbits import kepler_E

    M, e = _kepler_inputs(dev)
    before = KeplerE.launches
    k = kepler_E_op(M, e)
    torch.cuda.synchronize()
    assert KeplerE.launches == before + 1
    err = float(torch.max(torch.abs(k - kepler_E(M, e))))
    print(f"kepler_E on the card: max |E - E_plain| = {err:.3e} rad")
    assert err <= 1e-13
    with pytest.raises(ValueError):      # float32: refused, not run
        kepler_E_op(M.float(), e)
    with pytest.raises(ValueError):      # e on another device
        KeplerE.apply(M, e.cpu())


def test_kepler_vmap_jacfwd_on_card():
    dev = _card()
    from pint_tpu_torch.kernels.kepler import KeplerE, kepler_E_op
    from pint_tpu_torch.models.binary_orbits import kepler_E

    M, e = _kepler_inputs(dev)
    xs = torch.tensor([[1.0, 0.0], [1.01, 0.05]], dtype=torch.float64,
                      device=dev)

    def f(kep):
        return lambda x: kep(M[3] * x[0], e[3] + x[1])

    before = KeplerE.launches
    J = torch.func.vmap(torch.func.jacfwd(f(kepler_E_op)))(xs)
    torch.cuda.synchronize()
    assert KeplerE.launches == before + 1
    Jp = torch.func.vmap(torch.func.jacfwd(f(kepler_E)))(xs)
    rel = float(torch.max(torch.abs(J - Jp) / torch.abs(Jp)))
    assert rel <= 1e-12


def test_dd_fit_on_card_matches_reference():
    dev = _card()
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.kernels.delay_chain import DelayChain

    with open(data.DD_REF_JSON) as f:
        ref = json.load(f)
    model, toas = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    data.perturb_dd(model)
    fitter = WLSFitter(toas, model)
    assert fitter.device.type == dev.type and fitter._fused_ok()
    before = DelayChain.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=ref["maxiter"])
    # the DD orbit's Kepler solve runs inside the delay_chain kernel
    assert DelayChain.launches > before
    assert fitter.fitresult.rung == "fused"
    dev_sig = max(abs(float(np.sum(np.asarray(model[n].device_value)
                                   - np.asarray(v))))
                  / ref["uncertainties"][n] for n, v in ref["values"].items())
    unc = max(abs(model[n].device_uncertainty / u - 1.0)
              for n, u in ref["uncertainties"].items())
    gap = abs(chi2 - ref["chi2"]) / ref["chi2"]
    print(f"card DD fit vs pint_tpu: {dev_sig:.3e} sigma, unc {unc:.3e}, "
          f"chi2 {gap:.3e}")
    assert dev_sig <= 1e-3 and unc <= 1e-3 and gap <= 1e-6


@pytest.mark.parametrize("case", ["ELL1", "DD"])
def test_delay_chain_matches_plain(case):
    """The delay_chain kernel against the plain component delays on the
    card: delay within 1e-12 s, every jacfwd column within 1e-10
    relative, one primal and one tangent launch per jacfwd, the DD
    orbit's E bit-equal to the kepler_E kernel's on the same M and e."""
    dev = _card()
    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.kernels.kepler import kepler_E_op
    from pint_tpu_torch.residuals import Residuals

    from pint_tpu_torch.examples import j0740_realistic_par

    par, tim = (j0740_realistic_par(
        dmx_bins=data.DMX_BINS, span_days=data.SPAN_DAYS,
        center_mjd=data.CENTER_MJD).splitlines(), data.REF_TIM) \
        if case == "ELL1" else (data.dd_par_lines(), data.DD_REF_TIM)
    model, toas = data.load_torch(tim, par=par)
    r = Residuals(toas, model, device=dev)
    p, b, calc = r.pdict, r.batch, model.calc
    names = model.free_params
    x0 = model.x0(p, names).to(dev)
    with torch.no_grad():
        before = dc.DelayChain.launches
        k = calc.delay(p, b)
        torch.cuda.synchronize()
        assert dc.DelayChain.launches == before + 1
        err = float(torch.max(torch.abs(k - calc.delay_plain(p, b))))
    before = dc.DelayChain.launches
    Jk = torch.func.jacfwd(lambda x: calc.delay(
        model.with_x(p, x, names), b))(x0)
    assert dc.DelayChain.launches == before + 2
    Jp = torch.func.jacfwd(lambda x: calc.delay_plain(
        model.with_x(p, x, names), b))(x0)
    scale = torch.amax(torch.abs(Jp), 0)
    rel = float(torch.max(torch.amax(torch.abs(Jk - Jp), 0)
                          / torch.where(scale > 0, scale, 1.0)))
    print(f"{case}: delay {err:.3e} s, columns {rel:.3e} relative")
    assert err <= 1e-12 and rel <= 1e-10
    if case == "DD":
        _, aux = dc.delay_chain_aux(calc, p, b)
        assert torch.equal(kepler_E_op(aux[0], aux[1]), aux[2])


def test_delay_chain_refuses_what_it_does_not_cover():
    dev = _card()
    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.residuals import Residuals

    model, toas = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    r = Residuals(toas, model, device=dev)
    lay = model.calc.chain_layout
    rows = dc.row_inputs(lay, r.pdict, r.batch)
    theta = lay.theta(r.pdict)
    with pytest.raises(ValueError):      # float32 theta: refused, not run
        dc.DelayChain.apply(theta.float(), lay, *rows)
    with pytest.raises(ValueError):      # theta on another device
        dc.DelayChain.apply(theta.cpu(), lay, *rows)
    model.PLANET_SHAPIRO.value = True
    with pytest.raises(NotImplementedError, match="PLANET_SHAPIRO"):
        model.calc.delay(r.pdict, r.batch)


def test_gls_fit_on_card_matches_reference():
    """GLSFitter on the card on the committed GLS set: pint_tpu's stored
    fit within 1e-3 sigma, 1e-3 relative in the uncertainties and 1e-6
    in chi2; every delay through the kernel."""
    dev = _card()
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.kernels.delay_chain import DelayChain

    with open(data.GLS_REF_JSON) as f:
        ref = json.load(f)
    model, toas = data.load_torch(data.GLS_REF_TIM,
                                  par=data.dd_gls_par_lines())
    data.perturb_dd(model)
    fitter = GLSFitter(toas, model)
    assert fitter.device.type == dev.type
    before = DelayChain.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=ref["maxiter"])
    assert DelayChain.launches > before
    dev_sig = max(abs(float(np.sum(np.asarray(model[n].device_value)
                                   - np.asarray(v))))
                  / ref["uncertainties"][n] for n, v in ref["values"].items())
    unc = max(abs(model[n].device_uncertainty / u - 1.0)
              for n, u in ref["uncertainties"].items())
    gap = abs(chi2 - ref["chi2"]) / ref["chi2"]
    print(f"card GLS fit vs pint_tpu: {dev_sig:.3e} sigma, unc {unc:.3e}, "
          f"chi2 {gap:.3e}")
    assert dev_sig <= 1e-3 and unc <= 1e-3 and gap <= 1e-6
