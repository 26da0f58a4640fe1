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
  the multi-lane tangent launch bit-equal to the single-lane one at
  lanes 1, 3, 10, 76 and P on the J0740, DD and GLS models; a vmap over
  9 grid points of a jacfwd is one primal and one tangent launch; and
  ``backward`` against the plain version's reverse mode within 5e-9 of
  sum |J||g| (the plain reverse mode through the quad-single t - epoch
  is float32-grade);
* ``GLSFitter.fit_toas`` on the card on the committed GLS set within the
  fit-parity bars of pint_tpu's stored GLS fit;
* the DD and ELL1 variants of the row function (``examples.VARIANTS``:
  DDS, DDH, DDGR, DDK in equatorial and ecliptic coordinates, ELL1H in
  its three modes, ELL1k): ``delay_chain`` against the plain delays at
  its bars, both kernels' lanes and the fused chain against the
  unfused one as for the three paths' models; ``fit_toas`` on the card
  on the committed DDK set in ecliptic coordinates within the
  fit-parity bars of pint_tpu's stored fit;
* the DM family of the row function (``examples.DM_FAMILY``: NE_SW with
  SWM 0 and 1, SWX, DMJUMP, FDJUMPDM and FD<k>JUMP on the DD and ELL1
  sets) as the variants above; the three wideband fitters on the card on
  the committed wideband set against pint_tpu's stored fits;
* the chromatic family of the row function (``examples.CHROM_FAMILY``:
  each term alone on DD and ELL1; the ``CHROM`` and ``WAVEX`` sets) as
  the variants above; the chromatic set's noise fit and the WaveX set's
  WLS fit on the card against pint_tpu's stored fits;
* the orbit family of the row function (``examples.ORBIT_FAMILY``: an
  FBn orbit, ORBWAVEs and PLANET_SHAPIRO each alone on DD and ELL1; the
  ``SPIDER`` and ``BTPW`` sets) as the variants above; the spider set's
  ``Fitter.auto`` fit and the BT_PIECEWISE set's WLS fit on the card
  against pint_tpu's stored fits;
* ``phase_chain`` (the delay chain with the phase as its epilogue, the
  paths' kernel since the fusion): on the J0740, DD and GLS models its
  primal (frac, slope, dt64; words) bit-equal to the unfused card chain
  (the delay_chain kernel, PyTorch's shift, qs_phase_frac) in every
  mode at 1 and 9 θ sets, its tangents through jvp bit-equal to the
  unfused chain's (the delay_chain tangent launch, the shift's forward
  rule, QSPhaseFrac.jvp) at lanes 1, 3, 10, 76 and P with one primal and
  one tangent launch each, every lanes-per-thread bit-equal to the
  single-lane launch; a vmap over 9 grid points of a jacfwd is one primal
  and one tangent launch; refused inputs raise.  The grid, DD and GLS
  fits above run through it;
* the noise likelihood's gradient on the card never enters either
  phase_chain wrapper's backward, and equals the CPU's within 1e-9
  (value) and 1e-7 (gradient norm); ``get_designmatrix`` on the card is
  one primal and one tangent launch, bit-equal to the fitter's full
  assembly and within 1e-10 per column of the CPU's;
* the phase family of the fused row function (the ``YOUNG`` set:
  three glitches, a PiecewiseSpindown group, WAVE, IFUNC, PHOFF; and
  ``examples.PHASE_FAMILY``'s edge variants on its TOAs): the primal at
  9 θ sets within F0 x 1e-12 s of the plain composition and of the
  unfused card chain (the family's exp, sin and cos are CUDA's libm built
  without FMA contraction in the kernel, PyTorch's own in the unfused
  chain), the tangent launch bit-equal at 1, 2 and 4 lanes per thread
  along fit directions, a jacfwd one primal and one tangent launch of
  the family's template value, its columns within 1e-10 relative of the
  plain composition's; ``Fitter.auto`` on the young set on the card
  against pint_tpu's stored fit;
* ``calculate_random_models`` at 100 draws: one primal launch over the
  base's and the 100 draws' θ sets, within F0 x 1e-12 s of the CPU's plain
  composition; the chunked, checkpointed grid on the committed set within
  1e-6 of pint_tpu's stored grid and of the whole-grid program, its
  resume after a SIGTERM bit-identical, a raising chunk rerouted.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu_torch import qs as tqs
from pint_tpu_torch.examples import (CHROM_FAMILY, DM_FAMILY, ORBIT_FAMILY,
                                     PHASE_FAMILY, VARIANTS)
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
    from pint_tpu_torch.kernels.phase_chain import PhaseChain

    before = PhaseChain.launches
    chi2 = grid_chisq_flat(fitter, {k: np.asarray(v) for k, v in
                                    ref["grid"].items()},
                           maxiter=ref["maxiter"])
    # the grid's phase chain runs fused (the delay chain and qs_phase)
    assert PhaseChain.launches > before
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
    from pint_tpu_torch.kernels.phase_chain import PhaseChain

    with open(data.DD_REF_JSON) as f:
        ref = json.load(f)
    model, toas = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    data.perturb_dd(model)
    fitter = WLSFitter(toas, model)
    assert fitter.device.type == dev.type and fitter._fused_ok()
    before = PhaseChain.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=ref["maxiter"])
    # the DD orbit's Kepler solve runs inside the delay chain's row
    # function, fused into the phase_chain kernel
    assert PhaseChain.launches > before
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
    before = (dc.DelayChain.launches, dc.DelayChainTangent.launches)
    Jk = torch.func.jacfwd(lambda x: calc.delay(
        model.with_x(p, x, names), b))(x0)
    assert (dc.DelayChain.launches, dc.DelayChainTangent.launches) == (
        before[0] + 1, before[1] + 1)
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


#: the chromatic family's reference sets (the chromatic set: troposphere,
#: CM, a dip, a Gaussian event; the WaveX set: the WaveX family, CM, CMX)
CHROM_SETS = {"CHROM": (data.chrom_par_lines, data.CHROM_REF_TIM),
              "WAVEX": (data.wavex_full_par_lines, data.WAVEX_REF_TIM)}
#: the orbit family's reference sets (the spider set: an FBn orbit,
#: ORBWAVEs, PLANET_SHAPIRO; the BT_PIECEWISE set)
ORBIT_SETS = {"SPIDER": (data.spider_par_lines, data.SPIDER_REF_TIM),
              "BTPW": (data.btpw_par_lines, data.BTPW_REF_TIM)}
#: the phase family's layouts on the young set's TOAs: its own par and
#: the edge variants
PHASE_SETS = {"YOUNG": data.young_par_lines,
              **{k: (lambda k=k: _phase_family_lines(k))
                 for k in PHASE_FAMILY}}


def _phase_family_lines(kind):
    from pint_tpu_torch.examples import phase_family_par

    return phase_family_par(kind).splitlines()


def _chain_model(case, dev):
    """(model, Residuals) of one path's model on the committed 200-TOA
    set, or of one DD or ELL1 variant (``examples.variant_par``) on its
    family's set, on ``dev``."""
    from pint_tpu_torch.examples import j0740_realistic_par
    from pint_tpu_torch.residuals import Residuals

    if case in VARIANTS:
        par, tim = (lambda: data.variant_par_lines(case),
                    data.variant_tim(case))
    elif case in DM_FAMILY:
        par, tim = (lambda: data.dm_family_par_lines(case),
                    data.dm_family_tim(case))
    elif case in CHROM_FAMILY:
        par, tim = (lambda: data.chrom_family_par_lines(case),
                    data.chrom_family_tim(case))
    elif case in CHROM_SETS:
        par, tim = CHROM_SETS[case]
    elif case in ORBIT_FAMILY:
        par, tim = (lambda: data.orbit_family_par_lines(case),
                    data.orbit_family_tim(case))
    elif case in ORBIT_SETS:
        par, tim = ORBIT_SETS[case]
    elif case in PHASE_SETS:
        par, tim = PHASE_SETS[case], data.YOUNG_REF_TIM
    else:
        par, tim = {
            "J0740": (lambda: j0740_realistic_par(
                dmx_bins=data.DMX_BINS, span_days=data.SPAN_DAYS,
                center_mjd=data.CENTER_MJD).splitlines(), data.REF_TIM),
            "DD": (data.dd_par_lines, data.DD_REF_TIM),
            "GLS": (data.dd_gls_par_lines, data.GLS_REF_TIM)}[case]
    model, toas = data.load_torch(tim, par=par())
    return model, Residuals(toas, model, device=dev)


@pytest.mark.parametrize("case", [*VARIANTS, *DM_FAMILY, *CHROM_FAMILY,
                                  *CHROM_SETS, *ORBIT_FAMILY, *ORBIT_SETS])
def test_variant_delay_chain_matches_plain(case):
    """The delay_chain kernel on each DD and ELL1 variant against the
    plain component delays: delay within 1e-12 s, every jacfwd column
    within 1e-10 relative, one primal and one tangent launch per jacfwd,
    a DD-family orbit's E bit-equal to the kepler_E kernel's."""
    dev = _card()
    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.kernels.kepler import kepler_E_op

    model, r = _chain_model(case, dev)
    p, b, calc = r.pdict, r.batch, model.calc
    names = model.free_params
    x0 = model.x0(p, names).to(dev)
    with torch.no_grad():
        err = float(torch.max(torch.abs(calc.delay(p, b)
                                        - calc.delay_plain(p, b))))
    before = (dc.DelayChain.launches, dc.DelayChainTangent.launches)
    Jk = torch.func.jacfwd(lambda x: calc.delay(
        model.with_x(p, x, names), b))(x0)
    assert (dc.DelayChain.launches, dc.DelayChainTangent.launches) == (
        before[0] + 1, before[1] + 1)
    Jp = torch.func.jacfwd(lambda x: calc.delay_plain(
        model.with_x(p, x, names), b))(x0)
    scale = torch.amax(torch.abs(Jp), 0)
    rel = float(torch.max(torch.amax(torch.abs(Jk - Jp), 0)
                          / torch.where(scale > 0, scale, 1.0)))
    print(f"{case}: delay {err:.3e} s, columns {rel:.3e} relative")
    assert err <= 1e-12 and rel <= 1e-10
    if calc.chain_layout.cfg[1] in dc.DD_FAMILY:
        _, aux = dc.delay_chain_aux(calc, p, b)
        assert torch.equal(kepler_E_op(aux[0], aux[1]), aux[2])


def test_ddk_fit_on_card_matches_reference():
    """fit_toas on the card (the fused loop) on the committed DDK set in
    ecliptic coordinates: pint_tpu's stored eager fit within 1e-3 sigma,
    1e-3 relative in the uncertainties and 1e-6 in chi2."""
    dev = _card()
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.kernels.phase_chain import PhaseChain

    with open(data.DDK_REF_JSON) as f:
        ref = json.load(f)
    model, toas = data.load_torch(data.DDK_REF_TIM, par=data.ddk_par_lines())
    data.perturb(model, data.DDK_PERTURB)
    fitter = WLSFitter(toas, model)
    assert fitter.device.type == dev.type and fitter._fused_ok()
    before = PhaseChain.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=ref["maxiter"])
    assert PhaseChain.launches > before
    assert fitter.fitresult.rung == "fused"
    dev_sig = max(abs(float(np.sum(np.asarray(model[n].device_value)
                                   - np.asarray(v))))
                  / ref["uncertainties"][n] for n, v in ref["values"].items())
    unc = max(abs(model[n].device_uncertainty / u - 1.0)
              for n, u in ref["uncertainties"].items())
    gap = abs(chi2 - ref["chi2"]) / ref["chi2"]
    print(f"card DDK fit vs pint_tpu: {dev_sig:.3e} sigma, unc {unc:.3e}, "
          f"chi2 {gap:.3e}")
    assert dev_sig <= 1e-3 and unc <= 1e-3 and gap <= 1e-6


@pytest.mark.parametrize("case", ["J0740", "DD", "GLS", *VARIANTS,
                                  *DM_FAMILY, *CHROM_FAMILY, *CHROM_SETS,
                                  *ORBIT_FAMILY, *ORBIT_SETS])
def test_delay_chain_lanes_bit_equal_to_single_lane(case):
    """The multi-lane tangent launch (every lanes-per-thread) against the
    single-lane one, on two θ sets: bit-equal at lanes 1, 3, 10, 76 and
    P, a ragged last lane block included."""
    dev = _card()
    from pint_tpu_torch.kernels import delay_chain as dc

    model, r = _chain_model(case, dev)
    lay = model.calc.chain_layout
    rows = dc.row_inputs(lay, r.pdict, r.batch)
    names = model.free_params
    x0 = model.x0(r.pdict, names).to(dev)
    rng = np.random.default_rng(20261017)
    with torch.no_grad():
        thetas = torch.stack([lay.theta(model.with_x(r.pdict, x, names))
                              for x in (x0, x0 + 1e-9 * torch.from_numpy(
                                  rng.standard_normal(len(names))).to(dev))])
    for K in (1, 3, 10, 76, lay.P):
        dth = torch.from_numpy(rng.standard_normal((2, K, lay.P))).to(dev)
        before = dc.DelayChainTangent.launches
        one = dc.run(lay, thetas, dth, rows, lanes=1)
        for L in dc.KERNEL_LANES[1:]:
            many = dc.run(lay, thetas, dth, rows, lanes=L)
            assert torch.equal(many, one), (K, L)
        torch.cuda.synchronize()
        assert dc.DelayChainTangent.launches == before + len(dc.KERNEL_LANES)
        assert torch.all(torch.isfinite(one))


def test_delay_chain_vmap_grid_one_tangent_launch():
    """vmap over 9 grid points of a jacfwd: one primal and one tangent
    launch (9 θ sets, each with its lanes), each point's columns within
    1e-10 of the plain version's."""
    dev = _card()
    from pint_tpu_torch.kernels import delay_chain as dc

    model, r = _chain_model("J0740", dev)
    p, b, calc = r.pdict, r.batch, model.calc
    names = model.free_params
    rng = np.random.default_rng(20261018)
    X = model.x0(p, names).to(dev) + 1e-9 * torch.from_numpy(
        rng.standard_normal((9, len(names)))).to(dev)
    before = (dc.DelayChain.launches, dc.DelayChainTangent.launches)
    J = torch.func.vmap(torch.func.jacfwd(lambda x: calc.delay(
        model.with_x(p, x, names), b)))(X)
    torch.cuda.synchronize()
    assert (dc.DelayChain.launches, dc.DelayChainTangent.launches) == (
        before[0] + 1, before[1] + 1)
    for g in range(9):
        Jp = torch.func.jacfwd(lambda x: calc.delay_plain(
            model.with_x(p, x, names), b))(X[g])
        scale = torch.amax(torch.abs(Jp), 0)
        rel = float(torch.max(torch.amax(torch.abs(J[g] - Jp), 0)
                              / torch.where(scale > 0, scale, 1.0)))
        assert rel <= 1e-10, (g, rel)


@pytest.mark.parametrize("case", ["J0740", "DD"])
def test_delay_chain_backward_matches_plain(case):
    """Reverse mode through the kernel (one tangent launch with P unit
    lanes) against the plain version's, within 5e-9 of sum |J||g|."""
    dev = _card()
    from pint_tpu_torch.kernels import delay_chain as dc

    model, r = _chain_model(case, dev)
    p, b, calc = r.pdict, r.batch, model.calc
    names = model.free_params
    x0 = model.x0(p, names).to(dev)
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        b.ntoas)).to(dev)

    def grad(delay):
        x = x0.clone().requires_grad_(True)
        return torch.autograd.grad(
            torch.sum(w * delay(model.with_x(p, x, names), b)), x)[0]

    before = dc.DelayChainTangent.launches
    gk = grad(calc.delay)
    torch.cuda.synchronize()
    assert dc.DelayChainTangent.launches == before + 1
    gp = grad(calc.delay_plain)
    Jp = torch.func.jacfwd(lambda x: calc.delay_plain(
        model.with_x(p, x, names), b))(x0)
    scale = torch.abs(Jp).T @ torch.abs(w)
    rel = float(torch.max(torch.abs(gk - gp)
                          / torch.where(scale > 0, scale, 1.0)))
    print(f"{case}: backward vs plain reverse mode {rel:.3e} of sum |J||g|")
    assert rel <= 5e-9


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
    # a layout the kernel still refuses: more members of a mask family
    # than one bit word per row carries
    from pint_tpu_torch.models.jump import DelayJump

    dj = DelayJump()
    for i in range(dc.MAX_JUMPS + 1):
        dj.add_jump(index=11 + i, key="-fe", key_value=["RCVR800"],
                    value=1e-7 * i)
    model.add_component(dj)
    with pytest.raises(NotImplementedError, match="at most 31"):
        model.calc.chain_layout


def test_gls_fit_on_card_matches_reference():
    """GLSFitter on the card on the committed GLS set: pint_tpu's stored
    fit within 1e-3 sigma, 1e-3 relative in the uncertainties and 1e-6
    in chi2; every delay through the fused phase_chain kernel."""
    dev = _card()
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.kernels.phase_chain import PhaseChain

    with open(data.GLS_REF_JSON) as f:
        ref = json.load(f)
    model, toas = data.load_torch(data.GLS_REF_TIM,
                                  par=data.dd_gls_par_lines())
    data.perturb_dd(model)
    fitter = GLSFitter(toas, model)
    assert fitter.device.type == dev.type
    before = PhaseChain.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=ref["maxiter"])
    assert PhaseChain.launches > before
    dev_sig = max(abs(float(np.sum(np.asarray(model[n].device_value)
                                   - np.asarray(v))))
                  / ref["uncertainties"][n] for n, v in ref["values"].items())
    unc = max(abs(model[n].device_uncertainty / u - 1.0)
              for n, u in ref["uncertainties"].items())
    gap = abs(chi2 - ref["chi2"]) / ref["chi2"]
    print(f"card GLS fit vs pint_tpu: {dev_sig:.3e} sigma, unc {unc:.3e}, "
          f"chi2 {gap:.3e}")
    assert dev_sig <= 1e-3 and unc <= 1e-3 and gap <= 1e-6


def _fused_case(case, dev):
    """One path's model on its committed 200-TOA set on ``dev``, with 9
    fit points a hair apart and seeded pulse numbers."""
    model, r = _chain_model(case, dev)
    names = model.free_params
    rng = np.random.default_rng(20261019)
    X = model.x0(r.pdict, names).to(dev) + 1e-9 * torch.from_numpy(
        rng.standard_normal((9, len(names)))).to(dev)
    pn = torch.from_numpy(np.round(rng.uniform(-1e9, 1e9, r.batch.ntoas)))
    pn[::17] = float("nan")
    return model, r, names, X, pn.to(dev), rng


@pytest.mark.parametrize("case", ["J0740", "DD", "GLS", *VARIANTS,
                                  *DM_FAMILY, *CHROM_FAMILY, *CHROM_SETS,
                                  *ORBIT_FAMILY, *ORBIT_SETS])
def test_phase_chain_bit_equal_to_unfused_chain(case):
    """The fused launches against the unfused card chain: the primal of
    one launch over 1 and 9 θ sets in every mode (frac or the words,
    slope, dt64), and the tangents of jvp along K random fit-parameter
    directions, one primal and one tangent launch each."""
    dev = _card()
    import dataclasses

    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.kernels import phase_chain as pc
    from pint_tpu_torch.kernels import qs_phase

    model, r, names, X, pn, rng = _fused_case(case, dev)
    p, b, calc = r.pdict, r.batch, model.calc

    def at(x):
        return model.with_x(p, x, names)

    for mode in ("nearest", "use_pulse_numbers", "words"):
        for sets in (1, 9):
            ins = [pc.fused_inputs(calc, at(x), b, mode) for x in X[:sets]]
            spec, _, _, tensors = ins[0]
            if mode == "use_pulse_numbers":
                tensors[len(dc.ROWS)] = pn
            with torch.no_grad():
                fused = pc.run(spec, torch.stack([t for _, t, _, _ in ins]),
                               torch.stack([o for _, _, o, _ in ins]),
                               tensors)
                for g, x in enumerate(X[:sets]):
                    qspec, shift, dF, other = pc.unfused_inputs(
                        calc, at(x), b, mode, delay=calc.delay)
                    if mode == "use_pulse_numbers":
                        qspec = dataclasses.replace(qspec, pulse_number=pn)
                    want = qs_phase.run(qspec, shift, dF, other)
                    for name, a, w in zip(("out", "slope", "dt64"), fused,
                                          want):
                        assert torch.equal(a[g], w), (mode, sets, g, name)
    x0 = X[0]
    for K in (1, 3, 10, 76, len(names)):
        V = torch.from_numpy(rng.standard_normal((K, len(names)))).to(dev)

        def along(fn):
            return torch.func.vmap(lambda v: torch.func.jvp(
                fn, (x0,), (v,))[1])(V)

        before = (pc.PhaseChain.launches, pc.PhaseChainTangent.launches)
        kf = along(lambda x: pc.fused(calc, at(x), b, "nearest"))
        torch.cuda.synchronize()
        assert (pc.PhaseChain.launches, pc.PhaseChainTangent.launches) == (
            before[0] + 1, before[1] + 1)
        ku = along(lambda x: pc.unfused(calc, at(x), b, "nearest",
                                        delay=calc.delay))
        assert torch.all(torch.isfinite(ku))
        assert torch.equal(kf, ku), (K, float(torch.max(torch.abs(kf - ku))))


@pytest.mark.parametrize("case", ["J0740", "DD", "GLS", *VARIANTS,
                                  *DM_FAMILY, *CHROM_FAMILY, *CHROM_SETS,
                                  *ORBIT_FAMILY, *ORBIT_SETS])
def test_phase_chain_lanes_bit_equal_to_single_lane(case):
    """Every lanes-per-thread of the fused tangent launch against the
    single-lane one on two θ sets, with random tangents of θ and of
    other: bit-equal at lanes 1, 3, 10, 76 and P."""
    dev = _card()
    from pint_tpu_torch.kernels import phase_chain as pc
    from pint_tpu_torch.kernels.delay_chain import KERNEL_LANES

    model, r, names, X, _, rng = _fused_case(case, dev)
    p, b, calc = r.pdict, r.batch, model.calc
    ins = [pc.fused_inputs(calc, model.with_x(p, x, names), b, "nearest")
           for x in X[:2]]
    spec, _, _, tensors = ins[0]
    thetas = torch.stack([t for _, t, _, _ in ins])
    others = torch.stack([o for _, _, o, _ in ins])
    for K in (1, 3, 10, 76, spec.P):
        dth = torch.from_numpy(rng.standard_normal((2, K, spec.P))).to(dev)
        dot = torch.from_numpy(rng.standard_normal((2, K, b.ntoas))).to(dev)
        one = pc.run(spec, thetas, others, tensors, dth, dot, lanes=1)
        assert torch.all(torch.isfinite(one))
        for L in KERNEL_LANES[1:]:
            many = pc.run(spec, thetas, others, tensors, dth, dot, lanes=L)
            assert torch.equal(many, one), (K, L)


def test_phase_chain_vmap_grid_one_tangent_launch():
    """vmap over 9 grid points of a jacfwd of the residual phase: one
    primal and one tangent launch, bit-equal to the unfused chain's."""
    dev = _card()
    from pint_tpu_torch.kernels import phase_chain as pc

    model, r, names, X, _, _ = _fused_case("J0740", dev)
    p, b, calc = r.pdict, r.batch, model.calc
    before = (pc.PhaseChain.launches, pc.PhaseChainTangent.launches)
    J = torch.func.vmap(torch.func.jacfwd(lambda x: calc.phase_frac(
        model.with_x(p, x, names), b, "nearest")))(X)
    torch.cuda.synchronize()
    assert (pc.PhaseChain.launches, pc.PhaseChainTangent.launches) == (
        before[0] + 1, before[1] + 1)
    Ju = torch.func.vmap(torch.func.jacfwd(lambda x: pc.unfused(
        calc, model.with_x(p, x, names), b, "nearest", delay=calc.delay)))(X)
    assert torch.equal(J, Ju)


def test_phase_chain_refuses_what_it_does_not_take():
    dev = _card()
    from pint_tpu_torch.kernels import phase_chain as pc

    model, r = _chain_model("DD", dev)
    spec, theta, other, tensors = pc.fused_inputs(
        model.calc, r.pdict, r.batch, "nearest")
    with pytest.raises(ValueError):      # float32 theta: refused, not run
        pc.PhaseChain.apply(theta.float(), other, spec, *tensors)
    with pytest.raises(ValueError):      # theta on another device
        pc.PhaseChain.apply(theta.cpu(), other, spec, *tensors)
    with pytest.raises(ValueError):      # a pulse-number mode without them
        pc.run(pc.PhaseChainSpec(spec.layout, spec.K, "use_pulse_numbers"),
               theta, other, tensors)


def _noisefit_pair(dev):
    """The noise-fitting set's model (all 11 noise parameters free) with
    its residuals on the card and on the CPU."""
    from pint_tpu_torch.examples import dd_noise_fit_par
    from pint_tpu_torch.residuals import Residuals

    par = dd_noise_fit_par(data.DMX_BINS, data.SPAN_DAYS,
                           data.CENTER_MJD).splitlines()
    model, toas = data.load_torch(data.NOISEFIT_REF_TIM, par=par)
    cpu = Residuals(toas, model, device="cpu")
    card = Residuals(toas, model, device=dev)
    return model, card, cpu


def test_noise_lnlike_gradient_on_card_never_reaches_backward(monkeypatch):
    """The noise likelihood's gradient on the card: the residuals run
    through the phase_chain kernel with no grad, so neither wrapper's
    backward is entered; value and gradient equal the CPU's plain
    evaluation within 1e-9 and 1e-7 relative."""
    dev = _card()
    from pint_tpu_torch.examples import NOISE_FIT_PARAMS
    from pint_tpu_torch.fitter import _noise_grad, build_noise_lnlike
    from pint_tpu_torch.kernels.phase_chain import (PhaseChain,
                                                    PhaseChainTangent)

    calls = []
    for k in (PhaseChain, PhaseChainTangent):
        monkeypatch.setattr(k, "backward", staticmethod(
            lambda ctx, *g: calls.append(ctx) or (None,) * 64))
    model, card, cpu = _noisefit_pair(dev)
    names = list(NOISE_FIT_PARAMS)
    rng = np.random.default_rng(20261017)
    out = {}
    before = PhaseChain.launches
    for label, r in (("card", card), ("cpu", cpu)):
        lnl = build_noise_lnlike(model, r.batch, names, r.track_mode)
        x = torch.as_tensor(rng.standard_normal(len(names)) * 0.1,
                            device=r.device) if label == "card" else \
            out["card"][2].to("cpu")
        with torch.no_grad():
            ll = float(lnl(x, r.pdict))
        g = _noise_grad(lnl)(x, r.pdict).cpu().numpy()
        out[label] = (ll, g, x)
    assert PhaseChain.launches > before and calls == []
    (lc, gc, _), (lh, gh, _) = out["card"], out["cpu"]
    gap_l = abs(lc / lh - 1.0)
    gap_g = float(np.linalg.norm(gc - gh) / np.linalg.norm(gh))
    print(f"noise lnlike card vs CPU: {gap_l:.3e}, gradient {gap_g:.3e}")
    assert gap_l <= 1e-9 and gap_g <= 1e-7


def test_designmatrix_on_card_matches_assembly():
    """``get_designmatrix`` on the card (one primal and one tangent
    phase_chain launch) against the fitter's full assembly at the same
    point: the same columns, bit for bit; and the CPU's within 1e-10 per
    column."""
    dev = _card()
    from pint_tpu_torch.fitter import WLSFitter, build_whitened_assembly
    from pint_tpu_torch.kernels.phase_chain import (PhaseChain,
                                                    PhaseChainTangent)

    model, toas = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    fitter = WLSFitter(toas, model, device=dev)
    p0, t0 = PhaseChain.launches, PhaseChainTangent.launches
    M, names = fitter.get_designmatrix()
    assert (PhaseChain.launches - p0, PhaseChainTangent.launches - t0) == \
        (1, 1)
    asm = build_whitened_assembly(model, fitter.resids.batch, names,
                                  fitter.track_mode, include_offset=False,
                                  design_matrix="full")
    with torch.no_grad():
        _, Ma, _, _ = asm.inline(torch.zeros(len(names), dtype=torch.float64,
                                             device=dev),
                                 fitter.resids.pdict)
    assert np.array_equal(M, Ma.cpu().numpy())
    Mc, _ = WLSFitter(toas, model, device="cpu").get_designmatrix()
    gap = float(np.max(np.max(np.abs(M - Mc), axis=0)
                       / np.max(np.abs(Mc), axis=0)))
    print(f"design matrix card vs CPU: {gap:.3e} per column")
    assert gap <= 1e-10


@pytest.mark.parametrize("label", ["wideband_gls", "wideband_downhill",
                                   "wideband_lm"])
def test_wideband_fit_on_card_matches_reference(label):
    """The wideband fitters on the card on the committed 200-TOA wideband
    set: pint_tpu's stored fits within 1e-3 sigma (LM 1e-2: its steps
    are decided by comparing chi2 values), 1e-3 in the uncertainties and
    1e-6 in chi2 (the downhill fit 1e-3, and its DMEFACs within 1e-2
    sigma and 1e-2 in their uncertainties: L-BFGS-B's stop); every
    residual through the fused phase_chain kernel."""
    _card()
    from pint_tpu_torch.examples import WB_NOISE_FREE
    from pint_tpu_torch.fitter import (WidebandDownhillFitter,
                                       WidebandLMFitter, WidebandTOAFitter)
    from pint_tpu_torch.kernels.phase_chain import PhaseChain

    with open(data.WB_REF_JSON) as f:
        ref = json.load(f)
    cls, free, sig_tol, chi2_tol, kw = {
        "wideband_gls": (WidebandTOAFitter, (), 1e-3, 1e-6,
                         {"maxiter": ref["maxiter"]}),
        "wideband_downhill": (WidebandDownhillFitter, WB_NOISE_FREE, 1e-3,
                              1e-3, {}),
        "wideband_lm": (WidebandLMFitter, (), 1e-2, 1e-6, {})}[label]
    want = ref[label]
    model, toas = data.load_torch(data.WB_REF_TIM,
                                  par=data.wb_par_lines(free))
    data.wb_start(model)
    fitter = cls(toas, model)
    before = PhaseChain.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(**kw)
    assert PhaseChain.launches > before
    sig, unc = data.fit_gaps(model, want["values"], want["uncertainties"])
    gap = abs(chi2 - want["chi2"]) / want["chi2"]
    print(f"card {label} vs pint_tpu: {sig:.3e} sigma, unc {unc:.3e}, "
          f"chi2 {gap:.3e}")
    assert fitter.fitresult.status.name == want["status"]
    assert sig <= sig_tol and unc <= 1e-3 and gap <= chi2_tol
    if free:
        nsig, nunc = data.fit_gaps(model, want["noise_values"],
                                   want["noise_uncertainties"])
        assert nsig <= 1e-2 and nunc <= 1e-2


def test_chromatic_fits_on_card_match_reference():
    """The chromatic set's DownhillGLSFitter noise fit and the WaveX set's
    WLSFitter fit on the card against pint_tpu's stored fits, at the bars
    of tests/test_torch_chromatic.py and tests/test_torch_wavex.py; every
    residual through the fused phase_chain kernel."""
    _card()
    from pint_tpu_torch.fitter import DownhillGLSFitter, WLSFitter
    from pint_tpu_torch.kernels.phase_chain import PhaseChain

    with open(data.CHROM_REF_JSON) as f:
        want = json.load(f)
    model, toas = data.load_torch(data.CHROM_REF_TIM,
                                  par=data.chrom_par_lines())
    data.chrom_start(model)
    fitter = DownhillGLSFitter(toas, model)
    before = PhaseChain.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas()
    assert PhaseChain.launches > before
    sig, unc = data.fit_gaps(model, want["values"], want["uncertainties"])
    nsig, nunc = data.fit_gaps(model, want["noise_values"],
                               want["noise_uncertainties"])
    gap = abs(chi2 / want["chi2"] - 1.0)
    print(f"card chromatic fit vs pint_tpu: {sig:.3e} sigma, unc {unc:.3e},"
          f" chi2 {gap:.3e}, noise {nsig:.3e} sigma, unc {nunc:.3e}")
    assert fitter.fitresult.status.name == want["status"]
    assert sig <= 1e-3 and unc <= 1e-3 and gap <= 1e-3
    assert nsig <= 1e-2 and nunc <= 1e-2
    with open(data.WAVEX_REF_JSON) as f:
        want = json.load(f)
    model, toas = data.load_wavex("pint_tpu_torch")
    fitter = WLSFitter(toas, model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=want["maxiter"])
    sig, unc = data.fit_gaps(model, want["values"], want["uncertainties"])
    gap = abs(chi2 / want["chi2"] - 1.0)
    print(f"card WaveX fit vs pint_tpu: {sig:.3e} sigma, unc {unc:.3e}, "
          f"chi2 {gap:.3e}")
    assert sig <= 1e-3 and unc <= 1e-3 and gap <= 1e-6


def test_orbit_fits_on_card_match_reference():
    """The spider set's ``Fitter.auto`` fit (an FBn orbit, ORBWAVEs and
    PLANET_SHAPIRO) and the BT_PIECEWISE set's WLSFitter fit on the card
    against pint_tpu's stored fits, at the bars of
    tests/test_torch_orbit_family.py; every residual through the fused
    phase_chain kernel."""
    _card()
    from pint_tpu_torch.fitter import Fitter, WLSFitter
    from pint_tpu_torch.kernels.phase_chain import PhaseChain

    for label, ref, par, tim in (
            ("spider", data.SPIDER_REF_JSON, data.spider_par_lines,
             data.SPIDER_REF_TIM),
            ("btpw", data.BTPW_REF_JSON, data.btpw_par_lines,
             data.BTPW_REF_TIM)):
        with open(ref) as f:
            want = json.load(f)
        model, toas = data.load_torch(tim, par=par())
        if label == "spider":
            data.spider_start(model)
            fitter = Fitter.auto(toas, model)
            kw = {}
        else:
            data.perturb_dd(model)
            fitter = WLSFitter(toas, model)
            kw = {"maxiter": want["maxiter"]}
        before = PhaseChain.launches
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            chi2 = fitter.fit_toas(**kw)
        assert PhaseChain.launches > before
        sig, unc = data.fit_gaps(model, want["values"],
                                 want["uncertainties"])
        gap = abs(chi2 / want["chi2"] - 1.0)
        print(f"card {label} fit vs pint_tpu: {sig:.3e} sigma, unc "
              f"{unc:.3e}, chi2 {gap:.3e}")
        assert fitter.fit_params == want["fit_params"]
        assert fitter.fitresult.status.name == want["status"]
        assert sig <= 1e-3 and unc <= 1e-3 and gap <= 1e-6


@pytest.mark.parametrize("case", sorted(PHASE_SETS))
def test_phase_family_on_card(case):
    """The phase family's template values against the plain composition
    and the unfused card chain on the young set's TOAs (the bars of the
    module docstring), its lanes bit-equal across lanes per thread, a
    jacfwd one launch of each, its columns against the plain
    composition's."""
    dev = _card()
    from pint_tpu_torch.kernels import phase_chain as pc
    from pint_tpu_torch.kernels import qs_phase
    from pint_tpu_torch.kernels.delay_chain import KERNEL_LANES

    model, r, names, _, _, rng = _fused_case(case, dev)
    p, b, calc = r.pdict, r.batch, model.calc
    bar = float(model.F0.value) * 1e-12

    def at(x):
        return model.with_x(p, x, names)

    # 9 fit points, each parameter moved by up to 1e-4 cycles of phase (a
    # uniform 1e-9 moves F2 and GLF2 by ~1e13 cycles at the span's ends)
    x0 = model.x0(p, names).to(dev)
    J0 = torch.func.jacfwd(lambda x: pc.fused(calc, at(x), b, "nearest"))(x0)
    step = 1e-4 / torch.clamp(torch.amax(torch.abs(J0), dim=0), min=1e-300)
    X = x0 + step * torch.from_numpy(
        rng.standard_normal((9, len(names)))).to(dev)
    X[0] = x0
    ins = [pc.fused_inputs(calc, at(x), b, "nearest") for x in X]
    spec, _, _, tensors = ins[0]
    assert spec.family is not None
    with torch.no_grad():
        thetas = torch.stack([t for _, t, _, _ in ins])
        others = torch.stack([o for _, _, o, _ in ins])
        fused = pc.run(spec, thetas, others, tensors)
        for g, x in enumerate(X):
            want = qs_phase.run(*pc.unfused_inputs(calc, at(x), b, "nearest",
                                                   delay=calc.delay))
            plain = pc.unfused(calc, at(x), b, "nearest")
            assert float(torch.max(torch.abs(fused[0][g] - want[0]))) <= bar
            assert float(torch.max(torch.abs(fused[0][g] - plain))) <= bar
    for K in (1, 3, 10, len(names)):
        V = torch.from_numpy(rng.standard_normal((K, len(names)))).to(dev)

        def along(i):
            return torch.func.vmap(lambda v: torch.func.jvp(
                lambda x: pc.fused_inputs(calc, at(x), b, "nearest")[i],
                (x0,), (v,))[1])(V)

        dth, dot = along(1)[None], along(2)[None]
        one = pc.run(spec, thetas[:1], others[:1], tensors, dth, dot,
                     lanes=1)
        assert torch.all(torch.isfinite(one))
        for L in KERNEL_LANES[1:]:
            assert torch.equal(pc.run(spec, thetas[:1], others[:1], tensors,
                                      dth, dot, lanes=L), one), (K, L)
    before = (pc.PhaseFamilyPrimal.launches, pc.PhaseFamilyTangent.launches)
    J = torch.func.jacfwd(lambda x: pc.fused(calc, at(x), b, "nearest"))(x0)
    torch.cuda.synchronize()
    assert (pc.PhaseFamilyPrimal.launches,
            pc.PhaseFamilyTangent.launches) == (before[0] + 1,
                                                before[1] + 1)
    Jp = torch.func.jacfwd(lambda x: pc.unfused(calc, at(x), b,
                                                "nearest"))(x0)
    scale = torch.amax(torch.abs(Jp), dim=0)
    gap = float(torch.max(torch.amax(torch.abs(J - Jp), dim=0)
                          / torch.where(scale > 0, scale, 1.0)))
    print(f"{case}: columns vs the plain composition {gap:.3e}")
    assert gap <= 1e-10


def test_young_fit_on_card_matches_reference():
    """``Fitter.auto`` on the young set on the card against pint_tpu's
    stored fit (tests/test_torch_phase_family.py's bars), every residual
    through the phase family's template value."""
    _card()
    from pint_tpu_torch.examples import young_start
    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.kernels.phase_chain import PhaseFamilyPrimal

    with open(data.YOUNG_REF_JSON) as f:
        want = json.load(f)
    model, toas = data.load_torch(data.YOUNG_REF_TIM,
                                  par=data.young_par_lines())
    young_start(model)
    fitter = Fitter.auto(toas, model)
    before = PhaseFamilyPrimal.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas()
    assert PhaseFamilyPrimal.launches > before
    sig, unc = data.fit_gaps(model, want["values"], want["uncertainties"])
    gap = abs(chi2 / want["chi2"] - 1.0)
    print(f"card young fit vs pint_tpu: {sig:.3e} sigma, unc {unc:.3e}, "
          f"chi2 {gap:.3e}")
    assert fitter.fit_params == want["fit_params"]
    assert fitter.fitresult.status.name == want["status"]
    assert sig <= 1e-3 and unc <= 1e-3 and gap <= 1e-6


def _grid_fitter(device):
    """A WLSFitter on ``device`` on the committed J0740 set, M2 and SINI
    frozen as the headline grid has them."""
    from pint_tpu_torch.examples import j0740_realistic_par
    from pint_tpu_torch.fitter import WLSFitter

    model, toas = data.load_torch(data.REF_TIM, grid=True,
                                  par=j0740_realistic_par(
                                      dmx_bins=data.DMX_BINS,
                                      span_days=data.SPAN_DAYS,
                                      center_mjd=data.CENTER_MJD)
                                  .splitlines())
    return WLSFitter(toas, model, device=device)


def test_random_models_on_card_match_plain():
    """``calculate_random_models`` at 100 draws on the card: one
    phase_chain primal launch over the base's and the 100 draws' θ sets
    (the fitter's residuals are up to date after the fit), no tangent
    launch; the draws equal the CPU's (the same host draw) and
    the phase deviations within F0 x 1e-12 s of the CPU's plain
    composition on the same covariance (K3's bar against the plain
    version)."""
    dev = _card()
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.kernels.phase_chain import (PhaseChain,
                                                    PhaseChainTangent)
    from pint_tpu_torch.simulation import calculate_random_models

    fitter = _grid_fitter(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fitter.fit_toas(maxiter=2)
    before = (PhaseChain.launches, PhaseChainTangent.launches)
    dphase, draws = calculate_random_models(fitter, fitter.toas,
                                            Nmodels=100, seed=1)
    torch.cuda.synchronize()
    assert (PhaseChain.launches - before[0],
            PhaseChainTangent.launches - before[1]) == (1, 0)
    # the same fitted model and covariance on the CPU
    host = WLSFitter(fitter.toas, fitter.model, device="cpu")
    host.parameter_covariance_matrix = fitter.parameter_covariance_matrix
    host.covariance_params = fitter.covariance_params
    want, wdraws = calculate_random_models(host, host.toas, Nmodels=100,
                                           seed=1)
    np.testing.assert_array_equal(draws, wdraws)
    gap = float(np.max(np.abs(dphase - want)))
    bar = float(fitter.model.F0.value) * 1e-12
    print(f"card random models vs CPU plain: {gap:.3e} cycles "
          f"(bar {bar:.3e})")
    assert dphase.shape == (100, fitter.toas.ntoas) and gap <= bar


def test_chunked_grid_on_card(tmp_path):
    """The stored 3 x 3 grid in chunks of 2 on the card: within 1e-6 of
    pint_tpu's stored chi2 and of the card's whole-grid program; a
    SIGTERM after chunk 1 then ``resume=True`` bit-identical to the
    uninterrupted chunked scan; a chunk that raises beyond its retries
    rerouted through the unbatched fit per point within 1e-6."""
    _card()
    from pint_tpu_torch import faultinject
    from pint_tpu_torch.exceptions import ScanInterrupted
    from pint_tpu_torch.gridutils import grid_chisq_flat
    from pint_tpu_torch.runtime import ChunkStatus

    with open(data.REF_JSON) as f:
        ref = json.load(f)
    fitter = _grid_fitter(None)
    grid = {k: np.asarray(v) for k, v in ref["grid"].items()}
    kw = dict(maxiter=ref["maxiter"], chunk_size=2)
    whole = grid_chisq_flat(fitter, grid, maxiter=ref["maxiter"])
    chunked, s = grid_chisq_flat(fitter, grid, return_summary=True, **kw)
    assert s.n_chunks == 5 and s.counts() == {"OK": 5}, s
    for want in (np.asarray(ref["chi2"]), whole):
        assert float(np.max(np.abs(chunked - want) / want)) <= 1e-6
    ck = str(tmp_path / "grid.npz")
    with faultinject.sigterm_midscan(after_chunk=1):
        with pytest.raises(ScanInterrupted):
            grid_chisq_flat(fitter, grid, checkpoint=ck, **kw)
    resumed, rs = grid_chisq_flat(fitter, grid, checkpoint=ck, resume=True,
                                  return_summary=True, **kw)
    assert rs.resumed_chunks == 2 and rs.counts() == {"OK": 5}, rs
    np.testing.assert_array_equal(resumed, chunked)
    with faultinject.chunk_raise(chunks=(1,), times=99):
        rerouted, xs = grid_chisq_flat(fitter, grid, max_retries=1,
                                       return_summary=True, **kw)
    assert xs.statuses[1] == ChunkStatus.REROUTED
    assert xs.counts() == {"OK": 4, "REROUTED": 1}, xs
    assert float(np.max(np.abs(rerouted - chunked) / chunked)) <= 1e-6


def test_young_columns_on_card_match_stored():
    """The young set's design matrix on the card (the fused tangent
    launch's word-level spin-phase tangent) against pint_tpu's stored
    columns (``python tests/torch_port_data.py young_columns``): every
    column within 1e-10 relative, RAJ, DECJ and DM included."""
    dev = _card()
    from pint_tpu_torch.fitter import build_resid_sec_fn
    from pint_tpu_torch.residuals import Residuals

    with open(data.YOUNG_COLUMNS_JSON) as f:
        want = json.load(f)
    model, toas = data.load_torch(data.YOUNG_REF_TIM,
                                  par=data.young_par_lines())
    r = Residuals(toas, model, device=dev)
    names = want["names"]
    f = build_resid_sec_fn(model, r.batch, names, r.track_mode)
    M = torch.func.jacfwd(lambda x: f(x, r.pdict))(
        model.x0(r.pdict, names).to(dev)).cpu().numpy()
    W = np.asarray(want["columns"]).T
    scale = np.max(np.abs(W), axis=0)
    gap = np.max(np.abs(M - W), axis=0) / np.where(scale > 0, scale, 1.0)
    print("young columns on the card: "
          + ", ".join(f"{n} {g:.2e}" for n, g in zip(names, gap)))
    assert float(np.max(gap)) <= 1e-10


#: the binary families of the orbital-phase entry, on the 200-TOA sets
ORBITAL_SETS = {
    "ELL1": (lambda: _torch_j0740_par(), data.REF_TIM),
    "DD": (data.dd_par_lines, data.DD_REF_TIM),
    "DDK": (lambda: data.variant_par_lines("DDK_ECL"),
            data.variant_tim("DDK_ECL")),
    "DDGR": (lambda: data.variant_par_lines("DDGR"),
             data.variant_tim("DDGR")),
    "ELL1H": (lambda: data.variant_par_lines("ELL1H"),
              data.variant_tim("ELL1H")),
    "BT_PIECEWISE": (data.btpw_par_lines, data.BTPW_REF_TIM),
    "FBn_ORBWAVE": (data.spider_par_lines, data.SPIDER_REF_TIM)}


def _torch_j0740_par():
    from pint_tpu_torch.examples import j0740_realistic_par

    return j0740_realistic_par(dmx_bins=data.DMX_BINS,
                               span_days=data.SPAN_DAYS,
                               center_mjd=data.CENTER_MJD).splitlines()


@pytest.mark.parametrize("case", list(ORBITAL_SETS))
def test_orbital_phase_on_card(case):
    """``TimingModel.orbital_phase`` on a CUDA batch: one launch of the
    delay kernel's orbital-phase entry and nothing else of the chain,
    within 1e-12 orbits (circularly) of the plain version run on the
    card's tensors (the delay up to the binary, the binary's own
    ``orbital_phase``)."""
    dev = _card()
    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.residuals import Residuals

    par, tim = ORBITAL_SETS[case]
    model, toas = data.load_torch(tim, par=par())
    r = Residuals(toas, model, device=dev)
    p, b = r.pdict, r.batch
    before = (dc.OrbitalPhase.launches, dc.DelayChain.launches)
    with torch.no_grad():
        got = model.orbital_phase(p, b)
        torch.cuda.synchronize()
        after = (dc.OrbitalPhase.launches, dc.DelayChain.launches)
        binary = [c for c in model.delay_components
                  if c.category == "pulsar_system"][0]
        want = binary.orbital_phase(
            p, b, model.calc.delay_plain(p, b, upto="pulsar_system"))
    d = (got - want).cpu().numpy()
    gap = float(np.max(np.abs(d - np.round(d))))
    print(f"{case}: orbital phase on the card {gap:.3e} orbits from the "
          "plain version")
    assert after == (before[0] + 1, before[1])
    assert bool(torch.all((got >= 0) & (got < 1))) and gap <= 1e-12
