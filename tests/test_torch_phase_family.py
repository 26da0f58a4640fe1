"""pint_tpu_torch's last five timing-model components against pint_tpu's,
on the CPU: Glitch, PiecewiseSpindown, Wave, IFunc (the phase family:
their phase reads the delay) and PhaseOffset.

The same inputs go through both packages (JAX on the CPU, float64), on
the committed young set (``tests/data/young_sim_200.tim``, Parkes at 1.4
and 3.1 GHz over eight years) and its par (``examples.young_par()``:
three glitches, a PiecewiseSpindown group, ten WAVE harmonics, sixteen
IFUNC points, PHOFF) and the edge variants of ``examples.PHASE_FAMILY``
(a glitch with its epoch free, one with GLTD 0, one with GLF2;
overlapping windows, the second over the TZR TOA; WAVE about PEPOCH;
IFUNC points inside the span for SIFUNC 0 and 2, so that TOAs lie before
the first and after the last; PHOFF):

* each component's phase within ``PHASE_TOL_CYCLES``, its derivatives in
  its parameters and in the delay within ``COLUMN_TOL`` relative;
* the residuals within 1 ns and every fit parameter's design-matrix
  column within ``COLUMN_TOL`` relative, pint_tpu evaluated op by op
  (``jax.disable_jit``: XLA:CPU's compile of the young par's phase parts
  from pint_tpu's eager evaluation by up to half a cycle, PERF.md);
  the TZR phase, PHOFF's absence from it and the groups that hold the TZR
  TOA; PHOFF in place of the mean subtraction;
* the components' validate errors, the phase family's layout and its
  refusals;
* ``Fitter.auto`` on the young set against pint_tpu's stored fit
  (``python tests/torch_port_data.py young``).

The young set's position and DM columns are held at ``COLUMN_TOL`` like
every other column: the port differentiates the quad-single spin phase
as pint_tpu does, by a float32 forward mode of the words per lane
(``models/spindown.py`` ``phase_frac_jvp``; the fused tangent kernel's
``F32N<L>`` words).  A float64 slope could not: pint_tpu's word-level
tangent is the secant frequency Σ F_k dt^k/(k+1)! of the F words on a
millisecond pulsar, but moves to the instantaneous frequency where F1
dt/2 is resolved in the words' tangents, as on a young pulsar's F1 ~
1e-11 Hz/s, and there carries its words' float32 rounding (~1e-7
relative, not linear in the shift's tangent; pint_tpu's own witness,
``test_secant_slope_departure_witness``).
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu import qs as jqs
from pint_tpu.fitter import build_resid_sec_fn as j_resid_sec
from pint_tpu.models import get_model as jax_get_model
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu.toa import get_TOAs as jax_get_TOAs
from pint_tpu_torch.examples import (PHASE_FAMILY, phase_family_par,
                                     young_start)
from pint_tpu_torch.fitter import Fitter
from pint_tpu_torch.fitter import build_resid_sec_fn as t_resid_sec
from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.kernels import phase_chain as pc
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.piecewise import PW_BITS
from pint_tpu_torch.models.timing_model import PhaseComponent
from pint_tpu_torch.residuals import Residuals as TResiduals
from pint_tpu_torch.toa import get_TOAs

RESID_TOL_S = 1e-9
COLUMN_TOL = 1e-10
#: a component's phase [cycles]: both are the same float64 expressions
PHASE_TOL_CYCLES = 1e-12
#: the TZR phase's words [cycles]: pint_tpu sums each component's phase
#: as a quad-single, the port the float64 phases once (PERF.md)
TZR_TOL_CYCLES = 1e-11
FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
CHI2_TOL = 1e-6
F64 = torch.float64
FAMILY = ("Glitch", "PiecewiseSpindown", "Wave", "IFunc", "PhaseOffset")
#: the young set's delay parameters, whose columns carry the spin phase's
#: word-level tangent in the shift (the module docstring)
DELAY_PARAMS = ("RAJ", "DECJ", "DM")


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


@pytest.fixture(scope="module")
def toas():
    return (_quiet(jax_get_TOAs, data.YOUNG_REF_TIM),
            _quiet(get_TOAs, data.YOUNG_REF_TIM))


PARS = {"YOUNG": data.young_par_lines,
        **{k: (lambda k=k: phase_family_par(k).splitlines())
           for k in PHASE_FAMILY}}


def _pair(kind, toas):
    jt, tt = toas
    par = PARS[kind]()
    jm, tm = _quiet(jax_get_model, par), _quiet(get_model, par)
    with jax.disable_jit():
        jr = _quiet(JResiduals, jt, jm)
    return jm, jr, tm, TResiduals(tt, tm, device="cpu")


@pytest.fixture(scope="module", params=[
    "PHF_EDGES_IF0", *[pytest.param(k, marks=pytest.mark.slow)
                       for k in ("PHF_EDGES_IF2", "YOUNG")]])
def pair(request, toas):
    return (request.param,) + _pair(request.param, toas)


def _rel_gap(a, b):
    """Largest |a - b| per column over the column's largest |b|."""
    a, b = np.atleast_2d(a.T).T, np.atleast_2d(b.T).T
    scale = np.max(np.abs(b), axis=0)
    return float(np.max(np.max(np.abs(a - b), axis=0)
                        / np.where(scale > 0, scale, 1.0)))


def test_component_phases_and_derivatives(pair):
    """Each component's float64 phase on the plain delay, and its
    derivatives in the model's free parameters and in the delay."""
    kind, jm, jr, tm, tr = pair
    jp, jb, tp, tb = jr.pdict, jr.batch, tr.pdict, tr.batch
    names = tm.free_params
    with jax.disable_jit():
        jd = jm.calc.delay(jp, jb)
    with torch.no_grad():
        td = tm.calc.delay_plain(tp, tb)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    jx0, tx0 = jm.x0(jp, names), tm.x0(tp, names)
    for name in FAMILY:
        jc, tc = jm.components[name], tm.components[name]

        def jphase(x, d):
            ph = jc.phase(jm.with_x(jp, x, names), jb, d)
            return jqs.to_f64(ph)

        def tphase(x, d):
            return tc.phase_f64(tm.with_x(tp, x, names), tb, d)

        with jax.disable_jit():
            jv = np.asarray(jphase(jx0, jd))
            jJ = np.asarray(jax.jacfwd(jphase)(jx0, jd))
            jdd = np.asarray(jax.jvp(lambda d: jphase(jx0, d), (jd,),
                                     (jnp.ones_like(jd),))[1])
        tv = tphase(tx0, td).detach().numpy()
        tJ = torch.func.jacfwd(tphase)(tx0, td).detach().numpy()
        tdd = torch.func.jvp(lambda d: tphase(tx0, d), (td,),
                             (torch.ones_like(td),))[1].detach().numpy()
        gap = float(np.max(np.abs(tv - jv)))
        cols, ddel = _rel_gap(tJ, jJ), _rel_gap(tdd, jdd)
        print(f"{kind} {name}: phase {gap:.3e} cycles of "
              f"{float(np.max(np.abs(jv))):.3e}, columns {cols:.3e}, "
              f"d/d delay {ddel:.3e} relative")
        assert gap <= PHASE_TOL_CYCLES
        assert cols <= COLUMN_TOL and ddel <= COLUMN_TOL


def _resid_and_columns(kind, toas):
    """(pint_tpu's, the port's) (residuals [s], design matrix, names) of
    the resid_sec function the fitters differentiate, pint_tpu's op by
    op."""
    jm, jr, tm, tr = _pair(kind, toas)
    names = tm.free_params
    jf = j_resid_sec(jm, jr.batch, names, jr.track_mode)
    tf = t_resid_sec(tm, tr.batch, names, tr.track_mode)

    def jboth(x):
        r = jf(x, jr.pdict)
        return r, r

    with jax.disable_jit():
        jM, jres = jax.jacfwd(jboth, has_aux=True)(jm.x0(jr.pdict, names))
    x0 = tm.x0(tr.pdict, names)
    tM = torch.func.jacfwd(lambda x: tf(x, tr.pdict))(x0).detach().numpy()
    with torch.no_grad():
        tres = tf(x0, tr.pdict).numpy()
    return (np.asarray(jres), np.asarray(jM), tres, tM, names, jm, jr, tm,
            tr)


def _check_resid_and_columns(kind, toas):
    jres, jM, tres, tM, names, jm, jr, tm, tr = _resid_and_columns(kind,
                                                                    toas)
    f0 = float(tm.F0.value)
    # the phase fraction's gap [cycles] is the summation order's (each
    # component's phase as a quad-single in pint_tpu, the float64 phases
    # summed once in the port)
    rgap = float(np.max(np.abs(tres - jres)))
    cols = _rel_gap(tM, jM)
    print(f"{kind}: residuals {rgap:.3e} s ({rgap * f0:.3e} cycles; bar "
          f"{RESID_TOL_S}), {len(names)} columns {cols:.3e} relative (bar "
          f"{COLUMN_TOL})")
    assert rgap <= RESID_TOL_S and cols <= COLUMN_TOL
    # PHOFF replaces the mean subtraction in both packages: the
    # Residuals' are the resid_sec function's
    assert not jr.subtract_mean and not tr.subtract_mean
    np.testing.assert_allclose(tr.time_resids, jres, rtol=0,
                               atol=RESID_TOL_S)
    # the TZR phase: PHOFF adds nothing there, and a group over the TZR
    # TOA adds its phase there (its mask built on the TZR TOA)
    jw = np.asarray(jr.pdict["const"]["__tzrphase__"], np.float64)
    tw = tr.pdict["const"]["__tzrphase__"].numpy().astype(np.float64)
    tzr_gap = abs(float(np.sum(jw) - np.sum(tw)))
    assert tzr_gap <= TZR_TOL_CYCLES and jw[0] == tw[0]
    return jres, jM, tres, tM, names, tm, tr


def test_residuals_and_columns_match_edges(toas):
    """The edge variant with SIFUNC 0: residuals and every column."""
    _, _, _, _, _, tm, tr = _check_resid_and_columns("PHF_EDGES_IF0", toas)
    # its second group holds the TZR TOA
    mask = tm.make_tzr_toas_or_none()
    bits = tm.components["PiecewiseSpindown"].mask_entries(mask)[PW_BITS]
    assert list(bits) == [2]


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["PHF_EDGES_IF2", "PHF_ONE_IF2", "YOUNG"])
def test_residuals_and_columns_match_depth(toas, kind):
    """The edge variants with SIFUNC 2 (six points, one) and the young
    set's par."""
    _check_resid_and_columns(kind, toas)


def _horner_jvp(F, dt, x=1.0):
    """pint_tpu's tangent of its quad-single Taylor phase Σ F_k dt^{k+1}/
    (k+1)! in dt along ``x`` (its word-level forward mode)."""
    Fw = [jqs.from_f64_host(np.float64(f)) for f in F]
    coeffs = [jqs.zeros_like(jnp.zeros((), jnp.float32))] + [
        jqs.QS(*[jnp.float32(w) for w in f.words]) for f in Fw]

    def phase(shift):
        d = jqs.from_f64_device(jnp.float64(dt) + shift)
        return jqs.to_f64(jqs.horner_taylor(d, coeffs))

    with jax.disable_jit():
        return float(jax.jvp(phase, (jnp.float64(0.0),),
                             (jnp.float64(x),))[1])


def test_secant_slope_departure_witness():
    """pint_tpu's own tangent of the spin phase: the secant frequency to
    the last bit at a millisecond pulsar's F1 (the primal's ``slope``),
    the instantaneous one within 1e-7 relative at the young set's F1, up
    to |F1| dt / (2 F0) from the secant.  At the young F1 pint_tpu's
    tangent is its words' float32 rounding: not linear in the shift's
    tangent by ~1e-7 relative, so no float64 slope times d shift meets
    it within COLUMN_TOL (the port forms it word by word:
    tests/test_torch_word_tangent.py); at the millisecond F1 it is linear
    to 1e-15."""
    dt = 1.26e8
    msp, young = [346.53199992, -1.46e-15], [11.19, -1.56e-11, 8e-22]
    sec = [sum(f * dt ** k / np.prod(np.arange(1, k + 2))
               for k, f in enumerate(F)) for F in (msp, young)]
    tan = sum(f * dt ** k / np.prod(np.arange(1, k + 1))
              for k, f in enumerate(young))
    assert _horner_jvp(msp, dt) == sec[0]
    jy = _horner_jvp(young, dt)
    assert abs(jy - tan) <= 1e-7 * young[0]
    assert abs(jy - sec[1]) / young[0] <= abs(young[1]) * dt / (
        2 * young[0]) * 1.01
    along = (1.0, -7.8e-4, 3e-3, 0.37)
    for F, lo, hi in ((young, 1e-8, 1e-6), (msp, 0.0, 1e-15)):
        per_unit = [_horner_jvp(F, dt, x) / x for x in along]
        spread = (max(per_unit) - min(per_unit)) / F[0]
        assert lo < spread <= hi, (F, spread)


@pytest.mark.slow
def test_young_delay_columns_match_word_level_tangent(toas):
    """The young set's position and DM columns against pint_tpu's within
    COLUMN_TOL: the spin phase's tangent is formed per lane from the
    quad-single words, as pint_tpu's forward mode forms it, where the
    secant frequency parted from it by up to |F1| dt_max / (2 F0)."""
    jm, jr, tm, tr = _pair("YOUNG", toas)
    names = list(DELAY_PARAMS)
    jf = j_resid_sec(jm, jr.batch, names, jr.track_mode)
    tf = t_resid_sec(tm, tr.batch, names, tr.track_mode)
    with jax.disable_jit():
        jM = np.asarray(jax.jacfwd(jf)(jm.x0(jr.pdict, names), jr.pdict))
    tM = torch.func.jacfwd(lambda x: tf(x, tr.pdict))(
        tm.x0(tr.pdict, names)).detach().numpy()
    tdb = tr.batch.tdb_day.numpy() + tr.batch.tdb_frac.numpy()
    dt_max = float(np.max(np.abs(tdb - tm.PEPOCH.mjd_float))) * 86400
    secant = abs(float(tm.F1.value)) * dt_max / (2 * float(tm.F0.value))
    gap = _rel_gap(tM, jM)
    print(f"YOUNG position and DM columns: {gap:.3e} relative (bar "
          f"{COLUMN_TOL}; the secant frequency's gap was {secant:.3e})")
    assert gap <= COLUMN_TOL


def _raises_same(lines, match):
    for gm in (get_model, jax_get_model):
        with pytest.raises(ValueError, match=match):
            _quiet(gm, data.young_par_lines()[:13] + lines)


def test_validate_errors_as_pint_tpu():
    _raises_same(["GLEP_1 55000", "GLF0D_1 1e-8"], "GLTD_1 is zero")
    _raises_same(["PWEP_1 55000", "PWSTART_1 54900"], "needs PWSTOP_1")
    _raises_same(["WAVE_OM 0.01", "WAVE1 1e-6 1e-6", "WAVE3 1e-6 1e-6"],
                 "non-contiguous WAVE")
    _raises_same(["WAVE1 1e-6 1e-6"], "require WAVE_OM")
    _raises_same(["IFUNC1 55000 1e-6"], "require SIFUNC")
    _raises_same(["SIFUNC 1", "IFUNC1 55000 1e-6"], "not supported")
    _raises_same(["SIFUNC 2", "IFUNC1 56000 1e-6", "IFUNC2 55000 1e-6"],
                 "MJD-sorted")


def test_phase_family_layout(toas):
    """The young par's family in the fused θ: F0, the glitches' and the
    group's blocks, the WAVE block, the pairs and points as constants; the
    launch's template value the phase family's on no binary."""
    _, _, tm, tr = _pair("YOUNG", toas)
    fam = tm.calc.phase_family
    ngl, npw, nwave, nif, sifunc, o_f0, o_gl, o_pw, o_wave, c_wave, c_if \
        = fam.counts
    assert (ngl, npw, nwave, nif, sifunc) == (3, 1, 10, 16, 2)
    assert fam.P == 1 + 7 * 3 + 5 + 2 and (o_f0, o_gl, o_pw, o_wave) == (
        0, 1, 22, 27)
    assert (c_wave, c_if) == (0, 20)
    spec, theta, other, tensors = pc.fused_inputs(tm.calc, tr.pdict,
                                                  tr.batch, "nearest")
    assert spec.P == theta.shape[0] == tm.calc.chain_layout.P + 3 + 1 + 29
    assert spec.kernel_index == 28 and spec.flags & dc.PHASE_TERMS
    assert spec.chain_cfg().o_gl == spec.layout.P + 4 + o_gl
    consts = dict(zip(pc.CONSTS, tensors[len(dc.ROWS):]))
    assert consts["fconst"].shape == (2 * 10 + 2 * 16,)
    assert consts["pw_bits"].dtype == torch.int32
    # other: PHOFF alone (the family is formed in the launch)
    np.testing.assert_array_equal(other.numpy(),
                                  -float(tm.PHOFF.value) * np.ones(200))
    assert tm.calc.chain_layout.kernel_index == 0


def test_phase_family_refusals(toas):
    """More than 31 groups, and a component whose phase reads the delay
    and that the family does not cover, are refused by the fused launch's
    layout (NotImplementedError naming them)."""
    lines = data.young_par_lines()[:13]
    for i in range(1, 33):
        lines += [f"PWEP_{i} {55000 + i}", f"PWSTART_{i} {54900 + i}",
                  f"PWSTOP_{i} {55100 + i}", f"PWF0_{i} 1e-10"]
    model = _quiet(get_model, lines)
    with pytest.raises(NotImplementedError, match="32 groups"):
        _ = model.calc.phase_family

    class DelayReader(PhaseComponent):
        register = False
        category = "ifunc"

        def phase_f64(self, p, batch, delay, is_tzr=False):
            return delay

    tm, _ = _pair("YOUNG", toas)[2:]
    others = [DelayReader()] + tm.calc._kernel_layout()[1]
    with pytest.raises(NotImplementedError, match="DelayReader"):
        pc.PhaseFamily.from_components(others)
    with pytest.raises(NotImplementedError, match="DelayReader"):
        pc._other_phase(others, None, None, None)


def test_young_fit_matches_stored(toas):
    """``Fitter.auto`` from ``examples.young_start`` on the young set
    against pint_tpu's stored fit: values within 1e-3 sigma,
    uncertainties within 1e-3 relative, chi2 within 1e-6."""
    with open(data.YOUNG_REF_JSON) as f:
        want = json.load(f)
    tt = toas[1]
    model = _quiet(get_model, data.young_par_lines())
    young_start(model)
    fitter = Fitter.auto(tt, model, device="cpu")
    chi2 = _quiet(fitter.fit_toas)
    sig, unc = data.fit_gaps(model, want["values"], want["uncertainties"])
    gap = abs(chi2 / want["chi2"] - 1.0)
    print(f"young fit vs pint_tpu: {sig:.3e} sigma, uncertainties "
          f"{unc:.3e}, chi2 {gap:.3e}")
    assert type(fitter).__name__ == want["fitter"]
    assert fitter.fit_params == want["fit_params"]
    assert fitter.fitresult.status.name == want["status"]
    assert sig <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
