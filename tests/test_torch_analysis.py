"""pint_tpu_torch's analysis modules against pint_tpu's, on the CPU:
``phase`` (``Phase``), ``derived_quantities``, ``Astrometry.radec_deg``,
``binaryconvert`` and ``modelselect``.

The same inputs go through both packages (JAX on the CPU, float64):

* ``Phase``: every operation bit-equal on the same float64 arrays;
* ``derived_quantities``: each function equal to pint_tpu's (both are
  the same float64 expressions on numpy and the same constants);
* ``radec_deg``: equal on an equatorial and an ecliptic par;
* ``convert_binary``: every value of the converted par equal to
  pint_tpu's, round trips back to the start within the reference
  tests' bars, and the converted models' residuals on the committed
  200-TOA sets within ``RESID_TOL_S`` of pint_tpu's;
* ``modelselect``: ``FTest`` equal, AIC and BIC within ``LNLIKE_TOL``
  relative, ``dmx_ranges`` the same bins and mask, the WAVE <-> WaveX
  translations the same values, ``plrednoise_from_wavex`` and
  ``pldmnoise_from_dmwavex`` the same power laws (their uncertainties
  within ``PL_UNC_TOL``); ``ftest`` (adding FD5
  to the J0740 set's WLS fit) within ``FIT_CHI2_TOL`` of pint_tpu's
  chi2 values and probability.
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu import binaryconvert as jbc
from pint_tpu import derived_quantities as jdq
from pint_tpu import modelselect as jms
from pint_tpu import phase as jphase
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.models import get_model as jax_get_model
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch import binaryconvert as tbc
from pint_tpu_torch import derived_quantities as tdq
from pint_tpu_torch import modelselect as tms
from pint_tpu_torch import phase as tphase
from pint_tpu_torch.fitter import WLSFitter as TWLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals as TResiduals

#: residuals of a converted model against pint_tpu's [s]
RESID_TOL_S = 1e-9
#: AIC/BIC relative: the residuals part by ~1e-12 s (the summation
#: orders of the two phase chains), which moves chi2 by up to ~1e-6
#: relative (the fits' chi2 bar, tests/test_torch_fit.py)
LNLIKE_TOL = 1e-6
#: the power law's uncertainties, relative: a finite-difference Hessian
#: (steps of 1e-3) of a likelihood whose logs and powers round another
#: way in torch than in XLA by an ulp here and there
PL_UNC_TOL = 1e-6
#: ftest's chi2 values, relative (tests/test_torch_fit.py's fit bar)
FIT_CHI2_TOL = 1e-6


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


# -- Phase ----------------------------------------------------------------
PHASES = np.array([0.0, 0.49999999, -0.5, 2.5, 1e11 + 0.3, -7.25e9 - 0.4,
                   123456789.987654321])


def _pair(p):
    return np.asarray(p.int, np.float64), np.asarray(p.frac, np.float64)


def _same(j, t):
    for a, b in zip(_pair(j), (t.int.numpy(), t.frac.numpy())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", ["from_float", "add", "sub", "neg",
                                "quantity", "to_dd", "from_dd", "zeros",
                                "add_float"])
def test_phase_operations_exact(op):
    x, y = PHASES, PHASES[::-1] * 0.37
    jx, tx = jphase.from_float(jnp.asarray(x)), tphase.from_float(
        torch.from_numpy(x))
    jy, ty = jphase.from_float(jnp.asarray(y)), tphase.from_float(
        torch.from_numpy(y))
    if op == "from_float":
        _same(jx, tx)
    elif op == "add":
        _same(jx + jy, tx + ty)
    elif op == "sub":
        _same(jx - jy, tx - ty)
    elif op == "neg":
        _same(-jx, -tx)
    elif op == "quantity":
        np.testing.assert_array_equal(np.asarray(jx.quantity),
                                      tx.quantity.numpy())
    elif op == "to_dd":
        jd, td = jx.to_dd(), tx.to_dd()
        np.testing.assert_array_equal(np.asarray(jd.hi), td.hi.numpy())
        np.testing.assert_array_equal(np.asarray(jd.lo), td.lo.numpy())
    elif op == "from_dd":
        from pint_tpu import dd as jdd
        from pint_tpu_torch import dd as tdd

        lo = y * 1e-17
        _same(jphase.from_dd(jdd.from_two(jnp.asarray(x), jnp.asarray(lo))),
              tphase.from_dd(tdd.from_two(torch.from_numpy(x),
                                          torch.from_numpy(lo))))
    elif op == "zeros":
        _same(jphase.zeros((3,)), tphase.zeros((3,)))
    else:
        _same(jx + 0.75, tx + 0.75)


# -- derived quantities ---------------------------------------------------
DQ_CASES = [
    ("p_to_f", (0.0333, -1e-15)), ("p_to_f", (0.0333, -1e-15, 2e-25)),
    ("pferrs", (0.0333, 1e-12)), ("pferrs", (29.9, 1e-9, -3.7e-10, 1e-15)),
    ("pulsar_age", (29.946923, -3.77535e-10)),
    ("pulsar_edot", (29.946923, -3.77535e-10)),
    ("pulsar_B", (29.946923, -3.77535e-10)),
    ("pulsar_B_lightcyl", (29.946923, -3.77535e-10)),
    ("mass_funct", (4.76694461, 3.9775561)),
    ("mass_funct2", (2.08, 0.253, 87.0)),
    ("pulsar_mass", (4.76694461, 3.9775561, 0.26, 87.0)),
    ("companion_mass", (4.76694461, 3.9775561, 87.0, 2.0)),
    ("companion_mass", (0.0905, 0.0476, 40.0, 1.4)),
    ("pbdot", (1.438, 1.390, 0.322997448918, 0.6171338)),
    ("gamma", (1.438, 1.390, 0.322997448918, 0.6171338)),
    ("omdot", (1.438, 1.390, 0.322997448918, 0.6171338)),
    ("sini", (1.4, 0.3, 10.0, 4.0)),
    ("omdot_to_mtot", (4.226595, 0.322997448918, 0.6171338)),
    ("a1sini", (1.4, 0.3, 10.0)),
    ("shklovskii_factor", (141.0, 0.157)),
    ("dispersion_slope", (14.96,)),
]


@pytest.mark.parametrize("name,args", DQ_CASES,
                         ids=[f"{n}-{len(a)}" for n, a in DQ_CASES])
def test_derived_quantities_equal(name, args):
    want = getattr(jdq, name)(*args)
    got = getattr(tdq, name)(*args)
    np.testing.assert_array_equal(np.asarray(got, np.float64),
                                  np.asarray(want, np.float64))
    assert tdq.__all__ == jdq.__all__


# -- radec_deg ------------------------------------------------------------
@pytest.mark.parametrize("kind", ["equatorial", "ecliptic"])
def test_radec_deg_equal(kind):
    par = (data.dd_par_lines() if kind == "equatorial"
           else data.variant_par_lines("DDK_ECL"))
    jm, tm = _quiet(jax_get_model, par), _quiet(get_model, par)
    name = "AstrometryEquatorial" if kind == "equatorial" \
        else "AstrometryEcliptic"
    want = jm.components[name].radec_deg()
    got = tm.components[name].radec_deg()
    print(f"{kind}: radec_deg {got} (pint_tpu {want})")
    assert got == want


# -- binaryconvert --------------------------------------------------------
def _values(model):
    """{parameter: value} of a model's par file lines (as written)."""
    out = {}
    for line in model.as_parfile().splitlines():
        parts = line.split()
        if len(parts) >= 2:
            out[parts[0]] = parts[1]
    return out


#: (start set, chain of targets): the J0740 set's ELL1 and the DD set's DD
CONVERSIONS = [("ELL1", ("DD", "ELL1")), ("ELL1", ("ELL1H", "ELL1")),
               ("ELL1", ("ELL1K", "ELL1")), ("ELL1", ("DDS",)),
               ("DD", ("ELL1", "DD")), ("DD", ("DDH", "DD")),
               ("DD", ("DDK",)), ("DD", ("BT",))]
def _j0740_par():
    from pint_tpu_torch.examples import j0740_realistic_par

    return j0740_realistic_par(dmx_bins=data.DMX_BINS,
                               span_days=data.SPAN_DAYS,
                               center_mjd=data.CENTER_MJD).splitlines()


BINARY_SETS = {"ELL1": (_j0740_par, data.REF_TIM),
               "DD": (data.dd_par_lines, data.DD_REF_TIM)}


@pytest.mark.parametrize("start,chain", CONVERSIONS,
                         ids=["-".join((s,) + c) for s, c in CONVERSIONS])
def test_convert_binary_matches_reference(start, chain):
    par, tim = BINARY_SETS[start]
    jm, tm = _quiet(jax_get_model, par()), _quiet(get_model, par())
    for target in chain:
        jm = _quiet(jbc.convert_binary, jm, target, KOM=10.0)
        tm = _quiet(tbc.convert_binary, tm, target, KOM=10.0)
        assert _values(tm) == _values(jm), target
        assert type(tm.components[
            [n for n in tm.components if n.startswith("Binary")][0]
        ]).__name__ == type(jm.components[
            [n for n in jm.components if n.startswith("Binary")][0]
        ]).__name__
    jt = _quiet(data.load_jax, tim, par=par())[1]
    tt = _quiet(data.load_torch, tim, par=par())[1]
    jres = np.asarray(_quiet(JResiduals, jt, jm).time_resids)
    tres = TResiduals(tt, tm, device="cpu").time_resids
    gap = float(np.max(np.abs(tres - jres)))
    print(f"{start} -> {'/'.join(chain)}: residuals {gap:.3e} s from "
          f"pint_tpu's (bar {RESID_TOL_S})")
    assert gap <= RESID_TOL_S


def test_convert_binary_refusals_match():
    tm = _quiet(get_model, data.dd_par_lines())
    jm = _quiet(jax_get_model, data.dd_par_lines())
    for target in ("DDGR", "XYZ"):
        with pytest.raises(ValueError) as je:
            jbc.convert_binary(jm, target)
        with pytest.raises(ValueError) as te:
            tbc.convert_binary(tm, target)
        assert str(te.value) == str(je.value)


# -- modelselect ----------------------------------------------------------
@pytest.mark.parametrize("args", [(120.0, 100, 95.0, 98), (120.0, 100,
                                                            119.0, 99),
                                  (50.0, 40, 10.0, 20)])
def test_ftest_probability_equal(args):
    assert tms.FTest(*args) == jms.FTest(*args)


@pytest.fixture(scope="module")
def j0740():
    jm, jt = _quiet(data.load_jax, data.REF_TIM, grid=True)
    tm, tt = _quiet(data.load_torch, data.REF_TIM, grid=True)
    return jm, jt, tm, tt


@pytest.mark.parametrize("which", ["aic", "bic"])
def test_information_criteria_match(j0740, which):
    jm, jt, tm, tt = j0740
    jf, tf = (("akaike_information_criterion",) * 2 if which == "aic"
              else ("bayesian_information_criterion",) * 2)
    want = _quiet(getattr(jms, jf), jm, jt)
    got = _quiet(getattr(tms, tf), tm, tt, device="cpu")
    rel = abs(got / want - 1.0)
    print(f"{which}: {got!r} (pint_tpu {want!r}), {rel:.3e} relative")
    assert rel <= LNLIKE_TOL


def test_dmx_ranges_match(j0740):
    _, jt, _, tt = j0740
    jmask, jc = jms.dmx_ranges(jt, divide_freq_mhz=1000.0,
                               binwidth_days=300.0)
    tmask, tc = tms.dmx_ranges(tt, divide_freq_mhz=1000.0,
                               binwidth_days=300.0)
    np.testing.assert_array_equal(tmask, jmask)
    assert sorted(tc.params) == sorted(jc.params)
    for n in jc.params:
        assert tc.params[n].value == jc.params[n].value, n


def test_wave_wavex_translations_match():
    par = data.young_par_lines()
    jm, tm = _quiet(jax_get_model, par), _quiet(get_model, par)
    jx, tx = _quiet(jms.translate_wave_to_wavex, jm), _quiet(
        tms.translate_wave_to_wavex, tm)
    assert _values(tx) == _values(jx)
    jw, tw = _quiet(jms.translate_wavex_to_wave, jx), _quiet(
        tms.translate_wavex_to_wave, tx)
    assert _values(tw) == _values(jw)


@pytest.mark.parametrize("kind", ["WaveX", "DMWaveX"])
def test_powerlaw_from_wavex_matches(kind):
    """The power law fitted to a WaveX (DMWaveX) series with stated
    amplitudes and uncertainties: the same spectral values and
    uncertainties in both packages (Nelder-Mead on the same numpy
    likelihood)."""
    prefix = "WX" if kind == "WaveX" else "DMWX"
    base = [ln for ln in data.dd_par_lines() if not ln.startswith("DMX")]
    rng = np.random.default_rng(3)
    lines = list(base) + [f"{prefix}EPOCH 55000"]
    for i in range(1, 9):
        lines += [f"{prefix}FREQ_{i:04d} {i / 3650.0!r}",
                  f"{prefix}SIN_{i:04d} {1e-6 * rng.standard_normal() / i!r}"
                  " 1 1e-7",
                  f"{prefix}COS_{i:04d} {1e-6 * rng.standard_normal() / i!r}"
                  " 1 1e-7"]
    jm, tm = _quiet(jax_get_model, lines), _quiet(get_model, lines)
    fn = "plrednoise_from_wavex" if kind == "WaveX" \
        else "pldmnoise_from_dmwavex"
    jo, to = _quiet(getattr(jms, fn), jm), _quiet(getattr(tms, fn), tm)
    names = (("TNREDAMP", "TNREDGAM", "TNREDC") if kind == "WaveX"
             else ("TNDMAMP", "TNDMGAM", "TNDMC"))
    for n in names:
        assert float(to[n].value) == float(jo[n].value), n
        if jo[n].uncertainty is not None:
            assert math.isclose(to[n].uncertainty, jo[n].uncertainty,
                                rel_tol=PL_UNC_TOL), n
    print(f"{kind}: log10_A {float(to[names[0]].value):.6f}, gamma "
          f"{float(to[names[1]].value):.6f}")


@pytest.mark.slow
def test_ftest_workflow_matches(j0740):
    """``ftest`` adding FD5 to the J0740 set's WLS fit: both fits' chi2
    and dof and the probability against pint_tpu's."""
    jm, jt, tm, tt = j0740
    jf = JWLSFitter(jt, jm)
    _quiet(jf.fit_toas, maxiter=2)
    tf = TWLSFitter(tt, tm, device="cpu")
    _quiet(tf.fit_toas, maxiter=2)
    want = _quiet(jms.ftest, jf, add_lines="FD5 0 1", maxiter=2)
    got = _quiet(tms.ftest, tf, add_lines="FD5 0 1", maxiter=2)
    for k in ("chi2_base", "chi2_new"):
        assert abs(got[k] / want[k] - 1.0) <= FIT_CHI2_TOL, k
    assert (got["dof_base"], got["dof_new"]) == (want["dof_base"],
                                                  want["dof_new"])
    assert math.isclose(got["ft"], want["ft"], rel_tol=FIT_CHI2_TOL)
    print(f"ftest FD5: p {got['ft']!r} (pint_tpu {want['ft']!r})")
