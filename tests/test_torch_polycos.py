"""pint_tpu_torch's polycos against pint_tpu's, on the CPU.

The J0740 set's par (ELL1, 200-TOA set's epoch range) at GBT, 1400 MHz:
two 60-minute segments of 12 coefficients from 24 samples each, in both
packages (JAX on the CPU, float64; the port's sample phases from one
words-mode evaluation of the phase chain, its plain composition here):

* each segment's integer reference phase equal, its fraction within
  ``FRAC_TOL_CYCLES`` of pint_tpu's, and the polyco phase at off-node
  times the same integers and fractions within ``FRAC_TOL_CYCLES``;
* the polyco phase within ``MODEL_TOL_CYCLES`` of the port's model phase
  at those times (the reference's own round trip);
* each package reads the other's tempo file to the same entries as the
  writer's own reader, and evaluates them to the same phases;
* a time outside every segment raises in both.
"""

import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.models import get_model as jax_get_model
from pint_tpu.polycos import Polycos as JPolycos
from pint_tpu_torch import qs
from pint_tpu_torch.models import get_model
from pint_tpu_torch.polycos import Polycos
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import get_TOAs_array

#: the two packages' sample phases part by the summation orders of their
#: phase chains (~1e-11 cycles), which the fit carries to its fractions
FRAC_TOL_CYCLES = 1e-9
#: polyco against the model at off-node times (the reference's bar)
MODEL_TOL_CYCLES = 1e-6
START = 54975.25
SEGMENTS = 2
SEG_MIN = 60.0


def _par():
    from pint_tpu_torch.examples import j0740_realistic_par

    return j0740_realistic_par(dmx_bins=data.DMX_BINS,
                               span_days=data.SPAN_DAYS,
                               center_mjd=data.CENTER_MJD).splitlines()


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


@pytest.fixture(scope="module")
def polycos():
    end = START + SEGMENTS * SEG_MIN / 1440.0
    tm, jm = _quiet(get_model, _par()), _quiet(jax_get_model, _par())
    kw = dict(obs="gbt", segLength=SEG_MIN, ncoeff=12, obsFreq=1400.0,
              nsamples=24)
    tp = _quiet(Polycos.generate_polycos, tm, START, end, device="cpu", **kw)
    jp = _quiet(JPolycos.generate_polycos, jm, START, end, **kw)
    return tm, tp, jp


def _times():
    rng = np.random.default_rng(7)
    return START + SEGMENTS * SEG_MIN / 1440.0 * rng.random(20)


def test_segments_match_reference(polycos):
    _, tp, jp = polycos
    assert len(tp.entries) == len(jp.entries) == SEGMENTS
    for t, j in zip(tp.entries, jp.entries):
        assert (t.tmid, t.mjdspan, t.ncoeff, t.obs, t.f0, t.psrname) == (
            j.tmid, j.mjdspan, j.ncoeff, j.obs, j.f0, j.psrname)
        assert t.rphase_int == j.rphase_int
        gap = abs(t.rphase_frac - j.rphase_frac)
        print(f"segment at {t.tmid}: rphase {t.rphase_int} + "
              f"{t.rphase_frac!r}, {gap:.3e} cycles from pint_tpu's; "
              f"log10 rms {t.log10_rms:.2f}")
        assert gap <= FRAC_TOL_CYCLES


def test_phase_at_times_matches_reference(polycos):
    _, tp, jp = polycos
    t = _times()
    ti, tf = tp.eval_abs_phase(t)
    ji, jf = jp.eval_abs_phase(t)
    d = (ti - ji) + (tf - jf)
    gap = float(np.max(np.abs(d)))
    print(f"polyco phase at 20 times: {gap:.3e} cycles from pint_tpu's")
    np.testing.assert_array_equal(ti, ji)
    assert gap <= FRAC_TOL_CYCLES
    np.testing.assert_allclose(tp.eval_spin_freq(t), jp.eval_spin_freq(t),
                               rtol=1e-12)


def test_phase_matches_model(polycos):
    tm, tp, _ = polycos
    t = _times()
    ints, fracs = tp.eval_abs_phase(t)
    toas = _quiet(get_TOAs_array, t, obs="gbt", errors_us=1.0,
                  freqs_mhz=np.full(len(t), 1400.0), ephem="DE421")
    r = Residuals(toas, tm, subtract_mean=False, device="cpu")
    with torch.no_grad():
        w = tm.calc.phase_frac(r.pdict, r.batch, "words")
        ip, fp = qs.round_nearest(qs.QS(*[w[:, k] for k in range(4)]))
    d = (ints - ip.numpy()) + (fracs - qs.to_f64(fp).numpy())
    d -= np.round(d)
    gap = float(np.max(np.abs(d)))
    print(f"polyco vs model phase: {gap:.3e} cycles (bar "
          f"{MODEL_TOL_CYCLES})")
    assert gap <= MODEL_TOL_CYCLES


@pytest.mark.parametrize("writer", ["port", "pint_tpu"])
def test_files_read_across(polycos, writer, tmp_path):
    """The writer's tempo file read by both packages: the same entries,
    evaluated to the same phases."""
    _, tp, jp = polycos
    fn = str(tmp_path / "polyco.dat")
    (tp if writer == "port" else jp).write_polyco_file(fn)
    a, b = Polycos.read_polyco_file(fn), JPolycos.read_polyco_file(fn)
    assert len(a.entries) == len(b.entries) == SEGMENTS
    for x, y in zip(a.entries, b.entries):
        assert (x.tmid, x.rphase_int, x.rphase_frac, x.f0, x.obs,
                x.obsfreq, x.ncoeff) == (y.tmid, y.rphase_int,
                                         y.rphase_frac, y.f0, y.obs,
                                         y.obsfreq, y.ncoeff)
        np.testing.assert_array_equal(x.coeffs, y.coeffs)
    t = _times()
    for (i1, f1), (i2, f2) in ((a.eval_abs_phase(t), b.eval_abs_phase(t)),):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(f1, f2)


def test_uncovered_time_raises(polycos):
    _, tp, jp = polycos
    for p in (tp, jp):
        with pytest.raises(ValueError, match="not covered"):
            p.eval_abs_phase([START + 10.0])
