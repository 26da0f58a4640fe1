"""pint_tpu_torch residuals vs pint_tpu.residuals.Residuals.

The same par string and tim file go through both packages (the port on
the CPU, where its phase kernel runs as its plain version); the time
residuals agree to <= 1 ns max abs, the bar tests/test_crossbackend.py
holds between backends, in each tracking and mean-subtraction mode.
"""

import os

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu import qs as jqs
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.residuals import Residuals as TResiduals

RESID_TOL_S = 1e-9
BENCH_TIM = os.path.join(os.path.dirname(data.DATA_DIR), os.pardir,
                         "bench_cache", "j0740_bench_wide_12500.tim")


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tim = data.sim_tim(tmp_path_factory)
    jm, jt = data.load_jax(tim)
    tm, tt = data.load_torch(tim)
    return jm, jt, tm, tt


def _gap(jr, tr, what):
    gap = float(np.max(np.abs(jr.time_resids - tr.time_resids)))
    print(f"{what}: max |dt| = {gap:.3e} s over {len(tr.time_resids)} TOAs "
          f"(bar {RESID_TOL_S:.0e})")
    return gap


@pytest.mark.parametrize("subtract_mean,weighted", [
    (True, True), (True, False), (False, False)])
def test_time_resids_nearest(sim, subtract_mean, weighted):
    """"nearest" tracking, weighted / plain / no mean subtraction."""
    jm, jt, tm, tt = sim
    kw = dict(subtract_mean=subtract_mean, use_weighted_mean=weighted)
    jr, tr = JResiduals(jt, jm, **kw), TResiduals(tt, tm, device="cpu", **kw)
    assert tr.track_mode == jr.track_mode == "nearest"
    assert _gap(jr, tr, f"nearest mean={subtract_mean} w={weighted}") \
        <= RESID_TOL_S


def test_resid_statistics(sim):
    """chi2, weighted rms and dof of the wrapper."""
    jm, jt, tm, tt = sim
    jr, tr = JResiduals(jt, jm), TResiduals(tt, tm, device="cpu")
    rel = abs(jr.calc_chi2() - tr.calc_chi2()) / jr.calc_chi2()
    print(f"chi2 {tr.calc_chi2():.6f} (rel gap {rel:.3e}); rms "
          f"{tr.rms_weighted():.6e} s")
    assert rel <= 1e-9
    assert abs(jr.rms_weighted() - tr.rms_weighted()) <= RESID_TOL_S
    assert jr.dof == tr.dof
    np.testing.assert_array_equal(jr.get_data_error(), tr.get_data_error())


def test_time_resids_pulse_numbers(sim):
    """"use_pulse_numbers" tracking: pulse numbers from pint_tpu's own
    absolute phase, every fifth one moved by a pulse, as ``-pn`` flags on
    both TOA sets."""
    jm, jt, tm, tt = sim
    jr = JResiduals(jt, jm)
    ph = jm.calc.phase(jr.pdict, jr.batch)
    n, _ = jqs.round_nearest(ph)
    n = np.array(n, np.float64)
    n[::5] += 1.0
    for toas in (jt, tt):
        for fl, pn in zip(toas.flags, n):
            fl["pn"] = str(int(pn))
    try:
        jr = JResiduals(jt, jm, track_mode="use_pulse_numbers")
        tr = TResiduals(tt, tm, track_mode="use_pulse_numbers", device="cpu")
        assert _gap(jr, tr, "use_pulse_numbers") <= RESID_TOL_S
        # the moved pulses show as whole-period steps in both
        assert np.max(np.abs(tr.phase_resids)) > 0.5
    finally:
        for toas in (jt, tt):
            for fl in toas.flags:
                fl.pop("pn", None)


def test_phase_resids_differentiable(sim):
    """jacfwd of the port's residual function through the phase kernel's
    tangent rule gives finite, nonzero columns for every free parameter."""
    _, _, tm, tt = sim
    from pint_tpu_torch.fitter import build_resid_sec_fn

    tr = TResiduals(tt, tm, device="cpu")
    names = tm.free_params
    f = build_resid_sec_fn(tm, tr.batch, names, "nearest")
    J = torch.func.jacfwd(f)(torch.zeros(len(names), dtype=torch.float64),
                             tr.pdict)
    assert J.shape == (tt.ntoas, len(names))
    assert torch.all(torch.isfinite(J))
    assert torch.all(torch.amax(torch.abs(J), dim=0) > 0)


@pytest.mark.slow
def test_time_resids_bench_tim_full_width():
    """The 12,500-TOA bench tim at the full J0740 width (70 DMX bins)."""
    import warnings

    from pint_tpu.examples import j0740_realistic_par as jpar
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.toa import get_TOAs as jget_toas
    from pint_tpu_torch.examples import j0740_realistic_par as tpar
    from pint_tpu_torch.models import get_model as tget_model
    from pint_tpu_torch.toa import get_TOAs as tget_toas

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jget_model(jpar().splitlines())
        jt = jget_toas(BENCH_TIM, model=jm)
        tm = tget_model(tpar().splitlines())
        tt = tget_toas(BENCH_TIM, model=tm)
    jr, tr = JResiduals(jt, jm), TResiduals(tt, tm, device="cpu")
    assert _gap(jr, tr, "bench tim") <= RESID_TOL_S
