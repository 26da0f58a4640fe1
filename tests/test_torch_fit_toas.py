"""pint_tpu_torch's ``WLSFitter.fit_toas`` vs pint_tpu's, on the DD set.

The committed 200-TOA DD set (``tests/data/dd_sim_200.tim``, the par of
``dd_realistic_par(dmx_bins=8)``) and pint_tpu's eager
``fit_toas(maxiter=3)`` from a perturbed start, stored beside it
(``dd_sim_200_fit.json``; ``test_committed_dd_reference_is_current``
re-runs pint_tpu and holds the files to it).  With the port on the CPU:

* ``sentinel_advance`` on crafted chi2 sequences (NaN, three rises, a
  period-2 stall, convergence): pint_tpu's status, streaks and best_x;
* the eager ``fit_toas`` and the fused loop (``build_fused_fit``, which
  ``fit_toas`` takes on CUDA) against pint_tpu's eager fit: values
  within 1e-3 sigma, uncertainties within 1e-3 relative, chi2 within
  1e-6 relative; the same FitStatus, iterations and rung; START, FINISH
  and CHI2 written back;
* the fused loop's host reads: one int32 status per iteration, no other;
* degradation: a poisoned uncertainty makes the fused loop NONFINITE,
  the eager rung fails too, and ConvergenceFailure carries both rungs'
  statuses;
* ``apply_deltas`` folds offsets back as pint_tpu's does (MJD included).
"""

import copy
import json
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu_torch.exceptions import ConvergenceFailure
from pint_tpu_torch.fitter import (FitDegradedWarning, FitStatus, WLSFitter,
                                   build_fused_fit, sentinel_advance)

FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
CHI2_TOL = 1e-6
F64 = torch.float64


@pytest.fixture(scope="module")
def ref():
    with open(data.DD_REF_JSON) as f:
        return json.load(f)


def _start(ref):
    """The port's (model, toas) at the reference fit's start."""
    model, toas = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    data.perturb_dd(model)
    assert data.device_values(model, ref["fit_params"]) == ref["start"]
    return model, toas


def _gaps(model, ref):
    dev = max(abs(float(np.sum(np.asarray(model[n].device_value)
                               - np.asarray(v))))
              / ref["uncertainties"][n] for n, v in ref["values"].items())
    unc = max(abs(model[n].device_uncertainty / u - 1.0)
              for n, u in ref["uncertainties"].items())
    return dev, unc


# -- the convergence sentinel ---------------------------------------------
SEQUENCES = {
    "nonfinite": [10.0, 9.0, float("nan")],
    "three_rises": [10.0, 11.0, 12.0, 13.0],
    "period2_stall": [10.0, 9.0, 9.5, 9.0, 9.5, 9.0, 9.5, 9.0, 9.5],
    "converged": [10.0, 9.0, 8.999999999],
}


@pytest.mark.parametrize("case", list(SEQUENCES))
def test_sentinel_matches_jax(case):
    """Run both sentinels over the same chi2 sequence (x_k = k) until a
    status other than RUNNING; compare every step's bookkeeping."""
    import jax.numpy as jnp

    from pint_tpu.fitter import sentinel_advance as j_sentinel

    tol, streak, stall = 1e-8, 3, 6
    j = (jnp.zeros(2), jnp.float64(jnp.inf), jnp.zeros(2),
         jnp.float64(jnp.inf), jnp.int32(0), jnp.int32(0))
    i32 = torch.zeros((), dtype=torch.int32)
    inf = torch.tensor(float("inf"), dtype=F64)
    t = (torch.zeros(2, dtype=F64), inf, torch.zeros(2, dtype=F64), inf,
         i32, i32)
    statuses = []
    for k, c in enumerate(SEQUENCES[case]):
        jx, jprev, jbx, jbc, jinc, jst = j
        bx, bc, inc, st, status = j_sentinel(
            jnp.full(2, float(k)), jnp.float64(c), jprev, jbx, jbc, jinc,
            jst, tol, streak, stall)
        tx, tprev, tbx, tbc, tinc, tst = t
        out = sentinel_advance(torch.full((2,), float(k), dtype=F64),
                               torch.tensor(c, dtype=F64), tprev, tbx, tbc,
                               tinc, tst, tol, streak, stall)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(bx))
        assert float(out[1]) == float(bc) or (
            np.isnan(float(bc)) and np.isnan(float(out[1])))
        assert (int(out[2]), int(out[3]), int(out[4])) == \
            (int(inc), int(st), int(status))
        statuses.append(int(status))
        j = (None, jnp.float64(c), bx, bc, inc, st)
        t = (None, torch.tensor(c, dtype=F64), *out[:4])
        if int(status) != -1:
            break
    want = {"nonfinite": FitStatus.NONFINITE,
            "three_rises": FitStatus.DIVERGED,
            "period2_stall": FitStatus.DIVERGED,
            "converged": FitStatus.CONVERGED}[case]
    print(f"{case}: statuses {statuses}")
    assert statuses[-1] == want


# -- fits against pint_tpu's ------------------------------------------------
@pytest.fixture(scope="module")
def eager_fit(ref):
    model, toas = _start(ref)
    fitter = WLSFitter(toas, model, device="cpu")
    assert not fitter._fused_ok()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=ref["maxiter"])
    return model, fitter, chi2


def test_eager_fit_toas_matches_jax(eager_fit, ref):
    model, fitter, chi2 = eager_fit
    assert fitter.fit_params == ref["fit_params"]
    dev, unc = _gaps(model, ref)
    gap = abs(chi2 - ref["chi2"]) / ref["chi2"]
    fr = fitter.fitresult
    print(f"eager: {dev:.3e} sigma, unc {unc:.3e}, chi2 {chi2:.9f} vs "
          f"{ref['chi2']:.9f} ({gap:.3e}); {fr.status.name} after "
          f"{fr.iterations} on {fr.rung}")
    assert dev <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
    assert (fr.status.name, fr.iterations, fr.rung) == \
        (ref["status"], ref["iterations"], ref["rung"])


def test_fit_writes_back_provenance(eager_fit, ref):
    model, fitter, chi2 = eager_fit
    mjds = fitter.resids.batch.tdbld.numpy()
    assert model.START.value == f"{mjds.min():.4f}"
    assert model.FINISH.value == f"{mjds.max():.4f}"
    assert model.CHI2.value == f"{chi2:.4f}"
    assert model.NTOA.value == str(ref["ntoas"])
    assert model.fit_provenance["rung"] == "eager"
    # the seeded post-fit residuals are those of the written-back model,
    # up to the float64 rounding of the written-back F0 (a phase drift of
    # ulp(F0)/F0 per second from PEPOCH)
    seeded = fitter.resids.time_resids.copy()
    fitter.resids.update()
    fresh = fitter.resids.time_resids
    f0 = float(model.F0.value)
    span = np.max(np.abs(mjds - model.PEPOCH.mjd_float)) * 86400.0
    bound = np.spacing(f0) / f0 * span
    gap = float(np.max(np.abs(seeded - fresh)))
    print(f"seeded vs recomputed post-fit residuals: {gap:.3e} s "
          f"(F0 rounding bound {bound:.3e} s)")
    assert gap <= bound


def test_fused_fit_matches_jax(ref):
    """build_fused_fit, the loop fit_toas runs on CUDA, here on the CPU,
    through the fitter's fused rung."""
    model, toas = _start(ref)
    fitter = WLSFitter(toas, model, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter._fit_fused(ref["maxiter"], None)
    dev, unc = _gaps(model, ref)
    gap = abs(chi2 - ref["chi2"]) / ref["chi2"]
    fr = fitter.fitresult
    print(f"fused: {dev:.3e} sigma, unc {unc:.3e}, chi2 gap {gap:.3e}; "
          f"{fr.status.name} after {fr.iterations}; {fitter.fit_info}")
    assert dev <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
    assert (fr.status.name, fr.iterations, fr.rung) == \
        (ref["status"], ref["iterations"], "fused")


def test_fused_loop_reads_one_status_per_iteration(ref):
    """The fused loop's only host reads are the int32 statuses that stand
    in for the while_loop's exit test, one per iteration: every other
    value of the loop state stays on the device until the one fetch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    model, toas = _start(ref)
    tf = WLSFitter(toas, model, device="cpu")
    fit = build_fused_fit(model, tf.resids.batch, tf.fit_params,
                          tf.track_mode, maxiter=ref["maxiter"])
    reads = []

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ == "_local_scalar_dense":
                reads.append(out)
            return out

    with torch.no_grad(), Reads():
        flat = fit.run(tf.resids.pdict)
    iterations = int(flat[-2])
    print(f"host reads in the fused loop: {len(reads)} over {iterations} "
          "iterations")
    assert iterations == ref["iterations"]
    assert len(reads) == iterations


@pytest.mark.slow
def test_fused_status_matches_jax_fused(ref):
    """Status and iterations of the port's fused loop against pint_tpu's
    build_fused_fit on the CPU (a heavy JAX compile, hence slow)."""
    from pint_tpu.fitter import build_fused_fit as j_fused

    jm, jt = data.load_jax(data.DD_REF_TIM, par=data.dd_par_lines())
    data.perturb_dd(jm)
    from pint_tpu.fitter import WLSFitter as JWLSFitter

    jf = JWLSFitter(jt, jm)
    names = jf.fit_params
    _, jout = j_fused(jm, jf.resids.batch, names, jf.track_mode,
                      maxiter=ref["maxiter"])(jf.resids.pdict)
    model, toas = _start(ref)
    tf = WLSFitter(toas, model, device="cpu")
    _, tout = build_fused_fit(model, tf.resids.batch, names, tf.track_mode,
                              maxiter=ref["maxiter"])(tf.resids.pdict)
    assert (tout["status"], tout["iterations"]) == \
        (jout["status"], jout["iterations"])
    assert abs(tout["chi2"] / float(jout["chi2"]) - 1.0) <= CHI2_TOL


def test_degradation_chain_reports_rungs(ref):
    """A poisoned TOA uncertainty: the fused loop ends NONFINITE, the
    eager rung cannot start, and ConvergenceFailure names both."""
    model, toas = _start(ref)
    fitter = WLSFitter(toas, model, device="cpu", policy="off")
    batch = fitter.resids.batch
    err = batch.error_us.clone()
    err[5] = float("nan")
    fitter.resids.batch = batch.replace(error_us=err)
    before = copy.deepcopy(data.device_values(model, ref["fit_params"]))
    with pytest.warns(FitDegradedWarning):
        with pytest.raises(ConvergenceFailure) as info:
            fitter._fit_fused(3, None)
    e = info.value
    print(f"rung statuses {e.rung_statuses}")
    assert e.rung_statuses == {"fused": FitStatus.NONFINITE,
                               "eager": FitStatus.NONFINITE}
    assert e.status == FitStatus.NONFINITE
    # nothing was written back
    assert data.device_values(model, ref["fit_params"]) == before


def test_apply_deltas_matches_jax(ref):
    """Offsets folded back into the host parameters, as pint_tpu's
    apply_deltas does, for a float, an angle and an MJD parameter."""
    from pint_tpu.models import get_model as jget
    from pint_tpu_torch.models import get_model as tget

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, tm = jget(data.dd_par_lines()), tget(data.dd_par_lines())
    deltas = {"F0": 3e-11, "RAJ": 2e-9, "T0": 1.5e-6, "ECC": -2e-7}
    jp = {"delta": {n: np.float64(v) for n, v in deltas.items()}}
    tp = {"delta": {n: torch.tensor(v, dtype=F64)
                    for n, v in deltas.items()}}
    jm.apply_deltas(jp)
    tm.apply_deltas(tp)
    for n in deltas:
        np.testing.assert_array_equal(np.asarray(tm[n].device_value),
                                      np.asarray(jm[n].device_value))
        assert float(np.sum(np.asarray(tp["delta"][n]))) == 0.0


def test_committed_dd_reference_is_current(tmp_path_factory, ref):
    """tests/data holds the DD tim text torch_port_data writes today and
    pint_tpu's eager fit on it."""
    tim = data.dd_sim_tim(tmp_path_factory)
    with open(tim) as f, open(data.DD_REF_TIM) as g:
        assert f.read() == g.read()
    fresh = data.jax_dd_fit(data.DD_REF_TIM)
    assert fresh["fit_params"] == ref["fit_params"]
    assert fresh["start"] == ref["start"]
    assert (fresh["status"], fresh["iterations"]) == \
        (ref["status"], ref["iterations"])
    np.testing.assert_allclose(fresh["chi2"], ref["chi2"], rtol=1e-12)
    for n, v in ref["values"].items():
        np.testing.assert_allclose(fresh["values"][n], v, rtol=0,
                                   atol=1e-6 * ref["uncertainties"][n])
        np.testing.assert_allclose(fresh["uncertainties"][n],
                                   ref["uncertainties"][n], rtol=1e-9)
