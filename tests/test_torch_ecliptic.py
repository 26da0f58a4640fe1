"""pint_tpu_torch's ecliptic astrometry vs pint_tpu's.

``AstrometryEcliptic`` (ELONG/ELAT, PMELONG/PMELAT, the obliquity of
ECL), the inputs of the Kopeikin terms (``kopeikin_frame``), and the host
frame conversion (``convert_astrometry``, ``TimingModel.as_ECL`` and
``as_ICRS``, ``host_psr_dir``), with JAX on the CPU as the reference:

* ``as_ECL`` of the DD par with pint_tpu's DDK proper motion and
  parallax gives pint_tpu's par text, and the rotated uncertainties;
  the ICRS round trip and a change of convention (IERS2003) too;
* on the committed 200-TOA DDK set in ecliptic coordinates
  (``ddk_ecliptic_realistic_par(dmx_bins=8)``): ``psr_dir``, the
  astrometry delay and ``kopeikin_frame`` at fit offsets of ELONG and
  ELAT drawn from a seed with numpy, within 1e-15 (unit vector), 1e-12 s
  and 1e-15 relative;
* the full-pipeline residuals within 1 ns, and the design-matrix columns
  of ELONG and ELAT (every column) within 1e-10 relative.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.fitter import build_whitened_assembly as j_assembly
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.fitter import build_whitened_assembly as t_assembly
from pint_tpu_torch.residuals import Residuals as TResiduals

DIR_TOL = 1e-15
DELAY_TOL_S = 1e-12
RESID_TOL_S = 1e-9
COL_TOL = 1e-10
F64 = torch.float64


def _eq_lines():
    """The DD par with pint_tpu's DDK proper motion and parallax, and
    uncertainties on the position and proper motion to rotate."""
    from pint_tpu_torch.examples import DDK_PM_PX

    out = []
    for ln in data.dd_par_lines():
        key = ln.split()[0]
        if key == "RAJ":
            ln = "RAJ 10:22:58.0 1 0.00002"
        elif key == "DECJ":
            ln = "DECJ +10:01:52.8 1 0.0004"
        out.append(ln)
    return out + [f"{k} {v} 0 {0.1 * abs(v)}" for k, v in DDK_PM_PX.items()]


def _both(lines):
    from pint_tpu.models import get_model as jget
    from pint_tpu_torch.models import get_model as tget

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jget(lines), tget(lines)


@pytest.mark.parametrize("ecl", ["IERS2010", "IERS2003"])
def test_as_ecl_matches_pint_tpu(ecl):
    jm, tm = _both(_eq_lines())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        je, te = jm.as_ECL(ecl=ecl), tm.as_ECL(ecl=ecl)
    assert te.as_parfile() == je.as_parfile()
    for n in ("ELONG", "ELAT", "PMELONG", "PMELAT"):
        assert te[n].value == je[n].value, n
        assert te[n].uncertainty == je[n].uncertainty, n
    assert "AstrometryEcliptic" in te.components
    print(f"{ecl}: ELONG {te.ELONG.value!r} ELAT {te.ELAT.value!r} rad, "
          f"PMELONG {te.PMELONG.value!r} PMELAT {te.PMELAT.value!r}")


def test_icrs_round_trip():
    """ICRS -> ECL -> ICRS: the position within 1e-12 rad, the proper
    motion within 1e-9 mas/yr, and pint_tpu's par text at each step;
    host_psr_dir the same unit vector in both frames."""
    from pint_tpu.models.astrometry import host_psr_dir as j_dir
    from pint_tpu_torch.models.astrometry import host_psr_dir as t_dir

    jm, tm = _both(_eq_lines())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        te, je = tm.as_ECL(), jm.as_ECL()
        tb, jb = te.as_ICRS(), je.as_ICRS()
    assert tb.as_parfile() == jb.as_parfile()
    for n, tol in (("RAJ", 1e-12), ("DECJ", 1e-12), ("PMRA", 1e-9),
                   ("PMDEC", 1e-9)):
        assert abs(tb[n].value - tm[n].value) <= tol, n
    dirs = [t_dir(tm), t_dir(te), j_dir(jm), j_dir(je)]
    gap = max(float(np.max(np.abs(d - dirs[0]))) for d in dirs[1:])
    print(f"host_psr_dir across frames and packages: {gap:.3e}")
    assert gap <= 1e-14


@pytest.fixture(scope="module")
def pair():
    jm, jt = data.load_jax(data.DDK_REF_TIM, par=data.ddk_par_lines())
    tm, tt = data.load_torch(data.DDK_REF_TIM, par=data.ddk_par_lines())
    return dict(jm=jm, tm=tm, jr=JResiduals(jt, jm),
                tr=TResiduals(tt, tm, device="cpu"))


def _offsets(pair):
    """(pint_tpu, port) params dicts with ELONG and ELAT moved by offsets
    drawn from a seed (a few uncertainties of a 200-TOA fit)."""
    import jax.numpy as jnp

    d = np.random.default_rng(20261017).normal(0.0, [1e-9, 3e-7])
    jp = dict(pair["jr"].pdict)
    jp["delta"] = {**jp["delta"], "ELONG": jnp.float64(d[0]),
                   "ELAT": jnp.float64(d[1])}
    tp = dict(pair["tr"].pdict)
    tp["delta"] = {**tp["delta"], "ELONG": torch.tensor(d[0], dtype=F64),
                   "ELAT": torch.tensor(d[1], dtype=F64)}
    return jp, tp


def test_psr_dir_and_delay_match_pint_tpu(pair):
    jp, tp = _offsets(pair)
    ja = pair["jm"].components["AstrometryEcliptic"]
    ta = pair["tm"].components["AstrometryEcliptic"]
    jb, tb = pair["jr"].batch, pair["tr"].batch
    with torch.no_grad():
        gap_dir = float(np.max(np.abs(
            ta.psr_dir(tp, tb).numpy() - np.asarray(ja.psr_dir(jp, jb)))))
        zero = np.zeros(tb.ntoas)
        gap_delay = float(np.max(np.abs(
            ta.delay(tp, tb, torch.from_numpy(zero)).numpy()
            - np.asarray(ja.delay(jp, jb, zero)))))
    print(f"psr_dir {gap_dir:.3e} (bar {DIR_TOL}), astrometry delay "
          f"{gap_delay:.3e} s (bar {DELAY_TOL_S})")
    assert gap_dir <= DIR_TOL and gap_delay <= DELAY_TOL_S


def test_kopeikin_frame_matches_pint_tpu(pair):
    """The sky angles' sines and cosines, the proper motions [rad/yr] and
    the observatory in the ecliptic frame [ls]."""
    jp, tp = _offsets(pair)
    want = pair["jm"].components["AstrometryEcliptic"].kopeikin_frame(
        jp, pair["jr"].batch)
    with torch.no_grad():
        got = pair["tm"].components["AstrometryEcliptic"].kopeikin_frame(
            tp, pair["tr"].batch)
    names = ("sin_lon", "cos_lon", "sin_lat", "cos_lat", "mu_lon", "mu_lat",
             "obs")
    worst = 0.0
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        rel = float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-300))
        worst = max(worst, rel)
        assert rel <= 1e-15, name
    mu = math.hypot(float(got[4]), float(got[5])) / 4.84813681109536e-09
    print(f"kopeikin_frame: worst relative gap {worst:.3e}; |mu| {mu:.6f} "
          "mas/yr")
    assert abs(mu - math.hypot(15.0, 8.0)) <= 1e-8


def test_residuals_match_pint_tpu(pair):
    jr, tr = pair["jr"], pair["tr"]
    gap = float(np.max(np.abs(tr.time_resids - jr.time_resids)))
    print(f"DDK ecliptic residuals: max gap {gap:.3e} s (bar {RESID_TOL_S}); "
          f"rms {np.std(jr.time_resids) * 1e6:.4f} us")
    assert gap <= RESID_TOL_S


def test_design_matrix_matches_pint_tpu(pair):
    import jax.numpy as jnp

    jm, jr, tm, tr = (pair[k] for k in ("jm", "jr", "tm", "tr"))
    names = jm.free_params
    assert tm.free_params == names and names[:2] == ["ELONG", "ELAT"]
    jM = np.asarray(j_assembly(jm, jr.batch, names, jr.track_mode,
                               include_offset=True, design_matrix="split")
                    .inline(jnp.zeros(len(names)), jr.pdict)[1])
    tM = t_assembly(tm, tr.batch, names, tr.track_mode, include_offset=True,
                    design_matrix="split").inline(
        torch.zeros(len(names), dtype=F64), tr.pdict)[1].numpy()
    scale = np.maximum(np.max(np.abs(jM), axis=0), 1e-300)
    per_col = np.max(np.abs(tM - jM), axis=0) / scale
    worst = int(np.argmax(per_col))
    print(f"{tM.shape[1]} columns, ELONG {per_col[0]:.3e}, ELAT "
          f"{per_col[1]:.3e}, max {per_col[worst]:.3e} "
          f"({(names + ['Offset'])[worst]}; bar {COL_TOL})")
    assert per_col[worst] <= COL_TOL
