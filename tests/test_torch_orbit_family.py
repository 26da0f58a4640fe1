"""pint_tpu_torch's orbit family against pint_tpu's, on the CPU.

The binary family's rest: the FBn Taylor orbit (``orbits_and_freq``),
the ORBWAVE Fourier terms of the orbital phase (``orbwave_delta``), the
planets' Shapiro delays (``PLANET_SHAPIRO``) and ``BinaryBTPiecewise``.
The same inputs go through both packages (JAX on the CPU, float64):

* each term alone on DD and on ELL1 (``examples.orbit_family_par`` on the
  committed DD and J0740 sets, the planets' positions loaded): the
  component's delay within 1e-12 s;
* on the committed spider set (``tests/data/spider_sim_200.tim``:
  ``spider_realistic_par(dmx_bins=8)``, an FBn orbit with FB0 and FB1
  free and FB2 frozen, four ORBWAVE harmonics and PLANET_SHAPIRO on
  ELL1), the committed BT_PIECEWISE set (``btpw_sim_200.tim``:
  ``btpw_par(dmx_bins=8)``, four pieces with T0X and A1X free) and a DD
  model with all three terms: the residuals within 1 ns, the design
  matrix's columns within 1e-10 relative, and every params-dict leaf bit-equal (the port's own
  kernel-only leaves aside), through ``pdict_from_numpy`` and
  ``batch_from_numpy`` too;
* BinaryBTPiecewise's validate errors and its masks (half-open windows,
  a gap between pieces), and the piece index the delay kernel reads;
* ``Fitter.auto`` on the spider set and ``WLSFitter.fit_toas(maxiter=3)``
  on the BT_PIECEWISE set against pint_tpu's stored fits
  (``*_sim_200_fit.json``, ``python tests/torch_port_data.py
  spider_sim_200 btpw_sim_200``): 1e-3 sigma in the values, 1e-3
  relative in the uncertainties, chi2 within 1e-6.
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.models import get_model as jax_get_model
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu.toa import get_TOAs as jax_get_TOAs
from pint_tpu_torch.convert import batch_from_numpy, pdict_from_numpy
from pint_tpu_torch.examples import ORBIT_FAMILY, orbit_family_lines
from pint_tpu_torch.fitter import Fitter, WLSFitter
from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.binary_dd import BTPW_INDEX
from pint_tpu_torch.residuals import Residuals as TResiduals
from pint_tpu_torch.toa import get_TOAs

DELAY_TOL_S = 1e-12
RESID_TOL_S = 1e-9
COLUMN_TOL = 1e-10
FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
CHI2_TOL = 1e-6
F64 = torch.float64
#: mask leaves only the port builds: the delay kernel's per-TOA indices
KERNEL_ONLY = {("mask", "__dmxidx__"), ("mask", BTPW_INDEX)}
#: each term's layout flag
FLAGS = {"FB": dc.FB_ORBIT, "ORBWAVE": dc.ORBWAVE,
         "PLANET": dc.PLANET_SHAPIRO}


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


@pytest.fixture(scope="module")
def toas():
    """The DD and the J0740 set in both packages, the planets' positions
    loaded (one load serves every model of the module)."""
    out = {}
    for binary, tim in (("DD", data.DD_REF_TIM), ("ELL1", data.REF_TIM),
                        ("SPIDER", data.SPIDER_REF_TIM),
                        ("BTPW", data.BTPW_REF_TIM)):
        out[binary] = (_quiet(jax_get_TOAs, tim, planets=True),
                       _quiet(get_TOAs, tim, planets=True))
    return out


def _pair(par, jt, tt):
    jm, tm = _quiet(jax_get_model, par), _quiet(get_model, par)
    return (jm, _quiet(JResiduals, jt, jm),
            tm, TResiduals(tt, tm, device="cpu"))


def _component_delay(jm, jr, tm, tr, name):
    jd = np.asarray(jm.components[name].delay(
        jr.pdict, jr.batch, jnp.zeros(jr.batch.freq_mhz.shape)))
    with torch.no_grad():
        td = tm.components[name].delay(
            tr.pdict, tr.batch, torch.zeros(tr.batch.ntoas, dtype=F64))
    return float(np.max(np.abs(td.numpy() - jd))), float(np.max(np.abs(jd)))


def _resid_gap(jr, tr):
    return float(np.max(np.abs(np.asarray(tr.time_resids)
                               - np.asarray(jr.time_resids))))


@pytest.mark.parametrize("kind", ORBIT_FAMILY)
def test_term_delay_matches(toas, kind):
    """Each term alone: its component's delay, and its layout flag (the
    residuals are held on the models with all the terms below)."""
    _, binary, term = kind.split("_", 2)
    jm, jr, tm, tr = _pair(data.orbit_family_par_lines(kind),
                           *toas[binary])
    name = "SolarSystemShapiro" if term == "PLANET" else next(
        c for c in tm.components if c.startswith("Binary"))
    gap, scale = _component_delay(jm, jr, tm, tr, name)
    print(f"{kind}: {name} delay {gap:.3e} s of {scale:.3e} s (bar "
          f"{DELAY_TOL_S})")
    assert gap <= DELAY_TOL_S
    assert tm.calc.chain_layout.flags & FLAGS[term]


def _dd_all_par():
    """The DD par with all three terms: an FBn orbit, ORBWAVEs, the
    planets."""
    lines = data.orbit_family_par_lines("ORB_DD_FB")
    for term in ("ORBWAVE", "PLANET"):
        lines += orbit_family_lines(term, "DD", data.SPAN_DAYS,
                                    data.CENTER_MJD)
    return lines


#: the models whose design matrix and params dict are held: the two
#: committed sets and the DD model with every term
MODELS = {"SPIDER": (data.spider_par_lines, "SPIDER"),
          "BTPW": (data.btpw_par_lines, "BTPW"),
          "DD_ALL": (_dd_all_par, "DD")}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_pair(request, toas):
    par, sets = MODELS[request.param]
    return (request.param, toas[sets]) + _pair(par(), *toas[sets])


def test_residuals_and_design_matrix_match(model_pair):
    name, (jt, tt), jm, jr, tm, tr = model_pair
    rgap = _resid_gap(jr, tr)
    Mj, nj = _quiet(JWLSFitter(jt, jm).get_designmatrix)
    Mt, nt = WLSFitter(tt, tm, device="cpu").get_designmatrix()
    assert nt == nj
    Mj = np.asarray(Mj)
    gap = float(np.max(np.max(np.abs(Mt - Mj), axis=0)
                       / np.max(np.abs(Mj), axis=0)))
    print(f"{name}: residuals {rgap:.3e} s; design matrix ({len(nt)} "
          f"columns) {gap:.3e} per column (bar {COLUMN_TOL})")
    assert rgap <= RESID_TOL_S and gap <= COLUMN_TOL
    want = {"SPIDER": {"FB0", "FB1", "ORBWAVEC0", "ORBWAVES3"},
            "BTPW": {"T0X_0001", "A1X_0002", "T0X_0004"},
            "DD_ALL": {"FB0", "ORBWAVES1", "ECC"}}[name]
    assert want <= set(nt)


def _leaves(p):
    return {(grp, k): (v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v))
            for grp in ("const", "delta", "mask") for k, v in p[grp].items()}


def _bits_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                  np.atleast_1d(b).view(np.uint8),
                                  err_msg=what)


def test_pdict_leaves_and_converters(model_pair):
    """Every leaf of the params dict bit-equal (the FB, ORBWAVE, A1X/T0X
    and XR values, the pieces' masks); pint_tpu's dict and batch through
    ``pdict_from_numpy`` / ``batch_from_numpy`` give the port's, the
    planets' positions included."""
    name, _, _, jr, tm, tr = model_pair
    j, t = _leaves(jr.pdict), _leaves(tr.pdict)
    assert set(j) == set(t) - KERNEL_ONLY
    tzr = ("const", "__tzrphase__")
    for k in j:
        if k != tzr:
            _bits_equal(j[k], t[k], str(k))
    conv = _leaves(pdict_from_numpy(data.tree_numpy(jr.pdict), device="cpu"))
    for k, v in conv.items():
        if k != tzr:
            _bits_equal(v, t[k], str(k))
    cols = {k: (data.tree_numpy(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in jr.batch._asdict().items()}
    tb = batch_from_numpy(cols, device="cpu")
    assert set(tb.obs_planet_pos_ls) == set(dc.PLANETS)
    for pl in dc.PLANETS:
        _bits_equal(tb.obs_planet_pos_ls[pl].numpy(),
                    tr.batch.obs_planet_pos_ls[pl].numpy(), pl)
    lay = tm.calc.chain_layout
    rows = dc.row_inputs(lay, tr.pdict, tr.batch)
    planets = rows[[r[0] for r in dc.ROWS].index("planets")]
    assert bool(lay.flags & dc.PLANET_SHAPIRO) == (planets.numel() > 0)
    print(f"{name}: {len(j)} leaves bit-equal")


@pytest.fixture(scope="module")
def btpw(toas):
    jt, tt = toas["BTPW"]
    return _pair(data.btpw_par_lines(), jt, tt) + (jt, tt)


def test_btpw_masks_and_piece_index(btpw):
    """The pieces' masks as pint_tpu's (half-open [XR1, XR2): the last
    TOA, a hair past XR2 of the fourth piece, and the gap between the
    second and third piece lie in none), and the kernel's piece index."""
    jm, _, tm, tr, jt, tt = btpw
    comp = tm.components["BinaryBTPiecewise"]
    masks = comp.mask_entries(tt)
    jmask = jm.components["BinaryBTPiecewise"].mask_entries(jt)
    pieces = comp.piece_indices()
    assert pieces == [1, 2, 3, 4]
    for i in pieces:
        key = f"__btpw_mask_{i:04d}__"
        _bits_equal(masks[key], np.asarray(jmask[key]), key)
    idx = masks[BTPW_INDEX]
    stack = np.stack([masks[f"__btpw_mask_{i:04d}__"] for i in pieces])
    assert np.all(stack.sum(0) <= 1)
    want = np.where(stack.any(0), stack.argmax(0), -1)
    np.testing.assert_array_equal(idx, want)
    mjd = tt.tdb.mjd_float
    gap = (mjd >= comp.XR2_0002.value) & (mjd < comp.XR1_0003.value)
    assert gap.any() and np.all(idx[gap] == -1)
    assert idx[-1] == -1 and mjd[-1] >= comp.XR2_0004.value
    # a TOA exactly on XR2 lies outside the piece, on XR1 inside
    on = float(mjd[100])
    comp.XR2_0002.value = on
    comp.XR1_0003.value = on
    moved = comp.mask_entries(tt)
    assert moved[BTPW_INDEX][100] == 2
    assert moved["__btpw_mask_0002__"][100] == 0.0


@pytest.mark.parametrize("change, match", [
    ("overlap", "overlap"), ("order", "XR1 must be < XR2"),
    ("missing", "must both be given")])
def test_btpw_validate_errors(change, match):
    """BinaryBTPiecewise.validate refuses what pint_tpu's refuses, with its
    message."""
    par = data.btpw_par_lines()
    if change == "overlap":
        par = [ln.replace("XR1_0003 55066.0000", "XR1_0003 54800.0000")
               for ln in par]
        par = [ln.replace("XR2_0002 54884.0000", "XR2_0002 54900.0000")
               for ln in par]
    elif change == "order":
        par = [ln for ln in par if not ln.startswith("XR2_0001")] + [
            "XR2_0001 52000"]
    else:
        par = [ln for ln in par if not ln.startswith("XR2_0003")]
    for gm in (jax_get_model, get_model):
        with pytest.raises(ValueError, match=match):
            _quiet(gm, par)


def _fit(kind):
    ref = data.SPIDER_REF_JSON if kind == "spider" else data.BTPW_REF_JSON
    with open(ref) as f:
        want = json.load(f)
    if kind == "spider":
        model, toas = data.load_torch(data.SPIDER_REF_TIM,
                                      par=data.spider_par_lines())
        data.spider_start(model)
        fitter = Fitter.auto(toas, model, device="cpu")
        kw = {}
    else:
        model, toas = data.load_torch(data.BTPW_REF_TIM,
                                      par=data.btpw_par_lines())
        data.perturb_dd(model)
        fitter = WLSFitter(toas, model, device="cpu")
        kw = {"maxiter": want["maxiter"]}
    assert data.device_values(model, fitter.fit_params) == want["start"]
    chi2 = _quiet(fitter.fit_toas, **kw)
    return fitter, chi2, want


@pytest.mark.parametrize("kind", ["spider", "btpw"])
def test_fit_matches_pint_tpu(kind):
    fitter, chi2, want = _fit(kind)
    fr = fitter.fitresult
    sig, unc = data.fit_gaps(fitter.model, want["values"],
                             want["uncertainties"])
    gap = abs(chi2 / want["chi2"] - 1.0)
    print(f"{kind} {type(fitter).__name__} fit vs pint_tpu: {sig:.3e} sigma "
          f"(bar {FIT_SIGMA_TOL}), uncertainties {unc:.3e} (bar {UNC_TOL}), "
          f"chi2 {gap:.3e} (bar {CHI2_TOL})")
    assert fitter.fit_params == want["fit_params"]
    assert (fr.status.name, fr.iterations) == (want["status"],
                                               want["iterations"])
    if kind == "spider":
        assert type(fitter).__name__ == want["fitter"]
    assert sig <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
