"""pint_tpu_torch's WaveX family and troposphere against pint_tpu's, on
the CPU.

``WaveX``, ``DMWaveX`` and ``CMWaveX`` (built by each package's own
``wavex_setup``, ``dmwavex_setup`` and ``cmwavex_setup``), ``ChromaticCM``
with four ``ChromaticCMX`` ranges, and ``TroposphereDelay`` on the
committed 200-TOA WaveX set (``tests/data/wavex_sim_200.tim``: the DD
par without DMX, ``torch_port_data.wavex_model``); the same inputs go
through both packages (JAX on the CPU, float64):

* each component's delay within 1e-12 s at the injected amplitudes
  (WaveX's dt shifted by the whole delay before it), and the residuals
  within 1 ns;
* the design matrix's columns within 1e-10 relative, and the SIN/COS
  amplitudes in the linear block, as pint_tpu partitions them;
* the troposphere's host geometry (geodetic inverse, zenith delay, the
  Niell maps) and ``CORRECT_TROPOSPHERE N``;
* ``WLSFitter.fit_toas(maxiter=3)`` against pint_tpu's stored fit
  (``wavex_sim_200_fit.json``) within 1e-3 sigma, 1e-3 relative in the
  uncertainties and 1e-6 in chi2.
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.models import troposphere as jtropo
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.examples import WAVEX_AMPS, WAVEX_CMX, WAVEX_MODES
from pint_tpu_torch.fitter import WLSFitter
from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.models import troposphere as ttropo
from pint_tpu_torch.residuals import Residuals as TResiduals

DELAY_TOL_S = 1e-12
RESID_TOL_S = 1e-9
COLUMN_TOL = 1e-10
FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
CHI2_TOL = 1e-6
COMPONENTS = ("TroposphereDelay", "DMWaveX", "ChromaticCM", "ChromaticCMX",
              "CMWaveX", "WaveX")
F64 = torch.float64


def _inject(model):
    for n in model.free_params:
        for stem, (a_s, a_c) in WAVEX_AMPS.items():
            if n.startswith(stem + "SIN_"):
                model[n].value = a_s
            elif n.startswith(stem + "COS_"):
                model[n].value = a_c


@pytest.fixture(scope="module")
def pair():
    jm, jt = data.load_wavex("pint_tpu")
    tm, tt = data.load_wavex("pint_tpu_torch")
    for m in (jm, tm):
        _inject(m)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr = JResiduals(jt, jm)
    tr = TResiduals(tt, tm, device="cpu")
    return (jm, jt, jr), (tm, tt, tr)


def test_components_match_pint_tpu(pair):
    """Each delay term given the delay accumulated before it (pint_tpu's),
    in DEFAULT_ORDER: WaveX, the last, reads the whole delay."""
    (jm, _, jr), (tm, _, tr) = pair
    kinds = [type(c).__name__ for c in tm.delay_components]
    assert kinds == [type(c).__name__ for c in jm.delay_components]
    assert kinds[-1] == "WaveX" and kinds.index("DMWaveX") < \
        kinds.index("ChromaticCM") < kinds.index("BinaryDD")
    acc = jnp.zeros(jr.batch.freq_mhz.shape)
    for jc, tc in zip(jm.delay_components, tm.delay_components):
        jd = jc.delay(jr.pdict, jr.batch, acc)
        with torch.no_grad():
            td = tc.delay(tr.pdict, tr.batch,
                          torch.from_numpy(np.asarray(acc))).numpy()
        acc = acc + jd
        name = type(tc).__name__
        if name in COMPONENTS:
            gap = float(np.max(np.abs(td - np.asarray(jd))))
            print(f"{name}: delay {gap:.3e} s of "
                  f"{np.max(np.abs(np.asarray(jd))):.3e} s (bar "
                  f"{DELAY_TOL_S})")
            assert np.any(np.asarray(jd)) and gap <= DELAY_TOL_S
    rgap = float(np.max(np.abs(np.asarray(tr.time_resids)
                               - np.asarray(jr.time_resids))))
    print(f"residuals {rgap:.3e} s (bar {RESID_TOL_S})")
    assert rgap <= RESID_TOL_S


def test_design_matrix_and_linear_block(pair):
    (jm, jt, _), (tm, tt, _) = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Mj, nj = JWLSFitter(jt, jm).get_designmatrix()
    Mt, nt = WLSFitter(tt, tm, device="cpu").get_designmatrix()
    assert nt == nj
    Mj = np.asarray(Mj)
    gap = float(np.max(np.max(np.abs(Mt - Mj), axis=0)
                       / np.max(np.abs(Mj), axis=0)))
    print(f"design matrix ({len(nt)} columns) vs pint_tpu: {gap:.3e} per "
          f"column (bar {COLUMN_TOL})")
    assert gap <= COLUMN_TOL
    lin = tm.linear_param_names
    assert lin == jm.linear_param_names
    amps = [n for n in nt if "SIN_" in n or "COS_" in n]
    assert len(amps) == 2 * sum(WAVEX_MODES.values())
    assert set(amps) <= set(lin)
    assert not any(n.startswith(("WXFREQ", "DMWXFREQ", "CMWXFREQ"))
                   for n in lin)


def test_layout_of_the_wavex_family(pair):
    _, (tm, _, tr) = pair
    lay = tm.calc.chain_layout
    want = dc.WAVEX | dc.DMWAVEX | dc.CMWAVEX | dc.CM | dc.CMX | dc.TROPO
    assert lay.flags & want == want
    cfg = dict(zip(dc.CFG_FIELDS, lay.cfg))
    assert (cfg["nwx"], cfg["ndmwx"], cfg["ncmwx"], cfg["ncmx"]) == (
        WAVEX_MODES["wavex_setup"], WAVEX_MODES["dmwavex_setup"],
        WAVEX_MODES["cmwavex_setup"], len(WAVEX_CMX))
    theta = lay.theta(tr.pdict)
    o = cfg["o_wx"]
    assert lay.names[o] == "PEPOCH__day"
    assert float(theta[o + 1]) == tm.WXFREQ_0001.device_value
    assert float(theta[o + 1 + cfg["nwx"]]) == tm.WXSIN_0001.device_value


def test_troposphere_geometry_matches_pint_tpu():
    from pint_tpu_torch.observatory import get_observatory

    xyz = np.asarray(get_observatory("gbt").itrf_xyz)
    lat, lon, h = ttropo.itrf_to_geodetic(xyz)
    assert (lat, lon, h) == jtropo.itrf_to_geodetic(xyz)
    assert ttropo.zenith_delay_sec(lat, h) == jtropo.zenith_delay_sec(lat, h)
    alt = np.linspace(0.02, 1.5, 50)
    yf = np.linspace(0.0, 1.0, 50)
    for deg in (-33.0, 38.4):
        np.testing.assert_array_equal(
            ttropo.niell_hydrostatic_map(alt, deg, h, yf),
            jtropo.niell_hydrostatic_map(alt, deg, h, yf))
        np.testing.assert_array_equal(ttropo.niell_wet_map(alt, deg),
                                      jtropo.niell_wet_map(alt, deg))


def test_troposphere_off(pair):
    _, (tm, tt, tr) = pair
    comp = tm.components["TroposphereDelay"]
    on = comp.mask_entries(tt)[dc.TROPO_DELAY]
    assert np.all(on > 0) and np.all(on < 1e-6)
    comp.CORRECT_TROPOSPHERE.value = False
    try:
        assert not np.any(comp.mask_entries(tt)[dc.TROPO_DELAY])
        assert not torch.any(comp.delay(tr.pdict, tr.batch, None))
    finally:
        comp.CORRECT_TROPOSPHERE.value = True


def test_wls_fit_matches_pint_tpu():
    with open(data.WAVEX_REF_JSON) as f:
        ref = json.load(f)
    model, toas = data.load_wavex("pint_tpu_torch")
    fitter = WLSFitter(toas, model, device="cpu")
    assert fitter.fit_params == ref["fit_params"]
    assert data.device_values(model, fitter.fit_params) == ref["start"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=data.DD_MAXITER)
    sig, unc = data.fit_gaps(model, ref["values"], ref["uncertainties"])
    gap = abs(chi2 / ref["chi2"] - 1.0)
    print(f"WaveX-family WLS fit vs pint_tpu: {sig:.3e} sigma (bar "
          f"{FIT_SIGMA_TOL}), uncertainties {unc:.3e} (bar {UNC_TOL}), chi2 "
          f"{gap:.3e} (bar {CHI2_TOL})")
    assert fitter.fitresult.status.name == ref["status"]
    assert sig <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
