"""pint_tpu_torch's DM family against pint_tpu's, on the CPU.

The components the wideband fit needs and the DM family of the delay
kernel's row function: ``SolarWindDispersion`` (NE_SW with a Taylor
term, SWM 0 and SWM 1), ``SolarWindDispersionX``, ``DispersionJump``
(DMJUMP), ``FDJumpDM``, ``FDJump`` and ``ScaleDmError``
(DMEFAC/DMEQUAD), with ``TimingModel.total_dm`` and
``scaled_dm_uncertainty``, on the committed 200-TOA DD set with the DM
family's par lines (``examples.dm_family_par``); the same seeded inputs
go through both packages (JAX on the CPU, float64):

* each component's delay within 1 ns and its DM within 1e-12 pc cm^-3,
  and ``total_dm``;
* SWM 1 at two SWP values, its delay and its SWP derivative (torch's
  jacfwd against ``jax.jacfwd``);
* SWX ranges that share a boundary: a TOA on it lies in both (the
  kernel's ``__swxidx__``), as in pint_tpu; three ranges on one TOA leave
  no index, and the kernel's inputs refuse the model;
* FD1JUMP and FD2JUMP (orders 1 and 2) and the layout's orders;
* DMJUMP moves the DM block only: the TOA residuals stay bit-identical;
* DMEFAC/DMEQUAD within 1e-15 relative of pint_tpu's;
* the par round trip, ``simulation.add_wideband_dm_data`` and the
  layout's refusal of more than 31 mask members.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals as TResiduals

DELAY_TOL_S = 1e-9
DM_TOL = 1e-12
SIGMA_REL_TOL = 1e-15
#: the SWP derivative of the delay, relative to its largest value
DERIV_REL_TOL = 1e-10
COMPONENTS = ("SolarWindDispersion", "SolarWindDispersionX",
              "DispersionJump", "FDJumpDM", "FDJump")
F64 = torch.float64


def _load(kind="DMF_DD", extra=()):
    """(pint_tpu model, toas, residuals), (port model, toas, residuals)
    of a DM-family par on its committed set, plus par lines ``extra``."""
    par = data.dm_family_par_lines(kind) + list(extra)
    tim = data.dm_family_tim(kind)
    jm, jt = data.load_jax(tim, par=par)
    tm, tt = data.load_torch(tim, par=par)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr = JResiduals(jt, jm)
    tr = TResiduals(tt, tm, device="cpu")
    return (jm, jt, jr), (tm, tt, tr)


@pytest.fixture(scope="module")
def pair():
    return _load(extra=("DMEFAC -fe RCVR800 1.3 1",
                        "DMEFAC -fe RCVR1400 0.9",
                        "DMEQUAD -fe RCVR1400L 5e-5 1"))


@pytest.mark.parametrize("name", COMPONENTS)
def test_component_matches_pint_tpu(pair, name):
    (jm, _, jr), (tm, _, tr) = pair
    jc, tc = jm.components[name], tm.components[name]
    jd = np.asarray(jc.delay(jr.pdict, jr.batch, None))
    with torch.no_grad():
        td = tc.delay(tr.pdict, tr.batch, None).numpy()
    gap = float(np.max(np.abs(td - jd)))
    msg = f"{name}: delay {gap:.3e} s of {np.max(np.abs(jd)):.3e} s"
    if hasattr(jc, "dm_value"):
        jdm = np.asarray(jc.dm_value(jr.pdict, jr.batch))
        with torch.no_grad():
            tdm = tc.dm_value(tr.pdict, tr.batch).numpy()
        dgap = float(np.max(np.abs(tdm - jdm)))
        msg += f", DM {dgap:.3e} pc cm^-3 of {np.max(np.abs(jdm)):.3e}"
        assert dgap <= DM_TOL
    print(msg)
    assert gap <= DELAY_TOL_S
    if name == "DispersionJump":
        assert not np.any(td) and np.any(jdm)


def test_total_dm_and_scaled_dm_error(pair):
    (jm, jt, jr), (tm, _, tr) = pair
    jdm = np.asarray(jm.total_dm(jr.pdict, jr.batch))
    with torch.no_grad():
        tdm = tm.total_dm(tr.pdict, tr.batch).numpy()
    err = np.random.default_rng(0).uniform(5e-5, 5e-4, jt.ntoas)
    js = np.asarray(jm.scaled_dm_uncertainty(jr.pdict, jr.batch, err))
    with torch.no_grad():
        ts = tm.scaled_dm_uncertainty(tr.pdict, tr.batch,
                                      torch.from_numpy(err)).numpy()
    rel = float(np.max(np.abs(ts / js - 1.0)))
    print(f"total_dm {np.max(np.abs(tdm - jdm)):.3e} pc cm^-3; DMEFAC/"
          f"DMEQUAD sigma {rel:.3e} relative (bar {SIGMA_REL_TOL})")
    assert np.max(np.abs(tdm - jdm)) <= DM_TOL
    assert rel <= SIGMA_REL_TOL
    assert not np.array_equal(ts, err)


@pytest.mark.parametrize("swp", [2.5, 3.2])
def test_swm1_and_its_swp_derivative(swp):
    (jm, _, jr), (tm, _, tr) = _load("DMF_DD_SWM1", extra=(f"SWP {swp} 1",))
    jc, tc = (m.components["SolarWindDispersion"] for m in (jm, tm))
    assert tc.power_law and tm.SWP.value == swp
    jd = np.asarray(jc.delay(jr.pdict, jr.batch, None))
    with torch.no_grad():
        td = tc.delay(tr.pdict, tr.batch, None).numpy()

    def jf(x):
        return jc.delay(jm.with_x(jr.pdict, x, ["SWP"]), jr.batch, None)

    def tf(x):
        return tc.delay(tm.with_x(tr.pdict, x, ["SWP"]), tr.batch, None)

    jJ = np.asarray(jax.jacfwd(jf)(jax.numpy.zeros(1)))[:, 0]
    tJ = torch.func.jacfwd(tf)(torch.zeros(1, dtype=F64))[:, 0].numpy()
    gap = float(np.max(np.abs(td - jd)))
    drel = float(np.max(np.abs(tJ - jJ)) / np.max(np.abs(jJ)))
    print(f"SWM 1, SWP {swp}: delay {gap:.3e} s of {np.max(np.abs(jd)):.3e}"
          f" s; d delay / d SWP {drel:.3e} relative (bar {DERIV_REL_TOL})")
    assert gap <= DELAY_TOL_S and drel <= DERIV_REL_TOL


def test_swx_shared_boundary():
    """A TOA on the boundary two SWX ranges share lies in both (inclusive
    ranges, as pint_tpu's masks); a third range on it leaves no kernel
    index, and the kernel's inputs refuse the model."""
    (jm, jt, _), (tm, tt, _) = _load()
    on = float(tt.utc.mjd_float[100])
    for m in (jm, tm):
        m.SWXR2_0001.set_value(on)
        m.SWXR1_0002.set_value(on)
    comp = tm.components["SolarWindDispersionX"]
    masks = comp.mask_entries(tt)
    idx = masks[dc.SWX_INDEX]
    assert list(idx[100]) == [0, 1]
    jmask = jm.components["SolarWindDispersionX"].mask_entries(jt)
    for n in comp.swx_names():
        np.testing.assert_array_equal(masks[f"{n}__rangemask"],
                                      jmask[f"{n}__rangemask"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr = JResiduals(jt, jm)
    tr = TResiduals(tt, tm, device="cpu")
    jd = np.asarray(jm.components["SolarWindDispersionX"].delay(
        jr.pdict, jr.batch, None))
    with torch.no_grad():
        td = comp.delay(tr.pdict, tr.batch, None).numpy()
    print(f"SWX on a shared boundary: delay {abs(td[100] - jd[100]):.3e} s, "
          f"all rows {np.max(np.abs(td - jd)):.3e} s")
    assert np.max(np.abs(td - jd)) <= DELAY_TOL_S
    tm.SWXR1_0003.set_value(on - 1.0)
    assert dc.SWX_INDEX not in comp.mask_entries(tt)
    tr = TResiduals(tt, tm, device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        dc.row_inputs(tm.calc.chain_layout, tr.pdict, tr.batch)


def test_layout_of_the_dm_family(pair):
    """ChainLayout takes every component of the DM family: its flags,
    blocks and FDJUMP orders; DMJUMP has no slot."""
    _, (tm, _, tr) = pair
    lay = tm.calc.chain_layout
    want = dc.SOLAR_WIND | dc.SWX | dc.FDJUMPDM | dc.FDJUMP
    assert lay.flags & want == want and not lay.flags & dc.SWM1
    cfg = dict(zip(dc.CFG_FIELDS, lay.cfg))
    assert (cfg["nsw"], cfg["nswx"], cfg["nfdm"], cfg["nfdj"]) == (2, 3, 2, 3)
    members = [p.name for p in tm.components["FDJump"].members()]
    assert lay.fdj_order == tuple(int(n[2]) for n in members) == (1, 1, 2)
    assert not any(n.startswith("DMJUMP") for n in lay.names)
    c = lay.ctypes_cfg()
    assert list(c.fdj_order[:3]) == [1, 1, 2] and c.nfdj == 3
    theta = lay.theta(tr.pdict)
    for n in ("NE_SW", "NE_SW1", "SWXDM_0002", "FDJUMPDM2", "FD2JUMP1"):
        assert float(theta[lay.names.index(n)]) == tm[n].device_value


def test_layout_refuses_32_members():
    from pint_tpu_torch.models.dispersion import FDJumpDM

    tm, tt = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    comp = FDJumpDM()
    for i in range(dc.MAX_JUMPS + 1):
        comp.add_fdjumpdm(key="-fe", key_value=["RCVR800"], value=1e-5 * i)
    tm.add_component(comp)
    assert "__fdjumpdmbits__" not in comp.mask_entries(tt)
    with pytest.raises(NotImplementedError, match="at most 31"):
        tm.calc.chain_layout


def test_dmjump_moves_the_dm_block_only(pair):
    _, (tm, tt, tr) = pair
    r0 = tr.time_resids.copy()
    with torch.no_grad():
        dm0 = tm.total_dm(tr.pdict, tr.batch).numpy()
    tm.DMJUMP1.value += 1e-3
    try:
        tr.update()
        with torch.no_grad():
            dm1 = tm.total_dm(tr.pdict, tr.batch).numpy()
        sel = np.array([f["fe"] == "RCVR800" for f in tt.flags])
        np.testing.assert_array_equal(tr.time_resids, r0)
        np.testing.assert_allclose(dm1[sel] - dm0[sel], -1e-3, atol=1e-15)
        np.testing.assert_array_equal(dm1[~sel], dm0[~sel])
    finally:
        tm.DMJUMP1.value -= 1e-3
        tr.update()


def test_par_round_trip(pair):
    _, (tm, _, _) = pair
    back = get_model(tm.as_parfile().splitlines())
    for name in ("NE_SW", "NE_SW1", "SWEPOCH", "SWM", "SWXDM_0003",
                 "SWXR1_0002", "DMJUMP1", "FDJUMPDM2", "FD2JUMP1",
                 "FD1JUMP2", "DMEFAC1", "DMEFAC2", "DMEQUAD1"):
        a, b = tm[name], back[name]
        assert a.value == b.value and a.frozen == b.frozen, name
        assert getattr(a, "key_value", None) == getattr(b, "key_value",
                                                        None), name
    assert set(back.components) == set(tm.components)


def test_add_wideband_dm_data(pair):
    from pint_tpu.simulation import add_wideband_dm_data as j_add
    from pint_tpu_torch.simulation import add_wideband_dm_data as t_add

    (jm, jt, _), (tm, tt, _) = pair
    j_add(jt, jm, dm_error=2e-4)
    t_add(tt, tm, dm_error=2e-4, device="cpu")
    jd = np.array([float(f["pp_dm"]) for f in jt.flags])
    td = np.array([float(f["pp_dm"]) for f in tt.flags])
    print(f"add_wideband_dm_data: {np.max(np.abs(td - jd)):.3e} pc cm^-3")
    assert np.max(np.abs(td - jd)) <= DM_TOL
    assert tt.is_wideband and all(f["pp_dme"] == "0.0002" for f in tt.flags)
