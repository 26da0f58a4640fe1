"""pint_tpu_torch's delay chain vs pint_tpu's, and the ``delay_chain``
kernel's host-side layout.

On the CPU the port's :meth:`PhaseCalc.delay` takes the plain version of
the ``delay_chain`` kernel (each component's own delay); the kernel itself
runs only on a card (``tests/test_torch_cuda.py``).  With JAX on the CPU
as the reference, on four models over the committed 200-TOA sets (the
J0740 ELL1 set, the DD set, its BT variant, and the J0740 par without a
binary):

* the total delay within 1 ns of ``pint_tpu``'s;
* every column of its jacobian in the free parameters (jacfwd) within
  1e-10 relative of ``pint_tpu``'s (the design-matrix bar).

And the kernel's inputs, built on the host: the θ packing round trip
(every slot equals the ``pv``/constant it packs, and is differentiable in
``p["delta"]`` exactly as ``pv`` is), the DMX bin index against the range
masks, the DelayJump bits, and the components and options the kernel
refuses with ``NotImplementedError``.
"""

import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.models.timing_model import pv
from pint_tpu_torch.residuals import Residuals as TResiduals

DELAY_TOL_S = 1e-9
COL_TOL = 1e-10
F64 = torch.float64

BINARY_LINES = ("BINARY ", "PB ", "A1 ", "TASC ", "EPS1 ", "EPS2 ", "M2 ",
                "SINI ")


def _bt_par():
    keep = ("M2 ", "SINI ", "OMDOT ")
    return [ln.replace("BINARY DD", "BINARY BT") for ln in
            data.dd_par_lines() if not ln.startswith(keep)]


def _no_binary_par():
    return [ln for ln in data.par_lines() if not ln.startswith(BINARY_LINES)]


CASES = {
    "ELL1": (data.par_lines, data.REF_TIM),
    "DD": (data.dd_par_lines, data.DD_REF_TIM),
    "BT": (_bt_par, data.DD_REF_TIM),
    "none": (_no_binary_par, data.REF_TIM),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    par, tim = CASES[request.param]
    jm, jt = data.load_jax(tim, par=par())
    tm, tt = data.load_torch(tim, par=par())
    return dict(case=request.param, jm=jm, tm=tm, jr=JResiduals(jt, jm),
                tr=TResiduals(tt, tm, device="cpu"))


def test_delay_matches_jax(pair):
    jm, jr, tm, tr = (pair[k] for k in ("jm", "jr", "tm", "tr"))
    want = np.asarray(jm.delay(jr.pdict, jr.batch))
    with torch.no_grad():
        got = tm.calc.delay(tr.pdict, tr.batch).numpy()
    gap = float(np.max(np.abs(got - want)))
    print(f"{pair['case']}: total delay max gap {gap:.3e} s (bar "
          f"{DELAY_TOL_S}); amplitude {np.max(np.abs(want)):.3f} s")
    assert gap <= DELAY_TOL_S


def test_delay_columns_match_jax(pair):
    """d delay / d(free parameters) by jacfwd on both sides."""
    import jax

    jm, jr, tm, tr = (pair[k] for k in ("jm", "jr", "tm", "tr"))
    names = jm.free_params
    assert tm.free_params == names
    jp, jb = jr.pdict, jr.batch
    jJ = np.asarray(jax.jacfwd(
        lambda x: jm.delay(jm.with_x(jp, x, names), jb))(jm.x0(jp, names)))
    tp, tb = tr.pdict, tr.batch
    tJ = torch.func.jacfwd(
        lambda x: tm.calc.delay(tm.with_x(tp, x, names), tb))(
            tm.x0(tp, names)).numpy()
    scale = np.max(np.abs(jJ), axis=0)
    per_col = np.max(np.abs(tJ - jJ), axis=0) / np.where(scale > 0, scale,
                                                          1.0)
    # a parameter the delay does not depend on has an all-zero column on
    # both sides
    assert np.all((scale > 0) | (np.max(np.abs(tJ), axis=0) == 0))
    worst = int(np.argmax(per_col))
    print(f"{pair['case']}: {len(names)} columns, max relative gap "
          f"{per_col[worst]:.3e} ({names[worst]}; bar {COL_TOL})")
    assert per_col[worst] <= COL_TOL


def test_theta_packing_round_trip(pair):
    """Every θ slot equals what it packs, and its tangent in the free
    parameters equals pv's."""
    tm, tr = pair["tm"], pair["tr"]
    p = tr.pdict
    lay = tm.calc.chain_layout
    theta = lay.theta(p)
    assert theta.shape == (lay.P,) and lay.cfg[2] == lay.P
    slots = lay.unpack(theta)
    assert list(slots) == list(lay.names)
    checked = 0
    for name, v in slots.items():
        if name in p["const"] and name in p["delta"]:
            c = p["const"][name]
            want = pv(p, name) if c.ndim == 0 else c[0] + c[1] + \
                p["delta"][name]
            assert torch.equal(v, want), name
            checked += 1
        elif name.endswith("__sin") or name.endswith("__cos"):
            ang, f = name.rsplit("__", 1)
            assert float(v) == float(
                p["const"][ang + "__sincos"][0 if f == "sin" else 1])
        elif "__word" in name:
            ep, k = name.split("__word")
            assert float(v) == float(p["const"][ep + "__fracqs"][int(k)])
    # the packing is differentiable exactly as pv is: one unit tangent
    # per free delay parameter lands on its own slot(s); the phase
    # parameters (spin, phase jumps) reach no slot
    names = tm.free_params
    J = torch.func.jacfwd(lambda x: lay.theta(tm.with_x(p, x, names)))(
        tm.x0(p, names))
    delay_params = {n for c in tm.delay_components for n in c.params}
    for j, n in enumerate(names):
        rows = [i for i, d in enumerate(lay.deltas) if d == n]
        assert bool(rows) == (n in delay_params), n
        col = J[:, j]
        assert torch.all(col[rows] == 1.0) and float(
            torch.sum(torch.abs(col))) == len(rows), n
    print(f"{pair['case']}: P={lay.P} slots, {checked} parameter slots "
          f"equal to pv, flags={lay.cfg[0]}, binary={lay.cfg[1]}")


def test_dmx_index_matches_range_masks():
    """The (N, 2) DMX bins of each TOA against the range masks: one bin,
    two where ranges overlap (inclusive ranges sharing a boundary both
    hold a TOA on it), and no index, refused by the kernel's inputs,
    where three overlap."""
    tm, tt = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    comp = tm.components["DispersionDMX"]
    bins = comp.dmx_names()

    def check():
        m = comp.mask_entries(tt)
        idx = m[dc.DMX_INDEX]
        assert idx.dtype == np.int32 and idx.shape == (tt.ntoas, 2)
        masks = np.stack([m[f"{n}__rangemask"] for n in bins])
        for row in range(tt.ntoas):
            want = list(np.flatnonzero(masks[:, row]))
            assert list(idx[row][idx[row] >= 0]) == want
        return int(np.sum(idx[:, 1] >= 0))

    assert check() == 0
    r = lambda k, i: comp.params[f"DMXR{k}_{bins[i].split('_')[1]}"]
    r(1, 1).set_value(r(2, 0).mjd_float - 100.0)   # bins 0, 1 overlap
    assert check() > 0
    r(1, 2).set_value(r(2, 0).mjd_float - 50.0)    # bin 2 reaches both
    assert dc.DMX_INDEX not in comp.mask_entries(tt)
    res = TResiduals(tt, tm, device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        dc.row_inputs(tm.calc.chain_layout, res.pdict, res.batch)


def test_delay_jump_bits():
    from pint_tpu_torch.models.jump import JUMP_BITS, DelayJump

    tm, tt = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    dj = DelayJump()
    # indices clear of the par's phase JUMP1/JUMP2
    dj.add_jump(index=11, key="-fe", key_value=["RCVR800"], value=1e-6,
                frozen=False)
    dj.add_jump(index=12, key="-fe", key_value=["RCVR1400L"], value=-2e-6)
    tm.add_component(dj)
    m = dj.mask_entries(tt)
    bits = m[JUMP_BITS]
    fe = np.array([f["fe"] for f in tt.flags])
    np.testing.assert_array_equal(bits & 1, fe == "RCVR800")
    np.testing.assert_array_equal((bits >> 1) & 1, fe == "RCVR1400L")
    lay = tm.calc.chain_layout
    assert lay.jumps and lay.cfg[0] & dc.JUMP and lay.cfg[5] == 2


@pytest.mark.parametrize("change, match", [
    ("planets", "PLANET_SHAPIRO"),
    ("fb", "FBn"),
    ("orbwave", "ORBWAVE"),
])
def test_uncovered_components_raise(change, match):
    par = data.dd_par_lines()
    if change == "planets":
        par = par + ["PLANET_SHAPIRO Y"]
    elif change == "orbwave":
        par = par + ["ORBWAVE_OM 1e-8", "ORBWAVE_EPOCH 55000",
                     "ORBWAVEC0 1e-6", "ORBWAVES0 1e-6"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from pint_tpu_torch.models import get_model

        tm = get_model(par)
    if change == "fb":
        tm.components["BinaryDD"].params["FB0"].value = 1.0 / (7.75 * 86400)
    with pytest.raises(NotImplementedError, match=match):
        dc.ChainLayout.from_components(tm.delay_components)
