"""pint_tpu_torch's DD and ELL1 variants vs pint_tpu: DDS, DDH, DDK (in
equatorial and in ecliptic coordinates), DDGR, ELL1H (the STIGMA form,
the H4 harmonic sum and H3 alone) and ELL1k.

Each variant's par (``pint_tpu_torch.examples.variant_par`` at 8 DMX
bins) loads in both packages with the committed 200-TOA DD set (the DD
family; DDK in ecliptic coordinates on its own DDK set) or J0740 set (the
ELL1 family); JAX on the CPU is the reference:

* the binary component's delay, given a nonzero accumulated delay drawn
  from a seed with numpy, within 1e-12 s;
* the full-pipeline residuals within 1 ns;
* the split design matrix within 1e-10 relative, column by column (the
  new parameters are free: SHAPMAX, H3, STIGMA, H4, MTOT, M2, KIN, KOM,
  OMDOT, LNEDOT);
* ``pdict_from_numpy`` of pint_tpu's params dict equals the port's own,
  leaf for leaf.

And the reference's own reductions, on the port alone: DDS and DDH
against DD at the same SINI and M2 (pint_tpu's
``tests/test_binary_dd.py:193-237``), DDK against DD without PX and
proper motion (``tests/test_binary_ddk.py:145``), DDGR against DD at
its derived post-Keplerian values (``tests/test_binary_ddgr_btx.py:65``)
and ELL1H's STIGMA form against its harmonic sum above the second
harmonic (``tests/test_binary_ell1.py:202``).
"""

import math
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.fitter import build_whitened_assembly as j_assembly
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.convert import pdict_from_numpy
from pint_tpu_torch.examples import VARIANTS
from pint_tpu_torch.fitter import build_whitened_assembly as t_assembly
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals as TResiduals

DELAY_TOL_S = 1e-12
RESID_TOL_S = 1e-9
COL_TOL = 1e-10
F64 = torch.float64
#: mask leaves only the port builds (the delay kernel's DMX bin index)
KERNEL_ONLY = {("mask", "__dmxidx__"), ("mask", "__delayjumpbits__")}


par_of = data.variant_par_lines


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    kind = request.param
    tim = data.variant_tim(kind)
    jm, jt = data.load_jax(tim, par=par_of(kind))
    tm, tt = data.load_torch(tim, par=par_of(kind))
    return dict(kind=kind, jm=jm, tm=tm, jr=JResiduals(jt, jm),
                tr=TResiduals(tt, tm, device="cpu"))


def _binary(model):
    return next(n for n in model.components if n.startswith("Binary"))


def test_binary_delay_matches_jax(pair):
    import jax.numpy as jnp

    jm, jr, tm, tr = (pair[k] for k in ("jm", "jr", "tm", "tr"))
    name = _binary(tm)
    assert name == _binary(jm)
    n = jr.batch.ntoas
    delay = np.random.default_rng(3).uniform(-500.0, 500.0, n)
    want = np.asarray(jm.components[name].delay(jr.pdict, jr.batch,
                                                 jnp.asarray(delay)))
    got = tm.components[name].delay(tr.pdict, tr.batch,
                                    torch.from_numpy(delay)).numpy()
    gap = float(np.max(np.abs(got - want)))
    print(f"{pair['kind']} ({name}): max delay gap {gap:.3e} s (bar "
          f"{DELAY_TOL_S}); amplitude {np.max(np.abs(want)):.3f} s")
    assert gap <= DELAY_TOL_S


def test_residuals_match_jax(pair):
    jr, tr = pair["jr"], pair["tr"]
    gap = float(np.max(np.abs(tr.time_resids - jr.time_resids)))
    print(f"{pair['kind']}: residuals max gap {gap:.3e} s (bar "
          f"{RESID_TOL_S}); rms {np.std(jr.time_resids) * 1e6:.4f} us")
    assert gap <= RESID_TOL_S


def test_design_matrix_matches_jax(pair):
    import jax.numpy as jnp

    jm, jr, tm, tr = (pair[k] for k in ("jm", "jr", "tm", "tr"))
    names = jm.free_params
    assert tm.free_params == names
    jM = np.asarray(j_assembly(jm, jr.batch, names, jr.track_mode,
                               include_offset=True, design_matrix="split")
                    .inline(jnp.zeros(len(names)), jr.pdict)[1])
    tM = t_assembly(tm, tr.batch, names, tr.track_mode, include_offset=True,
                    design_matrix="split").inline(
        torch.zeros(len(names), dtype=F64), tr.pdict)[1].numpy()
    scale = np.maximum(np.max(np.abs(jM), axis=0), 1e-300)
    per_col = np.max(np.abs(tM - jM), axis=0) / scale
    worst = int(np.argmax(per_col))
    print(f"{pair['kind']}: {tM.shape[1]} columns, max relative gap "
          f"{per_col[worst]:.3e} ({(names + ['Offset'])[worst]}; bar "
          f"{COL_TOL})")
    assert per_col[worst] <= COL_TOL


def _leaves(p):
    return {(grp, k): (v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v))
            for grp in ("const", "delta", "mask") for k, v in p[grp].items()}


def test_pdict_leaves_match(pair):
    """pint_tpu's params dict through ``pdict_from_numpy`` against the
    port's own: the same leaves, bit for bit (the TZR phase, computed by
    each package's own chain, within 1e-12 cycles)."""
    conv = _leaves(pdict_from_numpy(data.tree_numpy(pair["jr"].pdict),
                                    device="cpu"))
    own = _leaves(pair["tr"].pdict)
    assert set(conv) == set(own) - KERNEL_ONLY
    for k, v in conv.items():
        if k == ("const", "__tzrphase__"):
            a, b = v.astype(np.float64), own[k].astype(np.float64)
            assert abs((a[0] - b[0]) + (a[1:] - b[1:]).sum()) <= 1e-12
            continue
        assert v.dtype == own[k].dtype and v.shape == own[k].shape, k
        np.testing.assert_array_equal(np.atleast_1d(v).view(np.uint8),
                                      np.atleast_1d(own[k]).view(np.uint8),
                                      err_msg=str(k))
    print(f"{pair['kind']}: {len(conv)} leaves equal")


# -- the reference's reductions, on the port ----------------------------------

def _model(lines):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_model(lines)


@pytest.fixture(scope="module")
def dd_toas():
    """The committed DD set's TOAs, loaded once for the reductions."""
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_TOAs(data.DD_REF_TIM, model=_model(data.dd_par_lines()))


def _delay(model, toas):
    r = TResiduals(toas, model, device="cpu")
    with torch.no_grad():
        return model.components[_binary(model)].delay(
            r.pdict, r.batch, torch.zeros(r.batch.ntoas, dtype=F64)).numpy()


def _replace(lines, swap):
    out = []
    for ln in lines:
        key = ln.split()[0]
        out += swap.get(key, [ln])
    return out


@pytest.mark.parametrize("kind", ["DDS", "DDH"])
def test_dds_ddh_match_dd(dd_toas, kind):
    """DDS (SHAPMAX = -ln(1 - SINI)) and DDH (H3, STIGMA of M2 and SINI)
    equal DD at that M2 and SINI (pint_tpu's test_binary_dd.py)."""
    d1 = _delay(_model(par_of(kind)), dd_toas)
    d2 = _delay(_model(data.dd_par_lines()), dd_toas)
    gap = float(np.max(np.abs(d1 - d2)))
    print(f"{kind} vs DD: {gap:.3e} s")
    assert gap <= 1e-13


def test_ddk_reduces_to_dd_without_px_pm(dd_toas):
    """DDK with PX and proper motion zero is DD at SINI = sin(KIN)."""
    from pint_tpu_torch.examples import DDK_KIN_DEG

    zero = {k: [f"{k} 0.0"] for k in ("PMRA", "PMDEC", "PX")}
    d1 = _delay(_model(_replace(par_of("DDK"), zero)), dd_toas)
    dd = _replace(data.dd_par_lines(), {"SINI": [
        f"SINI {math.sin(math.radians(DDK_KIN_DEG))!r}"]})
    d2 = _delay(_model(dd), dd_toas)
    gap = float(np.max(np.abs(d1 - d2)))
    print(f"DDK without PX, PM vs DD: {gap:.3e} s")
    assert gap <= 1e-12


def test_ddgr_matches_dd_with_derived_values(dd_toas):
    """DDGR equals DD at its GR-derived SINI, GAMMA, OMDOT, PBDOT, DR and
    DTH (pint_tpu's test_binary_ddgr_btx.py)."""
    gr = _model(par_of("DDGR"))
    r = TResiduals(dd_toas, gr, device="cpu")
    with torch.no_grad():
        pk = {k: float(v) for k, v in
              gr.components["BinaryDDGR"]._gr_pk(r.pdict).items()}
    secyr = 365.25 * 86400.0
    dd = _replace(data.dd_par_lines(), {
        "SINI": [f"SINI {pk['sini']:.15f}"],
        "GAMMA": [f"GAMMA {pk['gamma']:.15e}"],
        "OMDOT": [f"OMDOT {pk['k'] * pk['n'] * 180 / np.pi * secyr:.12f}",
                  f"PBDOT {pk['pbdot']:.10e}", f"DR {pk['dr']:.15e}",
                  f"DTH {pk['dth']:.15e}"]})
    d1 = _delay(gr, dd_toas)
    d2 = _delay(_model(dd), dd_toas)
    gap = float(np.max(np.abs(d1 - d2)))
    print(f"DDGR vs DD at the derived values (SINI {pk['sini']:.6f}): "
          f"{gap:.3e} s")
    assert 0.85 < pk["sini"] < 0.95
    assert gap <= 2e-12


def test_ell1h_exact_vs_harmonic_sum():
    """ELL1H's STIGMA form and its harmonic sum (H4 = STIGMA H3, 30
    harmonics) agree above the second harmonic (pint_tpu's
    test_binary_ell1.py)."""
    def shapiro(lines):
        m = _model(lines)
        p = m.build_pdict(device="cpu")
        phi = torch.linspace(0, 2 * np.pi, 100, dtype=F64)
        with torch.no_grad():
            return m.components["BinaryELL1H"].shapiro_delay(p, phi).numpy()

    swap = {"STIGMA": ["STIGMA 0.3"]}
    exact = shapiro(_replace(par_of("ELL1H"), swap))
    h3 = next(float(ln.split()[1]) for ln in par_of("ELL1H")
              if ln.startswith("H3 "))
    harm = shapiro(_replace(par_of("ELL1H"), {
        "STIGMA": [f"H4 {0.3 * h3!r}", "NHARMS 30"]}))

    def high_harm(y):
        f = np.fft.rfft(y - y.mean())
        f[:3] = 0
        return np.fft.irfft(f, len(y))

    gap = float(np.max(np.abs(high_harm(exact) - high_harm(harm))))
    print(f"ELL1H exact vs harmonic sum above the 2nd harmonic: {gap:.3e} s")
    assert gap <= 5e-12


def test_refusals():
    """What the port does not cover raises: a DDK model without an
    astrometry component (as pint_tpu's delay raises).  BT_piecewise
    builds now (a BT layout with its pieces), and an FBn orbit on a
    variant is laid out (its FB block after the binary's slots)."""
    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.kernels.delay_chain import ChainLayout

    ddk = par_of("DDK")
    bt = [ln.replace("BINARY DDK", "BINARY BT_PIECEWISE") for ln in ddk
          if not ln.startswith(("KIN ", "KOM ", "K96 "))]
    m = _model(bt + ["XR1_0001 53000", "XR2_0001 54000",
                     "A1X_0001 9.2301"])
    assert "BinaryBTPiecewise" in m.components
    lay = m.calc.chain_layout
    assert lay.flags & dc.BT_PIECES and lay.cfg[1] == dc.DD
    assert not lay.flags & dc.ABERRATION
    assert {"A1X_0001", "A1X_0001__set", "T0X_0001__shift"} <= set(lay.names)
    comps = [c for c in _model(ddk).delay_components
             if not type(c).__name__.startswith("Astrometry")]
    with pytest.raises(AttributeError, match="astrometry"):
        ChainLayout.from_components(comps)
    for kind in ("DDK", "ELL1H"):
        m = _model(par_of(kind) + ["FB0 1.5e-6", "FB1 0"])
        lay = m.calc.chain_layout
        assert lay.flags & dc.FB_ORBIT
        cfg = dict(zip(dc.CFG_FIELDS, lay.cfg))
        assert cfg["nfb"] == 2
        assert lay.names[cfg["o_fb"]:cfg["o_fb"] + 3] == (
            "FB__zero", "FB0", "FB1")
