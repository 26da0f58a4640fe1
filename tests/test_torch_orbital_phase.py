"""pint_tpu_torch's ``TimingModel.orbital_phase`` against pint_tpu's, on
the CPU, and the delay kernel's orbital-phase entry compiled for the host.

The same 200-TOA sets go through both packages (JAX on the CPU, float64):
the J0740 set (ELL1), the DD set with its DD, BT and DDK (ecliptic)
binaries, the variants' ELL1H, ELL1k and DDGR (whose orbit reads the
par's PBDOT, not its derived one, in both packages), the BT_PIECEWISE set
and the spider set (an FBn orbit with four ORBWAVE harmonics):

* the port's orbital phase (the delay up to the binary, then the
  binary's ``orbital_phase``) within ``ORBIT_TOL`` of pint_tpu's,
  circularly (a phase just below 1 against one just above 0);
* the host build of ``csrc/delay_chain.cu``'s ``delay_chain_orbital_phase``
  (``csrc/delay_chain_host.cpp``) bit-equal to the port's plain version,
  and on a second θ set too;
* ``PhaseCalc.delay(upto=...)`` within ``DELAY_TOL_S`` of pint_tpu's
  partial delay,
  and refused on a non-CPU batch; a model without a binary refused with
  pint_tpu's error.

g++ is looked for inside the test; without it the host legs skip.
"""

import ctypes
import shutil
import types
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.kernels import build
from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.residuals import Residuals

#: orbital phase against pint_tpu's [orbits]: the same float64
#: expressions on bit-equal delays
ORBIT_TOL = 1e-12
#: the delay up to the binary against pint_tpu's [s] (bit-equal but in
#: ecliptic coordinates, whose rotation rounds another way)
DELAY_TOL_S = 1e-12
F64 = torch.float64


def _j0740_par():
    from pint_tpu_torch.examples import j0740_realistic_par

    return j0740_realistic_par(dmx_bins=data.DMX_BINS,
                               span_days=data.SPAN_DAYS,
                               center_mjd=data.CENTER_MJD).splitlines()


def _bt_par():
    keep = ("M2 ", "SINI ", "OMDOT ")
    return [ln.replace("BINARY DD", "BINARY BT") for ln in
            data.dd_par_lines() if not ln.startswith(keep)]


SETS = {"ELL1": (_j0740_par, data.REF_TIM),
        "DD": (data.dd_par_lines, data.DD_REF_TIM),
        "BT": (_bt_par, data.DD_REF_TIM),
        "DDK": (lambda: data.variant_par_lines("DDK_ECL"),
                data.variant_tim("DDK_ECL")),
        "DDGR": (lambda: data.variant_par_lines("DDGR"),
                 data.variant_tim("DDGR")),
        "ELL1H": (lambda: data.variant_par_lines("ELL1H"),
                  data.variant_tim("ELL1H")),
        "ELL1k": (lambda: data.variant_par_lines("ELL1k"),
                  data.variant_tim("ELL1k")),
        "BT_PIECEWISE": (data.btpw_par_lines, data.BTPW_REF_TIM),
        "FBn_ORBWAVE": (data.spider_par_lines, data.SPIDER_REF_TIM)}


@pytest.fixture(scope="module")
def host():
    """The host build of the delay kernel's row function, loaded with
    ctypes."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the row function for the host")
    h = ctypes.CDLL(build.host_library("delay_chain_host"))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    h.delay_chain_orbital_phase_host.argtypes = [vp] * (len(dc.ROWS) + 2) + [
        dc.ChainCfg, i64, i64]
    h.delay_chain_orbital_phase_host.restype = ctypes.c_int
    return h


def host_orbital_phase(h, layout, theta, rows):
    """delay_chain_orbital_phase on host tensors: theta (G, P) -> (G, N)."""
    theta = theta.contiguous()
    G, N = theta.shape[0], rows[0].shape[0]
    out = torch.empty((G, N), dtype=F64)
    err = h.delay_chain_orbital_phase_host(
        *[t.data_ptr() if t.numel() else None for t in rows],
        theta.data_ptr(), out.data_ptr(), layout.ctypes_cfg(), G, N)
    assert err == 0
    return out


@pytest.fixture(scope="module", params=list(SETS))
def pair(request):
    par, tim = SETS[request.param]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, jt = data.load_jax(tim, par=par())
        tm, tt = data.load_torch(tim, par=par())
        jr = JResiduals(jt, jm)
    return request.param, jm, jr, tm, Residuals(tt, tm, device="cpu")


def circular_gap(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.max(np.abs(d - np.round(d))))


def test_orbital_phase_matches_reference(pair):
    kind, jm, jr, tm, tr = pair
    want = np.asarray(jm.orbital_phase(jr.pdict, jr.batch))
    with torch.no_grad():
        got = tm.orbital_phase(tr.pdict, tr.batch).numpy()
    gap = circular_gap(got, want)
    print(f"{kind}: orbital phase {gap:.3e} orbits from pint_tpu's "
          f"(bar {ORBIT_TOL}), range [{got.min():.4f}, {got.max():.4f}]")
    assert got.shape == (tr.batch.ntoas,)
    assert np.all((got >= 0.0) & (got < 1.0))
    assert gap <= ORBIT_TOL


def test_host_entry_bit_equal_to_plain(host, pair):
    """The kernel's entry against the plain version, on the set's θ and a
    second θ set moved by 1e-9 of each free parameter."""
    kind, _, _, tm, tr = pair
    p, b, calc = tr.pdict, tr.batch, tm.calc
    lay = calc.chain_layout
    rows = [t.contiguous() for t in dc.row_inputs(lay, p, b)]
    names = tm.free_params
    x0 = tm.x0(p, names)
    x1 = x0 + torch.from_numpy(
        1e-9 * np.random.default_rng(16).standard_normal(len(names)))
    with torch.no_grad():
        ps = [tm.with_x(p, x, names) for x in (x0, x1)]
        thetas = torch.stack([dc.slot_values(lay.consts, lay.deltas, q)
                              for q in ps])
        want = torch.stack([tm.orbital_phase(q, b) for q in ps])
    got = host_orbital_phase(host, lay, thetas, rows)
    print(f"{kind}: host entry bit-equal {torch.equal(got, want)}, "
          f"{float(torch.max(torch.abs(got - want))):.3e} orbits")
    assert torch.equal(got, want)


def test_partial_delay_matches_reference(pair):
    kind, jm, jr, tm, tr = pair
    want = np.asarray(jm.calc.delay(jr.pdict, jr.batch,
                                    upto="pulsar_system"))
    with torch.no_grad():
        got = tm.calc.delay(tr.pdict, tr.batch, upto="pulsar_system")
    gap = float(np.max(np.abs(got.numpy() - want)))
    print(f"{kind}: delay up to the binary {gap:.3e} s from pint_tpu's "
          f"(bar {DELAY_TOL_S})")
    assert gap <= DELAY_TOL_S
    # the kernel forms the whole chain only: a partial delay of a batch on
    # the card is refused before anything is read
    card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="whole chain"):
        tm.calc.delay(tr.pdict, card, upto="pulsar_system")


def test_no_binary_refused():
    """Both packages refuse a model without a binary, with one message."""
    lines = [ln for ln in _j0740_par()
             if ln.split()[:1] not in (["BINARY"], ["PB"], ["A1"],
                                       ["TASC"], ["EPS1"], ["EPS2"],
                                       ["M2"], ["SINI"])]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, jt = data.load_jax(data.REF_TIM, par=lines)
        tm, tt = data.load_torch(data.REF_TIM, par=lines)
        jr = JResiduals(jt, jm)
    tr = Residuals(tt, tm, device="cpu")
    with pytest.raises(ValueError) as jerr:
        jm.orbital_phase(jr.pdict, jr.batch)
    with pytest.raises(ValueError) as terr:
        tm.orbital_phase(tr.pdict, tr.batch)
    assert str(jerr.value) == str(terr.value)
