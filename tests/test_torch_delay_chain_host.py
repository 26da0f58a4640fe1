"""The ``delay_chain`` kernel's row function compiled for the host CPU.

``csrc/delay_chain.cuh`` is plain C++ under ``PT_HD``, so
``csrc/delay_chain_host.cpp`` (the kernel's launch shapes as loops) builds
with ``g++ -ffp-contract=off`` here, without a card or nvcc.  On the
committed 200-TOA J0740 (ELL1), DD and BT sets, and on the DD and ELL1
variants (``examples.variant_par``: DDS, DDH, DDGR, DDK in equatorial
and, on its own 200-TOA set, in ecliptic coordinates, ELL1H in its three
modes, ELL1k), and the DM family (``examples.dm_family_par``: NE_SW with SWM 0
and SWM 1, SWX, DMJUMP, FDJUMPDM and FD<k>JUMP on the DD and the ELL1
binary; and the wideband set's layout, ``WB``), and the chromatic family
(the chromatic set ``CHROM``: troposphere, CM, a dip and a Gaussian
event; the WaveX set ``WAVEX``: WaveX, DMWaveX, CMWaveX, CM and CMX; and,
as depth legs, each term alone on DD and ELL1,
``examples.chromatic_family_par``), and the orbit family (the spider set
``SPIDER``: an FBn orbit, four ORBWAVE harmonics and PLANET_SHAPIRO on
ELL1; and, as depth legs, the BT_PIECEWISE set ``BTPW`` and each term
alone on DD and ELL1, ``examples.orbit_family_par``), whose delay is held
bit-equal (SWM 1 too: torch's pow on the CPU is libm's here, so its
quadrature's 64 powers per row agree to the last bit):

* every lane of the multi-lane number type ``DualN<L>`` (L = 2, 4) is
  bit-equal to the single-lane ``Dual`` at lane counts 1, 3, 10 and P,
  on two θ sets (the multi-lane kernel changed no arithmetic), on the
  three sets, DDK in ecliptic coordinates, ELL1H, and the DM family on
  DD (SWM 0) and ELL1 (SWM 1);
* the row function's delay within 1e-12 s and its jacfwd columns within
  1e-10 relative of :meth:`PhaseCalc.delay_plain`;
* the wrapper's autograd rules (``kernels/delay_chain.py``) driven
  through the host build in place of the card: a jacfwd is one primal
  and one tangent launch, a vmap over 9 grid points of a jacfwd too, and
  ``backward`` agrees with the plain version's reverse mode within 5e-9
  of sum |J||g| (the plain reverse mode through the quad-single t -
  epoch is float32-grade, ROADMAP queue C).

g++ is looked for inside the test; without it the tests skip.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu_torch.examples import (CHROM_FAMILY, DM_FAMILY, ORBIT_FAMILY,
                                     VARIANTS)
from pint_tpu_torch.kernels import build
from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.residuals import Residuals

DELAY_TOL_S = 1e-12
COLUMN_TOL = 1e-10
#: backward vs the plain reverse mode, relative to sum |J| |g|
BACKWARD_TOL = 5e-9
GRID_POINTS = 9
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


SETS = {"J0740": (_j0740_par, data.REF_TIM),
        "DD": (data.dd_par_lines, data.DD_REF_TIM),
        "BT": (_bt_par, data.DD_REF_TIM),
        **{kind: (lambda kind=kind: data.variant_par_lines(kind),
                  data.variant_tim(kind)) for kind in VARIANTS},
        **{kind: (lambda kind=kind: data.dm_family_par_lines(kind),
                  data.dm_family_tim(kind)) for kind in DM_FAMILY},
        "WB": (data.wb_par_lines, data.WB_REF_TIM),
        "CHROM": (data.chrom_par_lines, data.CHROM_REF_TIM),
        "WAVEX": (data.wavex_full_par_lines, data.WAVEX_REF_TIM),
        **{kind: (lambda kind=kind: data.chrom_family_par_lines(kind),
                  data.chrom_family_tim(kind)) for kind in CHROM_FAMILY},
        "SPIDER": (data.spider_par_lines, data.SPIDER_REF_TIM),
        "BTPW": (data.btpw_par_lines, data.BTPW_REF_TIM),
        **{kind: (lambda kind=kind: data.orbit_family_par_lines(kind),
                  data.orbit_family_tim(kind)) for kind in ORBIT_FAMILY}}
#: the depth legs: the chromatic and the orbit family's single-term
#: variants and BT_PIECEWISE (the CHROM and WAVEX sets hold every
#: chromatic term in tier-1, the SPIDER set the FBn orbit, ORBWAVE and
#: the planets)
DEPTH_SETS = CHROM_FAMILY + ORBIT_FAMILY + ("BTPW",)
#: every set
SET_PARAMS = [pytest.param(k, marks=pytest.mark.slow)
              if k in DEPTH_SETS else k for k in SETS]
#: the cases of the depth legs (every lanes-per-thread at every lane
#: count): the first three sets, DDK in ecliptic coordinates, ELL1H and
#: the DM family on the DD binary (SWM 0) and the ELL1 one (SWM 1)
DEPTH = ("J0740", "DD", "BT", "DDK_ECL", "ELL1H", "DMF_DD",
         "DMF_ELL1_SWM1", *[pytest.param(k, marks=pytest.mark.slow)
                            for k in ("CHROM", "WAVEX", "SPIDER", "BTPW")])


@pytest.fixture(scope="module")
def host():
    """The host build of the row function (built once per source hash,
    ``build.host_library``), loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the row function for the host")
    h = ctypes.CDLL(build.host_library("delay_chain_host"))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    h.delay_chain_host.argtypes = [vp] * (len(dc.ROWS) + 3) + [
        dc.ChainCfg, i64, i64, i64, ctypes.c_int]
    h.delay_chain_host.restype = ctypes.c_int
    return h


def _ptr(t):
    return t.data_ptr() if t.numel() else None


def host_run(h, layout, theta, dtheta, rows, lanes=1):
    """delay_chain.cu's launch on host tensors: theta (G, P) -> (G, N)
    delay; with dtheta (G, K, P) -> (G, K, N) tangents."""
    theta = theta.contiguous()
    G, N = theta.shape[0], rows[0].shape[0]
    K = 0 if dtheta is None else dtheta.shape[1]
    out = torch.empty((G, N) if dtheta is None else (G, K, N), dtype=F64)
    if dtheta is not None:
        dtheta = dtheta.contiguous()
    err = h.delay_chain_host(
        *[_ptr(t) for t in rows], theta.data_ptr(),
        None if dtheta is None else dtheta.data_ptr(), out.data_ptr(),
        layout.ctypes_cfg(), G, K, N, lanes)
    assert err == 0
    return out


@pytest.fixture(scope="module", params=SET_PARAMS)
def case(request):
    par, tim = SETS[request.param]
    model, toas = data.load_torch(tim, par=par())
    r = Residuals(toas, model, device="cpu")
    p, b, calc = r.pdict, r.batch, model.calc
    lay = calc.chain_layout
    rows = [t.contiguous() for t in dc.row_inputs(lay, p, b)]
    names = model.free_params
    x0 = model.x0(p, names)
    rng = np.random.default_rng(20261017)
    # a second θ set a hair away from the first
    x1 = x0 + torch.from_numpy(1e-9 * rng.standard_normal(len(names)))
    with torch.no_grad():
        thetas = torch.stack([lay.theta(model.with_x(p, x, names))
                              for x in (x0, x1)])
    return dict(name=request.param, model=model, p=p, b=b, calc=calc,
                lay=lay, rows=rows, names=names, x0=x0, thetas=thetas,
                rng=rng)


def test_host_delay_matches_plain(host, case):
    lay, rows, calc = case["lay"], case["rows"], case["calc"]
    got = host_run(host, lay, case["thetas"][:1], None, rows)[0]
    with torch.no_grad():
        want = calc.delay_plain(case["p"], case["b"])
    err = float(torch.max(torch.abs(got - want)))
    print(f"{case['name']}: host row function vs plain delay {err:.3e} s, "
          f"bit-equal {torch.equal(got, want)}")
    assert err <= DELAY_TOL_S
    if case["name"] not in ("J0740", "DD", "BT"):
        # the models of the DD and ELL1 variants: bit-equal
        assert torch.equal(got, want)


def _plain_columns(case):
    model, p, b, names = case["model"], case["p"], case["b"], case["names"]
    return torch.func.jacfwd(lambda x: case["calc"].delay_plain(
        model.with_x(p, x, names), b))(case["x0"])


def _theta_tangents(case):
    """(P, free) d theta / d x: the unit tangents of the free parameters
    in theta's slots."""
    model, p, names, lay = case["model"], case["p"], case["names"], \
        case["lay"]
    return torch.func.jacfwd(lambda x: lay.theta(model.with_x(p, x, names)))(
        case["x0"])


def _column_gap(J, Jp):
    scale = torch.amax(torch.abs(Jp), 0)
    return float(torch.max(torch.amax(torch.abs(J - Jp), 0)
                           / torch.where(scale > 0, scale, 1.0)))


def test_host_columns_match_plain(host, case):
    """Every free parameter's column, one lane each, from one tangent
    pass at the wrapper's lanes per thread."""
    dth = _theta_tangents(case).T[None]                  # (1, free, P)
    lanes = dc.lanes_per_thread(1, dth.shape[1])
    J = host_run(host, case["lay"], case["thetas"][:1], dth, case["rows"],
                 lanes)[0].T                              # (N, free)
    gap = _column_gap(J, _plain_columns(case))
    print(f"{case['name']}: {len(case['names'])} columns, max relative gap "
          f"{gap:.3e} (bar {COLUMN_TOL})")
    assert gap <= COLUMN_TOL


@pytest.mark.parametrize("case", DEPTH, indirect=True)
@pytest.mark.parametrize("lanes", [1, 3, 10, "P"])
@pytest.mark.parametrize("L", [2, 4])
def test_lanes_bit_equal_to_dual(host, case, L, lanes):
    """DualN<L> against Dual on two θ sets: every lane bit-equal, a
    ragged last lane block included."""
    lay = case["lay"]
    K = lay.P if lanes == "P" else lanes
    rng = np.random.default_rng(K)
    dth = torch.from_numpy(rng.standard_normal((2, K, lay.P)))
    if lanes == "P":
        dth[0] = torch.eye(lay.P, dtype=F64)
    one = host_run(host, lay, case["thetas"], dth, case["rows"], 1)
    many = host_run(host, lay, case["thetas"], dth, case["rows"], L)
    assert torch.all(torch.isfinite(one))
    assert torch.equal(many, one), float(torch.max(torch.abs(many - one)))


@pytest.mark.parametrize("case", ["CHROM", "WAVEX"], indirect=True)
@pytest.mark.parametrize("L", [2, 4])
def test_chromatic_lanes_bit_equal_to_dual(host, case, L):
    """The chromatic family's tier-1 lanes leg: every lane of a tangent
    launch over all P unit lanes and random ones (the depth legs run every
    lane count)."""
    test_lanes_bit_equal_to_dual(host, case, L, "P")


@pytest.mark.parametrize("case", ["SPIDER"], indirect=True)
@pytest.mark.parametrize("L", [2, 4])
def test_orbit_lanes_bit_equal_to_dual(host, case, L):
    """The orbit family's tier-1 lanes leg, as the chromatic family's."""
    test_lanes_bit_equal_to_dual(host, case, L, "P")


@pytest.fixture
def on_host(host, monkeypatch):
    """The wrapper's kernel calls routed to the host build: ``run`` takes
    host tensors and the library is the host one (no aux, no stream)."""

    class Lib:
        @staticmethod
        def delay_chain(*args):
            nptr = len(dc.ROWS) + 4
            ptrs, (cfg, G, K, N, lpt, _stream) = args[:nptr], args[nptr:]
            assert ptrs[-1] is None
            return host.delay_chain_host(*ptrs[:-1], cfg, G, K, N, lpt)

        @staticmethod
        def delay_chain_error_string(err):
            return b"host error"

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(dc, "_lib", lambda layout: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream)
    monkeypatch.setattr(dc, "run", lambda layout, theta, dtheta, rows: dc
                        ._launch(layout, theta, dtheta, rows)[0])


def _kernel_delay(case, p):
    lay = case["lay"]
    return dc.DelayChain.apply(lay.theta(p), lay, *case["rows"])


def _counts():
    return dc.DelayChain.launches, dc.DelayChainTangent.launches


def test_wrapper_jacfwd_one_tangent_launch(on_host, case):
    model, p, names = case["model"], case["p"], case["names"]
    before = _counts()
    J = torch.func.jacfwd(lambda x: _kernel_delay(
        case, model.with_x(p, x, names)))(case["x0"])
    assert _counts() == (before[0] + 1, before[1] + 1)
    gap = _column_gap(J, _plain_columns(case))
    print(f"{case['name']}: wrapper jacfwd vs plain {gap:.3e}")
    assert gap <= COLUMN_TOL


def test_wrapper_vmap_grid_one_tangent_launch(on_host, case):
    """vmap over 9 grid points of a jacfwd: still one primal and one
    tangent launch (9 θ sets, each with its lanes), every point's
    columns as the plain version's."""
    model, p, names, b = case["model"], case["p"], case["names"], case["b"]
    X = case["x0"] + torch.from_numpy(
        1e-9 * case["rng"].standard_normal((GRID_POINTS, len(names))))
    before = _counts()
    J = torch.func.vmap(torch.func.jacfwd(lambda x: _kernel_delay(
        case, model.with_x(p, x, names))))(X)
    assert _counts() == (before[0] + 1, before[1] + 1)
    assert J.shape == (GRID_POINTS, b.ntoas, len(names))
    for g in (0, GRID_POINTS - 1):
        Jp = torch.func.jacfwd(lambda x: case["calc"].delay_plain(
            model.with_x(p, x, names), b))(X[g])
        assert _column_gap(J[g], Jp) <= COLUMN_TOL


def test_wrapper_backward_matches_plain(on_host, case):
    """Reverse mode: the tangent launch with P unit lanes, reduced
    against the incoming gradient."""
    model, p, names, b = case["model"], case["p"], case["names"], case["b"]
    w = torch.from_numpy(case["rng"].standard_normal(b.ntoas))
    x = case["x0"].clone().requires_grad_(True)
    before = _counts()
    (gk,) = torch.autograd.grad(
        torch.sum(w * _kernel_delay(case, model.with_x(p, x, names))), x)
    assert _counts() == (before[0] + 1, before[1] + 1)
    x = case["x0"].clone().requires_grad_(True)
    (gp,) = torch.autograd.grad(torch.sum(w * case["calc"].delay_plain(
        model.with_x(p, x, names), b)), x)
    Jp = _plain_columns(case)
    scale = torch.abs(Jp).T @ torch.abs(w)
    scale = torch.where(scale > 0, scale, 1.0)
    rel = float(torch.max(torch.abs(gk - gp) / scale))
    # J^T g of the plain forward columns (float64-grade)
    rel_fwd = float(torch.max(torch.abs(gk - Jp.T @ w) / scale))
    print(f"{case['name']}: backward vs plain reverse mode {rel:.3e}, vs "
          f"the plain columns' J^T g {rel_fwd:.3e} of sum |J||g|")
    assert rel_fwd <= BACKWARD_TOL
    if case["name"] not in DEPTH_SETS:
        # the depth legs are held against J^T g alone: the plain reverse
        # mode's float32-grade t - epoch reaches 5.6e-9 of sum |J||g| on
        # CHF_ELL1_DMWAVEX and 7.3e-9 on BTPW
        assert rel <= BACKWARD_TOL
