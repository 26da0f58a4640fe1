"""The fused ``phase_chain`` kernel's row functions compiled for the host.

``csrc/phase_chain.cuh`` (the delay chain's row function with the
quad-single phase row as its epilogue, and the tangent lanes) is plain
C++ under ``PT_HD``, so ``csrc/phase_chain_host.cpp`` (the kernel's
launch shapes as loops) builds with ``g++ -ffp-contract=off`` here,
without a card or nvcc, and so does ``csrc/delay_chain_host.cpp``, the
host build of the delay chain alone.  On the committed 200-TOA J0740
(ELL1), DD and GLS sets, and on the DD and ELL1 variants
(``examples.variant_par``: DDS, DDH, DDGR, DDK in equatorial and, on its
own 200-TOA set, in ecliptic coordinates, ELL1H in its three modes,
ELL1k), on the DM family (``examples.dm_family_par``: NE_SW with SWM 0
and 1, SWX, DMJUMP, FDJUMPDM and FD<k>JUMP on the DD and ELL1 binaries),
on the chromatic family (the ``CHROM`` and ``WAVEX`` sets, and as depth
legs each term alone on DD and ELL1, ``examples.chromatic_family_par``),
on the orbit family (the ``SPIDER`` set: an FBn orbit, ORBWAVEs and
PLANET_SHAPIRO on ELL1; and as depth legs the ``BTPW`` set and each term
alone on DD and ELL1, ``examples.orbit_family_par``), on the phase family
(the ``YOUNG`` set: ``examples.young_par()``, three glitches, a
PiecewiseSpindown group, WAVE, IFUNC and PHOFF, its terms formed in the
launch by the template values with kPhaseFamily) and on the wideband
set's layout (``WB``; the tangent lanes at every L
and lane count on DDK in ecliptic coordinates, ELL1H and the DM family
with SWM 1 on DD, the shared-other and words-mode rules on the three
sets):

* the fused primal's frac, slope, dt64 and words are bit-equal to the
  unfused host chain (the delay chain's host build, PyTorch's shift,
  ``phase_frac_plain``) in all three modes, on 1 and 9 θ sets;
* the fused tangent lanes (L = 1, 2, 4; lanes 1, 3, 10 and P) are
  bit-equal to the unfused host chain's (the delay chain's host
  tangents, the shift's forward rule, ``QSPhaseFrac.jvp``'s word-level
  tangent), up to the sign of a zero, which ``torch.equal`` ignores;
* frac within ``FRAC_TOL_CYCLES`` of the plain composition (the
  components' own delays), and the jacfwd columns within 1e-10 relative
  of it;
* the wrapper's rules (``kernels/phase_chain.py``) driven through the
  host build: a jacfwd is one primal and one tangent launch, and so is a
  vmap over 9 grid points of one, every column bit-equal to the unfused
  host chain's;
* on the J0740 set, the port's residuals and design matrix through the
  host build against pint_tpu's (on the CPU, float64) at parameter
  offsets drawn from a seed with numpy: residuals within 1 ns, columns
  within 1e-10 relative.

g++ is looked for inside the test; without it the tests skip.
"""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu_torch.examples import (CHROM_FAMILY, DM_FAMILY, ORBIT_FAMILY,
                                     PHASE_FAMILY, VARIANTS,
                                     phase_family_par)
from pint_tpu_torch.kernels import build
from pint_tpu_torch.kernels import delay_chain as dc
from pint_tpu_torch.kernels import phase_chain as pc
from pint_tpu_torch.kernels.qs_phase import QSPhaseFrac
from pint_tpu_torch.residuals import Residuals

FRAC_TOL_CYCLES = 1e-12
#: the phase family's frac against the unfused host chain [cycles]: the
#: family's exp, sin and cos are the C library's in the host build and
#: torch's vectorized ones in the unfused chain's PyTorch, which differ
#: by an ulp on some arguments (a glitch's phase of ~4e3 cycles carries
#: ~1e-12 cycles per ulp)
FAMILY_FRAC_TOL_CYCLES = 1e-12
COLUMN_TOL = 1e-10
RESID_TOL_S = 1e-9
GRID_POINTS = 9
SECS_PER_DAY = 86400.0
F64 = torch.float64

#: the first three sets, which every test runs on
BASE = ("J0740", "DD", "GLS")
SETS = {"J0740": (data.par_lines, data.REF_TIM),
        "DD": (data.dd_par_lines, data.DD_REF_TIM),
        "GLS": (data.dd_gls_par_lines, data.GLS_REF_TIM),
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
                  data.orbit_family_tim(kind)) for kind in ORBIT_FAMILY},
        # the phase family's layouts (held by the family's tests below)
        "YOUNG": (data.young_par_lines, data.YOUNG_REF_TIM),
        **{kind: (lambda kind=kind: phase_family_par(kind).splitlines(),
                  data.YOUNG_REF_TIM) for kind in PHASE_FAMILY}}
#: the phase family's layouts: the young set's par and its edge variants
FAMILY_SETS = ("YOUNG",) + PHASE_FAMILY
#: the depth legs: the chromatic and the orbit family's single-term
#: variants and BT_PIECEWISE (the CHROM and WAVEX sets hold every
#: chromatic term in tier-1, the SPIDER set the FBn orbit, ORBWAVE and
#: the planets)
DEPTH_SETS = CHROM_FAMILY + ORBIT_FAMILY + ("BTPW",)
#: every set of the generic tests (the phase family's have their own)
SET_PARAMS = [pytest.param(k, marks=pytest.mark.slow)
              if k in DEPTH_SETS else k for k in SETS
              if k not in FAMILY_SETS]
#: the cases of the depth legs (every lanes-per-thread at every lane
#: count): the first three sets, DDK in ecliptic coordinates and ELL1H
DEPTH = BASE + ("DDK_ECL", "ELL1H", "DMF_DD_SWM1",
                *[pytest.param(k, marks=pytest.mark.slow)
                  for k in ("CHROM", "WAVEX", "SPIDER", "BTPW")])


@pytest.fixture(scope="module")
def host():
    """The host builds of the fused chain and of the delay chain alone
    (built once per source hash, ``build.host_library``)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the row functions for the host")
    ph, de = (ctypes.CDLL(build.host_library(name))
              for name in ("phase_chain_host", "delay_chain_host"))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    ph.phase_chain_host.argtypes = [vp] * pc.N_POINTERS + [
        pc.PhCfg, pc.PhaseCfg, i64, i64, i64, i64, i64, i64, ctypes.c_int]
    ph.phase_chain_host.restype = ctypes.c_int
    de.delay_chain_host.argtypes = [vp] * (len(dc.ROWS) + 3) + [
        dc.ChainCfg, i64, i64, i64, ctypes.c_int]
    de.delay_chain_host.restype = ctypes.c_int
    return ph, de


@pytest.fixture
def on_host(host, monkeypatch):
    """Both wrappers' kernel calls routed to the host builds: ``run``
    takes host tensors and the libraries are the host ones (no aux, no
    stream)."""
    ph, de = host

    class PhaseLib:
        @staticmethod
        def phase_chain(*args):
            return ph.phase_chain_host(*args[:-1])

        @staticmethod
        def phase_chain_error_string(err):
            return b"host error"

    class DelayLib:
        @staticmethod
        def delay_chain(*args):
            nptr = len(dc.ROWS) + 4
            ptrs, (cfg, G, K, N, lpt, _stream) = args[:nptr], args[nptr:]
            assert ptrs[-1] is None
            return de.delay_chain_host(*ptrs[:-1], cfg, G, K, N, lpt)

        @staticmethod
        def delay_chain_error_string(err):
            return b"host error"

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(pc, "_lib", lambda spec: PhaseLib)
    monkeypatch.setattr(dc, "_lib", lambda layout: DelayLib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream)
    monkeypatch.setattr(pc, "run", pc._launch)
    monkeypatch.setattr(dc, "run", lambda layout, theta, dtheta, rows,
                        lanes=None: dc._launch(layout, theta, dtheta, rows,
                                               lanes=lanes)[0])
    # the fused launches on a CPU batch, as on a CUDA one
    monkeypatch.setattr(pc, "phase_frac", pc.fused)


@pytest.fixture(scope="module", params=SET_PARAMS)
def case(request):
    par, tim = SETS[request.param]
    model, toas = data.load_torch(tim, par=par())
    r = Residuals(toas, model, device="cpu")
    p, b, calc = r.pdict, r.batch, model.calc
    names = model.free_params
    x0 = model.x0(p, names)
    rng = np.random.default_rng(20261018)
    X = x0 + torch.from_numpy(
        1e-9 * rng.standard_normal((GRID_POINTS, len(names))))
    X[0] = x0
    pn = torch.from_numpy(np.round(rng.uniform(-1e9, 1e9, b.ntoas)))
    pn[::17] = float("nan")
    return dict(name=request.param, model=model, p=p, b=b, calc=calc,
                names=names, x0=x0, X=X, pn=pn, rng=rng)


def _at(case, x):
    return case["model"].with_x(case["p"], x, case["names"])


def host_delay(calc):
    """The delay chain's kernel path on a CPU batch (its host build once
    ``on_host`` routes it): the K4 step of the unfused host chain."""
    lay = calc.chain_layout

    def delay(p, b):
        return dc.DelayChain.apply(lay.theta(p), lay,
                                   *dc.row_inputs(lay, p, b))
    return delay


def _inputs(case, x, mode):
    """The fused launch's inputs at ``x``, with the case's pulse numbers
    in the use_pulse_numbers mode (the sets carry none)."""
    spec, theta, other, tensors = pc.fused_inputs(
        case["calc"], _at(case, x), case["b"], mode,
        subtract_tzr=mode != "words")
    if mode == "use_pulse_numbers":
        tensors[len(dc.ROWS)] = case["pn"]
    return spec, theta, other, tensors


def _unfused_primal(case, x, mode, delay):
    """(out, slope, dt64) of the unfused chain at ``x``: ``delay``, the
    shift, and qs_phase_frac's plain version; and its inputs."""
    spec, shift, dF, other = pc.unfused_inputs(
        case["calc"], _at(case, x), case["b"], mode,
        subtract_tzr=mode != "words", delay=delay)
    if mode == "use_pulse_numbers":
        spec = dataclasses.replace(spec, pulse_number=case["pn"])
    return spec.plain(shift, dF, other), (spec, shift, dF, other)


@pytest.mark.parametrize("mode", ["nearest", "use_pulse_numbers", "words"])
@pytest.mark.parametrize("sets", [1, GRID_POINTS])
def test_primal_bit_equal_to_unfused(on_host, case, mode, sets):
    """frac (or the words), slope and dt64 of one fused launch over
    ``sets`` θ sets against the unfused host chain at each point."""
    calc = case["calc"]
    ins = [_inputs(case, x, mode) for x in case["X"][:sets]]
    spec, _, _, tensors = ins[0]
    thetas = torch.stack([t for _, t, _, _ in ins])
    others = torch.stack([o for _, _, o, _ in ins])
    before = pc.PhaseChain.launches
    fused = pc.run(spec, thetas, others, tensors)
    assert pc.PhaseChain.launches == before + 1
    for g, x in enumerate(case["X"][:sets]):
        want, _ = _unfused_primal(case, x, mode, host_delay(calc))
        for name, a, w in zip(("out", "slope", "dt64"), fused, want):
            assert torch.equal(a[g], w), (case["name"], mode, g, name)


def _dtheta(spec, K, G):
    rng = np.random.default_rng(K)
    dth = torch.from_numpy(rng.standard_normal((G, K, spec.P)))
    if K == spec.P:
        dth[0] = torch.eye(spec.P, dtype=F64)
    return dth


@pytest.mark.parametrize("case", DEPTH, indirect=True)
@pytest.mark.parametrize("lanes", [1, 3, 10, "P"])
@pytest.mark.parametrize("L", [1, 2, 4])
def test_tangent_lanes_bit_equal_to_unfused(on_host, case, L, lanes):
    """d frac of the fused tangent launch at L lanes per thread on two θ
    sets, with random tangents of θ and of ``other``, against the delay
    chain's host tangents, the shift's forward rule and QSPhaseFrac.jvp
    (every lane, a ragged last lane block included)."""
    calc, b = case["calc"], case["b"]
    ins = [_inputs(case, x, "nearest") for x in case["X"][:2]]
    spec, _, _, tensors = ins[0]
    thetas = torch.stack([t for _, t, _, _ in ins])
    others = torch.stack([o for _, _, o, _ in ins])
    K = spec.P if lanes == "P" else lanes
    dth = _dtheta(spec, K, 2)
    dother = torch.from_numpy(np.random.default_rng(K + 1).standard_normal(
        (2, K, b.ntoas)))
    got = pc.run(spec, thetas, others, tensors, dth, dother, lanes=L)
    lay, P4 = spec.layout, spec.layout.P
    o_spin, o_pep = P4, P4 + spec.K
    rows = tensors[:len(dc.ROWS)]
    for g, x in enumerate(case["X"][:2]):
        dd = dc.run(lay, thetas[g, None, :P4], dth[g, None, :, :P4], rows,
                    lanes=1)[0]                          # (K, N)
        dshift = (-dd) - (dth[g, :, o_pep, None] * SECS_PER_DAY)
        _, (qspec, shift, dF, other) = _unfused_primal(
            case, x, "nearest", host_delay(calc))

        def f(s, d, o):
            return QSPhaseFrac.call(qspec, s, d, o)[0]

        want = torch.func.vmap(lambda ds, dF_, do: torch.func.jvp(
            f, (shift, dF, other), (ds, dF_, do))[1])(
                dshift, dth[g, :, o_spin:o_spin + spec.K], dother[g])
        assert torch.all(torch.isfinite(want))
        assert torch.equal(got[g], want), (
            case["name"], L, K, g, float(torch.max(torch.abs(got[g] - want))))


@pytest.mark.parametrize("case", ["CHROM", "WAVEX"], indirect=True)
@pytest.mark.parametrize("L", [2, 4])
def test_chromatic_tangent_lanes_bit_equal(on_host, case, L):
    """The chromatic family's tier-1 lanes leg: the fused tangent at P
    lanes against the unfused host chain (the depth legs run every lane
    count)."""
    test_tangent_lanes_bit_equal_to_unfused(on_host, case, L, "P")


@pytest.mark.parametrize("case", ["SPIDER"], indirect=True)
@pytest.mark.parametrize("L", [2, 4])
def test_orbit_tangent_lanes_bit_equal(on_host, case, L):
    """The orbit family's tier-1 lanes leg, as the chromatic family's."""
    test_tangent_lanes_bit_equal_to_unfused(on_host, case, L, "P")


@pytest.mark.parametrize("case", FAMILY_SETS, indirect=True)
@pytest.mark.parametrize("mode", ["nearest", "use_pulse_numbers", "words"])
def test_phase_family_primal_vs_unfused(on_host, case, mode):
    """The phase family's template value against the unfused host chain
    (the delay chain's host build, the family's and the other components'
    phase in PyTorch, phase_frac_plain) over 9 θ sets: slope and dt64
    bit-equal, frac (or the words) bit-equal on the rows where torch's
    transcendentals meet the C library's and within
    FAMILY_FRAC_TOL_CYCLES on every row; one launch."""
    calc = case["calc"]
    ins = [_inputs(case, x, mode) for x in case["X"]]
    spec, _, _, tensors = ins[0]
    assert spec.family is not None and spec.flags & dc.PHASE_TERMS
    thetas = torch.stack([t for _, t, _, _ in ins])
    others = torch.stack([o for _, _, o, _ in ins])
    before = pc.PhaseFamilyPrimal.launches
    fused = pc.run(spec, thetas, others, tensors)
    assert pc.PhaseFamilyPrimal.launches == before + 1
    rows = gap = 0
    for g, x in enumerate(case["X"]):
        want, _ = _unfused_primal(case, x, mode, host_delay(calc))
        for name, a, w in zip(("slope", "dt64"), fused[1:], want[1:]):
            assert torch.equal(a[g], w), (case["name"], mode, g, name)
        a, w = fused[0][g], want[0]
        if mode == "words":
            a, w = (v.to(F64).sum(-1) for v in (a, w))
        d = torch.abs(a - w)
        rows += int(torch.sum(d > 0))
        gap = max(gap, float(torch.max(d)))
    print(f"{case['name']} {mode}: {rows} of {fused[0].shape[0] * fused[0].shape[1]} "
          f"rows not bit-equal, largest gap {gap:.3e} cycles")
    assert gap <= FAMILY_FRAC_TOL_CYCLES


@pytest.mark.parametrize("case", FAMILY_SETS, indirect=True)
@pytest.mark.parametrize("lanes", [3, "n"])
def test_phase_family_tangent_lanes_bit_equal(on_host, case, lanes):
    """The phase family's lanes: along random fit-parameter directions
    (θ's and other's tangents their images, as a jacfwd forms them), the
    fused tangent launch bit-equal at L = 1, 2 and 4 lanes per thread,
    and within COLUMN_TOL relative of the jvp of the unfused host chain
    (its transcendentals torch's)."""
    calc, b, x0 = case["calc"], case["b"], case["x0"]
    n = len(case["names"])
    K = n if lanes == "n" else lanes
    V = torch.from_numpy(np.random.default_rng(K).standard_normal((K, n)))

    def fused_part(i):
        return lambda x: pc.fused_inputs(calc, _at(case, x), b,
                                         "nearest")[i]

    spec, theta, other, tensors = _inputs(case, x0, "nearest")
    dth = torch.func.vmap(lambda v: torch.func.jvp(
        fused_part(1), (x0,), (v,))[1])(V)
    dother = None if other is None else torch.func.vmap(
        lambda v: torch.func.jvp(fused_part(2), (x0,), (v,))[1])(V)
    got = [pc.run(spec, theta[None], None if other is None else other[None],
                  tensors, dth[None],
                  None if dother is None else dother[None], lanes=L)[0]
           for L in dc.KERNEL_LANES]
    assert all(torch.equal(g, got[0]) for g in got[1:])
    want = torch.func.vmap(lambda v: torch.func.jvp(
        lambda x: pc.unfused(calc, _at(case, x), b, "nearest",
                             delay=host_delay(calc)), (x0,), (v,))[1])(V)
    assert torch.all(torch.isfinite(want))
    assert _column_gap(got[0].T, want.T) <= COLUMN_TOL


@pytest.mark.parametrize("case", FAMILY_SETS, indirect=True)
def test_phase_family_jacfwd_one_launch(on_host, case):
    """A jacfwd over every free parameter through the phase family's
    template value is one primal and one tangent launch, its columns
    within COLUMN_TOL relative of the unfused host chain's and of the
    plain composition's; a vmap over 9 grid points of one is still one
    of each."""
    calc, b, X = case["calc"], case["b"], case["X"]

    def fused(x):
        return pc.fused(calc, _at(case, x), b, "nearest")

    before = (pc.PhaseFamilyPrimal.launches, pc.PhaseFamilyTangent.launches)
    J = torch.func.jacfwd(fused)(case["x0"])
    assert (pc.PhaseFamilyPrimal.launches,
            pc.PhaseFamilyTangent.launches) == (before[0] + 1, before[1] + 1)
    Ju = torch.func.jacfwd(lambda x: pc.unfused(
        calc, _at(case, x), b, "nearest", delay=host_delay(calc)))(
            case["x0"])
    Jp = torch.func.jacfwd(lambda x: pc.unfused(
        calc, _at(case, x), b, "nearest"))(case["x0"])
    print(f"{case['name']}: {int(torch.sum(J != Ju))} of {J.numel()} "
          f"entries not bit-equal to the unfused host chain's")
    assert _column_gap(J, Ju) <= COLUMN_TOL
    assert _column_gap(J, Jp) <= COLUMN_TOL
    before = (pc.PhaseFamilyPrimal.launches, pc.PhaseFamilyTangent.launches)
    Jg = torch.func.vmap(torch.func.jacfwd(fused))(X)
    assert (pc.PhaseFamilyPrimal.launches,
            pc.PhaseFamilyTangent.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(Jg[0], J)


def _column_gap(J, Jp):
    scale = torch.amax(torch.abs(Jp), 0)
    return float(torch.max(torch.amax(torch.abs(J - Jp), 0)
                           / torch.where(scale > 0, scale, 1.0)))


def test_fused_vs_plain_composition(on_host, case):
    """The fused launches against the plain composition (the components'
    own delays): frac within FRAC_TOL_CYCLES, every jacfwd column within
    COLUMN_TOL relative."""
    calc, b = case["calc"], case["b"]
    with torch.no_grad():
        frac = pc.fused(calc, case["p"], b, "nearest")
        plain = pc.unfused(calc, case["p"], b, "nearest")
    gap = float(torch.max(torch.abs(frac - plain)))
    J = torch.func.jacfwd(lambda x: pc.fused(calc, _at(case, x), b,
                                             "nearest"))(case["x0"])
    Jp = torch.func.jacfwd(lambda x: pc.unfused(calc, _at(case, x), b,
                                                "nearest"))(case["x0"])
    col = _column_gap(J, Jp)
    print(f"{case['name']}: fused vs plain composition: frac {gap:.3e} "
          f"cycles, columns {col:.3e} relative")
    assert gap <= FRAC_TOL_CYCLES
    assert col <= COLUMN_TOL


def _counts():
    return pc.PhaseChain.launches, pc.PhaseChainTangent.launches


def test_wrapper_jacfwd_one_tangent_launch(on_host, case):
    """A jacfwd over every free parameter is one primal and one tangent
    launch, bit-equal to the unfused host chain's jacfwd."""
    calc, b = case["calc"], case["b"]
    before = _counts()
    J = torch.func.jacfwd(lambda x: pc.fused(calc, _at(case, x), b,
                                             "nearest"))(case["x0"])
    assert _counts() == (before[0] + 1, before[1] + 1)
    Ju = torch.func.jacfwd(lambda x: pc.unfused(
        calc, _at(case, x), b, "nearest", delay=host_delay(calc)))(
            case["x0"])
    assert torch.equal(J, Ju)


def test_wrapper_vmap_grid_one_tangent_launch(on_host, case):
    """vmap over 9 grid points of a jacfwd: still one primal and one
    tangent launch (9 θ sets, each with its lanes), every point's columns
    bit-equal to the unfused host chain's."""
    calc, b, X = case["calc"], case["b"], case["X"]

    def fused(x):
        return pc.fused(calc, _at(case, x), b, "nearest")

    before = _counts()
    J = torch.func.vmap(torch.func.jacfwd(fused))(X)
    assert _counts() == (before[0] + 1, before[1] + 1)
    assert J.shape == (GRID_POINTS, b.ntoas, len(case["names"]))
    for g in (0, GRID_POINTS - 1):
        Ju = torch.func.jacfwd(lambda x: pc.unfused(
            calc, _at(case, x), b, "nearest", delay=host_delay(calc)))(X[g])
        assert torch.equal(J[g], Ju)


@pytest.mark.parametrize("case", BASE, indirect=True)
def test_unbatched_other_is_shared(on_host, case):
    """A vmap over θ sets with ``other`` and its tangent unbatched (the
    grid's first step, where only M2/SINI vary): every θ set reads the
    one row of each through a stride of 0, with the values of the same
    rows broadcast and copied."""
    ins = [_inputs(case, x, "nearest") for x in case["X"][:3]]
    spec, _, other, tensors = ins[0]
    thetas = torch.stack([t for _, t, _, _ in ins])
    G, N = thetas.shape[0], other.shape[0]
    rng = np.random.default_rng(5)
    dth = torch.from_numpy(rng.standard_normal(spec.P))
    dot = torch.from_numpy(rng.standard_normal(N))

    def f(t, o):
        return pc.PhaseChain.apply(t, o, spec, *tensors)[0]

    out = torch.func.vmap(f, in_dims=(0, None))(thetas, other)
    tan = torch.func.vmap(lambda t: torch.func.jvp(
        f, (t, other), (dth, dot))[1])(thetas)
    want = pc.run(spec, thetas, other.expand(G, N), tensors)[0]
    assert torch.equal(out, want)
    assert torch.equal(tan, pc.run(
        spec, thetas, other.expand(G, N), tensors, dth.expand(G, 1, spec.P),
        dot.expand(G, 1, N))[:, 0])


@pytest.mark.parametrize("case", BASE, indirect=True)
def test_words_mode_has_no_tangent(on_host, case):
    """The words mode (the TZR phase) is a primal only."""
    spec, theta, other, tensors = _inputs(case, case["x0"], "words")
    with pytest.raises(NotImplementedError):
        torch.func.jacfwd(lambda t: pc.PhaseChain.apply(
            t, other, spec, *tensors)[0])(theta)


@pytest.fixture(scope="module")
def j0740_pair():
    """pint_tpu's and the port's split assemblies on the J0740 set at x
    offsets drawn from a seed: each parameter moved so that its column
    moves the model by ~0.1 ns at most."""
    import jax.numpy as jnp

    from pint_tpu.fitter import WLSFitter as JWLSFitter
    from pint_tpu.fitter import build_whitened_assembly as j_assembly
    from pint_tpu_torch.fitter import WLSFitter as TWLSFitter

    jm, jt = data.load_jax(data.REF_TIM)
    tm, tt = data.load_torch(data.REF_TIM)
    jf, tf = JWLSFitter(jt, jm), TWLSFitter(tt, tm, device="cpu")
    assert jf.fit_params == tf.fit_params
    asm = j_assembly(jm, jf.resids.batch, jf.fit_params, jf.track_mode,
                     include_offset=True, design_matrix="split")
    P = len(jf.fit_params)
    M0 = np.asarray(asm.inline(jnp.zeros(P), jf.resids.pdict)[1])[:, :P]
    rng = np.random.default_rng(20261019)
    x = 1e-10 * rng.standard_normal(P) / np.max(np.abs(M0), axis=0)
    r, M, _ = (np.asarray(v) for v in asm.inline(jnp.asarray(x),
                                                  jf.resids.pdict)[:3])
    return tf, x, r, M


def test_residuals_and_columns_vs_pint_tpu(on_host, j0740_pair):
    """The port's residuals [s] and design matrix through the host build
    of the fused launches against pint_tpu's."""
    from pint_tpu_torch.fitter import build_whitened_assembly

    tf, x, r_ref, M_ref = j0740_pair
    asm = build_whitened_assembly(tf.model, tf.resids.batch, tf.fit_params,
                                  tf.track_mode, include_offset=True,
                                  design_matrix="split")
    before = _counts()
    r, M, _, _ = asm.inline(torch.from_numpy(x), tf.resids.pdict)
    assert _counts()[0] > before[0] and _counts()[1] > before[1]
    r_gap = float(np.max(np.abs(r.numpy() - r_ref)))
    col = _column_gap(M, torch.from_numpy(M_ref))
    print(f"J0740 through the host build vs pint_tpu: residuals "
          f"{r_gap:.3e} s (bar {RESID_TOL_S}), columns {col:.3e} relative "
          f"(bar {COLUMN_TOL})")
    assert r_gap <= RESID_TOL_S
    assert col <= COLUMN_TOL
