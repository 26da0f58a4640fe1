"""pint_tpu_torch's extended-precision layer and phase kernel vs pint_tpu.

* ``dd``/``qs`` words: bit-identical to :mod:`pint_tpu.dd`/:mod:`pint_tpu.qs`
  (eager JAX on the CPU) on the same seeded numpy inputs, and within the
  ``2**-85`` mpmath bar of ``tests/test_qs.py`` on its fuzz cases.
* ``phase_frac_plain`` (the plain version of the ``qs_phase_frac``
  kernel): fraction bit-identical to the JAX spin phase + TZR + rounding
  chain; its autodiff through the words bit-identical to ``jax.jvp``.
* ``QSPhaseFrac`` (plain forward on the CPU, analytic tangent rule): the
  tangent equals its rule, pint_tpu's (the secant spin frequency on
  d shift, ROADMAP.md queue C), to 1e-13 and ``jax.jacfwd`` of pint_tpu's
  chain to 1e-12; its vmap rule matches the unbatched call.

The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import mpmath
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pint_tpu import dd as jdd
from pint_tpu import qs as jqs
from pint_tpu.toabatch import split_f64_words
from pint_tpu.utils import taylor_horner as j_taylor_horner
from pint_tpu_torch import dd as tdd
from pint_tpu_torch import qs as tqs
from pint_tpu_torch.kernels.qs_phase import (PhaseSpec, QSPhaseFrac,
                                             qs_phase_frac)
from pint_tpu_torch.models.spindown import phase_frac_plain

mpmath.mp.dps = 60
RNG_SEED = 20261016
F0, F1 = 346.53199992, -1.46e-15


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _same(jax_words, torch_words):
    """Every word bit-identical (nested tuples of words allowed)."""
    assert len(jax_words) == len(torch_words)
    for a, b in zip(jax_words, torch_words):
        if isinstance(b, tuple):
            _same(a, b)
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


@pytest.fixture
def flush_denormal():
    """XLA:CPU flushes float32 subnormals to zero; torch on the CPU keeps
    them (IEEE gradual underflow), as does the CUDA kernel (built without
    -ftz).  Subnormal words are outside the QS magnitude contract, but the
    random lower words of the bit comparisons below reach them in a few
    products, so those comparisons run torch flushing as XLA does.

    The mode is the calling thread's, and a thread inherits it from the
    thread that starts it: torch's intra-op threads are started first (a
    reduction wide enough to reach every one), so that none of them
    flushes for the rest of the process."""
    torch.ones(torch.get_num_threads() * (1 << 16),
               dtype=torch.float64).sum()
    prev = torch.set_flush_denormal(True)
    assert prev is not None
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _mags(rng, n, lo, hi):
    """Signed magnitudes 10^[lo, hi) with some exact zeros."""
    v = rng.choice([-1.0, 1.0], n) * rng.uniform(1, 10, n) \
        * 10.0 ** rng.integers(lo, hi, n)
    v[::17] = 0.0
    return v


# -- dd ------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dd_transforms_bit_identical(dtype, flush_denormal):
    """two_sum/quick_two_sum/split/two_prod and the DD ops: same bits."""
    rng = np.random.default_rng(RNG_SEED)
    a = _mags(rng, 4000, -6, 6).astype(dtype)
    b = _mags(rng, 4000, -6, 6).astype(dtype)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("two_sum", "two_prod"):
        _same(getattr(jdd, name)(ja, jb), getattr(tdd, name)(ta, tb))
    big, small = np.maximum(abs(a), abs(b)) * np.sign(a), np.minimum(
        abs(a), abs(b))
    _same(jdd.quick_two_sum(jnp.asarray(big), jnp.asarray(small)),
          tdd.quick_two_sum(torch.from_numpy(big), torch.from_numpy(small)))
    _same(jdd.split(ja), tdd.split(ta))
    jx, jy = jdd.from_two(ja, jb * 1e-9), jdd.from_two(jb, ja * 1e-9)
    tx, ty = tdd.from_two(ta, tb * 1e-9), tdd.from_two(tb, ta * 1e-9)
    for name in ("add", "sub", "mul"):
        _same(getattr(jdd, name)(jx, jy), getattr(tdd, name)(tx, ty))
    nz = b != 0
    _same(jdd.div(jdd.DD(jx.hi[nz], jx.lo[nz]), jdd.DD(jy.hi[nz], jy.lo[nz])),
          tdd.div(tdd.DD(tx.hi[nz], tx.lo[nz]), tdd.DD(ty.hi[nz], ty.lo[nz])))
    _same(jdd.add_f(jx, jb), tdd.add_f(tx, tb))
    _same(jdd.mul_f(jx, jb), tdd.mul_f(tx, tb))
    _same(jdd.round_nearest(jx), tdd.round_nearest(tx))
    _same(jdd.floor(jx), tdd.floor(tx))
    if dtype == np.float64:
        # (on f32 words pint_tpu's horner promotes to f64: its 1/k! factor
        # is a Python float, split with the f64 Dekker constant)
        coeffs_j = [jb, ja, jb * 1e-3]
        coeffs_t = [tb, ta, tb * 1e-3]
        small_j = jdd.from_two(ja * 1e-6, jb * 1e-15)
        small_t = tdd.from_two(ta * 1e-6, tb * 1e-15)
        _same(jdd.horner(small_j, coeffs_j), tdd.horner(small_t, coeffs_t))
    # the reductions sum in another order than XLA's: equal to rounding
    w = np.abs(b) + 1.0
    for jm, tm in ((jdd.weighted_mean(jx, jnp.asarray(w)),
                    tdd.weighted_mean(tx, torch.from_numpy(w))),
                   (jdd.mean(jx), tdd.mean(tx))):
        jv = float(jm.hi) + float(jm.lo)
        tv = float(tm.hi) + float(tm.lo)
        assert abs(jv - tv) <= 8 * np.finfo(dtype).eps * np.sum(
            np.abs(a)) / len(a)


def test_dd_host_numpy_matches():
    """The numpy (host) path the carried mjd.py uses: identical results."""
    rng = np.random.default_rng(RNG_SEED + 1)
    x = jdd.DD(rng.uniform(5e4, 6e4, 100), rng.uniform(-1e-12, 1e-12, 100))
    f = rng.uniform(-1, 1, 100)
    a, b = jdd.add_f(x, f), tdd.add_f(tdd.DD(*x), f)
    np.testing.assert_array_equal(a.hi, b.hi)
    np.testing.assert_array_equal(a.lo, b.lo)
    assert tdd.self_check()


# -- qs ------------------------------------------------------------------------
def _qs_pair(rng, n, lo, hi):
    v = _mags(rng, n, lo, hi)
    tail = v * rng.uniform(-1, 1, n) * 2.0 ** -30
    return v, tail


def test_qs_ops_bit_identical(flush_denormal):
    """add/add_w/sub/mul/mul_w/from_f64_device/to_f64/to_dd/horner_taylor/
    round_nearest: every word bit-identical to pint_tpu.qs."""
    rng = np.random.default_rng(RNG_SEED + 2)
    n = 3000
    a_hi, a_lo = _qs_pair(rng, n, -9, 12)
    b_hi, b_lo = _qs_pair(rng, n, -9, 9)
    jA = jqs.add(jqs.from_f64_device(jnp.asarray(a_hi)),
                 jqs.from_f64_device(jnp.asarray(a_lo)))
    tA = tqs.add(tqs.from_f64_device(torch.from_numpy(a_hi)),
                 tqs.from_f64_device(torch.from_numpy(a_lo)))
    _same(jA, tA)
    jB = jqs.from_dd_host(b_hi, b_lo)
    tB = tqs.QS(*[torch.from_numpy(np.asarray(w)) for w in
                  tqs.from_dd_host(b_hi, b_lo).words])
    _same(jB, tB)
    _same(jqs.add(jA, jB), tqs.add(tA, tB))
    _same(jqs.sub(jA, jB), tqs.sub(tA, tB))
    _same(jqs.mul(jA, jB), tqs.mul(tA, tB))
    w = rng.uniform(-1e3, 1e3, n).astype(np.float32)
    _same(jqs.add_w(jA, jnp.asarray(w)), tqs.add_w(tA, torch.from_numpy(w)))
    _same(jqs.mul_w(jA, jnp.asarray(w)), tqs.mul_w(tA, torch.from_numpy(w)))
    np.testing.assert_array_equal(np.asarray(jqs.to_f64(jA)),
                                  tqs.to_f64(tA).numpy())
    _same(jqs.to_dd(jA), tqs.to_dd(tA))
    _same(jqs.from_dd_device(jqs.to_dd(jA)),
          tqs.from_dd_device(tqs.to_dd(tA)))
    _same(jqs.from_words(jA.w0, jA.w1), tqs.from_words(tA.w0, tA.w1))
    dt_j = jqs.from_f64_device(jnp.asarray(rng.uniform(-2e8, 2e8, n)))
    dt_t = tqs.QS(*[torch.from_numpy(np.asarray(x)) for x in dt_j.words])
    cj = [jqs.zeros_like(dt_j.w0)] + [
        jqs.QS(*[jnp.broadcast_to(x, (n,)) for x in jqs.from_f64_host(f).words])
        for f in (F0, F1, 3e-27)]
    ct = [tqs.QS(*[torch.from_numpy(np.asarray(x)) for x in c.words])
          for c in cj]
    ph_j, ph_t = jqs.horner_taylor(dt_j, cj), tqs.horner_taylor(dt_t, ct)
    _same(ph_j, ph_t)
    n_j, fr_j = jqs.round_nearest(ph_j)
    n_t, fr_t = tqs.round_nearest(ph_t)
    np.testing.assert_array_equal(np.asarray(n_j), n_t.numpy())
    _same(fr_j, fr_t)


def _as_mp(q):
    return sum(mpmath.mpf(float(w)) for w in q.words)


@pytest.mark.parametrize("case", ["add", "mul"])
def test_qs_accuracy_mpmath(case):
    """The fuzz cases of tests/test_qs.py (add: magnitudes 1e-12..1e12;
    mul: 1e-9..1e9 x 1e-6..1e3) on the port, at its 2**-85 bar."""
    rng = np.random.default_rng(RNG_SEED + 3)
    lo_b, hi_b = (-12, 13) if case == "add" else (-6, 4)
    lo_a, hi_a = (-12, 13) if case == "add" else (-9, 10)
    a, b = _mags(rng, 150, lo_a, hi_a), _mags(rng, 150, lo_b, hi_b)
    qa = tqs.QS(*[torch.from_numpy(np.asarray(w))
                  for w in tqs.from_f64_host(a).words])
    qb = tqs.QS(*[torch.from_numpy(np.asarray(w))
                  for w in tqs.from_f64_host(b).words])
    got = (tqs.add if case == "add" else tqs.mul)(qa, qb)
    worst = 0.0
    for i in range(len(a)):
        want = mpmath.mpf(a[i]) + mpmath.mpf(b[i]) if case == "add" \
            else mpmath.mpf(a[i]) * mpmath.mpf(b[i])
        g = sum(mpmath.mpf(float(w[i])) for w in got.words)
        floor = 1.0 if case == "add" else 1e-20
        err = abs(g - want) / max(floor, abs(want))
        worst = max(worst, float(err))
    print(f"qs {case}: worst relative error {worst:.3e} (bar 2**-85 = "
          f"{2.0 ** -85:.3e})")
    assert worst <= 2.0 ** -85


def test_qs_spindown_and_round_mpmath():
    """Spindown-scale phase (F0 dt + F1 dt^2/2 over +-2e8 s) within
    1e-12 cycles of a 60-digit oracle, and exact nearest pulse numbers."""
    rng = np.random.default_rng(RNG_SEED + 4)
    dts = rng.uniform(-2e8, 2e8, 64)
    dt = tqs.QS(*[torch.from_numpy(np.asarray(w))
                  for w in tqs.from_f64_host(dts).words])
    co = [tqs.zeros_like(dt.w0)] + [
        tqs.QS(*[torch.broadcast_to(torch.from_numpy(np.asarray(w)), (64,))
                 for w in tqs.from_f64_host(f).words]) for f in (F0, F1)]
    ph = tqs.horner_taylor(dt, co)
    n, frac = tqs.round_nearest(ph)
    worst = 0.0
    for i in range(64):
        t = mpmath.mpf(float(dts[i]))
        want = mpmath.mpf(F0) * t + mpmath.mpf(F1) * t ** 2 / 2
        worst = max(worst, float(abs(_as_mp(tqs.QS(*[w[i] for w in
                                                     ph.words])) - want)))
        assert float(n[i]) == float(mpmath.nint(want))
        got_frac = sum(mpmath.mpf(float(w[i])) for w in frac.words)
        assert abs(got_frac - (want - mpmath.nint(want))) < 1e-12
    print(f"spindown phase: worst abs error {worst:.3e} cycles (bar 1e-12)")
    assert worst < 1e-12


# -- the phase kernel's plain version and its tangent rule ------------------------
N_ROWS, G_PTS = 400, 3


@pytest.fixture(scope="module")
def phase_inputs():
    """Seeded kernel inputs at J0740 scale: TDB epochs over 4550 days,
    row shifts (delays) of +-500 s at G grid points, spin offsets,
    other-phase rows, TZR words."""
    rng = np.random.default_rng(RNG_SEED + 5)
    day = rng.integers(52700, 57251, N_ROWS)
    frac = rng.uniform(-0.5, 0.5, N_ROWS)
    pep = jqs.from_f64_host(np.float64(0.0))
    f_w = np.stack([np.stack([np.float32(w) for w in
                              jqs.from_f64_host(np.float64(f)).words])
                    for f in (F0, F1)])
    return dict(
        day=day, frac_w=split_f64_words(frac), pep_day=55000.0,
        pep_w=np.stack([np.float32(w) for w in pep.words]), f_w=f_w,
        shift=rng.uniform(-500, 500, (G_PTS, N_ROWS)),
        dF=rng.standard_normal((G_PTS, 2)) * np.array([1e-10, 1e-20]),
        other=rng.uniform(-1e-2, 1e-2, (G_PTS, N_ROWS)),
        tzr_w=np.array([1.2345e6, 0.03125, 1e-9, 0.0], np.float32),
        t_shift=rng.standard_normal((G_PTS, N_ROWS)),
        t_dF=rng.standard_normal((G_PTS, 2)) * np.array([1e-10, 1e-20]),
        t_other=rng.standard_normal((G_PTS, N_ROWS)))


def _jax_frac(d, g, shift, dF, other):
    """pint_tpu's chain for grid point g: dt_seconds_qs + Spindown.phase +
    PhaseCalc.phase (zeros + spin + from_f64(other) - TZR) +
    raw_phase_resids "nearest"."""
    n = d["day"].shape[0]
    z = jnp.zeros(n, jnp.float32)
    dday = (jnp.asarray(d["day"]).astype(jnp.float64)
            - d["pep_day"]).astype(jnp.float32)
    w = jnp.asarray(d["frac_w"])
    dt = jqs.QS(dday, w[:, 0], w[:, 1], z)
    dt = jqs.add(dt, jqs.QS(w[:, 2], z, z, z))
    dt = jqs.sub(dt, jqs.QS(*[jnp.broadcast_to(x, (n,)) for x in d["pep_w"]]))
    dt = jqs.mul_w(dt, jnp.float32(86400.0))
    dt = jqs.add(dt, jqs.from_f64_device(shift))
    dt64 = jqs.to_f64(dt)
    co = [jqs.zeros_like(z)] + [jqs.QS(*[jnp.broadcast_to(x, (n,)) for x in fw])
                                for fw in d["f_w"]]
    ph = jqs.horner_taylor(dt, co)
    dph = j_taylor_horner(dt64, [jnp.float64(0.0), dF[0], dF[1]])
    spin = jqs.add(ph, jqs.from_f64_device(dph))
    total = jqs.add(jqs.zeros_like(z), spin)
    total = jqs.add(total, jqs.from_f64_device(other))
    total = jqs.sub(total, jqs.QS(*[jnp.broadcast_to(x, (n,))
                                    for x in d["tzr_w"]]))
    _, frac = jqs.round_nearest(total)
    return jqs.to_f64(frac), dt64


def _spec(d, mode="nearest"):
    t = torch.from_numpy
    return PhaseSpec(t(d["day"]), t(d["frac_w"]),
                     torch.tensor(d["pep_day"], dtype=torch.float64),
                     t(d["pep_w"]), t(d["f_w"]), t(d["tzr_w"]), None, mode)


def test_phase_frac_plain_bit_identical(phase_inputs):
    """The plain version's fraction vs pint_tpu's chain, every grid point:
    bit-identical (bar: equal bits; the issue's fallback bar is 1e-12)."""
    d = phase_inputs
    s = _spec(d)
    out, _, dt64 = phase_frac_plain(
        s.tdb_day, s.frac_w, s.pep_day, s.pep_w, s.f_w,
        torch.from_numpy(d["shift"]), torch.from_numpy(d["dF"]),
        torch.from_numpy(d["other"]), s.tzr_w)
    worst = 0.0
    for g in range(G_PTS):
        jf, jdt = _jax_frac(d, g, jnp.asarray(d["shift"][g]),
                            jnp.asarray(d["dF"][g]),
                            jnp.asarray(d["other"][g]))
        worst = max(worst, float(np.max(np.abs(np.asarray(jf)
                                               - out[g].numpy()))))
        np.testing.assert_array_equal(np.asarray(jf), out[g].numpy())
        np.testing.assert_array_equal(np.asarray(jdt), dt64[g].numpy())
    print(f"phase_frac_plain vs pint_tpu: max |dfrac| = {worst:.3e} cycles")


def test_word_autodiff_bit_identical(phase_inputs):
    """torch.func.jvp through the plain version's words reproduces
    jax.jvp through pint_tpu's words (max relative gap printed; bar
    1e-15)."""
    d = phase_inputs
    s = _spec(d)
    g = 1

    def t_fn(sh, dF, ot):
        return phase_frac_plain(s.tdb_day, s.frac_w, s.pep_day, s.pep_w,
                                s.f_w, sh, dF, ot, s.tzr_w)[0]

    prim = [torch.from_numpy(d[k][g]) for k in ("shift", "dF", "other")]
    tang = [torch.from_numpy(d["t_" + k][g]) for k in ("shift", "dF",
                                                        "other")]
    _, t_tan = torch.func.jvp(t_fn, tuple(prim), tuple(tang))
    _, j_tan = jax.jvp(lambda a, b, c: _jax_frac(d, g, a, b, c)[0],
                       tuple(jnp.asarray(p.numpy()) for p in prim),
                       tuple(jnp.asarray(t.numpy()) for t in tang))
    rel = np.max(np.abs(np.asarray(j_tan) - t_tan.numpy())
                 / np.abs(np.asarray(j_tan)))
    print(f"word-level tangents torch vs jax: max relative gap {rel:.3e}")
    assert rel <= 1e-15


def test_tangent_rule_exact_and_vs_jacfwd(phase_inputs):
    """QSPhaseFrac's analytic tangent (plain forward on the CPU) vs its
    rule, pint_tpu's tangent (S(dt) + δF0 + δF1·dt)·dshift +
    Σ dt^{k+1}/(k+1)!·ddF_k + dother with the secant frequency
    S(dt) = F0 + F1·dt/2 (bar 1e-13 relative); vs jax.jacfwd of
    pint_tpu's chain, which that rule reproduces (bar 1e-12); and vs the
    exact derivative, from which it differs by the secant's F1·dt/2 term
    only."""
    d = phase_inputs
    s = _spec(d)
    prim = tuple(torch.from_numpy(d[k]) for k in ("shift", "dF", "other"))
    tang = tuple(torch.from_numpy(d["t_" + k]) for k in ("shift", "dF",
                                                         "other"))
    _, k_tan = torch.func.jvp(lambda a, b, c: QSPhaseFrac.call(s, a, b, c)[0],
                              prim, tang)
    _, _, dt64 = phase_frac_plain(s.tdb_day, s.frac_w, s.pep_day,
                                     s.pep_w, s.f_w, *prim, s.tzr_w)
    dt, ts, tdF, to = (dt64.numpy(), d["t_shift"], d["t_dF"], d["t_other"])
    Fk = d["f_w"].astype(np.float64).sum(axis=1)
    rest = dt * tdF[:, :1] + dt * dt / 2 * tdF[:, 1:] + to
    secant = Fk[0] + Fk[1] * dt / 2 + d["dF"][:, :1] + d["dF"][:, 1:] * dt
    rule = secant * ts + rest
    exact = ((Fk[0] + d["dF"][:, :1]) + (Fk[1] + d["dF"][:, 1:]) * dt) * ts \
        + rest
    rel_rule = np.max(np.abs(k_tan.numpy() - rule) / np.abs(rule))
    j_tan = []
    for g in range(G_PTS):
        _, jt = jax.jvp(lambda a, b, c: _jax_frac(d, g, a, b, c)[0],
                        tuple(jnp.asarray(d[k][g]) for k in
                              ("shift", "dF", "other")),
                        tuple(jnp.asarray(d["t_" + k][g]) for k in
                              ("shift", "dF", "other")))
        j_tan.append(np.asarray(jt))
    j_tan = np.stack(j_tan)
    rel_jax = np.max(np.abs(k_tan.numpy() - j_tan) / np.abs(rule))
    half = np.abs(Fk[1] * dt / 2 * ts)
    print(f"tangent rule: {rel_rule:.3e} (bar 1e-13); vs jax.jacfwd: "
          f"{rel_jax:.3e} (bar 1e-12); vs the exact derivative up to "
          f"{np.max(np.abs(k_tan.numpy() - exact) / np.abs(exact)):.3e}, "
          f"the secant's F1*dt/2 term")
    assert rel_rule <= 1e-13
    assert rel_jax <= 1e-12
    assert np.all(np.abs(k_tan.numpy() - exact)
                  <= half + 1e-13 * np.abs(exact))


def test_function_vmap_and_jacfwd_plumbing(phase_inputs):
    """The Function's vmap rule folds a batched grid axis into one call
    (same outputs as the (G, N) call), and jacfwd through it under vmap
    gives the analytic columns (the design-matrix plumbing)."""
    d = phase_inputs
    s = _spec(d)
    sh, dF, ot = (torch.from_numpy(d[k]) for k in ("shift", "dF", "other"))
    direct = QSPhaseFrac.call(s, sh, dF, ot)[0]
    mapped = torch.func.vmap(lambda a, b, c: QSPhaseFrac.call(s, a, b, c)[0])(
        sh, dF, ot)
    assert torch.equal(direct, mapped)
    # d frac / d (dF0, dF1) per grid point = (dt, dt^2/2)
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda b, a, c: QSPhaseFrac.call(s, a, b, c)[0]))(dF, sh, ot)
    dt64 = phase_frac_plain(s.tdb_day, s.frac_w, s.pep_day, s.pep_w, s.f_w,
                            sh, dF, ot, s.tzr_w)[2]
    assert torch.equal(jac[..., 0], dt64)
    torch.testing.assert_close(jac[..., 1], dt64 * dt64 / 2.0, rtol=1e-15,
                               atol=0.0)
    words = qs_phase_frac(s.tdb_day, s.frac_w, s.pep_day, s.pep_w, s.f_w,
                          sh, dF, ot, tzr_w=s.tzr_w, mode="words")
    assert words.shape == (G_PTS, N_ROWS, 4) and words.dtype == torch.float32
