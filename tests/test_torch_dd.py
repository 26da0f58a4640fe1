"""pint_tpu_torch's DD slice vs pint_tpu: the Kepler solve, the BT/DD
delays, residuals, design matrix and the TOA simulator.

With the port on the CPU (the ``kepler_E`` kernel's plain version runs
inside its ``KeplerE`` wrapper) and JAX on the CPU as the reference:

* ``kepler_E``: the port's plain solve within 1e-13 rad of
  :func:`pint_tpu.models.binary_orbits.kepler_E` at e in {0, 1e-5, 0.1,
  0.5, 0.9}; the wrapper's implicit-function tangent and gradient in M
  and e within 1e-12 relative of pint_tpu's custom JVP; ``KeplerE``
  under ``torch.func.jacfwd`` and ``vmap`` equal to autodiff through the
  plain iteration;
* the BT and DD delays on the committed 200-TOA DD set within 1e-12 s,
  the full-pipeline residuals within 1 ns, the design-matrix columns
  within 1e-10 relative (split and full assembly);
* ``make_fake_toas_uniform``: the same seed gives TOAs within 1 ns.
"""

import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.fitter import build_whitened_assembly as j_assembly
from pint_tpu.models.binary_orbits import kepler_E as j_kepler
from pint_tpu.models.binary_orbits import true_anomaly_continuous as j_nu
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.fitter import build_whitened_assembly as t_assembly
from pint_tpu_torch.kernels.kepler import KeplerE, kepler_E_op
from pint_tpu_torch.models.binary_orbits import kepler_E as t_kepler
from pint_tpu_torch.models.binary_orbits import \
    true_anomaly_continuous as t_nu
from pint_tpu_torch.residuals import Residuals as TResiduals

E_TOL_RAD = 1e-13
TANGENT_TOL = 1e-12
DELAY_TOL_S = 1e-12
RESID_TOL_S = 1e-9
COL_TOL = 1e-10
TOA_TOL_S = 1e-9
ECCS = [0.0, 1e-5, 0.1, 0.5, 0.9]
F64 = torch.float64


def _M(n=257, seed=20261017):
    return np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi, n)


@pytest.mark.parametrize("e", ECCS)
def test_kepler_E_matches_jax(e):
    import jax.numpy as jnp

    M = _M()
    want = np.asarray(j_kepler(jnp.asarray(M), e))
    got = t_kepler(torch.from_numpy(M), torch.tensor(e, dtype=F64)).numpy()
    wrapped = kepler_E_op(torch.from_numpy(M), e).numpy()
    err = float(np.max(np.abs(got - want)))
    print(f"e={e}: max |E_port - E_jax| = {err:.3e} rad (bar {E_TOL_RAD})")
    assert err <= E_TOL_RAD
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("e", ECCS)
def test_kepler_E_tangent_matches_jax(e):
    """The wrapper's jvp in (M, e) against pint_tpu's custom JVP."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    M, dM = _M(), rng.standard_normal(257)
    de = rng.standard_normal(257) * 1e-2
    ev = np.full(257, e)
    _, jt = jax.jvp(j_kepler, (jnp.asarray(M), jnp.asarray(ev)),
                    (jnp.asarray(dM), jnp.asarray(de)))
    t = torch.from_numpy
    _, tt = torch.func.jvp(kepler_E_op, (t(M), t(ev)), (t(dM), t(de)))
    jt = np.asarray(jt)
    rel = float(np.max(np.abs(tt.numpy() - jt) / np.abs(jt)))
    print(f"e={e}: jvp max relative gap {rel:.3e} (bar {TANGENT_TOL})")
    assert rel <= TANGENT_TOL


def test_kepler_E_grad_matches_jax():
    """Reverse mode: d sum(E) / d(M, e), as jax.grad of pint_tpu's."""
    import jax
    import jax.numpy as jnp

    M = _M(64)
    for e in ECCS[1:]:
        jg = jax.grad(lambda m, ee: jnp.sum(j_kepler(m, ee)),
                      argnums=(0, 1))(jnp.asarray(M), e)
        Mt = torch.from_numpy(M).requires_grad_()
        et = torch.tensor(e, dtype=F64, requires_grad=True)
        kepler_E_op(Mt, et).sum().backward()
        relM = float(np.max(np.abs(Mt.grad.numpy() - np.asarray(jg[0]))
                            / np.abs(np.asarray(jg[0]))))
        rele = abs(float(et.grad) - float(jg[1])) / abs(float(jg[1]))
        print(f"e={e}: grad gaps M {relM:.3e}, e {rele:.3e}")
        assert relM <= TANGENT_TOL and rele <= TANGENT_TOL


def test_kepler_E_under_jacfwd_and_vmap():
    """KeplerE through torch.func.vmap(jacfwd) equals autodiff through
    the plain Newton iteration, and a vmapped batch is one forward."""
    M = torch.from_numpy(_M(100))

    def f(kep):
        return lambda x: kep(M * x[0], x[1] + 0.0 * M)

    xs = torch.tensor([[1.0, 0.3], [1.05, 0.6], [0.97, 0.9]], dtype=F64)
    calls = []
    from pint_tpu_torch.kernels import kepler as kk

    real = kk.run
    kk.run = lambda a, b: (calls.append(tuple(a.shape)), real(a, b))[1]
    try:
        J = torch.func.vmap(torch.func.jacfwd(f(kepler_E_op)))(xs)
    finally:
        kk.run = real
    Jp = torch.func.vmap(torch.func.jacfwd(f(t_kepler)))(xs)
    rel = float(torch.max(torch.abs(J - Jp) / torch.abs(Jp)))
    print(f"vmap(jacfwd): max relative gap {rel:.3e}; forwards {calls}")
    assert rel <= TANGENT_TOL
    assert calls == [(3, 100)]
    assert KeplerE.launches == 0     # plain CPU runs are not launches


def test_kepler_E_refuses_wrapped_tensors():
    from pint_tpu_torch.kernels.kepler import kepler_E_op, run

    M = torch.from_numpy(_M(8))
    with pytest.raises(TypeError, match="wrapped"):
        torch.func.vmap(lambda m: run(m, torch.tensor(0.1, dtype=F64)))(
            M[None])
    with pytest.raises(ValueError, match="float64"):
        kepler_E_op(M.float(), 0.1)


def test_true_anomaly_matches_jax():
    import jax.numpy as jnp

    orbits = np.linspace(0.0, 3.0, 301)
    M = 2 * np.pi * (orbits - np.floor(orbits))
    E = np.asarray(j_kepler(jnp.asarray(M), 0.3))
    want = np.asarray(j_nu(jnp.asarray(E), 0.3, jnp.asarray(orbits),
                           jnp.asarray(M)))
    got = t_nu(*(torch.from_numpy(a) for a in (E, np.full(301, 0.3),
                                                orbits, M))).numpy()
    assert float(np.max(np.abs(got - want))) <= 1e-13


@pytest.fixture(scope="module")
def dd_pair():
    """pint_tpu and port (model, toas, residuals) on the committed DD set
    at the simulated truth, and the BT variant of the same par."""
    jm, jt = data.load_jax(data.DD_REF_TIM, par=data.dd_par_lines())
    tm, tt = data.load_torch(data.DD_REF_TIM, par=data.dd_par_lines())
    return dict(jm=jm, jt=jt, tm=tm, tt=tt, jr=JResiduals(jt, jm),
                tr=TResiduals(tt, tm, device="cpu"))


def _bt_par():
    keep = ("M2 ", "SINI ", "OMDOT ")
    return [ln.replace("BINARY DD", "BINARY BT") for ln in
            data.dd_par_lines() if not ln.startswith(keep)]


@pytest.mark.parametrize("binary", ["BinaryDD", "BinaryBT"])
def test_binary_delay_matches_jax(dd_pair, binary):
    import jax.numpy as jnp

    if binary == "BinaryDD":
        jm, jr, tm, tr = (dd_pair[k] for k in ("jm", "jr", "tm", "tr"))
    else:
        jm, jt = data.load_jax(data.DD_REF_TIM, par=_bt_par())
        tm, tt = data.load_torch(data.DD_REF_TIM, par=_bt_par())
        jr, tr = JResiduals(jt, jm), TResiduals(tt, tm, device="cpu")
    n = jr.batch.ntoas
    # a nonzero accumulated delay, as the chain hands the binary one
    delay = np.random.default_rng(3).uniform(-500.0, 500.0, n)
    want = np.asarray(jm.components[binary].delay(
        jr.pdict, jr.batch, jnp.asarray(delay)))
    got = tm.components[binary].delay(tr.pdict, tr.batch,
                                      torch.from_numpy(delay)).numpy()
    gap = float(np.max(np.abs(got - want)))
    print(f"{binary}: max delay gap {gap:.3e} s (bar {DELAY_TOL_S}); "
          f"delay amplitude {np.max(np.abs(want)):.3f} s")
    assert gap <= DELAY_TOL_S


def test_dd_residuals_match_jax(dd_pair):
    jr, tr = dd_pair["jr"], dd_pair["tr"]
    gap = float(np.max(np.abs(tr.time_resids - jr.time_resids)))
    print(f"DD residuals: max gap {gap:.3e} s (bar {RESID_TOL_S}); rms "
          f"{np.std(jr.time_resids) * 1e6:.4f} us")
    assert gap <= RESID_TOL_S


@pytest.fixture(scope="module")
def dd_jax_design(dd_pair):
    import jax.numpy as jnp

    jm, jr = dd_pair["jm"], dd_pair["jr"]
    names = jm.free_params
    asm = j_assembly(jm, jr.batch, names, jr.track_mode,
                     include_offset=True, design_matrix="split")
    return names, np.asarray(asm.inline(jnp.zeros(len(names)),
                                        jr.pdict)[1])


@pytest.mark.parametrize("mode", ["split", "full"])
def test_dd_design_matrix_matches_jax(dd_pair, dd_jax_design, mode):
    names, jM = dd_jax_design
    tm, tr = dd_pair["tm"], dd_pair["tr"]
    assert tm.free_params == names
    asm = t_assembly(tm, tr.batch, names, tr.track_mode,
                     include_offset=True, design_matrix=mode)
    tM = asm.inline(torch.zeros(len(names), dtype=F64), tr.pdict)[1].numpy()
    scale = np.maximum(np.max(np.abs(jM), axis=0), 1e-300)
    per_col = np.max(np.abs(tM - jM), axis=0) / scale
    worst = int(np.argmax(per_col))
    label = (names + ["Offset"])[worst]
    print(f"{mode}: {tM.shape[1]} columns, max relative gap "
          f"{per_col[worst]:.3e} ({label}; bar {COL_TOL})")
    assert per_col[worst] <= COL_TOL


def test_make_fake_toas_uniform_matches_jax(tmp_path):
    """The port's simulator against pint_tpu's, same seed and inputs."""
    from pint_tpu.models import get_model as jget
    from pint_tpu.simulation import make_fake_toas_uniform as j_fake
    from pint_tpu_torch.examples import receiver_freqs
    from pint_tpu_torch.models import get_model as tget
    from pint_tpu_torch.mjd import diff_sec
    from pint_tpu_torch.simulation import make_fake_toas_uniform as t_fake

    n = 48
    _, freqs = receiver_freqs(n)
    kw = dict(obs="gbt", error_us=1.0, freq_mhz=freqs, add_noise=True,
              seed=11)
    lo, hi = data.CENTER_MJD - 300.0, data.CENTER_MJD + 300.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = j_fake(lo, hi, n, jget(data.dd_par_lines()), **kw)
        tt = t_fake(lo, hi, n, tget(data.dd_par_lines()), device="cpu",
                    **kw)
    d = diff_sec(tt.utc, jt.utc)
    gap = float(np.max(np.abs(np.asarray(d.hi) + np.asarray(d.lo))))
    print(f"simulated TOAs: max gap {gap:.3e} s (bar {TOA_TOL_S})")
    assert gap <= TOA_TOL_S
    assert [f["simulated"] for f in tt.flags] == ["1"] * n
