"""The spin phase's word-level tangent of pint_tpu_torch against
pint_tpu's, on the CPU.

pint_tpu differentiates its quad-single phase by JAX's forward mode
through the float32 words (``pint_tpu/models/spindown.py``, ``qs.py``;
the error-free transforms' guard has the identity as its JVP): each
float64 tangent enters the words where its value does
(``from_f64_device``), every word operation carries its float32 tangent,
and ``to_f64`` sums them.  On a young pulsar that tangent is the float32
rounding of the instantaneous frequency, not linear in the shift's
tangent, so only the same word-level forward mode meets it.  The port
forms it so in the plain version (``models/spindown.py``
``phase_frac_jvp``, ``QSPhaseFrac.jvp``) and, lane by lane, in the fused
tangent kernel (``csrc/qs.cuh`` ``F32N<L>``, ``qs_phase.cuh``
``phase_row_tangent``):

* the Taylor phase's tangent along the witness's tangents
  (``tests/test_torch_phase_family.py``
  ``test_secant_slope_departure_witness``) bit-equal to pint_tpu's, at a
  millisecond pulsar's and the young set's F1;
* ``phase_frac_jvp`` on rows spanning eight years about PEPOCH, along
  random tangents of the shift and the spin offsets, bit-equal to
  ``jax.jvp`` of pint_tpu's chain in its order (``dt_seconds_qs``,
  ``Spindown.phase``, the total, ``round_nearest``, ``to_f64``);
* the young set's design matrix on the CPU within ``COLUMN_TOL`` of the
  stored pint_tpu columns that ``chip_smoke.py`` holds the card to
  (``tests/data/young_sim_200_columns.json``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu import qs as jqs
from pint_tpu.utils import taylor_horner as j_taylor_horner
from pint_tpu_torch import qs as tqs
from pint_tpu_torch.fitter import build_resid_sec_fn
from pint_tpu_torch.models.spindown import phase_frac_jvp
from pint_tpu_torch.residuals import Residuals

COLUMN_TOL = 1e-10
F32, F64 = torch.float32, torch.float64
#: the witness's span and spin sets: a millisecond pulsar's, the young
#: set's (F0, F1, F2)
DT = 1.26e8
MSP = [346.53199992, -1.46e-15]
YOUNG = [11.19, -1.56e-11, 8e-22]
ALONG = (1.0, -7.8e-4, 3e-3, 0.37)


def _j_horner_jvp(F, dt, x):
    """pint_tpu's tangent of its quad-single Taylor phase in dt along
    ``x`` (the witness's form, op by op)."""
    coeffs = [jqs.zeros_like(jnp.zeros((), jnp.float32))] + [
        jqs.QS(*[jnp.float32(w) for w in jqs.from_f64_host(
            np.float64(f)).words]) for f in F]

    def phase(shift):
        d = jqs.from_f64_device(jnp.float64(dt) + shift)
        return jqs.to_f64(jqs.horner_taylor(d, coeffs))

    with jax.disable_jit():
        return float(jax.jvp(phase, (jnp.float64(0.0),),
                             (jnp.float64(x),))[1])


def _t_horner_jvp(F, dt, x):
    """The port's: the same operations of pint_tpu_torch.qs, through
    torch.func.jvp on a one-row tensor (torch promotes a 0-dim float32
    operand against a wrapped Python number in a jvp, so the rows of the
    port's chain are never 0-dim)."""
    coeffs = [tqs.zeros_like(torch.zeros(1, dtype=F32))] + [
        tqs.QS(*[torch.tensor([float(w)], dtype=F32)
                 for w in tqs.from_f64_host(np.float64(f)).words])
        for f in F]

    def phase(shift):
        d = tqs.from_f64_device(torch.tensor([dt], dtype=F64) + shift)
        return tqs.to_f64(tqs.horner_taylor(d, coeffs))

    return float(torch.func.jvp(phase, (torch.zeros(1, dtype=F64),),
                                (torch.tensor([x], dtype=F64),))[1][0])


@pytest.mark.parametrize("spin", ["msp", "young"])
@pytest.mark.parametrize("x", ALONG)
def test_horner_tangent_bit_equal_to_reference(spin, x):
    F = MSP if spin == "msp" else YOUNG
    want, got = _j_horner_jvp(F, DT, x), _t_horner_jvp(F, DT, x)
    print(f"{spin} along {x}: {got!r} (pint_tpu {want!r})")
    assert got == want


def _rows(spin, n=64, seed=5):
    """A spindown row set: TOAs over eight years about PEPOCH (integer
    day and frac words), the PEPOCH day and words, the F words, the
    shift, the spin offsets and their tangents."""
    rng = np.random.default_rng(seed)
    F = MSP if spin == "msp" else YOUNG
    pep_day, pep_frac = 55000.0, 0.3125
    days = pep_day + np.round(rng.uniform(-1460, 1460, n))
    fracs = rng.random(n)
    frac_w = np.stack([np.stack(tqs.from_f64_host(f).words[:3])
                       for f in fracs]).astype(np.float32)
    pep_w = np.stack(tqs.from_f64_host(pep_frac).words).astype(np.float32)
    f_w = np.stack([np.stack(tqs.from_f64_host(np.float64(f)).words)
                    for f in F]).astype(np.float32)
    K = len(F)
    shift = rng.uniform(-500.0, 500.0, n)
    dF = np.array([1e-10, 1e-18, 1e-28][:K]) * rng.standard_normal(K)
    dshift = 1e-3 * rng.standard_normal(n)
    ddF = np.array([1e-9, 1e-17, 1e-27][:K]) * rng.standard_normal(K)
    return days.astype(np.int64), frac_w, pep_day, pep_w, f_w, shift, dF, \
        dshift, ddF


def _j_chain_jvp(days, frac_w, pep_day, pep_w, f_w, shift, dF, dshift,
                 ddF):
    """jax.jvp of pint_tpu's phase chain in its order: dt_seconds_qs's QS
    difference and shift, Spindown.phase's Taylor words plus the offsets'
    float64 term, the total from zero, round_nearest, to_f64."""
    z = jnp.zeros(len(days), jnp.float32)

    def frac(sh, dFv):
        dday = (jnp.asarray(days, jnp.float64) - pep_day).astype(jnp.float32)
        w = jnp.asarray(frac_w)
        dt = jqs.QS(dday, w[:, 0], w[:, 1], z)
        dt = jqs.add(dt, jqs.QS(w[:, 2], z, z, z))
        dt = jqs.sub(dt, jqs.QS(*[jnp.broadcast_to(jnp.float32(x), z.shape)
                                  for x in pep_w]))
        dt = jqs.mul_w(dt, jnp.float32(86400.0))
        dt = jqs.add(dt, jqs.from_f64_device(sh))
        dt64 = jqs.to_f64(dt)
        coeffs = [jqs.zeros_like(z)] + [
            jqs.QS(*[jnp.broadcast_to(jnp.float32(x), z.shape) for x in fw])
            for fw in f_w]
        ph = jqs.horner_taylor(dt, coeffs)
        dph = j_taylor_horner(dt64, [jnp.float64(0.0)] +
                              [dFv[k] for k in range(len(f_w))])
        ph = jqs.add(ph, jqs.from_f64_device(dph))
        total = jqs.add(jqs.zeros_like(z), ph)
        _, fr = jqs.round_nearest(total)
        return jqs.to_f64(fr)

    with jax.disable_jit():
        return np.asarray(jax.jvp(frac, (jnp.asarray(shift),
                                         jnp.asarray(dF)),
                                  (jnp.asarray(dshift),
                                   jnp.asarray(ddF)))[1])


@pytest.mark.parametrize("spin", ["msp", "young"])
def test_phase_frac_jvp_bit_equal_to_reference(spin):
    days, frac_w, pep_day, pep_w, f_w, shift, dF, dshift, ddF = _rows(spin)
    want = _j_chain_jvp(days, frac_w, pep_day, pep_w, f_w, shift, dF,
                        dshift, ddF)
    t = torch.from_numpy
    got = phase_frac_jvp(t(days), t(frac_w), pep_day, t(pep_w), t(f_w),
                         t(shift), t(dF), None, None, None, "nearest",
                         t(dshift), t(ddF), None).numpy()
    gap = float(np.max(np.abs(got - want)))
    print(f"{spin}: {len(days)} rows, d frac {gap:.3e} from pint_tpu's, "
          f"bit-equal {np.array_equal(got, want)}")
    np.testing.assert_array_equal(got, want)


def test_young_columns_match_stored():
    """The port's young design matrix on the CPU against the pint_tpu
    columns the card is held to: within COLUMN_TOL in every column."""
    with open(data.YOUNG_COLUMNS_JSON) as f:
        want = json.load(f)
    model, toas = data.load_torch(data.YOUNG_REF_TIM,
                                  par=data.young_par_lines())
    r = Residuals(toas, model, device="cpu")
    names = want["names"]
    assert names == model.free_params and want["ntoas"] == toas.ntoas
    fn = build_resid_sec_fn(model, r.batch, names, r.track_mode)
    M = torch.func.jacfwd(lambda x: fn(x, r.pdict))(
        model.x0(r.pdict, names)).detach().numpy()
    W = np.asarray(want["columns"]).T
    scale = np.max(np.abs(W), axis=0)
    gap = np.max(np.abs(M - W), axis=0) / np.where(scale > 0, scale, 1.0)
    print("young columns: " + ", ".join(f"{n} {g:.2e}"
                                        for n, g in zip(names, gap)))
    assert float(np.max(gap)) <= COLUMN_TOL
