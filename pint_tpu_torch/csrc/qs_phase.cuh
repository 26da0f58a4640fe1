// The quad-single pulse phase of one TOA row (K3), shared by the
// standalone qs_phase_frac kernel (qs_phase.cu) and the fused phase chain
// (phase_chain.cu, the epilogue of the delay chain's row function).
//
// Device code of these JAX functions of pint_tpu (no Pallas kernel there:
// XLA compiles them from jnp, one error-free transform at a time):
//   K3  pint_tpu/models/spindown.py  dt_seconds_qs + Spindown.phase
//       pint_tpu/models/timing_model.py  PhaseCalc.phase (TZR subtraction)
//       pint_tpu/residuals.py  raw_phase_resids ("nearest" rounding)
// Its plain PyTorch version is pint_tpu_torch.models.spindown.
// phase_frac_plain.  Per row, in the operation order of pint_tpu.qs (so
// the words are bit-equal to the plain version's):
//   dt_days = QS(dday, fw0, fw1, 0) + QS(fw2) - PEPOCH frac words
//   dt      = dt_days * 86400 + from_f64(shift)           [s]
//   spin    = horner_taylor(dt, [0, F0, F1, ...]) + from_f64(taylor_horner(dt64, [0, dF...]))
//   total   = (0 + spin) [+ from_f64(other)] [- TZR words]
//   mode 0: to_f64(round_nearest(total).frac)
//   mode 1: to_f64(total - from_f64(pulse_number))
//   mode 2: the four words of total
// plus, in float64, dt64 and slope = d frac / d shift as pint_tpu's
// word-level autodiff gives it: the secant frequency sum_k F_k dt^k/(k+1)!
// of the F words plus the exact derivative sum_k dF_k dt^k/k! of the
// offsets' term.  The wrappers' tangent rules read both.
//
// What does not depend on the row is formed once, by spin_terms, into a
// SpinTerms that a kernel keeps in shared memory: the Taylor coefficients
// F_{k-1} / k! as QS words (the same qs_mul_w by the float32 1/k! that
// qs.horner_taylor applies at every row) and each F word's float64 value.
// The row function indexes no local array.
//
// Plain C++ under PT_HD (qs.cuh), so that the host can build it too
// (phase_chain_host.cpp); like qs.cuh it needs --fmad=false /
// -ffp-contract=off and never --use_fast_math.

#pragma once

#include <math.h>
#include <stdint.h>

#include "qs.cuh"

namespace ptphase {

using ptqs::QS;

constexpr int kMaxTerms = 16;  // F0..F15

// output modes (kernels/qs_phase.py MODES)
enum : int32_t { kNearest = 0, kPulseNumbers = 1, kWords = 2 };

// the row-independent part of the spin phase: coef[k] = F_{k-1} / k! as
// QS (coef[0] = 0), f64[k] = to_f64(F_k), for K spin terms
struct SpinTerms {
  QS coef[kMaxTerms + 1];
  double f64[kMaxTerms];
};

// entry k in 0..K of SpinTerms from the (K, 4) F words: coef[k], and for
// k < K f64[k].  Every entry is independent, so a block forms them with
// one thread each.
PT_HD void spin_term(SpinTerms& s, const float* f_w, int K, int k) {
  if (k == 0) {
    s.coef[0] = QS{{0.0f, 0.0f, 0.0f, 0.0f}};
  } else {
    const float* c = f_w + 4 * (k - 1);
    QS ck = QS{{c[0], c[1], c[2], c[3]}};
    double fact = 1.0;  // k!, exact in float64 for k <= 16
    for (int j = 2; j <= k; ++j) fact *= j;
    if (fact != 1.0) ck = ptqs::qs_mul_w(ck, (float)(1.0 / fact));
    s.coef[k] = ck;
  }
  if (k < K) {
    const float* c = f_w + 4 * k;
    s.f64[k] = ptqs::qs_to_f64(QS{{c[0], c[1], c[2], c[3]}});
  }
}

// the phase row's outputs; `words` only in mode kWords, `out` otherwise
struct PhaseOut {
  double out;
  float words[4];
  double slope;
  double dt64;
};

// One row: the TOA's integer TDB day and frac words, PEPOCH's integer day
// and frac words, the spin terms of K F words, the K float64 offsets dF,
// the row's shift [s] (-delay - dPEPOCH 86400), the float64 phase of the
// components after the Spindown (if has_other), the TZR words (or null),
// the mode and the row's pulse number (mode kPulseNumbers).
PT_HD PhaseOut phase_row(int64_t tdb_day, const float* frac_w,
                         double pep_day, const float* pep_w,
                         const SpinTerms& s, int K, const double* dF,
                         double shift, bool has_other, double other,
                         const float* tzr_w, int mode, double pn) {
  PhaseOut o;
  // (t_TDB - PEPOCH) [s] + shift, in QS
  const QS dt = ptqs::dt_seconds_qs(tdb_day, frac_w, pep_day, pep_w, shift);
  const double dt64 = ptqs::qs_to_f64(dt);

  // spin phase: Taylor-Horner over [0, F0, ..., F_{K-1}] in QS
  QS acc = s.coef[K];
  for (int k = K - 1; k >= 0; --k)
    acc = ptqs::qs_add(ptqs::qs_mul(acc, dt), s.coef[k]);
  // the fit offsets' Taylor term in float64 (utils.taylor_horner over
  // [0, dF_0, ..., dF_{K-1}])
  double th = 0.0 * dt64;
  for (int k = K; k >= 1; --k) th = th * dt64 / (k + 1.0) + dF[k - 1];
  th = th * dt64 / 1.0 + 0.0;
  acc = ptqs::qs_add(acc, ptqs::qs_from_f64(th));
  // d frac / d shift: secant of the F words + derivative of the offsets
  double sec = 0.0, der = 0.0;
  for (int k = K - 1; k >= 0; --k) {
    sec = sec * dt64 / (k + 2.0) + s.f64[k];
    der = der * dt64 / (k + 1.0) + dF[k];
  }
  o.slope = sec + der;
  o.dt64 = dt64;

  // PhaseCalc.phase: zeros + spin [+ other] [- TZR]
  QS total = ptqs::qs_add(QS{{0.0f, 0.0f, 0.0f, 0.0f}}, acc);
  if (has_other) total = ptqs::qs_add(total, ptqs::qs_from_f64(other));
  if (tzr_w != nullptr)
    total = ptqs::qs_add(
        total, ptqs::qs_neg(QS{{tzr_w[0], tzr_w[1], tzr_w[2], tzr_w[3]}}));

  o.out = 0.0;
  if (mode == kNearest) {
    o.out = ptqs::qs_to_f64(ptqs::qs_round_frac(total));
  } else if (mode == kPulseNumbers) {
    total = ptqs::qs_add(total, ptqs::qs_neg(ptqs::qs_from_f64(
                                    isnan(pn) ? 0.0 : pn)));
    o.out = ptqs::qs_to_f64(total);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o.words[i] = total.w[i];
  return o;
}

}  // namespace ptphase
