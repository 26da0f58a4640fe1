// qs_phase_frac: the quad-single pulse-phase chain of one timing model,
// fused into one kernel for NVIDIA Hopper (sm_90a).
//
// Replaces these JAX functions of pint_tpu (no Pallas kernel there: XLA
// compiles them from jnp, one error-free transform at a time):
//   K1  pint_tpu/dd.py      two_sum / split / two_prod (+ _guard)
//   K2  pint_tpu/qs.py      _distill / _renorm / add / add_w / mul / mul_w /
//                           horner_taylor / round_nearest / from_f64_device /
//                           to_f64
//   K3  pint_tpu/models/spindown.py  dt_seconds_qs + Spindown.phase
//       pint_tpu/models/timing_model.py  PhaseCalc.phase (TZR subtraction)
//       pint_tpu/residuals.py  raw_phase_resids ("nearest" rounding)
// Its plain PyTorch version is pint_tpu_torch.models.spindown.phase_frac_plain;
// the wrapper is pint_tpu_torch/kernels/qs_phase.py.
//
// One thread per (grid point, TOA) row; every row is independent.  Per
// row, in the operation order of pint_tpu.qs (so the words are bit-equal
// to the plain version's):
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
// offsets' term.  The wrapper's tangent rule reads both.
//
// What bounds it: arithmetic.  The plain version does ~2.3k float32 and
// ~60 float64 elementwise operations per row (the QS products renormalize
// 14 words three times) against ~42 bytes of device traffic per row, so
// at the headline grid's 112,500 rows the float32 issue rate (67 TFLOP/s
// on an H100 SXM, no tensor cores) sets a floor of ~4 us and the bytes
// (3.35 TB/s) ~1.4 us; chip_smoke.py counts both from the run's inputs.
// The design is the simple one: one thread per row, registers only, no
// shared memory, no tensor cores.
//
// The QS arithmetic (K1, K2) lives in qs.cuh, shared with delay_chain.cu;
// like every kernel that includes it, this one is compiled with
// --fmad=false and never --use_fast_math (see qs.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "qs.cuh"

namespace {

using ptqs::QS;
using ptqs::qs_add;
using ptqs::qs_from_f64;
using ptqs::qs_mul;
using ptqs::qs_mul_w;
using ptqs::qs_neg;
using ptqs::qs_round_frac;
using ptqs::qs_to_f64;

// pint_tpu.utils.taylor_horner in float64: sum_k c_k dt^k / k!
__device__ __forceinline__ double taylor_horner(double dt, const double* c,
                                                int n) {
  double acc = 0.0 * dt;
  for (int k = n - 1; k >= 0; --k) acc = acc * dt / (k + 1.0) + c[k];
  return acc;
}

constexpr int kMaxTerms = 16;  // F0..F15

__global__ void qs_phase_frac_kernel(
    const int64_t* __restrict__ tdb_day, const float* __restrict__ frac_w,
    const double* __restrict__ pep_day, const float* __restrict__ pep_w,
    const float* __restrict__ f_w, int K, const float* __restrict__ tzr_w,
    const double* __restrict__ pulse_number,
    const double* __restrict__ shift, const double* __restrict__ dF,
    const double* __restrict__ other, double* __restrict__ out,
    float* __restrict__ words, double* __restrict__ slope,
    double* __restrict__ dt64_out, int64_t G, int64_t N, int mode) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= G * N) return;
  const int64_t g = row / N;
  const int64_t n = row - g * N;

  // (t_TDB - PEPOCH) [s] + shift, in QS
  const QS dt = ptqs::dt_seconds_qs(tdb_day[n], frac_w + 3 * n, pep_day[0],
                                    pep_w, shift[row]);
  const double dt64 = qs_to_f64(dt);

  // spin phase: Taylor-Horner over [0, F0, ..., F_{K-1}] in QS
  const int n_terms = K + 1;
  double facts[kMaxTerms + 1];
  double fact = 1.0;
  for (int k = 0; k < n_terms; ++k) {
    facts[k] = fact;
    fact *= k + 1;
  }
  const float* top = f_w + 4 * (K - 1);
  QS acc = {{top[0], top[1], top[2], top[3]}};
  if (facts[n_terms - 1] != 1.0)
    acc = qs_mul_w(acc, (float)(1.0 / facts[n_terms - 1]));
  for (int k = n_terms - 2; k >= 0; --k) {
    QS ck = {{0.0f, 0.0f, 0.0f, 0.0f}};
    if (k > 0) {
      const float* c = f_w + 4 * (k - 1);
      ck = QS{{c[0], c[1], c[2], c[3]}};
    }
    if (facts[k] != 1.0) ck = qs_mul_w(ck, (float)(1.0 / facts[k]));
    acc = qs_add(qs_mul(acc, dt), ck);
  }
  // the fit offsets' Taylor term in float64
  double coef[kMaxTerms + 1];
  coef[0] = 0.0;
  for (int k = 0; k < K; ++k) coef[k + 1] = dF[g * K + k];
  acc = qs_add(acc, qs_from_f64(taylor_horner(dt64, coef, K + 1)));
  // d frac / d shift: secant of the F words + derivative of the offsets
  double sec = 0.0, der = 0.0;
  for (int k = K - 1; k >= 0; --k) {
    const float* c = f_w + 4 * k;
    sec = sec * dt64 / (k + 2.0) + qs_to_f64(QS{{c[0], c[1], c[2], c[3]}});
    der = der * dt64 / (k + 1.0) + dF[g * K + k];
  }
  slope[row] = sec + der;
  dt64_out[row] = dt64;

  // PhaseCalc.phase: zeros + spin [+ other] [- TZR]
  QS total = qs_add(QS{{0.0f, 0.0f, 0.0f, 0.0f}}, acc);
  if (other != nullptr) total = qs_add(total, qs_from_f64(other[row]));
  if (tzr_w != nullptr)
    total = qs_add(total,
                   qs_neg(QS{{tzr_w[0], tzr_w[1], tzr_w[2], tzr_w[3]}}));

  if (mode == 0) {
    out[row] = qs_to_f64(qs_round_frac(total));
  } else if (mode == 1) {
    const double pn = pulse_number[n];
    total = qs_add(total, qs_neg(qs_from_f64(isnan(pn) ? 0.0 : pn)));
    out[row] = qs_to_f64(total);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) words[4 * row + i] = total.w[i];
  }
}

}  // namespace

extern "C" int qs_phase_frac(const int64_t* tdb_day, const float* frac_w,
                             const double* pep_day, const float* pep_w,
                             const float* f_w, int K, const float* tzr_w,
                             const double* pulse_number, const double* shift,
                             const double* dF, const double* other,
                             double* out, float* words, double* slope,
                             double* dt64, int64_t G, int64_t N, int mode,
                             void* stream) {
  if (K < 1 || K > kMaxTerms || mode < 0 || mode > 2 || G < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t rows = G * N;
  const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
  qs_phase_frac_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tdb_day, frac_w, pep_day, pep_w, f_w, K, tzr_w, pulse_number, shift,
      dF, other, out, words, slope, dt64, G, N, mode);
  return (int)cudaGetLastError();
}

extern "C" const char* qs_phase_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
