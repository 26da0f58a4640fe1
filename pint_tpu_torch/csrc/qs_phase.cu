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
// Compile with --fmad=false and never --use_fast_math: a contracted
// a*b+c (FMA) or a reassociated sum silently breaks the error-free
// transforms (the CUDA form of the hazard pint_tpu.dd._guard fences).
// Rounding to nearest integer is rintf/rint (half to even, as torch.round
// and jnp.round), never roundf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct QS {
  float w[4];
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = 4097.0f * a;
  hi = t - (t - a);
  lo = a - hi;
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = a * b;
  float ahi, alo, bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo;
}

// pint_tpu.qs._distill: three bottom-up passes of chained two_sums
template <int N>
__device__ __forceinline__ QS renorm(float (&ws)[N]) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    float out[N];
    float s = ws[N - 1];
#pragma unroll
    for (int i = N - 2; i >= 0; --i) {
      float e;
      two_sum(ws[i], s, s, e);
      out[i + 1] = e;
    }
    out[0] = s;
#pragma unroll
    for (int i = 0; i < N; ++i) ws[i] = out[i];
  }
  QS q;
#pragma unroll
  for (int i = 0; i < 4; ++i) q.w[i] = ws[i];
  return q;
}

__device__ __forceinline__ QS qs_neg(const QS& a) {
  QS q;
#pragma unroll
  for (int i = 0; i < 4; ++i) q.w[i] = -a.w[i];
  return q;
}

__device__ __forceinline__ QS qs_add(const QS& a, const QS& b) {
  float s0, e0, s1, e1, s2, e2;
  two_sum(a.w[0], b.w[0], s0, e0);
  two_sum(a.w[1], b.w[1], s1, e1);
  two_sum(a.w[2], b.w[2], s2, e2);
  const float s3 = a.w[3] + b.w[3];
  float ws[7] = {s0, s1, e0, s2, e1, s3, e2};
  return renorm<7>(ws);
}

__device__ __forceinline__ QS qs_add_w(const QS& q, float w) {
  float s0, s1, s2, s3, e;
  two_sum(q.w[0], w, s0, e);
  two_sum(q.w[1], e, s1, e);
  two_sum(q.w[2], e, s2, e);
  two_sum(q.w[3], e, s3, e);
  float ws[5] = {s0, s1, s2, s3, e};
  return renorm<5>(ws);
}

__device__ __forceinline__ QS qs_mul_w(const QS& q, float w) {
  float p0, e0, p1, e1, p2, e2;
  two_prod(q.w[0], w, p0, e0);
  two_prod(q.w[1], w, p1, e1);
  two_prod(q.w[2], w, p2, e2);
  const float p3 = q.w[3] * w;
  float ws[7] = {p0, p1, e0, p2, e1, p3, e2};
  return renorm<7>(ws);
}

__device__ __forceinline__ QS qs_mul(const QS& a, const QS& b) {
  float p00, e00, p01, e01, p10, e10, p02, e02, p11, e11, p20, e20;
  two_prod(a.w[0], b.w[0], p00, e00);
  two_prod(a.w[0], b.w[1], p01, e01);
  two_prod(a.w[1], b.w[0], p10, e10);
  two_prod(a.w[0], b.w[2], p02, e02);
  two_prod(a.w[1], b.w[1], p11, e11);
  two_prod(a.w[2], b.w[0], p20, e20);
  // order-3 terms: plain products (errors below 2^-96)
  const float t3 = (a.w[0] * b.w[3] + a.w[3] * b.w[0]) +
                   (a.w[1] * b.w[2] + a.w[2] * b.w[1]);
  // order-4: below target precision but nearly free
  const float t4 = a.w[1] * b.w[3] + a.w[2] * b.w[2] + a.w[3] * b.w[1];
  float ws[14] = {p00, p01, p10, e00, p02, p11, p20,
                  e01, e10, t3,  e02, e11, e20, t4};
  return renorm<14>(ws);
}

// pint_tpu.qs.from_f64_device: exact three-word split, then renormalize
__device__ __forceinline__ QS qs_from_f64(double x) {
  const float w0 = (float)x;
  const double r = x - (double)w0;
  const float w1 = (float)r;
  const double r2 = r - (double)w1;
  const float w2 = (float)r2;
  float ws[4] = {w0, w1, w2, 0.0f};
  return renorm<4>(ws);
}

// pint_tpu.qs.to_f64: ((w0 + w1) + w2) + w3 in float64
__device__ __forceinline__ double qs_to_f64(const QS& q) {
  return (double)q.w[0] + (double)q.w[1] + (double)q.w[2] + (double)q.w[3];
}

// pint_tpu.qs.round_nearest, fraction only
__device__ __forceinline__ QS qs_round_frac(QS r) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float nk = rintf(r.w[0]);
    r = qs_add_w(r, -nk);
  }
  const double adj = rint(qs_to_f64(r));
  return qs_add_w(r, -1.0f * (float)adj);
}

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

  // (t_TDB - PEPOCH) in days: exact f64 integer-day difference, then f32
  const float dday = (float)((double)tdb_day[n] - pep_day[0]);
  QS dt = {{dday, frac_w[3 * n], frac_w[3 * n + 1], 0.0f}};
  dt = qs_add(dt, QS{{frac_w[3 * n + 2], 0.0f, 0.0f, 0.0f}});
  dt = qs_add(dt, qs_neg(QS{{pep_w[0], pep_w[1], pep_w[2], pep_w[3]}}));
  dt = qs_mul_w(dt, 86400.0f);
  dt = qs_add(dt, qs_from_f64(shift[row]));
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
