// Quad-single (QS) arithmetic shared by the port's kernels: four float32
// words per value, built on error-free transforms.
//
// Device code of these JAX functions of pint_tpu (no Pallas kernel there:
// XLA compiles them from jnp, one error-free transform at a time):
//   K1  pint_tpu/dd.py  two_sum / split / two_prod (+ _guard)
//   K2  pint_tpu/qs.py  _distill / _renorm / add / add_w / mul / mul_w /
//                       horner_taylor / round_nearest / from_f64_device /
//                       to_f64
// and the QS epoch difference of pint_tpu/models/spindown.py dt_seconds_qs.
// Included by qs_phase.cu (the spin phase) and delay_chain.cu (the binary
// orbit's t - epoch).
//
// Every kernel that includes this header is built with --fmad=false and
// never --use_fast_math: a contracted a*b+c (FMA) or a reassociated sum
// silently breaks the error-free transforms (the CUDA form of the hazard
// pint_tpu.dd._guard fences).  Rounding to the nearest integer is
// rintf/rint (half to even, as torch.round and jnp.round), never roundf.
//
// The functions are __host__ __device__ so that the arithmetic can also be
// compiled for the host (PT_HD).

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define PT_HD __host__ __device__ __forceinline__
#else
#define PT_HD inline
#endif

namespace ptqs {

struct QS {
  float w[4];
};

PT_HD void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

PT_HD void split(float a, float& hi, float& lo) {
  const float t = 4097.0f * a;
  hi = t - (t - a);
  lo = a - hi;
}

PT_HD void two_prod(float a, float b, float& p, float& e) {
  p = a * b;
  float ahi, alo, bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo;
}

// pint_tpu.qs._distill: three bottom-up passes of chained two_sums
template <int N>
PT_HD QS renorm(float (&ws)[N]) {
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

PT_HD QS qs_neg(const QS& a) {
  QS q;
#pragma unroll
  for (int i = 0; i < 4; ++i) q.w[i] = -a.w[i];
  return q;
}

PT_HD QS qs_add(const QS& a, const QS& b) {
  float s0, e0, s1, e1, s2, e2;
  two_sum(a.w[0], b.w[0], s0, e0);
  two_sum(a.w[1], b.w[1], s1, e1);
  two_sum(a.w[2], b.w[2], s2, e2);
  const float s3 = a.w[3] + b.w[3];
  float ws[7] = {s0, s1, e0, s2, e1, s3, e2};
  return renorm<7>(ws);
}

PT_HD QS qs_add_w(const QS& q, float w) {
  float s0, s1, s2, s3, e;
  two_sum(q.w[0], w, s0, e);
  two_sum(q.w[1], e, s1, e);
  two_sum(q.w[2], e, s2, e);
  two_sum(q.w[3], e, s3, e);
  float ws[5] = {s0, s1, s2, s3, e};
  return renorm<5>(ws);
}

PT_HD QS qs_mul_w(const QS& q, float w) {
  float p0, e0, p1, e1, p2, e2;
  two_prod(q.w[0], w, p0, e0);
  two_prod(q.w[1], w, p1, e1);
  two_prod(q.w[2], w, p2, e2);
  const float p3 = q.w[3] * w;
  float ws[7] = {p0, p1, e0, p2, e1, p3, e2};
  return renorm<7>(ws);
}

PT_HD QS qs_mul(const QS& a, const QS& b) {
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
PT_HD QS qs_from_f64(double x) {
  const float w0 = (float)x;
  const double r = x - (double)w0;
  const float w1 = (float)r;
  const double r2 = r - (double)w1;
  const float w2 = (float)r2;
  float ws[4] = {w0, w1, w2, 0.0f};
  return renorm<4>(ws);
}

// pint_tpu.qs.to_f64: ((w0 + w1) + w2) + w3 in float64
PT_HD double qs_to_f64(const QS& q) {
  return (double)q.w[0] + (double)q.w[1] + (double)q.w[2] + (double)q.w[3];
}

// pint_tpu.qs.round_nearest, fraction only
PT_HD QS qs_round_frac(QS r) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float nk = rintf(r.w[0]);
    r = qs_add_w(r, -nk);
  }
  const double adj = rint(qs_to_f64(r));
  return qs_add_w(r, -1.0f * (float)adj);
}

// pint_tpu.models.spindown.dt_seconds_qs: (t_TDB - epoch) * 86400 + shift
// [s] as a QS, from the TOA's integer day and frac words and the epoch's
// integer day and frac words; shift [s] enters through from_f64.
PT_HD QS dt_seconds_qs(int64_t tdb_day, const float* frac_w, double day0,
                       const float* epoch_w, double shift) {
  // exact f64 integer-day difference, then f32
  const float dday = (float)((double)tdb_day - day0);
  QS dt = {{dday, frac_w[0], frac_w[1], 0.0f}};
  dt = qs_add(dt, QS{{frac_w[2], 0.0f, 0.0f, 0.0f}});
  dt = qs_add(dt, qs_neg(QS{{epoch_w[0], epoch_w[1], epoch_w[2], epoch_w[3]}}));
  dt = qs_mul_w(dt, 86400.0f);
  return qs_add(dt, qs_from_f64(shift));
}

}  // namespace ptqs
