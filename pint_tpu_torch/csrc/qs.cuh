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

// A float32 word and L forward-mode tangent lanes: the word-level tangent
// of pint_tpu's quad-single chain (jax.jvp through pint_tpu.qs; the
// guard's JVP is the identity).  Each lane takes JAX's forward rule of
// each operation, in its order, in float32:
//   d(a + b) = da + db        d(a - b) = da - db        d(-a) = -da
//   d(a * b) = da * b + a * db
// and a float operand (a constant word: 4097, 86400, 1/k!, a rounded
// integer) carries no tangent, so d(a + c) = da, d(c * a) = c * da.
// Built without FMA contraction (like everything here), each lane is
// bit-equal to the plain version's (pint_tpu_torch.models.spindown.
// phase_frac_jvp), up to the sign of a zero.
template <int L>
struct F32N {
  float v;
  float d[L];
};

#define PT_QS_LANES _Pragma("unroll") for (int l = 0; l < L; ++l)

template <int L>
PT_HD F32N<L> operator+(const F32N<L>& a, const F32N<L>& b) {
  F32N<L> r;
  r.v = a.v + b.v;
  PT_QS_LANES r.d[l] = a.d[l] + b.d[l];
  return r;
}
template <int L>
PT_HD F32N<L> operator+(F32N<L> a, float b) {
  a.v = a.v + b;
  return a;
}
template <int L>
PT_HD F32N<L> operator+(float a, F32N<L> b) {
  b.v = a + b.v;
  return b;
}
template <int L>
PT_HD F32N<L> operator-(const F32N<L>& a, const F32N<L>& b) {
  F32N<L> r;
  r.v = a.v - b.v;
  PT_QS_LANES r.d[l] = a.d[l] - b.d[l];
  return r;
}
template <int L>
PT_HD F32N<L> operator-(F32N<L> a, float b) {
  a.v = a.v - b;
  return a;
}
template <int L>
PT_HD F32N<L> operator-(float a, const F32N<L>& b) {
  F32N<L> r;
  r.v = a - b.v;
  PT_QS_LANES r.d[l] = -b.d[l];
  return r;
}
template <int L>
PT_HD F32N<L> operator-(const F32N<L>& a) {
  F32N<L> r;
  r.v = -a.v;
  PT_QS_LANES r.d[l] = -a.d[l];
  return r;
}
template <int L>
PT_HD F32N<L> operator*(const F32N<L>& a, const F32N<L>& b) {
  F32N<L> r;
  r.v = a.v * b.v;
  PT_QS_LANES r.d[l] = a.d[l] * b.v + a.v * b.d[l];
  return r;
}
template <int L>
PT_HD F32N<L> operator*(const F32N<L>& a, float b) {
  F32N<L> r;
  r.v = a.v * b;
  PT_QS_LANES r.d[l] = a.d[l] * b;
  return r;
}
template <int L>
PT_HD F32N<L> operator*(float a, const F32N<L>& b) {
  F32N<L> r;
  r.v = a * b.v;
  PT_QS_LANES r.d[l] = a * b.d[l];
  return r;
}

// a word's value, and a word of value x with zero tangents
PT_HD float wval(float x) { return x; }
template <int L>
PT_HD float wval(const F32N<L>& x) {
  return x.v;
}
template <typename W>
PT_HD W word(float x) {
  W r;
  r.v = x;
#pragma unroll
  for (int l = 0; l < (int)(sizeof(r.d) / sizeof(float)); ++l) r.d[l] = 0.0f;
  return r;
}
template <>
PT_HD float word<float>(float x) {
  return x;
}

// the float64 counterpart of a word type (a float64 value and its lanes'
// tangents), with the casts between them: `of` widens a word, `narrow`
// rounds a float64 one to a word, lane by lane.  phase_chain.cuh
// specializes it for F32N<L> (whose float64 type is delay_chain.cuh's
// DualN<L>).
template <typename W>
struct Wide;
template <>
struct Wide<float> {
  using type = double;
  PT_HD static double of(float w) { return (double)w; }
  PT_HD static float narrow(double x) { return (float)x; }
};

template <typename W>
struct QSW {
  W w[4];
};
using QS = QSW<float>;

template <typename W, typename B>
PT_HD void two_sum(W a, B b, W& s, W& e) {
  s = a + b;
  const W bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

template <typename W>
PT_HD void split(W a, W& hi, W& lo) {
  const W t = 4097.0f * a;
  hi = t - (t - a);
  lo = a - hi;
}

template <typename W, typename B>
PT_HD void two_prod(W a, B b, W& p, W& e) {
  p = a * b;
  W ahi, alo;
  B bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo;
}

// pint_tpu.qs._distill: three bottom-up passes of chained two_sums
template <int N, typename W>
PT_HD QSW<W> renorm(W (&ws)[N]) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    W out[N];
    W s = ws[N - 1];
#pragma unroll
    for (int i = N - 2; i >= 0; --i) {
      W e;
      two_sum(ws[i], s, s, e);
      out[i + 1] = e;
    }
    out[0] = s;
#pragma unroll
    for (int i = 0; i < N; ++i) ws[i] = out[i];
  }
  QSW<W> q;
#pragma unroll
  for (int i = 0; i < 4; ++i) q.w[i] = ws[i];
  return q;
}

// a plain QS as words of type W (zero tangents)
template <typename W>
PT_HD QSW<W> lift(const QS& a) {
  QSW<W> q;
#pragma unroll
  for (int i = 0; i < 4; ++i) q.w[i] = word<W>(a.w[i]);
  return q;
}

template <typename W>
PT_HD QSW<W> qs_neg(const QSW<W>& a) {
  QSW<W> q;
#pragma unroll
  for (int i = 0; i < 4; ++i) q.w[i] = -a.w[i];
  return q;
}

template <typename W>
PT_HD QSW<W> qs_add(const QSW<W>& a, const QSW<W>& b) {
  W s0, e0, s1, e1, s2, e2;
  two_sum(a.w[0], b.w[0], s0, e0);
  two_sum(a.w[1], b.w[1], s1, e1);
  two_sum(a.w[2], b.w[2], s2, e2);
  const W s3 = a.w[3] + b.w[3];
  W ws[7] = {s0, s1, e0, s2, e1, s3, e2};
  return renorm<7>(ws);
}

template <typename W>
PT_HD QSW<W> qs_add_w(const QSW<W>& q, float w) {
  W s0, s1, s2, s3, e;
  two_sum(q.w[0], w, s0, e);
  two_sum(q.w[1], e, s1, e);
  two_sum(q.w[2], e, s2, e);
  two_sum(q.w[3], e, s3, e);
  W ws[5] = {s0, s1, s2, s3, e};
  return renorm<5>(ws);
}

template <typename W>
PT_HD QSW<W> qs_mul_w(const QSW<W>& q, float w) {
  W p0, e0, p1, e1, p2, e2;
  two_prod(q.w[0], w, p0, e0);
  two_prod(q.w[1], w, p1, e1);
  two_prod(q.w[2], w, p2, e2);
  const W p3 = q.w[3] * w;
  W ws[7] = {p0, p1, e0, p2, e1, p3, e2};
  return renorm<7>(ws);
}

template <typename W>
PT_HD QSW<W> qs_mul(const QSW<W>& a, const QSW<W>& b) {
  W p00, e00, p01, e01, p10, e10, p02, e02, p11, e11, p20, e20;
  two_prod(a.w[0], b.w[0], p00, e00);
  two_prod(a.w[0], b.w[1], p01, e01);
  two_prod(a.w[1], b.w[0], p10, e10);
  two_prod(a.w[0], b.w[2], p02, e02);
  two_prod(a.w[1], b.w[1], p11, e11);
  two_prod(a.w[2], b.w[0], p20, e20);
  // order-3 terms: plain products (errors below 2^-96)
  const W t3 = (a.w[0] * b.w[3] + a.w[3] * b.w[0]) +
               (a.w[1] * b.w[2] + a.w[2] * b.w[1]);
  // order-4: below target precision but nearly free
  const W t4 = a.w[1] * b.w[3] + a.w[2] * b.w[2] + a.w[3] * b.w[1];
  W ws[14] = {p00, p01, p10, e00, p02, p11, p20,
              e01, e10, t3,  e02, e11, e20, t4};
  return renorm<14>(ws);
}

// pint_tpu.qs.from_f64_device: exact three-word split, then renormalize
// (x a double, or the float64 counterpart of W with its lanes)
template <typename W = float>
PT_HD QSW<W> qs_from_f64(typename Wide<W>::type x) {
  using D = typename Wide<W>::type;
  const W w0 = Wide<W>::narrow(x);
  const D r = x - Wide<W>::of(w0);
  const W w1 = Wide<W>::narrow(r);
  const D r2 = r - Wide<W>::of(w1);
  const W w2 = Wide<W>::narrow(r2);
  W ws[4] = {w0, w1, w2, word<W>(0.0f)};
  return renorm<4>(ws);
}

// pint_tpu.qs.to_f64: ((w0 + w1) + w2) + w3 in float64
template <typename W>
PT_HD typename Wide<W>::type qs_to_f64(const QSW<W>& q) {
  return Wide<W>::of(q.w[0]) + Wide<W>::of(q.w[1]) + Wide<W>::of(q.w[2]) +
         Wide<W>::of(q.w[3]);
}

// qs_to_f64's value alone
template <typename W>
PT_HD double qs_value(const QSW<W>& q) {
  return (double)wval(q.w[0]) + (double)wval(q.w[1]) +
         (double)wval(q.w[2]) + (double)wval(q.w[3]);
}

// pint_tpu.qs.round_nearest, fraction only (the integers carry no
// tangent)
template <typename W>
PT_HD QSW<W> qs_round_frac(QSW<W> r) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float nk = rintf(wval(r.w[0]));
    r = qs_add_w(r, -nk);
  }
  const double adj = rint(qs_value(r));
  return qs_add_w(r, -1.0f * (float)adj);
}

// pint_tpu.models.spindown.dt_seconds_qs without the shift: (t_TDB -
// epoch) * 86400 [s] as a QS, from the TOA's integer day and frac words
// and the epoch's integer day and frac words.
PT_HD QS dt_days_seconds_qs(int64_t tdb_day, const float* frac_w,
                            double day0, const float* epoch_w) {
  // exact f64 integer-day difference, then f32
  const float dday = (float)((double)tdb_day - day0);
  QS dt = {{dday, frac_w[0], frac_w[1], 0.0f}};
  dt = qs_add(dt, QS{{frac_w[2], 0.0f, 0.0f, 0.0f}});
  dt = qs_add(dt, qs_neg(QS{{epoch_w[0], epoch_w[1], epoch_w[2], epoch_w[3]}}));
  return qs_mul_w(dt, 86400.0f);
}

// pint_tpu.models.spindown.dt_seconds_qs: (t_TDB - epoch) * 86400 + shift
// [s] as a QS; shift [s] enters through from_f64.
PT_HD QS dt_seconds_qs(int64_t tdb_day, const float* frac_w, double day0,
                       const float* epoch_w, double shift) {
  return qs_add(dt_days_seconds_qs(tdb_day, frac_w, day0, epoch_w),
                qs_from_f64(shift));
}

}  // namespace ptqs
