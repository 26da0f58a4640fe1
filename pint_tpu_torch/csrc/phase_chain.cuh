// The phase chain of one TOA row: the delay chain's row function
// (delay_chain.cuh), the spin phase's shift, and the quad-single phase
// row (qs_phase.cuh) as its epilogue; and the same row's forward-mode
// tangents of the fractional phase.  Shared by the kernels of
// phase_chain.cu and their host build, phase_chain_host.cpp.
//
// theta of the fused chain is the delay chain's theta (ChainLayout.theta,
// slots [0, ChainCfg.P)) followed by the K spin offsets dF_0..dF_{K-1}
// (slot o_spin) and the PEPOCH offset [days] (slot o_pep).  Per row, in
// the operation order of the unfused chain (K4, PyTorch's shift, K3), so
// that every output is bit-equal to it:
//   delay   = delay_row(theta)                         (K4's row function)
//   shift   = (-delay) - (dPEPOCH * 86400)            (Spindown.kernel_inputs)
//   phase   = phase_row(shift, dF, other, TZR, mode)  (K3's row function)
// and, per tangent lane, the word-level tangent of QSPhaseFrac.jvp
// (pint_tpu_torch.models.spindown.phase_frac_jvp) on the delay's tangent
// (DualN<L> or Dual): the shift with its lanes,
//   shift   = (-delay) - (dPEPOCH * 86400),
// then qs_phase.cuh phase_row_tangent, the phase row again over float32
// words that carry the lanes' tangents (qs.cuh F32N<L>), with the offsets
// dF_k and `other` entering with their lanes as their values do.  The
// tangent launch recomputes the row's words: it reads no output of the
// primal launch.
//
// The template values that carry kPhaseFamily add, right after the delay,
// the phase family: the phase components that read the delay (Glitch,
// PiecewiseSpindown, Wave, IFunc; pint_tpu/models/glitch.py,
// piecewise.py, wave.py, ifunc.py), whose plain versions are their
// phase_f64 in pint_tpu_torch/models.  Their slots follow the PEPOCH
// offset in theta (PhCfg), and their float64 sum `fam` joins the phase
// components that PyTorch sums (the phase JUMPs, PHOFF) as the plain
// composition sums them, other = fam + other (kernels/phase_chain.py
// _other_phase), in value and in each lane's tangent:
//   fam     = (((0 + glitches) + groups) + waves) + ifunc
//   d other = d fam [+ d other].
//
// Plain C++ under PT_HD, so that g++ builds it for the host as nvcc does
// for the card; both without FMA contraction (qs.cuh).

#pragma once

#include <math.h>
#include <stdint.h>

#include "delay_chain.cuh"
#include "qs_phase.cuh"

// the float64 counterpart of a word with L lanes: DualN<L>
namespace ptqs {
template <int L>
struct Wide<F32N<L>> {
  using type = ptchain::DualN<L>;
  PT_HD static type of(const F32N<L>& w) {
    type r;
    r.v = (double)w.v;
#pragma unroll
    for (int l = 0; l < L; ++l) r.d[l] = (double)w.d[l];
    return r;
  }
  PT_HD static F32N<L> narrow(const type& x) {
    F32N<L> r;
    r.v = (float)x.v;
#pragma unroll
    for (int l = 0; l < L; ++l) r.d[l] = (float)x.d[l];
    return r;
  }
};
}  // namespace ptqs

namespace ptphasechain {

using ptchain::CfgOf;
using ptchain::ChainCfg;
using ptchain::Dual;
using ptchain::DualN;
using ptchain::Row;
using ptchain::RowOf;
using ptchain::Theta;
using ptphase::PhaseOut;
using ptphase::SpinTerms;

// the phase's part of the fused layout (kernels/phase_chain.py PhaseCfg)
struct PhaseCfg {
  int32_t K;       // spin terms F0..F_{K-1}
  int32_t o_spin;  // theta slot of dF_0
  int32_t o_pep;   // theta slot of the PEPOCH offset [days]
  int32_t P;       // the fused theta's length
  int32_t mode;    // ptphase::kNearest, kPulseNumbers, kWords
};

constexpr double kSecsPerDay = 86400.0;

// the number of points of x[0..k) that are <= v (right) or < v (left):
// torch.searchsorted's index, by bisection
PT_HD int search_sorted(const double* x, int k, double v, bool right) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (right ? x[mid] <= v : x[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The phase family's float64 phase [cycles] of one row, given the row's
// delay d [s]: each component's sum in its phase_f64's operation order,
// the components summed in DEFAULT_ORDER from 0.
template <typename T, int BIN>
PT_HD T phase_family_row(const CfgOf<BIN>& c, const Theta<T>& th,
                         const RowOf<BIN>& r, const T& d) {
  using ptchain::make;
  using ptchain::val;
  const double t = (double)r.day + r.frac;
  T fam = make<T>(0.0);
  if (c.ngl > 0) {
    // Glitch: the dt > 0 gate, and the recovery's safe tau
    T total = make<T>(0.0);
    for (int i = 0; i < c.ngl; ++i) {
      const int o = c.o_gl + ptchain::glSlots * i;
      const T dt = (t - th[o + ptchain::glDay]) * kSecsPerDay - d;
      if (!(val(dt) > 0.0)) {
        total = total + 0.0;
        continue;
      }
      const T dph =
          th[o + ptchain::glPH] +
          dt * (th[o + ptchain::glF0] +
                dt / 2.0 * (th[o + ptchain::glF1] +
                            dt / 3.0 * th[o + ptchain::glF2]));
      const T tau = th[o + ptchain::glTD] * kSecsPerDay;
      if (val(tau) > 0.0) {
        const T decay = th[o + ptchain::glF0D] * tau *
                        (1.0 - ptchain::f_exp(-dt / tau));
        total = total + (dph + decay);
      } else {
        total = total + (dph + 0.0);
      }
    }
    fam = fam + total;
  }
  if (c.npw > 0) {
    // PiecewiseSpindown: each group whose window holds the row
    T total = make<T>(0.0);
    for (int i = 0; i < c.npw; ++i) {
      if (!((r.pwbits >> i) & 1)) continue;
      const int o = c.o_pw + ptchain::pwSlots * i;
      const T dt = (t - th[o + ptchain::pwDay]) * kSecsPerDay - d;
      total = total + (th[o + ptchain::pwPH] +
                       dt * (th[o + ptchain::pwF0] +
                             dt / 2.0 * (th[o + ptchain::pwF1] +
                                         dt / 3.0 * th[o + ptchain::pwF2])));
    }
    fam = fam + total;
  }
  if (c.nwave > 0) {
    // Wave: F0 sum_k [A_k sin(k OM dt) + B_k cos(k OM dt)]
    const T dt_day = (t - th[c.o_wave + ptchain::waveDay]) - d / kSecsPerDay;
    const T base = th[c.o_wave + ptchain::waveOM] * dt_day;
    const double* ab = r.fconst + c.c_wave;
    T times = make<T>(0.0);
    for (int k = 0; k < c.nwave; ++k) {
      const T arg = (double)(k + 1) * base;
      T sn, cs;
      ptchain::f_sincos(arg, sn, cs);
      times = times + ab[2 * k] * sn + ab[2 * k + 1] * cs;
    }
    fam = fam + times * th[c.o_f0];
  }
  if (c.nif > 0) {
    // IFunc: SIFUNC 0 the nearest preceding point, 2 linear and clamped
    const double* x = r.fconst + c.c_if;
    const double* y = x + c.nif;
    const int last = c.nif - 1;
    const T ts = t - d / kSecsPerDay;
    T times;
    if (c.sifunc == 0) {
      int i = search_sorted(x, c.nif, val(ts), true) - 1;
      i = i < 0 ? 0 : (i > last ? last : i);
      times = make<T>(y[i]);
    } else {
      int i = search_sorted(x, c.nif, val(ts), false);
      i = i < 1 ? 1 : i;  // torch.clamp(i, 1, last): the lower bound,
      i = i > last ? last : i;  // then the upper (0 where nif is 1)
      const int i0 = i == 0 ? last : i - 1;  // y[-1] where nif is 1
      const T w = ptchain::clamp2((ts - x[i0]) / (x[i] - x[i0]), 0.0, 1.0);
      times = y[i0] * (1.0 - w) + y[i] * w;
    }
    fam = fam + times * th[c.o_f0];
  }
  return fam;
}

// whether the phase family's slots lie after the PEPOCH offset, inside
// the fused theta (a layout without the family has none)
PT_HD bool family_fits(const ptchain::PhCfg& c, const PhaseCfg& pc) {
  if (!(c.flags & ptchain::kPhaseTerms))
    return c.ngl == 0 && c.npw == 0 && c.nwave == 0 && c.nif == 0;
  const int lo = pc.o_pep + 1;
  return !((c.nwave > 0 || c.nif > 0) && (c.o_f0 < lo || c.o_f0 >= pc.P)) &&
         !(c.ngl > 0 && (c.o_gl < lo ||
                         c.o_gl + ptchain::glSlots * c.ngl > pc.P)) &&
         !(c.npw > 0 && (c.o_pw < lo ||
                         c.o_pw + ptchain::pwSlots * c.npw > pc.P)) &&
         !(c.nwave > 0 && (c.o_wave < lo || c.o_wave + 2 > pc.P));
}

// the delay chain's template value of BIN (the phase family is no delay)
template <int BIN>
constexpr int kDelayBin = BIN & ~ptchain::kPhaseFamily;

// One row of the primal: theta is the row's theta set (pc.P slots).
template <int BIN>
PT_HD PhaseOut primal_row(const CfgOf<BIN>& c, const PhaseCfg& pc,
                          const double* theta, const RowOf<BIN>& r,
                          const SpinTerms& s, double pep_day,
                          const float* pep_w, const float* tzr_w,
                          bool has_other, double other, double pn) {
  const double d = ptchain::delay_row<double, kDelayBin<BIN>>(
      c, Theta<double>{theta}, r, nullptr);
  if constexpr ((BIN & ptchain::kPhaseFamily) != 0) {
    const double fam =
        phase_family_row<double, BIN>(c, Theta<double>{theta}, r, d);
    other = has_other ? fam + other : fam;
    has_other = true;
  }
  const double shift = (-d) - (theta[pc.o_pep] * kSecsPerDay);
  return ptphase::phase_row(r.day, r.frac_w, pep_day, pep_w, s, pc.K,
                            theta + pc.o_spin, shift, has_other, other,
                            tzr_w, pc.mode, pn);
}

// the lanes of a tangent number type, and lane l's tangent of theta slot i
template <typename T>
struct Lanes;
template <>
struct Lanes<Dual> {
  static constexpr int L = 1;
  PT_HD static double d(const Dual& x, int) { return x.d; }
  PT_HD static double dtheta(const Theta<Dual>& th, int, int i) {
    return th.d[i];
  }
};
template <int L_>
struct Lanes<DualN<L_>> {
  static constexpr int L = L_;
  PT_HD static double d(const DualN<L_>& x, int l) { return x.d[l]; }
  PT_HD static double dtheta(const Theta<DualN<L_>>& th, int l, int i) {
    return th.d[l * th.P + i];
  }
};

template <int L>
struct LaneOut {
  double d[L];
};

// a tangent number as DualN lanes (Dual is one lane)
PT_HD DualN<1> as_lanes(const Dual& x) {
  DualN<1> r;
  r.v = x.v;
  r.d[0] = x.d;
  return r;
}
template <int L>
PT_HD const DualN<L>& as_lanes(const DualN<L>& x) {
  return x;
}

// the phase's row inputs that are not the delay chain's: PEPOCH, the TZR
// words, the mode, the row's pulse number and the primal's `other`
struct PhaseRowIn {
  double pep_day;
  const float* pep_w;
  const float* tzr_w;
  int mode;
  double pn;
  bool has_other;
  double other;
};

// One row's d frac along the lanes of T (the first `valid` of them): the
// delay's tangents (K4's row function over T), the shift, and
// phase_row_tangent over words with the lanes' tangents; dother, if not
// null, lane l's tangent of `other` at dother[l * dother_sk].
template <int BIN, typename T>
PT_HD LaneOut<Lanes<T>::L> tangent_row(const CfgOf<BIN>& c,
                                       const PhaseCfg& pc,
                                       const Theta<T>& th,
                                       const RowOf<BIN>& r,
                                       const SpinTerms& s,
                                       const PhaseRowIn& in,
                                       const double* dother,
                                       int64_t dother_sk, int valid) {
  constexpr int L = Lanes<T>::L;
  using D = DualN<L>;
  using W = ptqs::F32N<L>;
  const T delay = ptchain::delay_row<T, kDelayBin<BIN>>(c, th, r, nullptr);
  const D d = as_lanes(delay);
  bool has_other = in.has_other;
  D other;
  other.v = in.other;
#pragma unroll
  for (int l = 0; l < L; ++l)
    other.d[l] = dother != nullptr && l < valid ? dother[l * dother_sk] : 0.0;
  if constexpr ((BIN & ptchain::kPhaseFamily) != 0) {
    const D fam = as_lanes(phase_family_row<T, BIN>(c, th, r, delay));
    D sum;
    sum.v = has_other ? fam.v + in.other : fam.v;
#pragma unroll
    for (int l = 0; l < L; ++l)
      sum.d[l] = dother != nullptr && l < valid ? fam.d[l] + other.d[l]
                                                : fam.d[l];
    other = sum;
    has_other = true;
  }
  const D shift = (-d) - (as_lanes(th[pc.o_pep]) * kSecsPerDay);
  const D frac = ptphase::phase_row_tangent<W>(
      r.day, r.frac_w, in.pep_day, in.pep_w, s, pc.K,
      [&](int k) { return as_lanes(th[pc.o_spin + k]); }, shift, has_other,
      other, in.tzr_w, in.mode, in.pn);
  LaneOut<L> o;
#pragma unroll
  for (int l = 0; l < L; ++l) o.d[l] = frac.d[l];
  return o;
}

}  // namespace ptphasechain
