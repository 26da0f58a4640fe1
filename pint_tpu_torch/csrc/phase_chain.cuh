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
// and, per tangent lane, QSPhaseFrac.jvp's arithmetic in its order on the
// delay's tangent (DualN<L> or Dual) and the primal's slope and dt64:
//   dshift  = (-d delay) - (d dPEPOCH * 86400)
//   dfrac   = ((0 + slope dshift) + sum_k pk d dF_k) [+ d other],
//             pk = dt^{k+1} / (k+1)! formed as pk <- pk dt64 / (k + 2).
//
// Plain C++ under PT_HD, so that g++ builds it for the host as nvcc does
// for the card; both without FMA contraction (qs.cuh).

#pragma once

#include <math.h>
#include <stdint.h>

#include "delay_chain.cuh"
#include "qs_phase.cuh"

namespace ptphasechain {

using ptchain::ChainCfg;
using ptchain::Dual;
using ptchain::DualN;
using ptchain::Row;
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

// One row of the primal: theta is the row's theta set (pc.P slots).
template <int BIN>
PT_HD PhaseOut primal_row(const ChainCfg& c, const PhaseCfg& pc,
                          const double* theta, const Row& r,
                          const SpinTerms& s, double pep_day,
                          const float* pep_w, const float* tzr_w,
                          bool has_other, double other, double pn) {
  const double d = ptchain::delay_row<double, BIN>(c, Theta<double>{theta},
                                                  r, nullptr);
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

// One row's d frac along the lanes of T (the first `valid` of them):
// *slope and *dt64 are the primal's at this row and theta set, read only
// once the delay's tangents are formed (so that they are not live across
// the delay row); dother, if not null, lane l's tangent of `other` at
// dother[l * dother_sk].
template <int BIN, typename T>
PT_HD LaneOut<Lanes<T>::L> tangent_row(const ChainCfg& c, const PhaseCfg& pc,
                                       const Theta<T>& th, const Row& r,
                                       const double* slope_p,
                                       const double* dt64_p,
                                       const double* dother,
                                       int64_t dother_sk, int valid) {
  using LT = Lanes<T>;
  const T d = ptchain::delay_row<T, BIN>(c, th, r, nullptr);
  const double slope = *slope_p, dt64 = *dt64_p;
  LaneOut<LT::L> o;
#pragma unroll
  for (int l = 0; l < LT::L; ++l) {
    const double dshift =
        (-LT::d(d, l)) - (LT::dtheta(th, l, pc.o_pep) * kSecsPerDay);
    o.d[l] = 0.0 + slope * dshift;
  }
  // each lane's terms in QSPhaseFrac.jvp's order; pk depends on the row
  // alone, so it is formed once for the thread's lanes
  double pk = dt64;
  for (int k = 0; k < pc.K; ++k) {
#pragma unroll
    for (int l = 0; l < LT::L; ++l)
      o.d[l] = o.d[l] + pk * LT::dtheta(th, l, pc.o_spin + k);
    pk = pk * dt64 / (k + 2.0);
  }
  if (dother != nullptr) {
#pragma unroll
    for (int l = 0; l < LT::L; ++l)
      if (l < valid) o.d[l] = o.d[l] + dother[l * dother_sk];
  }
  return o;
}

}  // namespace ptphasechain
