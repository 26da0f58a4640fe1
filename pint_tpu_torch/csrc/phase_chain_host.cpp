// The fused phase chain's row functions (phase_chain.cuh) compiled for
// the host CPU, with the launch shapes of phase_chain.cu: one loop where
// the kernel has one thread, the spin terms formed once where a kernel
// block forms them in shared memory.  Not part of the package's kernels:
// it lets a CPU test run the fused arithmetic (primal, words, and the
// tangent over Dual and DualN<2, 4>) against the unfused host chain and
// the plain PyTorch composition without a card or nvcc
// (tests/test_torch_phase_chain_host.py).  Build it without FMA
// contraction, as the kernels are, from the repository root:
//
//   g++ -std=c++17 -O1 -ffp-contract=off -shared -fPIC
//       -I pint_tpu_torch/csrc pint_tpu_torch/csrc/phase_chain_host.cpp
//       -o libphase_chain_host.so
//
// (-O1 compiles the 28 template values in about half the time -O2 takes;
// the arithmetic is the same IEEE operations, without contraction.)

#include <stdint.h>

#include <vector>

#include "phase_chain.cuh"

namespace {

using ptchain::ChainCfg;
using ptchain::Dual;
using ptchain::DualN;
using ptchain::RowData;
using ptchain::OrbCfg;
using ptchain::OrbRowData;
using ptchain::Theta;
using ptchain::load_row_of;
using ptphase::PhaseOut;
using ptphase::SpinTerms;
using ptphasechain::PhaseCfg;

struct Tangent {
  const double* slope;
  const double* dt64;
  const double* dother;
  int64_t dother_sg, dother_sk;
};

template <int BIN, int L>
void tangent_lanes(const OrbRowData& rd, const Tangent& td,
                   const double* theta, const double* dtheta,
                   const OrbCfg& c,
                   const PhaseCfg& pc, int64_t G, int64_t K, int64_t N,
                   double* out) {
  const int P = pc.P;
  std::vector<double> d((size_t)L * P);
  for (int64_t g = 0; g < G; ++g)
    for (int64_t k0 = 0; k0 < K; k0 += L) {
      // the block's L tangent rows, zero past K (the kernel's staging)
      for (int l = 0; l < L; ++l)
        for (int i = 0; i < P; ++i)
          d[(size_t)l * P + i] =
              k0 + l < K ? dtheta[((g * K) + k0 + l) * P + i] : 0.0;
      const int valid = K - k0 < L ? (int)(K - k0) : L;
      const Theta<DualN<L>> th{theta + g * P, d.data(), P};
      for (int64_t n = 0; n < N; ++n) {
        const ptphasechain::LaneOut<L> t =
            ptphasechain::tangent_row<BIN, DualN<L>>(
                c, pc, th, load_row_of<BIN>(rd, n), td.slope + g * N + n,
                td.dt64 + g * N + n,
                td.dother != nullptr
                    ? td.dother + g * td.dother_sg + k0 * td.dother_sk + n
                    : nullptr,
                td.dother_sk, valid);
        for (int l = 0; l < valid; ++l)
          out[(g * K + k0 + l) * N + n] = t.d[l];
      }
    }
}

template <int BIN>
int run(const OrbRowData& rd, const double* pulse_number,
        const double* pep_day, const float* pep_w, const float* f_w, const float* tzr_w,
        const double* other, int64_t other_sg, const Tangent& td,
        const double* theta, const double* dtheta, const OrbCfg& c,
        const PhaseCfg& pc, int64_t G, int64_t K, int64_t N, int lpt,
        double* out, float* words, double* slope, double* dt64) {
  const int P = pc.P;
  if (dtheta == nullptr) {
    SpinTerms spin;
    for (int k = 0; k <= pc.K; ++k) ptphase::spin_term(spin, f_w, pc.K, k);
    for (int64_t g = 0; g < G; ++g)
      for (int64_t n = 0; n < N; ++n) {
        const int64_t row = g * N + n;
        const PhaseOut o = ptphasechain::primal_row<BIN>(
            c, pc, theta + g * P, load_row_of<BIN>(rd, n), spin, pep_day[0],
            pep_w, tzr_w, other != nullptr,
            other != nullptr ? other[g * other_sg + n] : 0.0,
            pc.mode == ptphase::kPulseNumbers ? pulse_number[n] : 0.0);
        slope[row] = o.slope;
        dt64[row] = o.dt64;
        if (pc.mode == ptphase::kWords) {
          for (int i = 0; i < 4; ++i) words[4 * row + i] = o.words[i];
        } else {
          out[row] = o.out;
        }
      }
    return 0;
  }
  switch (lpt) {
    case 1:
      for (int64_t gk = 0; gk < G * K; ++gk) {
        const int64_t g = gk / K, k = gk - g * K;
        const Theta<Dual> th{theta + g * P, dtheta + gk * P};
        for (int64_t n = 0; n < N; ++n)
          out[gk * N + n] =
              ptphasechain::tangent_row<BIN, Dual>(
                  c, pc, th, load_row_of<BIN>(rd, n), td.slope + g * N + n,
                  td.dt64 + g * N + n,
                  td.dother != nullptr
                      ? td.dother + g * td.dother_sg + k * td.dother_sk + n
                      : nullptr,
                  td.dother_sk, 1)
                  .d[0];
      }
      return 0;
    case 2:
      tangent_lanes<BIN, 2>(rd, td, theta, dtheta, c, pc, G, K, N, out);
      return 0;
    case 4:
      tangent_lanes<BIN, 4>(rd, td, theta, dtheta, c, pc, G, K, N, out);
      return 0;
    default:
      return 1;
  }
}

}  // namespace

// phase_chain.cu's phase_chain() on host memory, without the stream.
// Returns 0, or 1 on inputs the kernel would refuse.
extern "C" int phase_chain_host(
    const int64_t* tdb_day, const double* tdb_frac, const float* frac_w,
    const double* pos, const double* sun, const double* freq,
    const int32_t* dmx, const int32_t* jbits, const int32_t* swx,
    const int32_t* fdmbits, const int32_t* fdjbits, const int32_t* cmx,
    const double* tropo, const double* planets, const int32_t* btpiece,
    const double* pulse_number,
    const double* pep_day, const float* pep_w, const float* f_w,
    const float* tzr_w, const double* theta, const double* dtheta,
    const double* other, const double* dother, const double* slope_in,
    const double* dt64_in, double* out, float* words, double* slope,
    double* dt64, OrbCfg cfg, PhaseCfg pc, int64_t G, int64_t K, int64_t N,
    int64_t other_sg, int64_t dother_sg, int64_t dother_sk, int lpt) {
  const bool tangent = dtheta != nullptr;
  const OrbRowData rd{{{tdb_day, tdb_frac, frac_w, pos, sun, freq, dmx, jbits,
                        swx, fdmbits, fdjbits},
                       cmx,
                       tropo},
                      planets,
                      btpiece};
  if (G < 1 || N < 1 || cfg.P < 1 || pc.K < 1 ||
      pc.K > ptphase::kMaxTerms || pc.o_spin < cfg.P ||
      pc.o_spin + pc.K > pc.P || pc.o_pep < pc.o_spin + pc.K ||
      pc.o_pep >= pc.P || pc.mode < 0 || pc.mode > 2 ||
      !ptchain::rows_cover(cfg, rd) ||
      (tangent && (K < 1 || slope_in == nullptr || dt64_in == nullptr ||
                   out == nullptr)) ||
      (!tangent && (slope == nullptr || dt64 == nullptr ||
                    (pc.mode == ptphase::kWords ? words == nullptr
                                                : out == nullptr) ||
                    (pc.mode == ptphase::kPulseNumbers &&
                     pulse_number == nullptr))))
    return 1;
  const Tangent td{slope_in, dt64_in, dother, dother_sg, dother_sk};
  switch (ptchain::kernel_family(cfg)) {
#define PT_CASE(B)                                                          \
  case B:                                                                   \
    return run<B>(rd, pulse_number, pep_day, pep_w, f_w, tzr_w, other,      \
                  other_sg, td, theta, dtheta, cfg, pc, G, K, N, lpt, out,  \
                  words, slope, dt64);
    PT_FAMILIES(PT_CASE)
#undef PT_CASE
    default:
      return 1;
  }
}
