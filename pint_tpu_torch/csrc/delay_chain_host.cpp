// The delay chain's row function (delay_chain.cuh) compiled for the host
// CPU, with the launch shapes of delay_chain.cu: one loop where the
// kernel has one thread.  Not part of the package's kernels: it lets a
// CPU test run the row function's arithmetic (every scalar type: double,
// Dual, DualN<2, 4>) against the plain PyTorch delays without a card
// or nvcc (tests/test_torch_delay_chain_host.py).  Build it without FMA
// contraction, as the kernels are, from the repository root:
//
//   g++ -std=c++17 -O1 -ffp-contract=off -shared -fPIC
//       -I pint_tpu_torch/csrc pint_tpu_torch/csrc/delay_chain_host.cpp
//       -o libdelay_chain_host.so
//
// (-O1 compiles the 28 template values in about half the time -O2 takes;
// the arithmetic is the same IEEE operations, without contraction.)

#include <stdint.h>

#include <vector>

#include "delay_chain.cuh"

namespace {

using ptchain::Dual;
using ptchain::DualN;
using ptchain::OrbCfg;
using ptchain::OrbRowData;
using ptchain::Theta;

template <int BIN, int L>
void tangent_lanes(const OrbRowData& rd, const double* theta,
                   const double* dtheta, const OrbCfg& c, int64_t G,
                   int64_t K, int64_t N, double* out) {
  const int P = c.P;
  std::vector<double> d((size_t)L * P);
  for (int64_t g = 0; g < G; ++g)
    for (int64_t k0 = 0; k0 < K; k0 += L) {
      // the block's L tangent rows, zero past K (the kernel's staging)
      for (int l = 0; l < L; ++l)
        for (int i = 0; i < P; ++i)
          d[(size_t)l * P + i] =
              k0 + l < K ? dtheta[((g * K) + k0 + l) * P + i] : 0.0;
      const Theta<DualN<L>> th{theta + g * P, d.data(), P};
      for (int64_t n = 0; n < N; ++n) {
        const DualN<L> t = ptchain::delay_row<DualN<L>, BIN>(
            c, th, ptchain::load_row_of<BIN>(rd, n), nullptr);
        for (int l = 0; l < L; ++l)
          if (k0 + l < K) out[(g * K + k0 + l) * N + n] = t.d[l];
      }
    }
}

template <int BIN>
int run(const OrbRowData& rd, const double* theta, const double* dtheta,
        const OrbCfg& c, int64_t G, int64_t K, int64_t N, int lpt,
        double* out) {
  const int P = c.P;
  if (dtheta == nullptr) {
    for (int64_t g = 0; g < G; ++g)
      for (int64_t n = 0; n < N; ++n)
        out[g * N + n] = ptchain::delay_row<double, BIN>(
            c, Theta<double>{theta + g * P}, ptchain::load_row_of<BIN>(rd, n),
            nullptr);
    return 0;
  }
  switch (lpt) {
    case 1:
      for (int64_t gk = 0; gk < G * K; ++gk)
        for (int64_t n = 0; n < N; ++n)
          out[gk * N + n] =
              ptchain::delay_row<Dual, BIN>(
                  c, Theta<Dual>{theta + (gk / K) * P, dtheta + gk * P},
                  ptchain::load_row_of<BIN>(rd, n), nullptr)
                  .d;
      return 0;
    case 2:
      tangent_lanes<BIN, 2>(rd, theta, dtheta, c, G, K, N, out);
      return 0;
    case 4:
      tangent_lanes<BIN, 4>(rd, theta, dtheta, c, G, K, N, out);
      return 0;
    default:
      return 1;
  }
}

template <int BIN>
int orbital_phase(const OrbRowData& rd, const double* theta, const OrbCfg& c,
                  int64_t G, int64_t N, double* out) {
  if constexpr ((BIN & 7) == ptchain::kNoBinary) {
    return 1;
  } else {
    for (int64_t g = 0; g < G; ++g)
      for (int64_t n = 0; n < N; ++n)
        out[g * N + n] = ptchain::delay_row<double, BIN, true>(
            c, Theta<double>{theta + g * c.P},
            ptchain::load_row_of<BIN>(rd, n), nullptr);
    return 0;
  }
}

}  // namespace

// delay_chain.cu's delay_chain_orbital_phase() on host memory, without
// the stream: out (G, N) the binary's fractional orbital phase.  Returns
// 0, or 1 on inputs the kernel would refuse (a layout without a binary
// among them).
extern "C" int delay_chain_orbital_phase_host(
    const int64_t* tdb_day, const double* tdb_frac, const float* frac_w,
    const double* pos, const double* sun, const double* freq,
    const int32_t* dmx, const int32_t* jbits, const int32_t* swx,
    const int32_t* fdmbits, const int32_t* fdjbits, const int32_t* cmx,
    const double* tropo, const double* planets, const int32_t* btpiece,
    const double* theta, double* out, OrbCfg cfg, int64_t G, int64_t N) {
  const OrbRowData rd{{{tdb_day, tdb_frac, frac_w, pos, sun, freq, dmx, jbits,
                        swx, fdmbits, fdjbits},
                       cmx,
                       tropo},
                      planets,
                      btpiece};
  if (G < 1 || N < 1 || cfg.P < 1 || out == nullptr ||
      !ptchain::rows_cover(cfg, rd))
    return 1;
  switch (ptchain::kernel_family(cfg)) {
#define PT_CASE(B) \
  case B:          \
    return orbital_phase<B>(rd, theta, cfg, G, N, out);
    PT_FAMILIES(PT_CASE)
#undef PT_CASE
    default:
      return 1;
  }
}

// delay_chain.cu's delay_chain() on host memory, without aux and stream:
// theta (G, P); dtheta null -> out (G, N) delay, else dtheta (G, K, P) ->
// out (G, K, N) tangent with `lpt` lanes per row pass.  Returns 0, or 1
// on inputs the kernel would refuse.
extern "C" int delay_chain_host(
    const int64_t* tdb_day, const double* tdb_frac, const float* frac_w,
    const double* pos, const double* sun, const double* freq,
    const int32_t* dmx, const int32_t* jbits, const int32_t* swx,
    const int32_t* fdmbits, const int32_t* fdjbits, const int32_t* cmx,
    const double* tropo, const double* planets, const int32_t* btpiece,
    const double* theta, const double* dtheta, double* out, OrbCfg cfg,
    int64_t G, int64_t K, int64_t N, int lpt) {
  const OrbRowData rd{{{tdb_day, tdb_frac, frac_w, pos, sun, freq, dmx, jbits,
                        swx, fdmbits, fdjbits},
                       cmx,
                       tropo},
                      planets,
                      btpiece};
  if (G < 1 || N < 1 || cfg.P < 1 || (dtheta != nullptr && K < 1) ||
      !ptchain::rows_cover(cfg, rd))
    return 1;
  switch (ptchain::kernel_family(cfg)) {
#define PT_CASE(B) \
  case B:          \
    return run<B>(rd, theta, dtheta, cfg, G, K, N, lpt, out);
    PT_FAMILIES(PT_CASE)
#undef PT_CASE
    default:
      return 1;
  }
}
