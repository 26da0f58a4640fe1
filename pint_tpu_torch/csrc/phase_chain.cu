// phase_chain: the pulse phase of a timing model (K3) as the epilogue of
// its delay chain (K4), for every (theta set, TOA) row, and its
// forward-mode tangents, for NVIDIA Hopper (sm_90a).
//
// Replaces, fused into one primal and one tangent launch per residual
// evaluation, the JAX functions of pint_tpu that the delay_chain and
// qs_phase_frac kernels replace one by one (no Pallas kernel there):
//   K4  the delay chain (delay_chain.cuh lists them, file by file)
//   K3  pint_tpu/models/spindown.py  dt_seconds_qs + Spindown.phase
//       pint_tpu/models/timing_model.py  PhaseCalc.phase (TZR subtraction)
//       pint_tpu/residuals.py  raw_phase_resids ("nearest" rounding)
// and, in the template values with kPhaseFamily, the phase components
// that read the delay (phase_chain.cuh phase_family_row):
//       pint_tpu/models/glitch.py  Glitch.phase
//       pint_tpu/models/piecewise.py  PiecewiseSpindown.phase
//       pint_tpu/models/wave.py  Wave.phase;  ifunc.py  IFunc.phase
// Its plain PyTorch version is the unfused composition on the CPU
// (PhaseCalc.delay_plain, the shift, phase_frac_plain with
// QSPhaseFrac's word-level tangent rule); the wrapper is
// pint_tpu_torch/kernels/phase_chain.py.
//
// Entry points (phase_chain.cuh has the row functions and the layout):
//   primal:  frac[g, n] (or the four words), slope[g, n], dt64[g, n]
//   tangent: dfrac[g, k, n] = d frac(theta[g], row n) . dtheta[g, k]
// with theta (G, P) and dtheta (G, K, P), P = the delay chain's slots +
// K spin offsets + the PEPOCH offset [+ the phase family's slots].
//
// What it removes.  Unfused, a residual evaluation is K4's launch (the
// delay written to memory), PyTorch's shift (elementwise launches), K3's
// launch (the shift read back), and under jacfwd K4's tangent launch
// writing (G, lanes, N) delay tangents (68.4 MB at the grid's 9 x 76 x
// 12,500) that the shift's forward rule and QSPhaseFrac.jvp then pass
// over, one elementwise launch per term.  Fused, the delay and its
// tangents stay in registers: the primal launch writes frac, slope and
// dt64, the tangent launch recomputes the row's quad-single words with
// their lanes' tangents and writes d frac only.
//
// What bounds it.  The primal launch does the delay row (~350-400
// float64 and ~590 float32 operations per row, K4) and the phase row
// (~2.3k float32, K3) per (theta set, row) against ~140 bytes of row
// data: operations.  The tangent launch is K4's tangent launch plus the
// phase row again over float32 words that carry each lane's tangent
// (qs.cuh F32N<L>: the row's ~2.3k float32 operations once, and as many
// again for each lane) and 8 bytes written per lane and row: operations
// at the tens of lanes of a fit's jacfwd.  The phase family
// adds per row ~15 float64 operations and an exp per glitch, ~10 per
// group, a sincos and ~8 per WAVE harmonic and a bisection over the IFUNC
// points (its constants read from a buffer that every row shares):
// operations too.
//
// The design is K4's launch shapes (delay_chain.cu): the primal one
// thread per (theta set, row), registers only, each block first forming
// the row-independent spin terms in shared memory; the tangent one
// thread per (theta set, row, block of L lanes) over DualN<L>, one block
// per (theta set, lane block, 64 rows) staging theta[g] and its L dtheta
// rows in shared memory, and the spin terms as the primal does.  L = 1 is
// the single-lane Dual kernel, kept as the reference the others are held
// bit-equal to.  The tangent launch reads nothing the primal wrote: it
// forms the shift with its lanes and the phase row's words again, and
// pint_tpu's word-level tangent from them (a young pulsar's F1 makes
// that tangent the float32 rounding of the instantaneous frequency, not
// linear in the shift's, so no float64 slope of the primal's meets it).
//
// Built with --fmad=false, as qs.cuh requires, and never --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase_chain.cuh"

namespace {

using ptchain::CfgOf;
using ptchain::ChainCfg;
using ptchain::Dual;
using ptchain::DualN;
using ptchain::RowData;
using ptchain::RowDataOf;
using ptchain::PhCfg;
using ptchain::PhRowData;
using ptchain::Theta;
using ptchain::load_row_of;
using ptphase::PhaseOut;
using ptphase::SpinTerms;
using ptphasechain::PhaseCfg;

// the phase's inputs that are not the delay chain's
struct PhaseData {
  const double* __restrict__ pulse_number;  // (N,), mode kPulseNumbers
  const double* __restrict__ pep_day;       // PEPOCH's integer day
  const float* __restrict__ pep_w;          // its four frac words
  const float* __restrict__ f_w;            // (K, 4) F words
  const float* __restrict__ tzr_w;          // TZR words, or null
  const double* __restrict__ other;         // (G, N) rows, or null
  int64_t other_sg;                         // other's theta-set stride
};

template <int BIN>
__global__ void phase_chain_primal(RowDataOf<BIN> rd, PhaseData ph,
                                   const double* __restrict__ theta,
                                   CfgOf<BIN> c, PhaseCfg pc, int64_t G,
                                   int64_t N, double* __restrict__ out,
                                   float* __restrict__ words,
                                   double* __restrict__ slope,
                                   double* __restrict__ dt64) {
  __shared__ SpinTerms spin;
  if ((int)threadIdx.x <= pc.K)
    ptphase::spin_term(spin, ph.f_w, pc.K, threadIdx.x);
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= G * N) return;
  const int64_t g = row / N;
  const int64_t n = row - g * N;
  const PhaseOut o = ptphasechain::primal_row<BIN>(
      c, pc, theta + g * pc.P, load_row_of<BIN>(rd, n), spin, ph.pep_day[0],
      ph.pep_w, ph.tzr_w, ph.other != nullptr,
      ph.other != nullptr ? ph.other[g * ph.other_sg + n] : 0.0,
      pc.mode == ptphase::kPulseNumbers ? ph.pulse_number[n] : 0.0);
  slope[row] = o.slope;
  dt64[row] = o.dt64;
  if (pc.mode == ptphase::kWords) {
#pragma unroll
    for (int i = 0; i < 4; ++i) words[4 * row + i] = o.words[i];
  } else {
    out[row] = o.out;
  }
}

// d other by strides, for the tangent launch
struct TangentData {
  const double* __restrict__ dother;  // (G, K, N) by strides, or null
  int64_t dother_sg, dother_sk;
};

// the phase's row inputs of theta set g, row n
__device__ __forceinline__ ptphasechain::PhaseRowIn phase_in(
    const PhaseData& ph, const PhaseCfg& pc, int64_t g, int64_t n) {
  return {ph.pep_day[0],
          ph.pep_w,
          ph.tzr_w,
          pc.mode,
          pc.mode == ptphase::kPulseNumbers ? ph.pulse_number[n] : 0.0,
          ph.other != nullptr,
          ph.other != nullptr ? ph.other[g * ph.other_sg + n] : 0.0};
}

template <int BIN>
__global__ void phase_chain_tangent(RowDataOf<BIN> rd, PhaseData ph,
                                    TangentData td,
                                    const double* __restrict__ theta,
                                    const double* __restrict__ dtheta,
                                    CfgOf<BIN> c, PhaseCfg pc, int K,
                                    int64_t G, int64_t N,
                                    double* __restrict__ tangent) {
  __shared__ SpinTerms spin;
  if ((int)threadIdx.x <= pc.K)
    ptphase::spin_term(spin, ph.f_w, pc.K, threadIdx.x);
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= G * K * N) return;
  const int64_t gk = row / N;
  const int64_t n = row - gk * N;
  const int64_t g = gk / K, k = gk - g * K;
  const Theta<Dual> th{theta + g * pc.P, dtheta + gk * pc.P};
  tangent[row] =
      ptphasechain::tangent_row<BIN, Dual>(
          c, pc, th, load_row_of<BIN>(rd, n), spin, phase_in(ph, pc, g, n),
          td.dother != nullptr
              ? td.dother + g * td.dother_sg + k * td.dother_sk + n
              : nullptr,
          td.dother_sk, 1)
          .d[0];
}

constexpr int kTangentThreads = 64;
// blocks per SM that each lane width asks the compiler to fit
// (registers per thread <= 65536 / (64 * blocks)), as delay_chain.cu
template <int L>
constexpr int kMinBlocks = L == 4 ? 8 : 1;

template <int BIN, int L>
__global__ void __launch_bounds__(kTangentThreads, kMinBlocks<L>)
    phase_chain_tangent_lanes(RowDataOf<BIN> rd, PhaseData ph,
                              TangentData td,
                              const double* __restrict__ theta,
                              const double* __restrict__ dtheta, CfgOf<BIN> c,
                              PhaseCfg pc, int K, int64_t N,
                              double* __restrict__ tangent) {
  // theta[g] (P), then the block's L tangent rows (L, P), zero past K;
  // and the spin terms
  extern __shared__ double sh[];
  __shared__ SpinTerms spin;
  if ((int)threadIdx.x <= pc.K)
    ptphase::spin_term(spin, ph.f_w, pc.K, threadIdx.x);
  const int P = pc.P;
  const int64_t g = blockIdx.z;
  const int k0 = blockIdx.y * L;
  for (int i = threadIdx.x; i < (L + 1) * P; i += blockDim.x) {
    double x;
    if (i < P) {
      x = theta[g * P + i];
    } else {
      const int l = (i - P) / P;
      x = k0 + l < K ? dtheta[(g * K + k0 + l) * P + (i - P - l * P)] : 0.0;
    }
    sh[i] = x;
  }
  __syncthreads();
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int valid = K - k0 < L ? K - k0 : L;
  const Theta<DualN<L>> th{sh, sh + P, P};
  const ptphasechain::LaneOut<L> t =
      ptphasechain::tangent_row<BIN, DualN<L>>(
          c, pc, th, load_row_of<BIN>(rd, n), spin, phase_in(ph, pc, g, n),
          td.dother != nullptr
              ? td.dother + g * td.dother_sg + k0 * td.dother_sk + n
              : nullptr,
          td.dother_sk, valid);
#pragma unroll
  for (int l = 0; l < L; ++l)
    if (l < valid) tangent[(g * K + k0 + l) * N + n] = t.d[l];
}

template <int BIN, int L>
cudaError_t launch_lanes(const RowDataOf<BIN>& rd, const PhaseData& ph,
                         const TangentData& td,
                         const double* theta, const double* dtheta,
                         const CfgOf<BIN>& c, const PhaseCfg& pc, int K,
                         int64_t G, int64_t N, double* out,
                         cudaStream_t stream) {
  const int64_t lane_blocks = (K + L - 1) / L;
  if (G > 65535 || lane_blocks > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * (L + 1) * (size_t)pc.P;
  auto kernel = phase_chain_tangent_lanes<BIN, L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 blocks((unsigned)((N + kTangentThreads - 1) / kTangentThreads),
                    (unsigned)lane_blocks, (unsigned)G);
  kernel<<<blocks, kTangentThreads, smem, stream>>>(rd, ph, td, theta,
                                                    dtheta, c, pc, K, N, out);
  return cudaSuccess;
}

template <int BIN>
cudaError_t launch(const RowDataOf<BIN>& rd, const PhaseData& ph,
                   const TangentData& td, const double* theta,
                   const double* dtheta, const CfgOf<BIN>& c,
                   const PhaseCfg& pc, int K, int lpt, int64_t G, int64_t N,
                   double* out, float* words, double* slope, double* dt64,
                   cudaStream_t stream) {
  const int threads = 128;
  if (dtheta == nullptr) {
    const unsigned blocks = (unsigned)((G * N + threads - 1) / threads);
    phase_chain_primal<BIN><<<blocks, threads, 0, stream>>>(
        rd, ph, theta, c, pc, G, N, out, words, slope, dt64);
    return cudaSuccess;
  }
  switch (lpt) {
    case 1: {
      const unsigned blocks =
          (unsigned)((G * K * N + threads - 1) / threads);
      phase_chain_tangent<BIN><<<blocks, threads, 0, stream>>>(
          rd, ph, td, theta, dtheta, c, pc, K, G, N, out);
      return cudaSuccess;
    }
    case 2:
      return launch_lanes<BIN, 2>(rd, ph, td, theta, dtheta, c, pc, K, G, N,
                                  out, stream);
    case 4:
      return launch_lanes<BIN, 4>(rd, ph, td, theta, dtheta, c, pc, K, G, N,
                                  out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// launch<BIN> where this library holds BIN (a build in parts holds some
// template values: kernels/build.py part_of picks the library)
template <int BIN>
cudaError_t launch_part(const PhRowData& rd, const PhaseData& ph,
                        const TangentData& td, const double* theta,
                        const double* dtheta, const PhCfg& c,
                        const PhaseCfg& pc, int K, int lpt, int64_t G,
                        int64_t N, double* out, float* words, double* slope,
                        double* dt64, cudaStream_t stream) {
  if constexpr (ptchain::in_part(BIN))
    return launch<BIN>(rd, ph, td, theta, dtheta, c, pc, K, lpt, G, N, out,
                       words, slope, dt64, stream);
  else
    return cudaErrorNotSupported;
}

}  // namespace

// One launch.  theta is (G, P) float64 in the fused layout (cfg: the
// delay chain's part, pc: the phase's).  With dtheta == nullptr the
// primal: `out` receives the (G, N) float64 phase (mode kNearest or
// kPulseNumbers) or `words` the (G, N, 4) float32 words (mode kWords),
// and `slope` and `dt64` the (G, N) d frac / d shift and dt [s]; `other`
// (rows of theta set g at other + g * other_sg) and `tzr_w` may be null,
// `pulse_number` is read in mode kPulseNumbers only.  With dtheta (G, K,
// P) the tangent: `out` receives the (G, K, N) d frac, each thread
// carrying `lpt` lanes (1, 2 or 4), from the row's words recomputed with
// their tangents, `other` as the primal's and, if not null, d other at
// dother + g * dother_sg + k * dother_sk + n.  dmx, jbits, swx, fdmbits, fdjbits, cmx, tropo, planets
// and btpiece as delay_chain.cu takes them; pwbits (N,) the rows'
// PiecewiseSpindown groups (or null: none) and fconst the phase family's
// constants (PhCfg), read by the template values with kPhaseFamily.
// Returns a cudaError_t code (0 on success).
extern "C" int phase_chain(
    const int64_t* tdb_day, const double* tdb_frac, const float* frac_w,
    const double* pos, const double* sun, const double* freq,
    const int32_t* dmx, const int32_t* jbits, const int32_t* swx,
    const int32_t* fdmbits, const int32_t* fdjbits, const int32_t* cmx,
    const double* tropo, const double* planets, const int32_t* btpiece,
    const double* pulse_number,
    const double* pep_day, const float* pep_w, const float* f_w,
    const float* tzr_w, const int32_t* pwbits, const double* fconst,
    const double* theta, const double* dtheta,
    const double* other, const double* dother, double* out, float* words,
    double* slope,
    double* dt64, PhCfg cfg, PhaseCfg pc, int64_t G, int64_t K, int64_t N,
    int64_t other_sg, int64_t dother_sg, int64_t dother_sk, int lpt,
    void* stream) {
  const bool tangent = dtheta != nullptr;
  const PhRowData rd{{{{tdb_day, tdb_frac, frac_w, pos, sun, freq, dmx,
                        jbits, swx, fdmbits, fdjbits},
                       cmx,
                       tropo},
                      planets,
                      btpiece},
                     pwbits,
                     fconst};
  if (G < 1 || N < 1 || cfg.P < 1 || pc.K < 1 ||
      pc.K > ptphase::kMaxTerms || pc.o_spin < cfg.P ||
      pc.o_spin + pc.K > pc.P || pc.o_pep < pc.o_spin + pc.K ||
      pc.o_pep >= pc.P || pc.mode < 0 || pc.mode > 2 ||
      !ptchain::rows_cover(cfg, rd) ||
      !ptphasechain::family_fits(cfg, pc) ||
      (tangent && (K < 1 || K > INT32_MAX || out == nullptr ||
                   pc.mode == ptphase::kWords ||
                   (pc.mode == ptphase::kPulseNumbers &&
                    pulse_number == nullptr))) ||
      (!tangent && (slope == nullptr || dt64 == nullptr ||
                    (pc.mode == ptphase::kWords ? words == nullptr
                                                : out == nullptr) ||
                    (pc.mode == ptphase::kPulseNumbers &&
                     pulse_number == nullptr))))
    return (int)cudaErrorInvalidValue;
  const PhaseData ph{pulse_number, pep_day, pep_w, f_w, tzr_w, other,
                     other_sg};
  const TangentData td{dother, dother_sg, dother_sk};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (ptchain::kernel_family(cfg)) {
#define PT_CASE(B)                                                        \
  case B:                                                                 \
    err = launch_part<B>(rd, ph, td, theta, dtheta, cfg, pc, (int)K, lpt, G, \
                         N, out, words, slope, dt64, s);                  \
    break;
    PT_FAMILIES(PT_CASE)
    PT_PHASE_FAMILIES(PT_CASE)
#undef PT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* phase_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
