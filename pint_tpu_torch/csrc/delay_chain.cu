// delay_chain: the whole delay chain of a timing model (astrometry, delay
// jumps, the troposphere, the Shapiro delays of the Sun and the planets,
// the solar wind, DM + DMX and the DM family's jumps, DMWaveX, the
// chromatic delays, the binary with its PB/PBDOT or FBn orbit, ORBWAVEs
// and BT_PIECEWISE's pieces, FD, FDJUMP and WaveX) for every (theta set,
// TOA) row, and its forward-mode tangents, for NVIDIA Hopper (sm_90a).
//
// Replaces (K4) the eager per-component delays that pint_tpu computes in
// jnp (no Pallas kernel there; see delay_chain.cuh for the functions, file
// by file).  Its plain PyTorch version is the components' own delay
// functions (PhaseCalc.delay_plain); the wrapper is
// pint_tpu_torch/kernels/delay_chain.py.
//
// Entry points, one row function (delay_chain.cuh) templated over the
// scalar type, the binary family a template parameter (none, ELL1, DD/BT,
// DDK, DDS/DDH, ELL1H, ELL1k; each again with the DM family's terms
// compiled in, kDMFamily, again with the DM and the chromatic family's,
// kDMFamily + kChromFamily, and again with those and the orbit family's,
// + kOrbitFamily, so that a layout without them runs the code it ran
// before they came):
//   primal:  out[g, n]        = delay(theta[g], row n)         (double)
//   tangent: tangent[g, k, n] = d delay(theta[g], row n) . dtheta[g, k]
// with theta (G, P) and dtheta (G, K, P): g runs over theta sets (the grid
// points of a vmap) and k over tangent lanes that share theta[g] (the
// lanes of a jacfwd, or the P unit lanes of a reverse-mode call).  Each
// jacfwd costs one primal and one tangent launch.
//
// What bounds it.  Counted as the plain version dispatches it
// (chip_smoke.py chain_ops, on the run's inputs), a DD row is ~350
// float64 operations (each transcendental counted once, the Kepler solve
// included) and ~590 float32 operations of the quad-single t - T0,
// against ~100 bytes of row data read once and 8 written.  The tangents
// add ~100 (DD) to ~240 (ELL1) float64 operations per row that no lane
// owns (each derivative's factor), and each lane ~420 (DD) to ~770
// (ELL1) of its own and 8 bytes written.  At 34 TFLOP/s float64, 67
// TFLOP/s float32 and 3.35 TB/s (H100 SXM) the primal launch of one
// theta set is bound by its bytes, and the tangent launch, at the tens
// of lanes of a fit's jacfwd, by its float64 operations.  A lane's own
// work is more than half of an L = 1 lane's, so sharing the primal
// saves at most the rest (PERF.md, K4).  The tangent launch runs bound
// by latency at its occupancy: fewer registers per thread (more warps
// per SM) made it faster, more made it slower.
//
// The design.  The primal launch is one thread per (theta set, row),
// registers only (a launch is a few microseconds of work at 12,500 rows:
// launch-bound).  The tangent launch does the primal once for many lanes:
// one thread per (theta set, row, block of L lanes) runs the row function
// over DualN<L> (one value, L tangents), so the transcendentals, the
// Kepler solve and the quad-single dt are computed once per L lanes, and
// each lane adds only its tangent products.  One block per (theta set,
// lane block, tile of rows) stages theta[g] and its L dtheta rows in
// shared memory once; a ragged last lane block reads zero tangents and
// writes nothing for the missing lanes, so any lane count works.  L is a
// template parameter (1, 2, 4): registers per thread grow with L + 1
// live doubles per value, so __launch_bounds__ caps the block (and holds
// L = 4 to 128 registers, 8 blocks per SM), and the wrapper picks L
// (kernels/delay_chain.py lanes_per_thread) by the registers, spills and
// times chip_smoke.py records.  L = 8 took 246-255 registers, spilled on
// DD and was slower than L = 4 at every lane count.  L = 1 is the
// single-lane Dual kernel, one thread per (theta set, lane, row), kept as
// the reference that the multi-lane launch is held bit-equal to.
//
// Built with --fmad=false, as qs.cuh requires, and never --use_fast_math:
// each product and sum rounds on its own, as in the plain version's
// separate PyTorch kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "delay_chain.cuh"

namespace {

using ptchain::CfgOf;
using ptchain::ChainCfg;
using ptchain::Dual;
using ptchain::DualN;
using ptchain::Row;
using ptchain::RowData;
using ptchain::RowDataOf;
using ptchain::load_row_of;
using ptchain::OrbCfg;
using ptchain::OrbRowData;
using ptchain::Theta;

template <int BIN>
__global__ void delay_chain_primal(RowDataOf<BIN> rd,
                                   const double* __restrict__ theta,
                                   CfgOf<BIN> c, int64_t G, int64_t N,
                                   double* __restrict__ out,
                                   double* __restrict__ aux) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= G * N) return;
  const int64_t g = row / N;
  const int64_t n = row - g * N;
  const Theta<double> th{theta + g * c.P};
  double a[3] = {0.0, 0.0, 0.0};
  out[row] = ptchain::delay_row<double, BIN>(c, th, load_row_of<BIN>(rd, n),
                                            aux != nullptr ? a : nullptr);
  if (aux != nullptr) {
    aux[row] = a[0];
    aux[G * N + row] = a[1];
    aux[2 * G * N + row] = a[2];
  }
}

template <int BIN>
__global__ void delay_chain_tangent(RowDataOf<BIN> rd,
                                    const double* __restrict__ theta,
                                    const double* __restrict__ dtheta,
                                    CfgOf<BIN> c, int K, int64_t G, int64_t N,
                                    double* __restrict__ tangent) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= G * K * N) return;
  const int64_t gk = row / N;
  const int64_t n = row - gk * N;
  const Theta<Dual> th{theta + (gk / K) * c.P, dtheta + gk * c.P};
  tangent[row] =
      ptchain::delay_row<Dual, BIN>(c, th, load_row_of<BIN>(rd, n), nullptr).d;
}

constexpr int kTangentThreads = 64;
// blocks per SM that each lane width asks the compiler to fit
// (registers per thread <= 65536 / (64 * blocks))
template <int L>
constexpr int kMinBlocks = L == 4 ? 8 : 1;

template <int BIN, int L>
__global__ void __launch_bounds__(kTangentThreads, kMinBlocks<L>)
    delay_chain_tangent_lanes(RowDataOf<BIN> rd,
                              const double* __restrict__ theta,
                              const double* __restrict__ dtheta, CfgOf<BIN> c,
                              int K, int64_t N,
                              double* __restrict__ tangent) {
  // theta[g] (P), then the block's L tangent rows (L, P), zero past K
  extern __shared__ double sh[];
  const int P = c.P;
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
  const Theta<DualN<L>> th{sh, sh + P, P};
  const DualN<L> t =
      ptchain::delay_row<DualN<L>, BIN>(c, th, load_row_of<BIN>(rd, n),
                                        nullptr);
#pragma unroll
  for (int l = 0; l < L; ++l)
    if (k0 + l < K) tangent[(g * K + k0 + l) * N + n] = t.d[l];
}

template <int BIN, int L>
cudaError_t launch_lanes(const RowDataOf<BIN>& rd, const double* theta,
                         const double* dtheta, const CfgOf<BIN>& c, int K,
                         int64_t G, int64_t N, double* out,
                         cudaStream_t stream) {
  const int64_t lane_blocks = (K + L - 1) / L;
  if (G > 65535 || lane_blocks > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * (L + 1) * (size_t)c.P;
  auto kernel = delay_chain_tangent_lanes<BIN, L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 blocks((unsigned)((N + kTangentThreads - 1) / kTangentThreads),
                    (unsigned)lane_blocks, (unsigned)G);
  kernel<<<blocks, kTangentThreads, smem, stream>>>(rd, theta, dtheta, c, K,
                                                    N, out);
  return cudaSuccess;
}

template <int BIN>
cudaError_t launch(const RowDataOf<BIN>& rd, const double* theta,
                   const double* dtheta, const CfgOf<BIN>& c, int K, int lpt,
                   int64_t G, int64_t N, double* out, double* aux,
                   cudaStream_t stream) {
  const int threads = 128;
  if (dtheta == nullptr) {
    const unsigned blocks = (unsigned)((G * N + threads - 1) / threads);
    delay_chain_primal<BIN><<<blocks, threads, 0, stream>>>(rd, theta, c, G,
                                                            N, out, aux);
    return cudaSuccess;
  }
  switch (lpt) {
    case 1: {
      const unsigned blocks =
          (unsigned)((G * K * N + threads - 1) / threads);
      delay_chain_tangent<BIN><<<blocks, threads, 0, stream>>>(
          rd, theta, dtheta, c, K, G, N, out);
      return cudaSuccess;
    }
    case 2:
      return launch_lanes<BIN, 2>(rd, theta, dtheta, c, K, G, N, out, stream);
    case 4:
      return launch_lanes<BIN, 4>(rd, theta, dtheta, c, K, G, N, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// launch<BIN> where this library holds BIN (a build in parts holds some
// template values: kernels/build.py part_of picks the library)
template <int BIN>
cudaError_t launch_part(const OrbRowData& rd, const double* theta,
                        const double* dtheta, const OrbCfg& c, int K, int lpt,
                        int64_t G, int64_t N, double* out, double* aux,
                        cudaStream_t stream) {
  if constexpr (ptchain::in_part(BIN))
    return launch<BIN>(rd, theta, dtheta, c, K, lpt, G, N, out, aux, stream);
  else
    return cudaErrorNotSupported;
}

}  // namespace

// One launch.  theta is (G, P) float64.  With dtheta == nullptr `out`
// receives the (G, N) delay [s] (and `aux`, if not null, the (3, G, N)
// M, e, E of a DD/BT binary's Kepler solve); with dtheta (G, K, P) `out`
// receives the (G, K, N) tangent, each thread carrying `lpt` lanes (1, 2
// or 4).  dmx ((N, 2) int32 bins per TOA, -1 none), jbits (int32
// DelayJump bits), swx ((N, 2) int32 SWX ranges), fdmbits and fdjbits
// (int32 FDJUMPDM and FDJUMP bits), cmx ((N, 2) int32 CMX ranges),
// tropo (float64 troposphere delay [s]), planets ((N, 5, 3) float64
// observatory -> planet [ls]) and btpiece (int32 BT_PIECEWISE piece, -1
// none) may be null when the model has none.
// Returns a cudaError_t code (0 on success).
extern "C" int delay_chain(const int64_t* tdb_day, const double* tdb_frac,
                           const float* frac_w, const double* pos,
                           const double* sun, const double* freq,
                           const int32_t* dmx, const int32_t* jbits,
                           const int32_t* swx, const int32_t* fdmbits,
                           const int32_t* fdjbits, const int32_t* cmx,
                           const double* tropo, const double* planets,
                           const int32_t* btpiece, const double* theta,
                           const double* dtheta, double* out, double* aux,
                           OrbCfg cfg, int64_t G, int64_t K, int64_t N,
                           int lpt, void* stream) {
  const OrbRowData rd{{{tdb_day, tdb_frac, frac_w, pos, sun, freq, dmx, jbits,
                        swx, fdmbits, fdjbits},
                       cmx,
                       tropo},
                      planets,
                      btpiece};
  if (G < 1 || N < 1 || cfg.P < 1 ||
      (dtheta != nullptr && (K < 1 || K > INT32_MAX)) ||
      !ptchain::rows_cover(cfg, rd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (ptchain::kernel_family(cfg)) {
#define PT_CASE(B)                                                        \
  case B:                                                                 \
    err = launch_part<B>(rd, theta, dtheta, cfg, (int)K, lpt, G, N, out,  \
                         aux, s);                                         \
    break;
    PT_FAMILIES(PT_CASE)
#undef PT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* delay_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
