// delay_chain: the whole delay chain of a timing model (astrometry, solar
// Shapiro, DM + DMX, delay jumps, the binary, FD) for every (theta set,
// TOA) row in one kernel, for NVIDIA Hopper (sm_90a).
//
// Replaces (K4) the eager per-component delays that pint_tpu computes in
// jnp (no Pallas kernel there; see delay_chain.cuh for the functions, file
// by file).  Its plain PyTorch version is the components' own delay
// functions (PhaseCalc.delay_plain); the wrapper is
// pint_tpu_torch/kernels/delay_chain.py.
//
// Two entry points, one row function (delay_chain.cuh) templated over the
// scalar type:
//   primal:  out[g, n]      = delay(theta[g], row n)             (double)
//   tangent: tangent[g, n]  = d delay(theta[g], row n) . dtheta[g]  (Dual)
// g runs over the leading axes of theta, which the wrapper's vmap rule
// fills with grid points and tangent lanes: every lane of a jacfwd is one
// more g, so each jacfwd costs one primal and one tangent launch.  The
// binary family is a template parameter (none, ELL1, DD/BT).
//
// What bounds it: the bytes, narrowly.  Counted as the plain version
// dispatches it (chip_smoke.py, on the run's inputs), a DD row is ~350
// float64 operations (each transcendental counted once, the Kepler solve
// included) and ~590 float32 operations of the quad-single t - T0,
// against ~100 bytes of row data read once and 8 written: at 34 TFLOP/s
// float64, 67 TFLOP/s float32 and 3.35 TB/s (H100 SXM) the bytes take
// the longest.  The tangent launch does about three times the float64
// work per lane.  At 12,500 rows a launch is a few microseconds of work,
// so a single call is launch-bound.  The design is the simple one: one
// thread per row, registers only, theta read by every thread of a row set
// (it stays in L1).
//
// Built with --fmad=false, as qs.cuh requires, and never --use_fast_math:
// each product and sum rounds on its own, as in the plain version's
// separate PyTorch kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "delay_chain.cuh"

namespace {

using ptchain::ChainCfg;
using ptchain::Dual;
using ptchain::Row;
using ptchain::Theta;

struct RowData {
  const int64_t* __restrict__ tdb_day;
  const double* __restrict__ tdb_frac;
  const float* __restrict__ frac_w;
  const double* __restrict__ pos;
  const double* __restrict__ sun;
  const double* __restrict__ freq;
  const int32_t* __restrict__ dmx;
  const int32_t* __restrict__ jbits;
};

__device__ __forceinline__ Row load_row(const RowData& rd, int64_t n) {
  Row r;
  r.day = rd.tdb_day[n];
  r.frac = rd.tdb_frac[n];
  r.frac_w = rd.frac_w + 3 * n;
  r.pos = rd.pos + 3 * n;
  r.sun = rd.sun + 3 * n;
  r.freq = rd.freq[n];
  r.dmx0 = rd.dmx != nullptr ? rd.dmx[2 * n] : -1;
  r.dmx1 = rd.dmx != nullptr ? rd.dmx[2 * n + 1] : -1;
  r.jbits = rd.jbits != nullptr ? rd.jbits[n] : 0;
  return r;
}

template <int BIN>
__global__ void delay_chain_primal(RowData rd, const double* __restrict__ theta,
                                   ChainCfg c, int64_t G, int64_t N,
                                   double* __restrict__ out,
                                   double* __restrict__ aux) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= G * N) return;
  const int64_t g = row / N;
  const int64_t n = row - g * N;
  const Theta<double> th{theta + g * c.P};
  double a[3] = {0.0, 0.0, 0.0};
  out[row] = ptchain::delay_row<double, BIN>(c, th, load_row(rd, n),
                                            aux != nullptr ? a : nullptr);
  if (aux != nullptr) {
    aux[row] = a[0];
    aux[G * N + row] = a[1];
    aux[2 * G * N + row] = a[2];
  }
}

template <int BIN>
__global__ void delay_chain_tangent(RowData rd,
                                    const double* __restrict__ theta,
                                    const double* __restrict__ dtheta,
                                    ChainCfg c, int64_t G, int64_t N,
                                    double* __restrict__ tangent) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= G * N) return;
  const int64_t g = row / N;
  const int64_t n = row - g * N;
  const Theta<Dual> th{theta + g * c.P, dtheta + g * c.P};
  tangent[row] =
      ptchain::delay_row<Dual, BIN>(c, th, load_row(rd, n), nullptr).d;
}

template <int BIN>
void launch(const RowData& rd, const double* theta, const double* dtheta,
            const ChainCfg& c, int64_t G, int64_t N, double* out,
            double* aux, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((G * N + threads - 1) / threads);
  if (dtheta == nullptr)
    delay_chain_primal<BIN><<<blocks, threads, 0, stream>>>(rd, theta, c, G,
                                                            N, out, aux);
  else
    delay_chain_tangent<BIN><<<blocks, threads, 0, stream>>>(
        rd, theta, dtheta, c, G, N, out);
}

}  // namespace

// One launch.  theta is (G, P) float64; with dtheta == nullptr `out`
// receives the (G, N) delay [s] (and `aux`, if not null, the (3, G, N)
// M, e, E of a DD/BT binary's Kepler solve); with dtheta (G, P) `out`
// receives the (G, N) tangent.  dmx ((N, 2) int32 bins per TOA, -1 none) and
// jbits (int32 DelayJump bits) may be null when the model has no DMX /
// DelayJump.  Returns a cudaError_t code (0 on success).
extern "C" int delay_chain(const int64_t* tdb_day, const double* tdb_frac,
                           const float* frac_w, const double* pos,
                           const double* sun, const double* freq,
                           const int32_t* dmx, const int32_t* jbits,
                           const double* theta, const double* dtheta,
                           double* out, double* aux, ChainCfg cfg, int64_t G,
                           int64_t N, void* stream) {
  if (G < 1 || N < 1 || cfg.P < 1 || cfg.njump > 31 ||
      ((cfg.flags & ptchain::kDMX) && cfg.ndmx > 0 && dmx == nullptr) ||
      ((cfg.flags & ptchain::kJump) && jbits == nullptr))
    return (int)cudaErrorInvalidValue;
  const RowData rd{tdb_day, tdb_frac, frac_w, pos, sun, freq, dmx, jbits};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cfg.binary) {
    case ptchain::kNoBinary:
      launch<ptchain::kNoBinary>(rd, theta, dtheta, cfg, G, N, out, aux, s);
      break;
    case ptchain::kELL1:
      launch<ptchain::kELL1>(rd, theta, dtheta, cfg, G, N, out, aux, s);
      break;
    case ptchain::kDD:
      launch<ptchain::kDD>(rd, theta, dtheta, cfg, G, N, out, aux, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* delay_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
