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
// One thread per (grid point, TOA) row; every row is independent.  The
// row function (qs_phase.cuh) runs in the operation order of pint_tpu.qs,
// so the words are bit-equal to the plain version's; each block first
// forms the row-independent spin terms (the F words scaled by 1/k!, and
// their float64 values) in shared memory, one thread per term.
//
// What bounds it: arithmetic.  The plain version does ~2.3k float32 and
// ~60 float64 elementwise operations per row (the QS products renormalize
// 14 words three times) against ~42 bytes of device traffic per row, so
// at the headline grid's 112,500 rows the float32 issue rate (67 TFLOP/s
// on an H100 SXM, no tensor cores) sets a floor of ~4 us and the bytes
// (3.35 TB/s) ~1.4 us; chip_smoke.py counts both from the run's inputs.
// A launch's fixed cost is above that floor, so on the paths this row
// function runs as the epilogue of the delay chain's launches
// (phase_chain.cu) and this kernel is the card's reference for them.
//
// The QS arithmetic (K1, K2) lives in qs.cuh; like every kernel that
// includes it, this one is compiled with --fmad=false and never
// --use_fast_math (see qs.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "qs_phase.cuh"

namespace {

using ptphase::kMaxTerms;
using ptphase::PhaseOut;
using ptphase::SpinTerms;

__global__ void qs_phase_frac_kernel(
    const int64_t* __restrict__ tdb_day, const float* __restrict__ frac_w,
    const double* __restrict__ pep_day, const float* __restrict__ pep_w,
    const float* __restrict__ f_w, int K, const float* __restrict__ tzr_w,
    const double* __restrict__ pulse_number,
    const double* __restrict__ shift, const double* __restrict__ dF,
    const double* __restrict__ other, double* __restrict__ out,
    float* __restrict__ words, double* __restrict__ slope,
    double* __restrict__ dt64_out, int64_t G, int64_t N, int mode) {
  __shared__ SpinTerms spin;
  if ((int)threadIdx.x <= K) ptphase::spin_term(spin, f_w, K, threadIdx.x);
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= G * N) return;
  const int64_t g = row / N;
  const int64_t n = row - g * N;
  const PhaseOut o = ptphase::phase_row(
      tdb_day[n], frac_w + 3 * n, pep_day[0], pep_w, spin, K, dF + g * K,
      shift[row], other != nullptr, other != nullptr ? other[row] : 0.0,
      tzr_w, mode, mode == ptphase::kPulseNumbers ? pulse_number[n] : 0.0);
  slope[row] = o.slope;
  dt64_out[row] = o.dt64;
  if (mode == ptphase::kWords) {
#pragma unroll
    for (int i = 0; i < 4; ++i) words[4 * row + i] = o.words[i];
  } else {
    out[row] = o.out;
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
