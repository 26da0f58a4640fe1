// kepler_E: the eccentric anomaly E(M, e) of Kepler's equation
// E - e sin E = M, for NVIDIA Hopper (sm_90a).
//
// Replaces this JAX function of pint_tpu (a jax.custom_jvp primitive, no
// Pallas kernel: XLA compiles it from jnp):
//   K5  pint_tpu/models/binary_orbits.py  kepler_E (the fixed-count
//       Newton solve; its implicit-function JVP stays in the wrapper)
// Its plain PyTorch version is pint_tpu_torch.models.binary_orbits.kepler_E;
// the wrapper is pint_tpu_torch/kernels/kepler.py.
//
// One thread per element; every element is independent.  The Newton
// solve itself is in kepler.cuh, which delay_chain.cu shares.
//
// What bounds it: the bytes.  Counted as the plain version dispatches it
// (one operation per sin, cos, add, sub, mul, div and clamp), an element
// takes ~110 float64 operations against 24 bytes of device traffic
// (M and e read, E written), so at 34 TFLOP/s float64 (H100 SXM, no
// tensor cores) and 3.35 TB/s the bytes set the floor; chip_smoke.py
// counts both from the run's inputs.  The design is the simple one: one
// thread per element, registers only, a grid-stride loop.
//
// Built with the package's shared flags, --fmad=false among them: every
// product and sum then rounds on its own, as the plain version's separate
// PyTorch kernels do, so the two follow the same rounding step by step
// (the solve converges to the same double either way; the flag keeps the
// comparison at the last bit of the iterates, not only of the answer).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kepler.cuh"

namespace {

__global__ void kepler_E_kernel(const double* __restrict__ M,
                                const double* __restrict__ e,
                                double* __restrict__ E, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    E[i] = ptkepler::solve(M[i], ptkepler::clamp_unit(e[i]));
  }
}

}  // namespace

extern "C" int kepler_E(const double* M, const double* e, double* E,
                        int64_t n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t need = (n + threads - 1) / threads;
  // at most 32 blocks of 256 threads per SM of an H100; the loop covers
  // the rest
  const unsigned blocks = (unsigned)(need < 132 * 32 ? need : 132 * 32);
  kepler_E_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(M, e, E, n);
  return (int)cudaGetLastError();
}

extern "C" const char* kepler_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
