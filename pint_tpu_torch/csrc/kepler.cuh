// The Newton solve of Kepler's equation E - e sin E = M, shared by
// kepler.cu (the standalone kepler_E kernel) and delay_chain.cu (the DD
// family's orbit inside the delay chain), so that both give the same E
// bit for bit.
//
// Device code of pint_tpu/models/binary_orbits.py kepler_E (the primal of
// its jax.custom_jvp; the implicit-function tangent is applied by the
// caller).  Per element, in the operation order of the plain version
// pint_tpu_torch.models.binary_orbits.kepler_E:
//   e_c = clamp(e, 0, 1 - 1e-9)        (NaN stays NaN, as torch.clamp)
//   E   = M + e_c sin M
//   12 x  E = E - ((E - e_c sin E) - M) / (1 - e_c cos E)
// Built with --fmad=false: every product and sum rounds on its own, as in
// the plain version's separate PyTorch kernels.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define PT_HD __host__ __device__ __forceinline__
#else
#define PT_HD inline
#endif

namespace ptkepler {

constexpr double kUnitMax = 1.0 - 1e-9;
constexpr int kNewtonSteps = 12;

// torch.clamp order: below the floor -> floor, above the ceiling ->
// ceiling, NaN passes through
PT_HD double clamp_unit(double e) {
  return e < 0.0 ? 0.0 : (e > kUnitMax ? kUnitMax : e);
}

PT_HD void sin_cos(double x, double* s, double* c) {
#ifdef __CUDA_ARCH__
  sincos(x, s, c);
#else
  *s = sin(x);
  *c = cos(x);
#endif
}

// E(M, e_c) for an e already clamped by clamp_unit
PT_HD double solve(double m, double ec) {
  double x = m + ec * sin(m);
#pragma unroll
  for (int k = 0; k < kNewtonSteps; ++k) {
    double s, c;
    sin_cos(x, &s, &c);
    x = x - ((x - ec * s) - m) / (1.0 - ec * c);
  }
  return x;
}

}  // namespace ptkepler
