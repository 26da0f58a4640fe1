// The delay chain of one TOA row: every delay component of a timing model
// that the delay_chain kernel covers, in DEFAULT_ORDER, in float64,
// written once over a scalar type T: `double` gives the delay, `Dual`
// (value, tangent) gives the delay and one forward-mode tangent, and
// `DualN<L>` (one value, L tangents) gives the delay and L tangents that
// share it, so that the primal work (the transcendentals, the Kepler
// solve, the quad-single t - epoch) is done once for L lanes.
//
// Device code of these JAX functions of pint_tpu (no Pallas kernel there:
// XLA compiles them from jnp, one elementwise op at a time):
//   K4  pint_tpu/models/astrometry.py  Astrometry.delay, _sincos
//       (equatorial and ecliptic, PM and PX: AstrometryEcliptic.psr_dir),
//       solar_system_shapiro.py (the Sun, and PLANET_SHAPIRO's planets)
//       dispersion.py  DispersionDM (+ DM Taylor terms), DispersionDMX
//       frequency_dependent.py  FD, FDJump;  jump.py  DelayJump
//       dispersion.py  FDJumpDM (DispersionJump adds no delay)
//       solar_wind.py  SolarWindDispersion (SWM 0 and 1),
//       SolarWindDispersionX
//       chromatic.py  ChromaticCM, ChromaticCMX;  wave.py  WaveX,
//       DMWaveX, CMWaveX;  transient_events.py  SimpleExponentialDip,
//       ChromaticGaussianEvent;  troposphere.py  TroposphereDelay (its
//       host-built delay, one row input)
//       binary_ell1.py  BinaryELL1.delay (M2/SINI Shapiro),
//       BinaryELL1H.shapiro_delay, BinaryELL1k._eps / roemer_const
//       binary_dd.py  BinaryDDBase/BinaryDD/BinaryBT.delay,
//       BinaryDDK._kopeikin, and BinaryDDS/DDH/DDGR through the theta
//       slots that kernels/delay_chain.py ChainLayout derives for them,
//       BinaryBTPiecewise.dt_extra / a1_val
//       binary_orbits.py  orbits_and_freq (the FBn orbit), orbwave_delta
// The plain PyTorch versions are the component delays of
// pint_tpu_torch/models/*.py, composed by PhaseCalc.delay_plain; each
// expression below keeps their operation order, so the two agree to the
// last bits.  Recipes carried over literally: the host-exact sin/cos of
// the reference sky angles rotated by the fit offsets (angle addition),
// clip_unit on e, eth and SINI (clamp with a straight-through tangent),
// the continuous true anomaly, the DD inverse-timing series, and the
// binary's t - epoch in quad-single (qs.cuh) with the analytic tangent
// d dt = d shift = -d delay - 86400 d epoch.  The Kepler solve is
// kepler.cuh's (bit-equal to the kepler_E kernel); its tangent is
// pint_tpu's implicit-function rule dE = (dM + sin E de) / (1 - e cos E).
//
// DualN<L> forms each lane's tangent by exactly Dual's operations in
// Dual's order (a division stays a division per lane, not a product with
// a shared reciprocal), so that built without FMA contraction every lane
// is bit-equal to a Dual run on that lane alone
// (tests/test_torch_delay_chain_host.py on the host, the card tests on
// the GPU).  What is shared is the value and each derivative's factor:
// cos x for sin x, the square root, the atan2 denominator, the Kepler
// solve with sin E and 1 / (1 - e cos E).
//
// The DM family (the solar wind, SWX, FDJUMPDM, FDJUMP) is compiled in
// only where the template's family value carries kDMFamily, so the
// instantiations without it are the code they were before it came.  The
// chromatic family (CM, CMX, the WaveX family, the exponential dips, the
// chromatic Gaussian events, the troposphere) likewise only where it
// carries kChromFamily, which is added on top of kDMFamily alone.  The
// orbit family (an FBn orbit, ORBWAVE, BT_PIECEWISE's pieces, the
// planets' Shapiro delays) only where it carries kOrbitFamily, which is
// added on top of kDMFamily + kChromFamily alone.  The phase family (the
// glitches, PiecewiseSpindown, WAVE and IFUNC: the phase terms that read
// the delay) is no delay: phase_chain.cuh's phase_family_row adds it, and
// only phase_chain.cu instantiates the template values that carry
// kPhaseFamily, always on top of the orbit family's.

#pragma once

#include <math.h>
#include <stdint.h>

#include "kepler.cuh"
#include "qs.cuh"

namespace ptchain {

// -- the scalar types ---------------------------------------------------

struct Dual {
  double v, d;
};

// one value and L tangent lanes
template <int L>
struct DualN {
  double v;
  double d[L];
};

PT_HD double val(double x) { return x; }
PT_HD double val(const Dual& x) { return x.v; }
template <int L>
PT_HD double val(const DualN<L>& x) {
  return x.v;
}

PT_HD Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
PT_HD Dual operator+(Dual a, double b) { return {a.v + b, a.d}; }
PT_HD Dual operator+(double a, Dual b) { return {a + b.v, b.d}; }
PT_HD Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
PT_HD Dual operator-(Dual a, double b) { return {a.v - b, a.d}; }
PT_HD Dual operator-(double a, Dual b) { return {a - b.v, -b.d}; }
PT_HD Dual operator-(Dual a) { return {-a.v, -a.d}; }
PT_HD Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
PT_HD Dual operator*(Dual a, double b) { return {a.v * b, a.d * b}; }
PT_HD Dual operator*(double a, Dual b) { return {a * b.v, a * b.d}; }
PT_HD Dual operator/(Dual a, Dual b) {
  const double q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
PT_HD Dual operator/(Dual a, double b) { return {a.v / b, a.d / b}; }
PT_HD Dual operator/(double a, Dual b) {
  const double q = a / b.v;
  return {q, -q * b.d / b.v};
}

// DualN<L>: Dual's operations, lane by lane
#define PT_LANES _Pragma("unroll") for (int l = 0; l < L; ++l)

template <int L>
PT_HD DualN<L> operator+(const DualN<L>& a, const DualN<L>& b) {
  DualN<L> r;
  r.v = a.v + b.v;
  PT_LANES r.d[l] = a.d[l] + b.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> operator+(DualN<L> a, double b) {
  a.v = a.v + b;
  return a;
}
template <int L>
PT_HD DualN<L> operator+(double a, DualN<L> b) {
  b.v = a + b.v;
  return b;
}
template <int L>
PT_HD DualN<L> operator-(const DualN<L>& a, const DualN<L>& b) {
  DualN<L> r;
  r.v = a.v - b.v;
  PT_LANES r.d[l] = a.d[l] - b.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> operator-(DualN<L> a, double b) {
  a.v = a.v - b;
  return a;
}
template <int L>
PT_HD DualN<L> operator-(double a, const DualN<L>& b) {
  DualN<L> r;
  r.v = a - b.v;
  PT_LANES r.d[l] = -b.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> operator-(const DualN<L>& a) {
  DualN<L> r;
  r.v = -a.v;
  PT_LANES r.d[l] = -a.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> operator*(const DualN<L>& a, const DualN<L>& b) {
  DualN<L> r;
  r.v = a.v * b.v;
  PT_LANES r.d[l] = a.d[l] * b.v + a.v * b.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> operator*(const DualN<L>& a, double b) {
  DualN<L> r;
  r.v = a.v * b;
  PT_LANES r.d[l] = a.d[l] * b;
  return r;
}
template <int L>
PT_HD DualN<L> operator*(double a, const DualN<L>& b) {
  DualN<L> r;
  r.v = a * b.v;
  PT_LANES r.d[l] = a * b.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> operator/(const DualN<L>& a, const DualN<L>& b) {
  DualN<L> r;
  const double q = a.v / b.v;
  r.v = q;
  PT_LANES r.d[l] = (a.d[l] - q * b.d[l]) / b.v;
  return r;
}
template <int L>
PT_HD DualN<L> operator/(const DualN<L>& a, double b) {
  DualN<L> r;
  r.v = a.v / b;
  PT_LANES r.d[l] = a.d[l] / b;
  return r;
}
template <int L>
PT_HD DualN<L> operator/(double a, const DualN<L>& b) {
  DualN<L> r;
  const double q = a / b.v;
  r.v = q;
  PT_LANES r.d[l] = -q * b.d[l] / b.v;
  return r;
}

PT_HD double f_sin(double x) { return sin(x); }
PT_HD double f_cos(double x) { return cos(x); }
PT_HD double f_log(double x) { return log(x); }
PT_HD double f_sqrt(double x) { return sqrt(x); }
PT_HD double f_floor(double x) { return floor(x); }
PT_HD double f_atan2(double y, double x) { return atan2(y, x); }
PT_HD Dual f_sin(Dual x) { return {sin(x.v), cos(x.v) * x.d}; }
PT_HD Dual f_cos(Dual x) { return {cos(x.v), -sin(x.v) * x.d}; }
PT_HD Dual f_log(Dual x) { return {log(x.v), x.d / x.v}; }
PT_HD Dual f_sqrt(Dual x) {
  const double s = sqrt(x.v);
  return {s, x.d / (2.0 * s)};
}
// torch.floor: no tangent
PT_HD Dual f_floor(Dual x) { return {floor(x.v), 0.0}; }
PT_HD Dual f_atan2(Dual y, Dual x) {
  return {atan2(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}

template <int L>
PT_HD DualN<L> f_sin(const DualN<L>& x) {
  DualN<L> r;
  const double c = cos(x.v);
  r.v = sin(x.v);
  PT_LANES r.d[l] = c * x.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> f_cos(const DualN<L>& x) {
  DualN<L> r;
  const double ms = -sin(x.v);
  r.v = cos(x.v);
  PT_LANES r.d[l] = ms * x.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> f_log(const DualN<L>& x) {
  DualN<L> r;
  r.v = log(x.v);
  PT_LANES r.d[l] = x.d[l] / x.v;
  return r;
}
template <int L>
PT_HD DualN<L> f_sqrt(const DualN<L>& x) {
  DualN<L> r;
  const double s = sqrt(x.v);
  const double s2 = 2.0 * s;
  r.v = s;
  PT_LANES r.d[l] = x.d[l] / s2;
  return r;
}
template <int L>
PT_HD DualN<L> f_floor(const DualN<L>& x) {
  DualN<L> r;
  r.v = floor(x.v);
  PT_LANES r.d[l] = 0.0;
  return r;
}
template <int L>
PT_HD DualN<L> f_atan2(const DualN<L>& y, const DualN<L>& x) {
  DualN<L> r;
  const double den = x.v * x.v + y.v * y.v;
  r.v = atan2(y.v, x.v);
  PT_LANES r.d[l] = (x.v * y.d[l] - y.v * x.d[l]) / den;
  return r;
}

// exp, and sin and cos of one argument with its transcendentals formed
// once for every lane (the WaveX family's modes)
PT_HD double f_exp(double x) { return exp(x); }
PT_HD Dual f_exp(Dual x) {
  const double e = exp(x.v);
  return {e, e * x.d};
}
template <int L>
PT_HD DualN<L> f_exp(const DualN<L>& x) {
  DualN<L> r;
  r.v = exp(x.v);
  PT_LANES r.d[l] = r.v * x.d[l];
  return r;
}
PT_HD void f_sincos(double x, double& s, double& c) {
  s = sin(x);
  c = cos(x);
}
PT_HD void f_sincos(const Dual& x, Dual& s, Dual& c) {
  s = f_sin(x);
  c = f_cos(x);
}
template <int L>
PT_HD void f_sincos(const DualN<L>& x, DualN<L>& s, DualN<L>& c) {
  const double sv = sin(x.v), cv = cos(x.v), ms = -sv;
  s.v = sv;
  c.v = cv;
  PT_LANES {
    s.d[l] = cv * x.d[l];
    c.d[l] = ms * x.d[l];
  }
}

// acos, asin, abs and pow, with torch's derivative rules
PT_HD double f_acos(double x) { return acos(x); }
PT_HD double f_asin(double x) { return asin(x); }
PT_HD double f_abs(double x) { return fabs(x); }
PT_HD double f_pow(double x, double y) { return pow(x, y); }
PT_HD double sgn(double x) { return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : 0.0); }
PT_HD Dual f_acos(Dual x) {
  return {acos(x.v), (-1.0 / sqrt(1.0 - x.v * x.v)) * x.d};
}
PT_HD Dual f_asin(Dual x) {
  return {asin(x.v), (1.0 / sqrt(1.0 - x.v * x.v)) * x.d};
}
PT_HD Dual f_abs(Dual x) { return {fabs(x.v), sgn(x.v) * x.d}; }
// d x^y = y x^(y-1) dx + x^y log(x) dy
PT_HD Dual f_pow(Dual x, Dual y) {
  const double r = pow(x.v, y.v);
  const double ax = y.v * pow(x.v, y.v - 1.0), ay = r * log(x.v);
  return {r, x.d * ax + y.d * ay};
}
template <int L>
PT_HD DualN<L> f_acos(const DualN<L>& x) {
  DualN<L> r;
  const double f = -1.0 / sqrt(1.0 - x.v * x.v);
  r.v = acos(x.v);
  PT_LANES r.d[l] = f * x.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> f_asin(const DualN<L>& x) {
  DualN<L> r;
  const double f = 1.0 / sqrt(1.0 - x.v * x.v);
  r.v = asin(x.v);
  PT_LANES r.d[l] = f * x.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> f_abs(const DualN<L>& x) {
  DualN<L> r;
  const double f = sgn(x.v);
  r.v = fabs(x.v);
  PT_LANES r.d[l] = f * x.d[l];
  return r;
}
template <int L>
PT_HD DualN<L> f_pow(const DualN<L>& x, const DualN<L>& y) {
  DualN<L> r;
  r.v = pow(x.v, y.v);
  const double ax = y.v * pow(x.v, y.v - 1.0), ay = r.v * log(x.v);
  PT_LANES r.d[l] = x.d[l] * ax + y.d[l] * ay;
  return r;
}

// x^y for a constant x > 0: d x^y = x^y log(x) dy
PT_HD double pow_cbase(double x, double y) { return pow(x, y); }
PT_HD Dual pow_cbase(double x, const Dual& y) {
  const double r = pow(x, y.v);
  return {r, (r * log(x)) * y.d};
}
template <int L>
PT_HD DualN<L> pow_cbase(double x, const DualN<L>& y) {
  DualN<L> r;
  r.v = pow(x, y.v);
  const double f = r.v * log(x);
  PT_LANES r.d[l] = f * y.d[l];
  return r;
}

// pint_tpu's clip_unit: clamp into [0, 1 - 1e-9], tangent straight through
PT_HD double clip_unit(double x) { return ptkepler::clamp_unit(x); }
PT_HD Dual clip_unit(Dual x) { return {ptkepler::clamp_unit(x.v), x.d}; }
template <int L>
PT_HD DualN<L> clip_unit(DualN<L> x) {
  x.v = ptkepler::clamp_unit(x.v);
  return x;
}

// a constant: the value, no tangent
PT_HD void set_const(double& r, double v) { r = v; }
PT_HD void set_const(Dual& r, double v) { r = {v, 0.0}; }
template <int L>
PT_HD void set_const(DualN<L>& r, double v) {
  r.v = v;
  PT_LANES r.d[l] = 0.0;
}
template <typename T>
PT_HD T make(double v) {
  T r;
  set_const(r, v);
  return r;
}

// torch.clamp(x, min=lo): the tangent where x >= lo, else none
PT_HD double clamp_min(double x, double lo) { return x < lo ? lo : x; }
template <typename T>
PT_HD T clamp_min(const T& x, double lo) {
  return x.v < lo ? make<T>(lo) : (x.v >= lo ? x : make<T>(x.v));
}

// torch.clamp(x, lo, hi): the tangent where lo <= x <= hi, else none
PT_HD double clamp2(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
template <typename T>
PT_HD T clamp2(const T& x, double lo, double hi) {
  if (x.v < lo) return make<T>(lo);
  if (x.v > hi) return make<T>(hi);
  return x.v >= lo ? x : make<T>(x.v);
}

// value v with the tangent of t (the binary's QS dt)
PT_HD double with_value(double v, double) { return v; }
template <typename T>
PT_HD T with_value(double v, T t) {
  t.v = v;
  return t;
}

// E of the Kepler solve with its implicit-function tangent
// dE = ((0 + dM) + sin E de) / (1 - e cos E), inv = 1 / (1 - e cos E)
PT_HD double implicit_E(double Ev, double, double, double, double) {
  return Ev;
}
PT_HD Dual implicit_E(double Ev, const Dual& M, const Dual& e, double sE,
                      double inv) {
  return {Ev, ((0.0 + M.d) + sE * e.d) * inv};
}
template <int L>
PT_HD DualN<L> implicit_E(double Ev, const DualN<L>& M, const DualN<L>& e,
                          double sE, double inv) {
  DualN<L> r;
  r.v = Ev;
  PT_LANES r.d[l] = ((0.0 + M.d[l]) + sE * e.d[l]) * inv;
  return r;
}

#undef PT_LANES

// the parameter vector theta, and for Dual / DualN its tangents
template <typename T>
struct Theta;
template <>
struct Theta<double> {
  const double* v;
  PT_HD double operator[](int i) const { return v[i]; }
};
template <>
struct Theta<Dual> {
  const double* v;
  const double* d;
  PT_HD Dual operator[](int i) const { return {v[i], d[i]}; }
};
// d holds the L lanes' tangents of theta, lane l's slot i at d[l * P + i]
template <int L>
struct Theta<DualN<L>> {
  const double* v;
  const double* d;
  int P;
  PT_HD DualN<L> operator[](int i) const {
    DualN<L> r;
    r.v = v[i];
#pragma unroll
    for (int l = 0; l < L; ++l) r.d[l] = d[l * P + i];
    return r;
  }
};

// -- the model's layout ---------------------------------------------------

// component flags (kernels/delay_chain.py ChainLayout builds them)
enum : int32_t {
  kAstro = 1,         // AstrometryEquatorial
  kPM = 2,            //   with a position epoch (proper motion applied)
  kShapiro = 4,       // SolarSystemShapiro (the Sun)
  kDM = 8,            // DispersionDM
  kDMX = 16,          // DispersionDMX
  kJump = 32,         // DelayJump
  kFD = 64,           // FD
  kBinShapiro = 128,  // the binary has M2 and SINI
  kOmegaFromNu = 256, // DD (omega advances with nu); BT: linear in time
  kAberration = 512,  // DD's A0/B0 aberration
  kEcliptic = 1024,   // the astrometry is AstrometryEcliptic
  kK96 = 2048,        // DDK: Kopeikin 1996 proper-motion terms
  kStigma = 4096,     // ELL1H: the exact STIGMA form (else the H3/H4 sum)
  kSolarWind = 8192,  // SolarWindDispersion (NE_SW)
  kSWM1 = 16384,      //   its power-law model (SWM 1)
  kSWX = 32768,       // SolarWindDispersionX
  kFDJumpDM = 65536,  // FDJumpDM
  kFDJump = 131072,   // FDJump
  kDMFamilyFlags = kSolarWind | kSWX | kFDJumpDM | kFDJump,
  kCM = 1 << 18,          // ChromaticCM (its block holds TNCHROMIDX)
  kCMX = 1 << 19,         // ChromaticCMX
  kCMWaveX = 1 << 20,     // CMWaveX
  kDMWaveX = 1 << 21,     // DMWaveX
  kWaveX = 1 << 22,       // WaveX
  kExpDip = 1 << 23,      // SimpleExponentialDip
  kChromGauss = 1 << 24,  // ChromaticGaussianEvent
  kTropo = 1 << 25,       // TroposphereDelay (one row input)
  kChromFamilyFlags = kCM | kCMX | kCMWaveX | kDMWaveX | kWaveX | kExpDip |
                      kChromGauss | kTropo,
  kFBOrbit = 1 << 26,        // the orbit is an FBn series (not PB/PBDOT)
  kOrbWave = 1 << 27,        // ORBWAVE Fourier terms of the orbital phase
  kBTPieces = 1 << 28,       // BT_PIECEWISE's pieces (one row input)
  kPlanetShapiro = 1 << 29,  // PLANET_SHAPIRO (one row input)
  kOrbitFamilyFlags = kFBOrbit | kOrbWave | kBTPieces | kPlanetShapiro,
  // the phase chain's layout holds a term of the phase family (PhCfg);
  // never set in a delay_chain launch
  kPhaseTerms = 1 << 30,
};

// binary families (the kernels' template parameter)
enum : int32_t {
  kNoBinary = 0,
  kELL1 = 1,
  kDD = 2,     // DD and BT (DDGR: its derived slots)
  kDDK = 3,    // DDK: the Kopeikin terms per row
  kDDTM2 = 4,  // DDS, DDH: the Shapiro slots hold TM2 [s] and sin i as is
  kELL1H = 5,  // ELL1H: the orthometric Shapiro delay
  kELL1K = 6,  // ELL1k: eps1, eps2 rotated and grown per row
  // added to a family: the DM family's terms compiled in (a layout with
  // any of kDMFamilyFlags launches the family + kDMFamily kernels)
  kDMFamily = 8,
  // added to family + kDMFamily: the chromatic family's terms compiled in
  // (a layout with any of kChromFamilyFlags)
  kChromFamily = 16,
  // added to family + kDMFamily + kChromFamily: the orbit family's terms
  // compiled in (a layout with any of kOrbitFamilyFlags)
  kOrbitFamily = 32,
  // added to family + kDMFamily + kChromFamily + kOrbitFamily: the phase
  // family's terms (phase_chain.cu only; a layout with kPhaseTerms)
  kPhaseFamily = 64,
};

// slot offsets within the binary block of theta
enum : int32_t {
  bDay0 = 0,     // the epoch's integer MJD
  bWords = 1,    // its four fraction words (float32 values)
  bDdays = 5,    // its fit offset [days]
  bPB = 6,
  bPBDOT = 7,
  bA1 = 8,
  bA1DOT = 9,
  // ELL1
  bEPS1 = 10,
  bEPS2 = 11,
  bEPS1DOT = 12,
  bEPS2DOT = 13,
  bM2_ELL1 = 14,
  bSINI_ELL1 = 15,
  // DD / BT
  bECC = 10,
  bEDOT = 11,
  bOM = 12,
  bOMDOT = 13,
  bGAMMA = 14,
  bM2_DD = 15,
  bSINI_DD = 16,
  bDR = 17,
  bDTH = 18,
  bA0 = 19,
  bB0 = 20,
  // DDTM2: the Shapiro slots hold TM2 [s] and sin i (not clipped)
  bTM2 = 15,
  bSINI_RAW = 16,
  // DDK: KIN in the SINI slot, sin and cos of KOM after B0
  bKIN = 16,
  bSKOM = 21,
  bCKOM = 22,
  // ELL1k: OMDOT and LNEDOT in the EPS1DOT, EPS2DOT slots
  bOMDOT_K = 12,
  bLNEDOT_K = 13,
  // ELL1H: the Shapiro factor (-2 H3 / STIGMA^3, or -2 H3), then the
  // STIGMA form's 1 + STIGMA^2, 2 STIGMA, STIGMA^2, or the sum's
  // weights c_k sigma^(k - 3), k = 3 .. nharm
  bH_FACTOR = 14,
  bH_A = 15,
  bH_B = 16,
  bH_D = 17,
  bH_W = 15,
};

// slots within the astrometry block of theta
enum : int32_t {
  aLonSin = 0,
  aLonCos = 1,
  aLonOffset = 2,
  aLatSin = 3,
  aLatCos = 4,
  aLatOffset = 5,
  aPMLon = 6,
  aPMLat = 7,
  aPX = 8,
  aPosEpoch = 9,
  // ecliptic: cos and sin of the obliquity (Python's math.cos/sin)
  aEclCos = 10,
  aEclSin = 11,
};

// the most FDJUMPDM and FD<k>JUMP members a layout carries (one bit
// word each per row)
constexpr int kMaxMaskMembers = 31;

struct ChainCfg {
  int32_t flags, binary, P;
  int32_t ndm, ndmx, njump, nfd;
  int32_t o_astro, o_dm, o_dmx, o_jump, o_fd, o_bin;
  int32_t nharm;  // ELL1H: the sum's highest harmonic
  // the DM family: NE_SW's Taylor terms, SWX ranges, FDJUMPDM and FDJUMP
  // members, their blocks' offsets, and each FDJUMP member's order k
  int32_t nsw, nswx, nfdm, nfdj;
  int32_t o_sw, o_swx, o_fdm, o_fdj;
  int8_t fdj_order[kMaxMaskMembers + 1];
};

// the config of the chromatic family's kernels: ChainCfg, then the
// chromatic family's counts (CM's Taylor terms, CMX ranges, the modes of
// CMWaveX, DMWaveX and WaveX, the dips, the Gaussian events) and their
// blocks' offsets.  The other kernels take ChainCfg as it was: a larger
// kernel parameter moved their ptxas spills.
struct ChromCfg : ChainCfg {
  int32_t ncm, ncmx, ncmwx, ndmwx, nwx, ndip, ngauss;
  int32_t o_cm, o_cmx, o_cmwx, o_dmwx, o_wx, o_dip, o_gauss;
};

// slots of the chromatic family's blocks: CM's epoch [day], TNCHROMIDX,
// then the ncm CM terms; a sinusoid family's epoch [day], then its n
// frequencies [1/day], n SIN and n COS amplitudes; the dips' EXPDIPEPS
// and EXPDIPFREF, then per dip its epoch [day], amplitude, index,
// timescale and peak normalization (formed in PyTorch); the events'
// CHROMGAUSSFREF, then per event its epoch [day], 10^LOGAMP, 10^LOGSIG
// (formed in PyTorch), sign and index
enum : int32_t {
  cmEpoch = 0,
  cmAlpha = 1,
  cmTerms = 2,
  dipEps = 0,
  dipFref = 1,
  dipFirst = 2,
  dipSlots = 5,
  // within a dip's slots
  dipAmp = 1,
  dipIdx = 2,
  dipTau = 3,
  dipNorm = 4,
  gaussFref = 0,
  gaussFirst = 1,
  gaussSlots = 5,
  // within an event's slots
  gaussAmp = 1,
  gaussSigma = 2,
  gaussSign = 3,
  gaussIdx = 4,
};

// the config of the orbit family's kernels: ChromCfg, then the FBn
// orbit's terms FB0..FB_{nfb-1}, the ORBWAVE harmonics, the BT_PIECEWISE
// pieces, and their blocks' offsets
struct OrbCfg : ChromCfg {
  int32_t nfb, norbw, npiece;
  int32_t o_fb, o_orbw, o_piece;
};

// slots of the orbit family's blocks: the FBn orbit's leading 0, then
// FB0..FB_{nfb-1} (taylor_horner's coefficients); ORBWAVE_OM [rad/s],
// ORBWAVE_EPOCH [day], then per harmonic its C and S [orbits]; per piece
// its t - T0 shift (T0 - T0X) * 86400 [s] (formed in PyTorch), whether it
// sets T0X, its A1X [ls] and whether it sets A1X (1 or 0)
enum : int32_t {
  fbZero = 0,
  fbFirst = 1,
  owOM = 0,
  owEpoch = 1,
  owFirst = 2,
  pieceShift = 0,
  pieceT0Set = 1,
  pieceA1X = 2,
  pieceA1Set = 3,
  pieceSlots = 4,
};

// the config of the phase family's kernels (phase_chain.cu only):
// OrbCfg, then the glitches, the PiecewiseSpindown groups, the WAVE
// harmonics and the IFUNC points with its interpolation (SIFUNC 0 or 2),
// the slots (in the fused theta) of F0's float64 value and of the blocks,
// and the offsets of the WAVE pairs and the IFUNC points in the family's
// constants (PhRowData::fconst)
struct PhCfg : OrbCfg {
  int32_t ngl, npw, nwave, nif, sifunc;
  int32_t o_f0, o_gl, o_pw, o_wave;
  int32_t c_wave, c_if;
};

// slots of the phase family's blocks in the fused theta: per glitch its
// epoch [day], GLPH, GLF0, GLF1, GLF2, GLF0D, GLTD [d]; per group its
// epoch [day], PWPH, PWF0, PWF1, PWF2; the WAVE epoch [day] (WAVEEPOCH or
// PEPOCH) and WAVE_OM [rad/d].  The constants: per WAVE harmonic its A
// and B [s], then the IFUNC points' nif MJDs and nif values [s]
enum : int32_t {
  glDay = 0,
  glPH = 1,
  glF0 = 2,
  glF1 = 3,
  glF2 = 4,
  glF0D = 5,
  glTD = 6,
  glSlots = 7,
  pwDay = 0,
  pwPH = 1,
  pwF0 = 2,
  pwF1 = 3,
  pwF2 = 4,
  pwSlots = 5,
  waveDay = 0,
  waveOM = 1,
};

// slots within the solar wind's block of theta: the Taylor epoch [day],
// the nsw NE_SW terms, then for SWM 1 SWP, the half range
// sqrt(pi)/2 Gamma((p-1)/2) / Gamma(p/2) and AU_LS^p (formed in PyTorch,
// SolarWindDispersion's own code; CUDA's libm has no digamma)
enum : int32_t { swEpoch = 0, swNE = 1 };

constexpr double kTwoPi = 6.283185307179586;   // 2.0 * math.pi
constexpr double kMasToRad = 4.8481368110953594e-09;  // pi/(180 3600 1000)
constexpr double kKpcLs = 102927125054.33899;  // 1 kpc in light-seconds
constexpr double kAuLs = 499.00478383615643;   // AU / c
constexpr double kTsun = 4.92549094830932e-06;  // GM_sun / c^3
constexpr double kDMconst = 4149.377593360996;   // 1 / 2.41e-4
constexpr double kSecsPerYear = 31557600.0;     // 365.25 * 86400
constexpr double kPi = 3.141592653589793;       // math.pi
constexpr double kHalfPi = 1.5707963267948966;  // math.pi / 2
constexpr double kAuLs2 = 249005.77429136922;   // AU_LS**2 (Python's)
constexpr double kPcLs = 102927125.05433899;    // 1 pc in light-seconds
// the planets' GM / c^3 [s] (PLANET_SHAPIRO), in kernels/delay_chain.py
// PLANETS order
constexpr double kTjupiter = 4.702819050227708e-09;
constexpr double kTsaturn = 1.408128810019423e-09;
constexpr double kTvenus = 1.205680558494223e-11;
constexpr double kTuranus = 2.1505895513637613e-10;
constexpr double kTneptune = 2.5373119991867603e-10;
// the J2000 ecliptic pole (solar_wind.py ECL_POLE)
constexpr double kEclPoleX = 0.0, kEclPoleY = -0.3977771559319137,
                 kEclPoleZ = 0.9174820620691818;

// np.polynomial.legendre.leggauss(64): the SWM 1 finite leg's nodes and
// weights (solar_wind.py GL_X, GL_W), in constant memory on the card
#ifdef __CUDACC__
#define PT_CONST __constant__
#else
#define PT_CONST
#endif
constexpr int kGLNodes = 64;
PT_CONST const double kGLX[kGLNodes] = {
    -0.9993050417357722, -0.9963401167719552, -0.9910133714767443,
    -0.983336253884626, -0.973326827789911, -0.9610087996520538,
    -0.9464113748584028, -0.9295691721319396, -0.9105221370785028,
    -0.8893154459951141, -0.8659993981540928, -0.8406292962525803,
    -0.8132653151227975, -0.7839723589433414, -0.7528199072605319,
    -0.7198818501716108, -0.6852363130542333, -0.6489654712546573,
    -0.6111553551723933, -0.571895646202634, -0.5312794640198946,
    -0.48940314570705296, -0.4463660172534641, -0.4022701579639916,
    -0.3572201583376681, -0.31132287199021097, -0.2646871622087674,
    -0.21742364374000708, -0.1696444204239928, -0.12146281929612056,
    -0.07299312178779904, -0.02435029266342443, 0.02435029266342443,
    0.07299312178779904, 0.12146281929612056, 0.1696444204239928,
    0.21742364374000708, 0.2646871622087674, 0.31132287199021097,
    0.3572201583376681, 0.4022701579639916, 0.4463660172534641,
    0.48940314570705296, 0.5312794640198946, 0.571895646202634,
    0.6111553551723933, 0.6489654712546573, 0.6852363130542333,
    0.7198818501716108, 0.7528199072605319, 0.7839723589433414,
    0.8132653151227975, 0.8406292962525803, 0.8659993981540928,
    0.8893154459951141, 0.9105221370785028, 0.9295691721319396,
    0.9464113748584028, 0.9610087996520538, 0.973326827789911,
    0.983336253884626, 0.9910133714767443, 0.9963401167719552,
    0.9993050417357722};
PT_CONST const double kGLW[kGLNodes] = {
    0.0017832807216942152, 0.004147033260562923, 0.006504457968979654,
    0.008846759826364391, 0.011168139460131466, 0.013463047896718231,
    0.015726030476025082, 0.0179517157756973, 0.020134823153530094,
    0.022270173808383007, 0.024352702568710853, 0.026377469715054627,
    0.028339672614259702, 0.030234657072402495, 0.03205792835485145,
    0.03380516183714179, 0.03547221325688232, 0.03705512854024015,
    0.03855015317861559, 0.03995374113272035, 0.041262563242623486,
    0.0424735151236536, 0.043583724529323464, 0.044590558163756545,
    0.045491627927418114, 0.046284796581314375, 0.04696818281621,
    0.0475401657148303, 0.04799938859645832, 0.048344762234802954,
    0.048575467441503456, 0.04869095700913975, 0.04869095700913975,
    0.048575467441503456, 0.048344762234802954, 0.04799938859645832,
    0.0475401657148303, 0.04696818281621, 0.046284796581314375,
    0.045491627927418114, 0.044590558163756545, 0.043583724529323464,
    0.0424735151236536, 0.041262563242623486, 0.03995374113272035,
    0.03855015317861559, 0.03705512854024015, 0.03547221325688232,
    0.03380516183714179, 0.03205792835485145, 0.030234657072402495,
    0.028339672614259702, 0.026377469715054627, 0.024352702568710853,
    0.022270173808383007, 0.020134823153530094, 0.0179517157756973,
    0.015726030476025082, 0.013463047896718231, 0.011168139460131466,
    0.008846759826364391, 0.006504457968979654, 0.004147033260562923,
    0.0017832807216942152};

// the per-row data
struct Row {
  int64_t day;
  double frac;
  const float* frac_w;  // 3 words
  const double* pos;    // SSB -> observatory [ls]
  const double* sun;    // observatory -> Sun [ls]
  double freq;          // [MHz]
  int32_t dmx0, dmx1;   // DMX bins (inclusive ranges sharing a boundary
                        // both hold a TOA on it), -1 for none
  int32_t jbits;        // DelayJump membership bits
  int32_t swx0, swx1;   // SWX ranges, as the DMX bins
  int32_t fdmbits;      // FDJUMPDM membership bits
  int32_t fdjbits;      // FDJUMP membership bits
};

// the row of the chromatic family's kernels: the CMX ranges (as the DMX
// bins) and the troposphere's delay on top of Row
struct ChromRow : Row {
  int32_t cmx0, cmx1;
  double tropo;  // [s]
};

// the row of the orbit family's kernels: the planets' positions and the
// BT_PIECEWISE piece on top of ChromRow
struct OrbRow : ChromRow {
  const double* planets;  // observatory -> planet [ls], (5, 3)
  int32_t btpiece;        // the row's piece, -1 for none
};

// the row of the phase family's kernels: the row's PiecewiseSpindown
// groups (bit i for group i) and the family's constants on top of OrbRow
struct PhRow : OrbRow {
  int32_t pwbits;
  const double* fconst;
};

// the per-row inputs as the kernels receive them (kernels/delay_chain.py
// ROWS), and one row of them
struct RowData {
  const int64_t* __restrict__ tdb_day;
  const double* __restrict__ tdb_frac;
  const float* __restrict__ frac_w;
  const double* __restrict__ pos;
  const double* __restrict__ sun;
  const double* __restrict__ freq;
  const int32_t* __restrict__ dmx;
  const int32_t* __restrict__ jbits;
  const int32_t* __restrict__ swx;
  const int32_t* __restrict__ fdmbits;
  const int32_t* __restrict__ fdjbits;
};
// and the chromatic family's: the CMX ranges and the troposphere's delay
struct ChromRowData : RowData {
  const int32_t* __restrict__ cmx;
  const double* __restrict__ tropo;
};
// and the orbit family's: the planets' positions and the pieces
struct OrbRowData : ChromRowData {
  const double* __restrict__ planets;
  const int32_t* __restrict__ btpiece;
};

// and the phase family's: the groups' bits per row and its constants
struct PhRowData : OrbRowData {
  const int32_t* __restrict__ pwbits;
  const double* __restrict__ fconst;
};

// the config, row inputs and row of the kernels of template value BIN:
// the chromatic family's only where it carries kChromFamily, the orbit
// family's only where it carries kOrbitFamily, and the phase family's
// only where it carries kPhaseFamily, so that the other kernels keep the
// parameters, and the code, they had
template <bool CHROM, bool ORB, bool PHF = false>
struct ChromSel {
  using Cfg = ChainCfg;
  using Data = RowData;
  using Row_ = Row;
};
template <>
struct ChromSel<true, false> {
  using Cfg = ChromCfg;
  using Data = ChromRowData;
  using Row_ = ChromRow;
};
template <>
struct ChromSel<true, true> {
  using Cfg = OrbCfg;
  using Data = OrbRowData;
  using Row_ = OrbRow;
};
template <>
struct ChromSel<true, true, true> {
  using Cfg = PhCfg;
  using Data = PhRowData;
  using Row_ = PhRow;
};
template <int BIN>
using SelOf = ChromSel<(BIN & kChromFamily) != 0, (BIN & kOrbitFamily) != 0,
                       (BIN & kPhaseFamily) != 0>;
template <int BIN>
using CfgOf = typename SelOf<BIN>::Cfg;
template <int BIN>
using RowDataOf = typename SelOf<BIN>::Data;
template <int BIN>
using RowOf = typename SelOf<BIN>::Row_;

// the template value of the kernels that a layout launches: its binary
// family, with kDMFamily added when it has a term of the DM family,
// kDMFamily + kChromFamily when it has one of the chromatic family,
// kDMFamily + kChromFamily + kOrbitFamily when it has one of the orbit
// family, and all four levels when the phase chain's layout has a term of
// the phase family
PT_HD int kernel_family(const ChainCfg& c) {
  if (c.flags & kPhaseTerms)
    return c.binary + kDMFamily + kChromFamily + kOrbitFamily + kPhaseFamily;
  if (c.flags & kOrbitFamilyFlags)
    return c.binary + kDMFamily + kChromFamily + kOrbitFamily;
  if (c.flags & kChromFamilyFlags) return c.binary + kDMFamily + kChromFamily;
  return c.binary + ((c.flags & kDMFamilyFlags) ? kDMFamily : 0);
}

// X(value) for every template value of the kernels
#define PT_FAMILIES(X)                                                   \
  X(ptchain::kNoBinary) X(ptchain::kELL1) X(ptchain::kDD)                \
  X(ptchain::kDDK) X(ptchain::kDDTM2) X(ptchain::kELL1H)                 \
  X(ptchain::kELL1K) X(ptchain::kNoBinary + ptchain::kDMFamily)          \
  X(ptchain::kELL1 + ptchain::kDMFamily)                                 \
  X(ptchain::kDD + ptchain::kDMFamily)                                   \
  X(ptchain::kDDK + ptchain::kDMFamily)                                  \
  X(ptchain::kDDTM2 + ptchain::kDMFamily)                                \
  X(ptchain::kELL1H + ptchain::kDMFamily)                                \
  X(ptchain::kELL1K + ptchain::kDMFamily)                                \
  PT_CHROM_FAMILIES(X) PT_ORB_FAMILIES(X)

#define PT_CHROM(B) ((B) + ptchain::kDMFamily + ptchain::kChromFamily)
#define PT_CHROM_FAMILIES(X)                                             \
  X(PT_CHROM(ptchain::kNoBinary)) X(PT_CHROM(ptchain::kELL1))            \
  X(PT_CHROM(ptchain::kDD)) X(PT_CHROM(ptchain::kDDK))                   \
  X(PT_CHROM(ptchain::kDDTM2)) X(PT_CHROM(ptchain::kELL1H))              \
  X(PT_CHROM(ptchain::kELL1K))

// the index of template value BIN among PT_FAMILIES' 28 and
// PT_PHASE_FAMILIES' 7: the binary family, plus 7 per level (alone,
// + kDMFamily, + kChromFamily, + kOrbitFamily, + kPhaseFamily;
// kernels/delay_chain.py family_index)
constexpr int family_index(int BIN) {
  return 7 * ((BIN & kPhaseFamily)   ? 4
              : (BIN & kOrbitFamily) ? 3
              : (BIN & kChromFamily) ? 2
              : (BIN & kDMFamily)    ? 1
                                     : 0) +
         (BIN & 7);
}
// whether this build instantiates template value BIN: a build in parts
// (nvcc -DPT_PARTS=n -DPT_PART=p, kernels/build.py PARTS) the values
// whose index is p mod n, a whole build (the host's) all of them
constexpr bool in_part(int BIN) {
#ifdef PT_PARTS
  return family_index(BIN) % PT_PARTS == PT_PART;
#else
  return BIN >= 0;
#endif
}

#define PT_ORB(B) (PT_CHROM(B) + ptchain::kOrbitFamily)
#define PT_ORB_FAMILIES(X)                                               \
  X(PT_ORB(ptchain::kNoBinary)) X(PT_ORB(ptchain::kELL1))                \
  X(PT_ORB(ptchain::kDD)) X(PT_ORB(ptchain::kDDK))                       \
  X(PT_ORB(ptchain::kDDTM2)) X(PT_ORB(ptchain::kELL1H))                  \
  X(PT_ORB(ptchain::kELL1K))

// X(value) for the template values of the phase family (phase_chain.cu
// only), each on top of every delay family
#define PT_PHASE(B) (PT_ORB(B) + ptchain::kPhaseFamily)
#define PT_PHASE_FAMILIES(X)                                             \
  X(PT_PHASE(ptchain::kNoBinary)) X(PT_PHASE(ptchain::kELL1))            \
  X(PT_PHASE(ptchain::kDD)) X(PT_PHASE(ptchain::kDDK))                   \
  X(PT_PHASE(ptchain::kDDTM2)) X(PT_PHASE(ptchain::kELL1H))              \
  X(PT_PHASE(ptchain::kELL1K))

// the most PiecewiseSpindown groups a layout carries (one bit word per
// row)
constexpr int kMaxPWGroups = 31;

// whether a layout's member counts fit the bit words and the row inputs
// hold what it reads (the kernels refuse it otherwise)
PT_HD bool rows_cover(const ChromCfg& c, const ChromRowData& rd) {
  const int f = c.flags;
  return c.njump <= kMaxMaskMembers && c.nfdm <= kMaxMaskMembers &&
         c.nfdj <= kMaxMaskMembers &&
         !((f & kDMX) && c.ndmx > 0 && rd.dmx == nullptr) &&
         !((f & kJump) && rd.jbits == nullptr) &&
         !((f & kSWX) && c.nswx > 0 && rd.swx == nullptr) &&
         !((f & kFDJumpDM) && rd.fdmbits == nullptr) &&
         !((f & kFDJump) && rd.fdjbits == nullptr) &&
         !((f & (kSolarWind | kSWX)) && !(f & kAstro)) &&
         !((f & kCMX) && c.ncmx > 0 && rd.cmx == nullptr) &&
         !((f & kTropo) && rd.tropo == nullptr) &&
         !((f & (kCMX | kCMWaveX)) && !(f & kCM));
}
// and the orbit family's: the planets need their positions and the Sun's
// term, the pieces their index and a DD/BT binary, an FBn orbit and
// ORBWAVEs a binary
PT_HD bool rows_cover(const OrbCfg& c, const OrbRowData& rd) {
  const int f = c.flags;
  return rows_cover(static_cast<const ChromCfg&>(c),
                    static_cast<const ChromRowData&>(rd)) &&
         !((f & kPlanetShapiro) &&
           (rd.planets == nullptr || !(f & kShapiro))) &&
         !((f & kBTPieces) && (rd.btpiece == nullptr || c.binary != kDD ||
                               c.npiece < 1)) &&
         !((f & (kFBOrbit | kOrbWave)) && c.binary == kNoBinary) &&
         !((f & kFBOrbit) && c.nfb < 1);
}

// and the phase family's: at most kMaxPWGroups groups, WAVE and IFUNC
// need their constants, and IFUNC's interpolation is 0 or 2 (a row
// without the groups' bits is in none of them)
PT_HD bool rows_cover(const PhCfg& c, const PhRowData& rd) {
  return rows_cover(static_cast<const OrbCfg&>(c),
                    static_cast<const OrbRowData&>(rd)) &&
         c.ngl >= 0 && c.npw >= 0 && c.npw <= kMaxPWGroups &&
         c.nwave >= 0 && c.nif >= 0 &&
         !((c.nwave > 0 || c.nif > 0) && rd.fconst == nullptr) &&
         !(c.nif > 0 && c.sifunc != 0 && c.sifunc != 2);
}

PT_HD Row load_row(const RowData& rd, int64_t n) {
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
  r.swx0 = rd.swx != nullptr ? rd.swx[2 * n] : -1;
  r.swx1 = rd.swx != nullptr ? rd.swx[2 * n + 1] : -1;
  r.fdmbits = rd.fdmbits != nullptr ? rd.fdmbits[n] : 0;
  r.fdjbits = rd.fdjbits != nullptr ? rd.fdjbits[n] : 0;
  return r;
}

// row n as template value BIN reads it
template <int BIN>
PT_HD RowOf<BIN> load_row_of(const RowDataOf<BIN>& rd, int64_t n) {
  if constexpr ((BIN & kPhaseFamily) != 0) {
    PhRow r;
    static_cast<OrbRow&>(r) = load_row_of<BIN & ~kPhaseFamily>(rd, n);
    r.pwbits = rd.pwbits != nullptr ? rd.pwbits[n] : 0;
    r.fconst = rd.fconst;
    return r;
  } else if constexpr ((BIN & kOrbitFamily) != 0) {
    OrbRow r;
    static_cast<Row&>(r) = load_row(rd, n);
    r.cmx0 = rd.cmx != nullptr ? rd.cmx[2 * n] : -1;
    r.cmx1 = rd.cmx != nullptr ? rd.cmx[2 * n + 1] : -1;
    r.tropo = rd.tropo != nullptr ? rd.tropo[n] : 0.0;
    r.planets = rd.planets != nullptr ? rd.planets + 15 * n : nullptr;
    r.btpiece = rd.btpiece != nullptr ? rd.btpiece[n] : -1;
    return r;
  } else if constexpr ((BIN & kChromFamily) != 0) {
    ChromRow r;
    static_cast<Row&>(r) = load_row(rd, n);
    r.cmx0 = rd.cmx != nullptr ? rd.cmx[2 * n] : -1;
    r.cmx1 = rd.cmx != nullptr ? rd.cmx[2 * n + 1] : -1;
    r.tropo = rd.tropo != nullptr ? rd.tropo[n] : 0.0;
    return r;
  } else {
    return load_row(rd, n);
  }
}

// K * dm / f^2 with infinite-frequency rows zeroed
template <typename T>
PT_HD T dispersion(const T& dm, double freq) {
  if (!isfinite(freq)) return make<T>(0.0);
  return (kDMconst * dm) / (freq * freq);
}

// -- the components ---------------------------------------------------------

// _sincos of the two sky angles: the host-exact reference sin/cos
// rotated by the fit offsets
template <typename T>
PT_HD void sky_sincos(const Theta<T>& th, int o, T& sl, T& cl, T& sb,
                      T& cb) {
  const T dl = th[o + aLonOffset], db = th[o + aLatOffset];
  const T sdl = f_sin(dl), cdl = f_cos(dl);
  sl = th[o + aLonSin] * cdl + th[o + aLonCos] * sdl;
  cl = th[o + aLonCos] * cdl - th[o + aLonSin] * sdl;
  const T sdb = f_sin(db), cdb = f_cos(db);
  sb = th[o + aLatSin] * cdb + th[o + aLatCos] * sdb;
  cb = th[o + aLatCos] * cdb - th[o + aLatSin] * sdb;
}

// Astrometry.delay + psr_dir (equatorial, or ecliptic: propagated in the
// ecliptic frame, then rotated by R_x(-obliquity)); L is the pulsar
// direction (ICRS)
template <typename T>
PT_HD T astrometry(const ChainCfg& c, const Theta<T>& th, const Row& r,
                   T (&L)[3]) {
  const int o = c.o_astro;
  T sa, ca, sd, cd;
  sky_sincos(th, o, sa, ca, sd, cd);
  L[0] = cd * ca;
  L[1] = cd * sa;
  L[2] = sd;
  if (c.flags & kPM) {
    const T pm_ra = th[o + aPMLon] * kMasToRad;
    const T pm_dec = th[o + aPMLat] * kMasToRad;
    const T dt_yr = (((double)r.day + r.frac) - th[o + aPosEpoch]) / 365.25;
    const T e_ra[3] = {-sa, ca, make<T>(0.0)};
    const T e_dec[3] = {-sd * ca, -sd * sa, cd};
    T n[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      n[i] = L[i] + (e_ra[i] * pm_ra + e_dec[i] * pm_dec) * dt_yr;
    const T norm = f_sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) L[i] = n[i] / norm;
  }
  if (c.flags & kEcliptic) {
    const double ce = val(th[o + aEclCos]), se = val(th[o + aEclSin]);
    const T y = L[1] * ce - L[2] * se;
    const T z = L[1] * se + L[2] * ce;
    L[1] = y;
    L[2] = z;
  }
  const T rdl = r.pos[0] * L[0] + r.pos[1] * L[1] + r.pos[2] * L[2];
  const double re_sqr =
      r.pos[0] * r.pos[0] + r.pos[1] * r.pos[1] + r.pos[2] * r.pos[2];
  T out = -rdl;
  // guard the 0/0 at exactly-barycentric TOAs
  if (re_sqr > 0.0)
    out = out + 0.5 * (re_sqr * th[o + aPX] / kKpcLs) *
                    (1.0 - rdl * rdl / re_sqr);
  return out;
}

// SolarSystemShapiro, the Sun only
template <typename T>
PT_HD T sun_shapiro(const Row& r, const T (&L)[3]) {
  const double rr =
      sqrt(r.sun[0] * r.sun[0] + r.sun[1] * r.sun[1] + r.sun[2] * r.sun[2]);
  if (!(rr > 0.0)) return make<T>(0.0);
  const T rcos = r.sun[0] * L[0] + r.sun[1] * L[1] + r.sun[2] * L[2];
  return (-2.0 * kTsun) * f_log((rr - rcos) / kAuLs);
}

// SolarSystemShapiro with PLANET_SHAPIRO: the Sun's term, then each
// planet's (solar_system_shapiro.py shapiro_delay) in the order of its sum
template <typename T>
PT_HD T planet_shapiro(const double* pos, const T (&L)[3], double t_obj) {
  const double rr = sqrt(pos[0] * pos[0] + pos[1] * pos[1] + pos[2] * pos[2]);
  if (!(rr > 0.0)) return make<T>(0.0);
  const T rcos = pos[0] * L[0] + pos[1] * L[1] + pos[2] * L[2];
  return (-2.0 * t_obj) * f_log((rr - rcos) / kAuLs);
}
template <typename T>
PT_HD T solar_system_shapiro(const OrbCfg& c, const OrbRow& r,
                             const T (&L)[3]) {
  T s = sun_shapiro(r, L);
  if (c.flags & kPlanetShapiro) {
    s = s + planet_shapiro(r.planets, L, kTjupiter);
    s = s + planet_shapiro(r.planets + 3, L, kTsaturn);
    s = s + planet_shapiro(r.planets + 6, L, kTvenus);
    s = s + planet_shapiro(r.planets + 9, L, kTuranus);
    s = s + planet_shapiro(r.planets + 12, L, kTneptune);
  }
  return s;
}

// pint_tpu.utils.taylor_horner: sum_k c_k dt^k / k!
template <typename T>
PT_HD T taylor_horner(const T& dt, const Theta<T>& th, int o, int n) {
  T acc = 0.0 * dt;
  for (int k = n - 1; k >= 0; --k) acc = acc * dt / (k + 1.0) + th[o + k];
  return acc;
}

// solar_wind.py _geometry_pc_impl (SWM 0): AU^2 rho / (r sin rho) [pc],
// zero on barycentric rows and where sin rho <= 1e-12
template <typename T>
PT_HD T sw_geometry(const Row& r, const T (&L)[3]) {
  const double rr =
      sqrt(r.sun[0] * r.sun[0] + r.sun[1] * r.sun[1] + r.sun[2] * r.sun[2]);
  const double safe_r = rr > 0.0 ? rr : 1.0;
  const T dot = r.sun[0] * L[0] + r.sun[1] * L[1] + r.sun[2] * L[2];
  const T rho = kPi - f_acos(clamp2(dot / safe_r, -1.0, 1.0));
  const T sin_rho = f_sin(rho);
  if (!(rr > 0.0 && val(sin_rho) > 1e-12)) return make<T>(0.0);
  return ((kAuLs2 * rho) / (safe_r * sin_rho)) / kPcLs;
}

// solar_wind.py solar_wind_geometry_p_pc (SWM 1): the power-law geometry
// [pc], p = SWP, half and au_p the theta slots of the half range and
// AU_LS^p; the 64-node leg summed node by node
template <typename T>
PT_HD T sw_geometry_p(const Row& r, const T (&L)[3], const T& p,
                      const T& half, const T& au_p) {
  const double rr =
      sqrt(r.sun[0] * r.sun[0] + r.sun[1] * r.sun[1] + r.sun[2] * r.sun[2]);
  if (!(rr > 0.0)) return make<T>(0.0);
  const T dot = r.sun[0] * L[0] + r.sun[1] * L[1] + r.sun[2] * L[2];
  const T cos_t = clamp2(dot / rr, -1.0, 1.0);
  const T b = clamp_min(rr * f_sin(f_acos(cos_t)), 1e-6);
  const T phi0 = f_atan2(-(rr * cos_t), b);
  const T mid = 0.5 * phi0;
  const T pm2 = p - 2.0;
  T acc = 0.0 * mid;
  // one node per iteration: 64 powers unrolled would bloat every family
#pragma unroll 1
  for (int k = 0; k < kGLNodes; ++k)
    acc = acc + kGLW[k] * f_pow(f_cos(mid * (1.0 + kGLX[k])), pm2);
  const T leg = mid * acc;
  return ((f_pow(b, 1.0 - p) * au_p) * (half - leg)) / kPcLs;
}

// SolarWindDispersion.delay: NE_SW (with its Taylor terms about SWEPOCH)
// times the SWM 0 or SWM 1 geometry, dispersed
template <typename T>
PT_HD T solar_wind(const ChainCfg& c, const Theta<T>& th, const Row& r,
                   const T (&L)[3]) {
  const int o = c.o_sw;
  T ne;
  if (c.nsw == 1) {
    ne = th[o + swNE];
  } else {
    const T dt_sec = (((double)r.day + r.frac) - th[o + swEpoch]) * 86400.0;
    ne = taylor_horner(dt_sec, th, o + swNE, c.nsw);
  }
  const int op = o + swNE + c.nsw;
  const T geom = (c.flags & kSWM1)
                     ? sw_geometry_p(r, L, th[op], th[op + 1], th[op + 2])
                     : sw_geometry(r, L);
  return dispersion(ne * geom, r.freq);
}

// SolarWindDispersionX.delay: each of the row's (up to two) ranges' SWXDM
// times the SWM 0 geometry scaled between its opposition and conjunction
// values at the pulsar's ecliptic latitude (solar_wind.py swx_norm)
template <typename T>
PT_HD T swx(const ChainCfg& c, const Theta<T>& th, const Row& r,
            const T (&L)[3]) {
  T tot = make<T>(0.0);
  if (r.swx0 >= 0 || r.swx1 >= 0) {
    const T g = sw_geometry(r, L);
    const T sinb = clamp2(
        (L[0] * kEclPoleX + L[1] * kEclPoleY) + L[2] * kEclPoleZ, -1.0, 1.0);
    const T beta = clamp2(f_abs(f_asin(sinb)), 1e-6, kHalfPi);
    const T rho_c = kPi - beta;
    const T g_conj = ((kAuLs * rho_c) / f_sin(rho_c)) / kPcLs;
    const T g_opp = ((kAuLs * beta) / f_sin(beta)) / kPcLs;
    const T norm = (g - g_opp) / (g_conj - g_opp);
    if (r.swx0 >= 0) tot = tot + th[c.o_swx + r.swx0] * norm;
    if (r.swx1 >= 0) tot = tot + th[c.o_swx + r.swx1] * norm;
  }
  return dispersion(tot, r.freq);
}

// ln(f / 1 GHz)^k as torch forms lf**k for an integer k
PT_HD double log_freq_pow(double lf, int k) {
  if (k == 1) return lf;
  if (k == 2) return lf * lf;
  if (k == 3) return lf * lf * lf;
  return pow(lf, (double)k);
}

// chromatic.py chromatic_delay: K * cm * f^-alpha, infinite-frequency
// rows zeroed
template <typename T>
PT_HD T chromatic(const T& cm, const T& alpha, double freq) {
  if (!isfinite(freq)) return make<T>(0.0);
  return (kDMconst * cm) * pow_cbase(freq, -alpha);
}

// wave.py _WaveXBasis.basis_sum at dt [days]: the sines' sum over modes
// in mode order, plus the cosines'
template <typename T>
PT_HD T wave_sum(const Theta<T>& th, int o, int n, const T& dt) {
  T s = make<T>(0.0), cs = make<T>(0.0);
  for (int k = 0; k < n; ++k) {
    const T arg = (kTwoPi * dt) * th[o + 1 + k];
    T sa, ca;
    f_sincos(arg, sa, ca);
    s = s + sa * th[o + 1 + n + k];
    cs = cs + ca * th[o + 1 + 2 * n + k];
  }
  return s + cs;
}

// dt [days] of a row from the epoch in slot o
template <typename T>
PT_HD T days_since(const Theta<T>& th, int o, const Row& r) {
  return ((double)r.day + r.frac) - th[o];
}

// transient_events.py _ffac: f / fref, 1 on infinite-frequency rows
template <typename T>
PT_HD T freq_factor(double freq, const T& fref) {
  if (!isfinite(freq)) return make<T>(1.0);
  return freq / fref;
}

// SimpleExponentialDip.delay: each dip's smoothed one-sided exponential,
// the branch by the sign of dt
template <typename T>
PT_HD T exp_dips(const ChromCfg& c, const Theta<T>& th, const Row& r) {
  const int o = c.o_dip;
  const T eps = th[o + dipEps];
  const T ffac = freq_factor(r.freq, th[o + dipFref]);
  T tot = make<T>(0.0);
  for (int i = 0; i < c.ndip; ++i) {
    const int q = o + dipFirst + dipSlots * i;
    const T dt = days_since(th, q, r);
    const T tau = th[q + dipTau];
    T expfac;
    if (val(dt) >= 0.0)
      expfac = f_exp(-dt / tau) / (1.0 + f_exp(-dt / eps));
    else
      expfac = f_exp(dt * (tau - eps) / (tau * eps)) /
               (1.0 + f_exp(dt / eps));
    tot = tot - ((th[q + dipAmp] * f_pow(ffac, th[q + dipIdx])) *
                 th[q + dipNorm]) *
                    expfac;
  }
  return tot;
}

// ChromaticGaussianEvent.delay
template <typename T>
PT_HD T chrom_gauss(const ChromCfg& c, const Theta<T>& th, const Row& r) {
  const int o = c.o_gauss;
  const T ffac = freq_factor(r.freq, th[o + gaussFref]);
  T tot = make<T>(0.0);
  for (int i = 0; i < c.ngauss; ++i) {
    const int q = o + gaussFirst + gaussSlots * i;
    const T z = days_since(th, q, r) / th[q + gaussSigma];
    tot = tot + ((th[q + gaussSign] * th[q + gaussAmp]) *
                 f_exp(-0.5 * (z * z))) *
                    f_pow(ffac, -th[q + gaussIdx]);
  }
  return tot;
}

// the binary's t_bary - epoch [s] from the QS epoch difference, with the
// analytic tangent of its shift
template <typename T>
PT_HD T binary_dt(const Theta<T>& th, int o, const Row& r, const T& delay) {
  const T shift = -delay - th[o + bDdays] * 86400.0;
  const float ew[4] = {(float)val(th[o + bWords]), (float)val(th[o + bWords + 1]),
                       (float)val(th[o + bWords + 2]),
                       (float)val(th[o + bWords + 3])};
  const ptqs::QS q =
      ptqs::dt_seconds_qs(r.day, r.frac_w, val(th[o + bDay0]), ew, val(shift));
  return with_value(ptqs::qs_to_f64(q), shift);
}

// binary_orbits.py orbits_and_freq: the orbit count and the orbital
// frequency [1/s] at dt from PB/PBDOT or (the orbit family: kFBOrbit) the
// FBn series, plus (kOrbWave) orbwave_delta's Fourier terms at
// tw = t - ORBWAVE_EPOCH - the delay before the binary [s]
template <typename T, bool ORB>
PT_HD void orbit(const ChainCfg& c, const Theta<T>& th, const Row& r,
                 const T& dt, const T& delay, T& orbits, T& forb) {
  const int o = c.o_bin;
  if constexpr (ORB) {
    const OrbCfg& oc = static_cast<const OrbCfg&>(c);
    if (c.flags & kFBOrbit) {
      orbits = taylor_horner(dt, th, oc.o_fb + fbZero, oc.nfb + 1);
      forb = taylor_horner(dt, th, oc.o_fb + fbFirst, oc.nfb);
    } else {
      const T pb = th[o + bPB], pbdot = th[o + bPBDOT];
      orbits = dt / pb - (0.5 * pbdot) * ((dt / pb) * (dt / pb));
      forb = (1.0 - pbdot * (dt / pb)) / pb;
    }
    if (c.flags & kOrbWave) {
      const int q = oc.o_orbw;
      const T om = th[q + owOM];
      const T tw = days_since(th, q + owEpoch, r) * 86400.0 - delay;
      T dphi = make<T>(0.0), dfreq = make<T>(0.0);
      for (int k = 0; k < oc.norbw; ++k) {
        const T w = (k + 1.0) * om;
        T ss, cc;
        f_sincos(w * tw, ss, cc);
        const T C = th[q + owFirst + 2 * k], S = th[q + owFirst + 2 * k + 1];
        dphi = (dphi + C * cc) + S * ss;
        dfreq = dfreq + w * (S * cc - C * ss);
      }
      orbits = orbits + dphi;
      forb = forb + dfreq;
    }
  } else {
    const T pb = th[o + bPB], pbdot = th[o + bPBDOT];
    orbits = dt / pb - (0.5 * pbdot) * ((dt / pb) * (dt / pb));
    forb = (1.0 - pbdot * (dt / pb)) / pb;
  }
}

// BinaryBTPiecewise.dt_extra: t - T0 [s] of a row in a piece that sets
// T0X shifted by the piece's (T0 - T0X) * 86400 (the orbit family only)
template <typename T, bool ORB>
PT_HD T piece_dt(const ChainCfg& c, const Theta<T>& th, const Row& r,
                 const T& dt) {
  if constexpr (ORB) {
    const int i = static_cast<const OrbRow&>(r).btpiece;
    if ((c.flags & kBTPieces) && i >= 0) {
      const int q = static_cast<const OrbCfg&>(c).o_piece + pieceSlots * i;
      if (val(th[q + pieceT0Set]) != 0.0) return dt + th[q + pieceShift];
    }
  }
  return dt;
}

// BinaryBTPiecewise.a1_val: a1 of a row in a piece that sets A1X replaced
// in the reference's order a1 + ((A1X + dt A1DOT) - a1)
template <typename T, bool ORB>
PT_HD T piece_a1(const ChainCfg& c, const Theta<T>& th, const Row& r,
                 const T& dt, const T& a1) {
  if constexpr (ORB) {
    const int i = static_cast<const OrbRow&>(r).btpiece;
    if ((c.flags & kBTPieces) && i >= 0) {
      const int q = static_cast<const OrbCfg&>(c).o_piece + pieceSlots * i;
      if (val(th[q + pieceA1Set]) != 0.0)
        return a1 + ((th[q + pieceA1X] + dt * th[c.o_bin + bA1DOT]) - a1);
    }
  }
  return a1;
}

// BinaryELL1 / ELL1H / ELL1k .delay (the PB/PBDOT orbit; with ORB the
// orbit family's FBn orbit and ORBWAVEs too)
template <typename T, int BIN, bool ORB = false>
PT_HD T ell1(const ChainCfg& c, const Theta<T>& th, const Row& r,
             const T& delay) {
  const int o = c.o_bin;
  const T dt = binary_dt(th, o, r, delay);
  T orbits, forb;
  orbit<T, ORB>(c, th, r, dt, delay, orbits, forb);
  const T Phi = kTwoPi * (orbits - f_floor(orbits));
  T e1, e2;
  if (BIN == kELL1K) {
    // BinaryELL1k._eps: rotated by OMDOT dt, grown by 1 + LNEDOT dt
    const T wdt = th[o + bOMDOT_K] * dt;
    const T co = f_cos(wdt), so = f_sin(wdt);
    const T grow = 1.0 + th[o + bLNEDOT_K] * dt;
    e1 = grow * (th[o + bEPS1] * co + th[o + bEPS2] * so);
    e2 = grow * (th[o + bEPS2] * co - th[o + bEPS1] * so);
  } else {
    e1 = th[o + bEPS1] + dt * th[o + bEPS1DOT];
    e2 = th[o + bEPS2] + dt * th[o + bEPS2DOT];
  }
  const T a1 = th[o + bA1] + dt * th[o + bA1DOT];
  const T nhat = kTwoPi * forb;
  // roemer_harmonics
  const T S[4] = {
      1.0 - (5.0 * (e2 * e2) + 3.0 * (e1 * e1)) / 8.0,
      e2 / 2.0 - (5.0 * (e2 * e2 * e2) + (3.0 * (e1 * e1)) * e2) / 12.0,
      (3.0 / 8.0) * (e2 * e2 - e1 * e1),
      (e2 * e2 * e2) / 3.0 - (e1 * e1) * e2};
  const T C[4] = {e1 * e2 / 4.0,
                  (-e1 / 2.0 + (e1 * (e2 * e2)) / 2.0) + (e1 * e1 * e1) / 3.0,
                  -(3.0 / 4.0) * e1 * e2,
                  -e1 * (e2 * e2) + (e1 * e1 * e1) / 3.0};
  T s0 = make<T>(0.0), s1 = s0, s2 = s0;
  for (int k = 1; k <= 4; ++k) {
    const T kp = (double)k * Phi;
    const T s = f_sin(kp), cc = f_cos(kp);
    s0 = s0 + S[k - 1] * s + C[k - 1] * cc;
    s1 = s1 + (double)k * (S[k - 1] * cc - C[k - 1] * s);
    s2 = s2 - (double)(k * k) * (S[k - 1] * s + C[k - 1] * cc);
  }
  // roemer_const: ELL1k keeps the time-varying -(3/2) eps1 term
  const T Dre = BIN == kELL1K ? a1 * (s0 + (-1.5 * e1)) : a1 * (s0 + 0.0);
  const T Drep = a1 * s1;
  const T Drepp = a1 * s2;
  const T nD = nhat * Drep;
  const T delayI =
      Dre * (((1.0 - nD) + nD * nD) + ((0.5 * (nhat * nhat)) * Dre) * Drepp);
  if (!(c.flags & kBinShapiro)) return delayI + 0.0;
  if (BIN == kELL1H) {
    if (c.flags & kStigma) {
      // Freire & Wex 2010 eq. 28, the factors of STIGMA from theta
      const T bs = th[o + bH_B] * f_sin(Phi);
      const T lognum = th[o + bH_A] - bs;
      return delayI + th[o + bH_FACTOR] *
                          ((f_log(lognum) + bs) -
                           th[o + bH_D] * f_cos(2.0 * Phi));
    }
    // the harmonic sum from the 3rd up, its weights from theta
    T total = make<T>(0.0);
    for (int k = 3; k <= c.nharm; ++k) {
      const T kp = (double)k * Phi;
      total = total + th[o + bH_W + (k - 3)] *
                          ((k % 2 == 0) ? f_cos(kp) : f_sin(kp));
    }
    return delayI + th[o + bH_FACTOR] * total;
  }
  const T tm2 = th[o + bM2_ELL1] * kTsun;
  const T sini = clip_unit(th[o + bSINI_ELL1]);
  return delayI +
         (-2.0 * tm2) * f_log(clamp_min(1.0 - sini * f_sin(Phi), 1e-12));
}

// BinaryDDK._kopeikin: (delta a1 [ls], delta omega [rad], kin [rad]) of
// the Kopeikin 1995 annual-orbital parallax and Kopeikin 1996 proper-motion
// terms, from the astrometry block (its sky angles, proper motions and
// PX) and the row's SSB -> observatory vector in the astrometry's frame
template <typename T>
PT_HD void kopeikin(const ChainCfg& c, const Theta<T>& th, const Row& r,
                    const T& dt, T& d_a1, T& d_om, T& kin) {
  const int o = c.o_bin, oa = c.o_astro;
  T sl, cl, sb, cb;
  sky_sincos(th, oa, sl, cl, sb, cb);
  const T mu_lon = th[oa + aPMLon] * kMasToRad;
  const T mu_lat = th[oa + aPMLat] * kMasToRad;
  double obs[3] = {r.pos[0], r.pos[1], r.pos[2]};
  if (c.flags & kEcliptic) {
    // Astrometry._obs_pos_frame: ICRS -> the ecliptic frame
    const double ce = val(th[oa + aEclCos]), se = val(th[oa + aEclSin]);
    obs[1] = ce * r.pos[1] + se * r.pos[2];
    obs[2] = -se * r.pos[1] + ce * r.pos[2];
  }
  const T skom = th[o + bSKOM], ckom = th[o + bCKOM];
  const T tt0_yr = dt / kSecsPerYear;
  const double k96 = (c.flags & kK96) ? 1.0 : 0.0;
  // Kopeikin 1996 eq. 10: secular inclination change from PM
  const T d_kin = (k96 * ((-mu_lon) * skom + mu_lat * ckom)) * tt0_yr;
  kin = th[o + bKIN] + d_kin;
  const T sin_kin = f_sin(kin), cos_kin = f_cos(kin);
  const T a1_0 = th[o + bA1] + dt * th[o + bA1DOT];
  // Kopeikin 1996 eqs. 8-9
  const T d_a1_pm = ((a1_0 * d_kin) * cos_kin) / sin_kin;
  const T d_om_pm =
      ((k96 * (mu_lon * ckom + mu_lat * skom)) * tt0_yr) / sin_kin;
  // Kopeikin 1995 eqs. 15-19; 1/d as PX / kpc, so PX = 0 gives 0
  const T dI0 = (-obs[0]) * sl + obs[1] * cl;
  const T dJ0 = ((-obs[0]) * sb) * cl - (obs[1] * sb) * sl + obs[2] * cb;
  const T inv_d = th[oa + aPX] / kKpcLs;
  const T d_a1_px =
      (((a1_0 * cos_kin) / sin_kin) * (dI0 * skom - dJ0 * ckom)) * inv_d;
  const T d_om_px = ((-(dI0 * ckom + dJ0 * skom)) * inv_d) / sin_kin;
  d_a1 = d_a1_pm + d_a1_px;
  d_om = d_om_pm + d_om_px;
}

// BinaryDD / BinaryBT delay (PB/PBDOT orbit), and the variants: DDK
// (the Kopeikin terms per row), DDS and DDH (the Shapiro slots as
// given); with ORB the orbit family's FBn orbit, ORBWAVEs and
// BT_PIECEWISE's pieces too; aux, if given, receives (M, e, E) of the
// Kepler solve
template <typename T, int BIN, bool ORB = false>
PT_HD T dd(const ChainCfg& c, const Theta<T>& th, const Row& r,
           const T& delay, double* aux) {
  const int o = c.o_bin;
  const T dt = piece_dt<T, ORB>(c, th, r, binary_dt(th, o, r, delay));
  T d_a1, d_om, kin;
  if (BIN == kDDK) kopeikin(c, th, r, dt, d_a1, d_om, kin);
  T orbits, forb;
  orbit<T, ORB>(c, th, r, dt, delay, orbits, forb);
  const T M = kTwoPi * (orbits - f_floor(orbits));
  const T e = clip_unit(th[o + bECC] + dt * th[o + bEDOT]);
  // the Kepler solve, and its implicit-function tangent
  const double ec = ptkepler::clamp_unit(val(e));
  const double Ev = ptkepler::solve(val(M), ec);
  const double inv = 1.0 / (1.0 - ec * cos(Ev));
  const T E = implicit_E(Ev, M, e, sin(Ev), inv);
  if (aux != nullptr) {
    aux[0] = val(M);
    aux[1] = val(e);
    aux[2] = Ev;
  }
  T a1 = th[o + bA1] + dt * th[o + bA1DOT];
  if (BIN == kDDK) a1 = a1 + d_a1;
  a1 = piece_a1<T, ORB>(c, th, r, dt, a1);
  const T n = kTwoPi * forb;
  // true_anomaly_continuous
  T nu = 2.0 * f_atan2(f_sqrt(1.0 + e) * f_sin(E / 2.0),
                       f_sqrt(1.0 - e) * f_cos(E / 2.0));
  if (val(nu) < 0.0) nu = nu + kTwoPi;
  nu = (kTwoPi * orbits + nu) - M;
  T omega = (c.flags & kOmegaFromNu)
                ? th[o + bOM] + (th[o + bOMDOT] / n) * nu
                : th[o + bOM] + th[o + bOMDOT] * dt;
  if (BIN == kDDK) omega = omega + d_om;
  const T er = e * (1.0 + th[o + bDR]);
  const T eth = clip_unit(e * (1.0 + th[o + bDTH]));
  const T sinE = f_sin(E), cosE = f_cos(E);
  const T sw = f_sin(omega), cw = f_cos(omega);
  const T alpha = a1 * sw;
  const T beta = (a1 * f_sqrt(1.0 - eth * eth)) * cw;
  const T bg = beta + th[o + bGAMMA];
  // Dre = Roemer + Einstein; derivatives wrt E (DD eq. [48-50])
  const T Dre = alpha * (cosE - er) + bg * sinE;
  const T Drep = (-alpha) * sinE + bg * cosE;
  const T Drepp = (-alpha) * cosE - bg * sinE;
  const T nhat = n / (1.0 - e * cosE);
  const T nD = nhat * Drep;
  const T nh2 = nhat * nhat;
  // inverse timing, DD eq. [46-52]
  const T delayI =
      Dre * ((((1.0 - nD) + nD * nD) + ((0.5 * nh2) * Dre) * Drepp) -
             (((((0.5 * e) * sinE) / (1.0 - e * cosE)) * nh2) * Dre) * Drep);
  T out = delayI;
  if (c.flags & kBinShapiro) {
    // DD eq. [26]
    T tm2, sini;
    if (BIN == kDDTM2) {
      tm2 = th[o + bTM2];
      sini = th[o + bSINI_RAW];
    } else {
      tm2 = th[o + bM2_DD] * kTsun;
      sini = clip_unit(BIN == kDDK ? f_sin(kin) : th[o + bSINI_DD]);
    }
    const T arg = (1.0 - e * cosE) -
                  sini * (sw * (cosE - e) + (f_sqrt(1.0 - e * e) * cw) * sinE);
    out = out + (-2.0 * tm2) * f_log(clamp_min(arg, 1e-12));
  } else {
    out = out + 0.0;
  }
  if (c.flags & kAberration) {
    // DD eq. [27]
    const T s = f_sin(omega + nu), cc = f_cos(omega + nu);
    out = out + (th[o + bA0] * (s + e * sw) + th[o + bB0] * (cc + e * cw));
  }
  return out;
}

// TimingModel.orbital_phase: the binary's orbits - floor(orbits) at the
// delay of the components before it, from TASC (the ELL1 family) or T0
// with BT_PIECEWISE's pieces (the DD family), with the orbit family's
// FBn orbit and ORBWAVEs: ell1's and dd's first steps
template <typename T, int FAM, bool ORB>
PT_HD T orbital_phase(const ChainCfg& c, const Theta<T>& th, const Row& r,
                      const T& delay) {
  const int o = c.o_bin;
  T dt = binary_dt(th, o, r, delay);
  if (FAM == kDD || FAM == kDDK || FAM == kDDTM2)
    dt = piece_dt<T, ORB>(c, th, r, dt);
  T orbits, forb;
  orbit<T, ORB>(c, th, r, dt, delay, orbits, forb);
  return orbits - f_floor(orbits);
}

// the whole chain, in DEFAULT_ORDER; each component reads the delay
// accumulated before it (PhaseCalc.delay).  With ORBPH the chain stops
// at the binary and returns its orbital_phase instead (a layout with a
// binary; the template values without ORBPH compile as they did)
template <typename T, int BIN, bool ORBPH = false>
PT_HD T delay_row(const CfgOf<BIN>& c, const Theta<T>& th, const RowOf<BIN>& r,
                  double* aux) {
  constexpr int FAM = BIN & ~(kDMFamily | kChromFamily | kOrbitFamily);
  constexpr bool DMF = (BIN & kDMFamily) != 0;
  constexpr bool CHF = (BIN & kChromFamily) != 0;
  constexpr bool ORB = (BIN & kOrbitFamily) != 0;
  T d = make<T>(0.0);
  T L[3] = {d, d, d};
  if (c.flags & kAstro) d = d + astrometry(c, th, r, L);
  if (c.flags & kJump) {
    T tot = make<T>(0.0);
    for (int j = 0; j < c.njump; ++j)
      if ((r.jbits >> j) & 1) tot = tot - th[c.o_jump + j];
    d = d + tot;
  }
  if constexpr (CHF) {
    if (c.flags & kTropo) d = d + r.tropo;
  }
  if (c.flags & kShapiro) {
    // the component's sum added once (PhaseCalc adds each component's)
    if constexpr (ORB)
      d = d + solar_system_shapiro(c, r, L);
    else
      d = d + sun_shapiro(r, L);
  }
  if constexpr (DMF) {
    if (c.flags & kSolarWind) d = d + solar_wind(c, th, r, L);
    if (c.flags & kSWX) d = d + swx(c, th, r, L);
  }
  if (c.flags & kDM) {
    const int o = c.o_dm;
    T dm;
    if (c.ndm == 1) {
      dm = th[o + 1];
    } else {
      const T dt_sec = (((double)r.day + r.frac) - th[o]) * 86400.0;
      dm = taylor_horner(dt_sec, th, o + 1, c.ndm);
    }
    d = d + dispersion(dm, r.freq);
  }
  if (c.flags & kDMX) {
    // the plain version's masked sum: two nonzero terms add exactly in
    // either order
    T dm = r.dmx0 >= 0 ? th[c.o_dmx + r.dmx0] : make<T>(0.0);
    if (r.dmx1 >= 0) dm = dm + th[c.o_dmx + r.dmx1];
    d = d + dispersion(dm, r.freq);
  }
  if constexpr (DMF) {
    if (c.flags & kFDJumpDM) {
      // FDJumpDM.dm_value: each selecting member subtracted
      T dm = make<T>(0.0);
      for (int j = 0; j < c.nfdm; ++j)
        if ((r.fdmbits >> j) & 1) dm = dm - th[c.o_fdm + j];
      d = d + dispersion(dm, r.freq);
    }
  }
  if constexpr (CHF) {
    if (c.flags & kDMWaveX)
      d = d + dispersion(wave_sum(th, c.o_dmwx, c.ndmwx,
                                  days_since(th, c.o_dmwx, r)),
                         r.freq);
    if (c.flags & kCM) {
      const int o = c.o_cm;
      T cm;
      if (c.ncm == 1) {
        cm = th[o + cmTerms];
      } else {
        const T dt_sec = days_since(th, o + cmEpoch, r) * 86400.0;
        cm = taylor_horner(dt_sec, th, o + cmTerms, c.ncm);
      }
      d = d + chromatic(cm, th[o + cmAlpha], r.freq);
    }
    if (c.flags & kCMX) {
      // as DMX's bins
      T cm = r.cmx0 >= 0 ? th[c.o_cmx + r.cmx0] : make<T>(0.0);
      if (r.cmx1 >= 0) cm = cm + th[c.o_cmx + r.cmx1];
      d = d + chromatic(cm, th[c.o_cm + cmAlpha], r.freq);
    }
    if (c.flags & kCMWaveX)
      d = d + chromatic(wave_sum(th, c.o_cmwx, c.ncmwx,
                                 days_since(th, c.o_cmwx, r)),
                        th[c.o_cm + cmAlpha], r.freq);
    if (c.flags & kExpDip) d = d + exp_dips(c, th, r);
    if (c.flags & kChromGauss) d = d + chrom_gauss(c, th, r);
  }
  if constexpr (ORBPH) return orbital_phase<T, FAM, ORB>(c, th, r, d);
  if (FAM == kELL1 || FAM == kELL1H || FAM == kELL1K)
    d = d + ell1<T, FAM, ORB>(c, th, r, d);
  if (FAM == kDD || FAM == kDDK || FAM == kDDTM2)
    d = d + dd<T, FAM, ORB>(c, th, r, d, aux);
  if (c.flags & kFD) {
    T out = make<T>(0.0);
    if (isfinite(r.freq)) {
      const double lf = log(r.freq / 1000.0);
      double term = 1.0;
      for (int k = 0; k < c.nfd; ++k) {
        term = term * lf;
        out = out + th[c.o_fd + k] * term;
      }
    }
    d = d + out;
  }
  if constexpr (DMF) {
    if (c.flags & kFDJump) {
      // FDJump.delay: each selecting member's FD<k>JUMP ln(f/1 GHz)^k
      T out = make<T>(0.0);
      if (isfinite(r.freq)) {
        const double lf = log(r.freq / 1000.0);
        for (int j = 0; j < c.nfdj; ++j)
          if ((r.fdjbits >> j) & 1)
            out = out + th[c.o_fdj + j] * log_freq_pow(lf, c.fdj_order[j]);
      }
      d = d + out;
    }
  }
  if constexpr (CHF) {
    // WaveX, the last delay term: dt shifted by the whole delay before it
    if (c.flags & kWaveX)
      d = d + wave_sum(th, c.o_wx, c.nwx,
                       days_since(th, c.o_wx, r) - d / 86400.0);
  }
  return d;
}

}  // namespace ptchain
