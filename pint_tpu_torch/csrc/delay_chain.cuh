// The delay chain of one TOA row: every delay component of a timing model
// that the delay_chain kernel covers, in DEFAULT_ORDER, in float64,
// written once over a scalar type T: `double` gives the delay, `Dual`
// (value, tangent) gives the delay and its forward-mode tangent.
//
// Device code of these JAX functions of pint_tpu (no Pallas kernel there:
// XLA compiles them from jnp, one elementwise op at a time):
//   K4  pint_tpu/models/astrometry.py  Astrometry.delay, _sincos
//       (equatorial, PM and PX), solar_system_shapiro.py (the Sun)
//       dispersion.py  DispersionDM (+ DM Taylor terms), DispersionDMX
//       frequency_dependent.py  FD;  jump.py  DelayJump
//       binary_ell1.py  BinaryELL1.delay (M2/SINI Shapiro)
//       binary_dd.py  BinaryDDBase/BinaryDD/BinaryBT.delay
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

PT_HD double val(double x) { return x; }
PT_HD double val(const Dual& x) { return x.v; }
PT_HD double tan_of(double) { return 0.0; }
PT_HD double tan_of(const Dual& x) { return x.d; }

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

// pint_tpu's clip_unit: clamp into [0, 1 - 1e-9], tangent straight through
PT_HD double clip_unit(double x) { return ptkepler::clamp_unit(x); }
PT_HD Dual clip_unit(Dual x) { return {ptkepler::clamp_unit(x.v), x.d}; }

// torch.clamp(x, min=lo): the tangent where x >= lo, else none
PT_HD double clamp_min(double x, double lo) { return x < lo ? lo : x; }
PT_HD Dual clamp_min(Dual x, double lo) {
  return x.v < lo ? Dual{lo, 0.0} : (x.v >= lo ? x : Dual{x.v, 0.0});
}

template <typename T>
PT_HD T make(double v, double d);
template <>
PT_HD double make<double>(double v, double) { return v; }
template <>
PT_HD Dual make<Dual>(double v, double d) { return {v, d}; }

// the parameter vector theta, and for Dual its tangent
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
};

// binary families (the kernels' template parameter)
enum : int32_t { kNoBinary = 0, kELL1 = 1, kDD = 2 };

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
};

struct ChainCfg {
  int32_t flags, binary, P;
  int32_t ndm, ndmx, njump, nfd;
  int32_t o_astro, o_dm, o_dmx, o_jump, o_fd, o_bin;
};

constexpr double kTwoPi = 6.283185307179586;   // 2.0 * math.pi
constexpr double kMasToRad = 4.8481368110953594e-09;  // pi/(180 3600 1000)
constexpr double kKpcLs = 102927125054.33899;  // 1 kpc in light-seconds
constexpr double kAuLs = 499.00478383615643;   // AU / c
constexpr double kTsun = 4.92549094830932e-06;  // GM_sun / c^3
constexpr double kDMconst = 4149.377593360996;   // 1 / 2.41e-4

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
};

// K * dm / f^2 with infinite-frequency rows zeroed
template <typename T>
PT_HD T dispersion(const T& dm, double freq) {
  if (!isfinite(freq)) return make<T>(0.0, 0.0);
  return (kDMconst * dm) / (freq * freq);
}

// -- the components ---------------------------------------------------------

// Astrometry.delay + psr_dir (equatorial); L is the pulsar direction
template <typename T>
PT_HD T astrometry(const ChainCfg& c, const Theta<T>& th, const Row& r,
                   T (&L)[3]) {
  const int o = c.o_astro;
  // _sincos: host-exact reference sin/cos, rotated by the fit offset
  const T dra = th[o + 2], ddec = th[o + 5];
  const T sdr = f_sin(dra), cdr = f_cos(dra);
  const T sa = th[o + 0] * cdr + th[o + 1] * sdr;
  const T ca = th[o + 1] * cdr - th[o + 0] * sdr;
  const T sdd = f_sin(ddec), cdd = f_cos(ddec);
  const T sd = th[o + 3] * cdd + th[o + 4] * sdd;
  const T cd = th[o + 4] * cdd - th[o + 3] * sdd;
  L[0] = cd * ca;
  L[1] = cd * sa;
  L[2] = sd;
  if (c.flags & kPM) {
    const T pm_ra = th[o + 6] * kMasToRad;
    const T pm_dec = th[o + 7] * kMasToRad;
    const T dt_yr = (((double)r.day + r.frac) - th[o + 9]) / 365.25;
    const T e_ra[3] = {-sa, ca, make<T>(0.0, 0.0)};
    const T e_dec[3] = {-sd * ca, -sd * sa, cd};
    T n[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      n[i] = L[i] + (e_ra[i] * pm_ra + e_dec[i] * pm_dec) * dt_yr;
    const T norm = f_sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) L[i] = n[i] / norm;
  }
  const T rdl = r.pos[0] * L[0] + r.pos[1] * L[1] + r.pos[2] * L[2];
  const double re_sqr =
      r.pos[0] * r.pos[0] + r.pos[1] * r.pos[1] + r.pos[2] * r.pos[2];
  T out = -rdl;
  // guard the 0/0 at exactly-barycentric TOAs
  if (re_sqr > 0.0)
    out = out + 0.5 * (re_sqr * th[o + 8] / kKpcLs) *
                    (1.0 - rdl * rdl / re_sqr);
  return out;
}

// SolarSystemShapiro, the Sun only
template <typename T>
PT_HD T sun_shapiro(const Row& r, const T (&L)[3]) {
  const double rr =
      sqrt(r.sun[0] * r.sun[0] + r.sun[1] * r.sun[1] + r.sun[2] * r.sun[2]);
  if (!(rr > 0.0)) return make<T>(0.0, 0.0);
  const T rcos = r.sun[0] * L[0] + r.sun[1] * L[1] + r.sun[2] * L[2];
  return (-2.0 * kTsun) * f_log((rr - rcos) / kAuLs);
}

// pint_tpu.utils.taylor_horner: sum_k c_k dt^k / k!
template <typename T>
PT_HD T taylor_horner(const T& dt, const Theta<T>& th, int o, int n) {
  T acc = 0.0 * dt;
  for (int k = n - 1; k >= 0; --k) acc = acc * dt / (k + 1.0) + th[o + k];
  return acc;
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
  return make<T>(ptqs::qs_to_f64(q), tan_of(shift));
}

// BinaryELL1.delay (PB/PBDOT orbit)
template <typename T>
PT_HD T ell1(const ChainCfg& c, const Theta<T>& th, const Row& r,
             const T& delay) {
  const int o = c.o_bin;
  const T dt = binary_dt(th, o, r, delay);
  const T pb = th[o + bPB], pbdot = th[o + bPBDOT];
  const T orbits = dt / pb - (0.5 * pbdot) * ((dt / pb) * (dt / pb));
  const T forb = (1.0 - pbdot * (dt / pb)) / pb;
  const T Phi = kTwoPi * (orbits - f_floor(orbits));
  const T e1 = th[o + bEPS1] + dt * th[o + bEPS1DOT];
  const T e2 = th[o + bEPS2] + dt * th[o + bEPS2DOT];
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
  T s0 = make<T>(0.0, 0.0), s1 = s0, s2 = s0;
  for (int k = 1; k <= 4; ++k) {
    const T kp = (double)k * Phi;
    const T s = f_sin(kp), cc = f_cos(kp);
    s0 = s0 + S[k - 1] * s + C[k - 1] * cc;
    s1 = s1 + (double)k * (S[k - 1] * cc - C[k - 1] * s);
    s2 = s2 - (double)(k * k) * (S[k - 1] * s + C[k - 1] * cc);
  }
  const T Dre = a1 * (s0 + 0.0);
  const T Drep = a1 * s1;
  const T Drepp = a1 * s2;
  const T nD = nhat * Drep;
  const T delayI =
      Dre * (((1.0 - nD) + nD * nD) + ((0.5 * (nhat * nhat)) * Dre) * Drepp);
  if (!(c.flags & kBinShapiro)) return delayI + 0.0;
  const T tm2 = th[o + bM2_ELL1] * kTsun;
  const T sini = clip_unit(th[o + bSINI_ELL1]);
  return delayI +
         (-2.0 * tm2) * f_log(clamp_min(1.0 - sini * f_sin(Phi), 1e-12));
}

// BinaryDD / BinaryBT delay (PB/PBDOT orbit); aux, if given, receives
// (M, e, E) of the Kepler solve
template <typename T>
PT_HD T dd(const ChainCfg& c, const Theta<T>& th, const Row& r,
           const T& delay, double* aux) {
  const int o = c.o_bin;
  const T dt = binary_dt(th, o, r, delay);
  const T pb = th[o + bPB], pbdot = th[o + bPBDOT];
  const T orbits = dt / pb - (0.5 * pbdot) * ((dt / pb) * (dt / pb));
  const T forb = (1.0 - pbdot * (dt / pb)) / pb;
  const T M = kTwoPi * (orbits - f_floor(orbits));
  const T e = clip_unit(th[o + bECC] + dt * th[o + bEDOT]);
  // the Kepler solve, and its implicit-function tangent
  const double ec = ptkepler::clamp_unit(val(e));
  const double Ev = ptkepler::solve(val(M), ec);
  const double inv = 1.0 / (1.0 - ec * cos(Ev));
  const T E = make<T>(Ev, ((0.0 + tan_of(M)) + sin(Ev) * tan_of(e)) * inv);
  if (aux != nullptr) {
    aux[0] = val(M);
    aux[1] = val(e);
    aux[2] = Ev;
  }
  const T a1 = th[o + bA1] + dt * th[o + bA1DOT];
  const T n = kTwoPi * forb;
  // true_anomaly_continuous
  T nu = 2.0 * f_atan2(f_sqrt(1.0 + e) * f_sin(E / 2.0),
                       f_sqrt(1.0 - e) * f_cos(E / 2.0));
  if (val(nu) < 0.0) nu = nu + kTwoPi;
  nu = (kTwoPi * orbits + nu) - M;
  const T omega = (c.flags & kOmegaFromNu)
                      ? th[o + bOM] + (th[o + bOMDOT] / n) * nu
                      : th[o + bOM] + th[o + bOMDOT] * dt;
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
    const T tm2 = th[o + bM2_DD] * kTsun;
    const T sini = clip_unit(th[o + bSINI_DD]);
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

// the whole chain, in DEFAULT_ORDER; each component reads the delay
// accumulated before it (PhaseCalc.delay)
template <typename T, int BIN>
PT_HD T delay_row(const ChainCfg& c, const Theta<T>& th, const Row& r,
                  double* aux) {
  T d = make<T>(0.0, 0.0);
  T L[3] = {d, d, d};
  if (c.flags & kAstro) d = d + astrometry(c, th, r, L);
  if (c.flags & kJump) {
    T tot = make<T>(0.0, 0.0);
    for (int j = 0; j < c.njump; ++j)
      if ((r.jbits >> j) & 1) tot = tot - th[c.o_jump + j];
    d = d + tot;
  }
  if (c.flags & kShapiro) d = d + sun_shapiro(r, L);
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
    T dm = r.dmx0 >= 0 ? th[c.o_dmx + r.dmx0] : make<T>(0.0, 0.0);
    if (r.dmx1 >= 0) dm = dm + th[c.o_dmx + r.dmx1];
    d = d + dispersion(dm, r.freq);
  }
  if (BIN == kELL1) d = d + ell1(c, th, r, d);
  if (BIN == kDD) d = d + dd(c, th, r, d, aux);
  if (c.flags & kFD) {
    T out = make<T>(0.0, 0.0);
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
  return d;
}

}  // namespace ptchain
