// K1: the dual interior pH solve, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   ocean_bgc_tpu/ops/pallas_carbonate.py::_carbonate_kernel (:63),
// in the instance the production step launches: equilibrium constants
// read from the env cache (coeffs_in=True), no saturation outputs
// (with_sat=False), no iteration seed.
//
// Per cell: tracers to mass units, then for each of the two scenarios
// (ambient, ALT_CO2) the pH bracket (previous pH +/- DEL_PH, or the cold
// [6, 9] window where the previous pH is the 0 sentinel), the bracketed
// safe-Newton root of the total-alkalinity residual (drtsafe_row,
// co2calc.F90:872-997) and the speciation into pH, H2CO3, HCO3 and CO3.
//
// Design.  One thread per cell, each running its own loop, grid-stride
// over the nlev*ncol cells; the ragged edge is masked by the loop bound.
// Each lane freezes on its own convergence in the reference too
// (ocean_bgc_tpu/ops/carbonate.py:416-425), so a thread-private loop
// gives each lane the same iterate sequence the batched solve gives it.
// The TPU kernel's 128-lane tiles, padding and stacked/sequential dual
// choice have no counterpart here: each thread solves ambient, then
// ALT_CO2.  Templated on float/double with the solver tolerance chosen
// per type as the plain version chooses it (1e-10 at f64, 1e-13 at f32).
// The alkalinity residual keeps the reference's association order term
// by term; built with --fmad=false and IEEE division, so the kernel and
// its plain PyTorch version differ only where an iterate flips a
// convergence test.
//
// Bound.  The kernel must read 21 fields per cell (DIC, ALK, PO4, SiO3,
// the two previous pH fields, 15 cached coefficients) and write 8:
// 29 * sizeof(T) bytes per cell, ~114 MB at f64 and ~57 MB at f32 for
// the 60 x 8192 flagship world.  Warm cells converge in ~3 iterations of
// ~150 arithmetic operations each, so at that size the kernel is bound
// by device memory bandwidth; cold cells (first step) take ~13
// iterations and move it towards the f64 arithmetic rate.  Coalescing is
// what the design keeps: thread i reads element i of each field, so a
// warp reads 32 neighbouring columns.  Divergence between a warp's lanes
// (a lane that needs more iterations holds its warp) is the cost it
// accepts; the step keeps it small by warm-seeding every lane, inactive
// ones included, from a converged root.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// constants of ocean_bgc_tpu_torch/constants.py, evaluated in double as
// Python evaluates them, then rounded to the working type
constexpr int kMaxit = 100;
constexpr int kBracketGrowGuard = 60;
constexpr double kLn10 = 2.302585092994045684;
constexpr double kDelPh = 0.20;
constexpr double kPhlo3dInit = 6.0;
constexpr double kPhhi3dInit = 9.0;
constexpr double kRhoSw = 1.026;
constexpr double kMassToVol = 1e6 * kRhoSw;
constexpr double kVolToMass = 1.0 / kMassToVol;
constexpr double kSaltMin = 0.1;
constexpr double kDicMin = kSaltMin / 35.0 * 1944.0;
constexpr double kAlkMin = kSaltMin / 35.0 * 2225.0;
constexpr double kXaccF64 = 1e-10;
constexpr double kXaccF32 = 1e-5 * 1e-8;

constexpr int kNumCoeffs = 15;
constexpr int kNumIn = 6 + kNumCoeffs;
constexpr int kNumOut = 8;

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log10(float x) { return log10f(x); }
__device__ __forceinline__ double m_log10(double x) { return log10(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

// max(x, lo) that keeps a NaN x, like torch.clamp_min
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }

template <typename T>
struct Coeffs {
  T k0, k1, k2, ff, kb, k1p, k2p, k3p, ksi, kw, ks, kf, bt, st, ft;
};

template <typename T>
struct Args {
  // dic, ta, pt, sit (mmol/m^3), ph_prev_a, ph_prev_b, then the 15
  // coefficients in CarbCoeffs order
  const T* in[kNumIn];
  // ph_a, h2co3_a, hco3_a, co3_a, ph_b, h2co3_b, hco3_b, co3_b
  T* out[kNumOut];
};

// Total alkalinity residual fn(H) and its slope (ops/carbonate.py::talk),
// same association order term by term.
template <typename T>
__device__ __forceinline__ void talk(const Coeffs<T>& c, T dic, T ta, T pt,
                                     T sit, T h, T& fn, T& df) {
  const T inv_h = T(1) / h;
  const T h2 = h * h;
  const T inv_h2 = inv_h * inv_h;
  const T h3 = h2 * h;
  const T k12 = c.k1 * c.k2;
  const T k12p = c.k1p * c.k2p;
  const T k123p = k12p * c.k3p;
  const T phos_den = h3 + c.k1p * h2 + k12p * h + k123p;
  const T inv_phos_den = T(1) / phos_den;
  const T inv_phos_den2 = inv_phos_den * inv_phos_den;
  const T dphos_den = T(3) * h2 + T(2) * c.k1p * h + k12p;
  const T carb_den = h2 + c.k1 * h + k12;
  const T inv_carb_den = T(1) / carb_den;
  const T inv_carb_den2 = inv_carb_den * inv_carb_den;
  const T dcarb_den = T(2) * h + c.k1;
  const T htot_per_hfree = T(1) + c.st / c.ks;
  const T hfree_per_htot = T(1) / htot_per_hfree;
  const T inv_borate_den = T(1) / (c.kb + h);
  const T inv_sili_den = T(1) / (c.ksi + h);
  const T hso4_frac = T(1) / (T(1) + htot_per_hfree * c.ks * inv_h);
  const T hf_frac = T(1) / (T(1) + c.kf * inv_h);

  fn = c.k1 * dic * h * inv_carb_den
     + T(2) * dic * k12 * inv_carb_den
     + c.bt * c.kb * inv_borate_den
     + c.kw * inv_h
     + pt * k12p * h * inv_phos_den
     + T(2) * pt * k123p * inv_phos_den
     + sit * c.ksi * inv_sili_den
     - h * hfree_per_htot
     - c.st * hso4_frac
     - c.ft * hf_frac
     - pt * h3 * inv_phos_den
     - ta;

  df = c.k1 * dic * (carb_den - h * dcarb_den) * inv_carb_den2
     - T(2) * dic * k12 * dcarb_den * inv_carb_den2
     - c.bt * c.kb * inv_borate_den * inv_borate_den
     - c.kw * inv_h2
     + (pt * k12p * (phos_den - h * dphos_den)) * inv_phos_den2
     - T(2) * pt * k123p * dphos_den * inv_phos_den2
     - sit * c.ksi * inv_sili_den * inv_sili_den
     - T(1) * hfree_per_htot
     - c.st * hso4_frac * hso4_frac * (htot_per_hfree * c.ks * inv_h2)
     - c.ft * hf_frac * hf_frac * c.kf * inv_h2
     - pt * h2 * (T(3) * phos_den - h * dphos_den) * inv_phos_den2;
}

template <typename T>
__device__ __forceinline__ bool not_bracketed(T flo, T fhi) {
  return (flo > T(0) && fhi > T(0)) || (flo < T(0) && fhi < T(0));
}

// One lane of ops/carbonate.py::_solve_htotal_impl.
template <typename T>
__device__ T solve_htotal(const Coeffs<T>& c, T dic, T ta, T pt, T sit,
                          T x1, T x2, T xacc) {
  T flo, fhi, unused;
  talk(c, dic, ta, pt, sit, x1, flo, unused);
  talk(c, dic, ta, pt, sit, x2, fhi, unused);
  for (int it = 0; it < kBracketGrowGuard && not_bracketed(flo, fhi); ++it) {
    const T growth = m_sqrt(x2 / x1);
    x1 = x1 / growth;
    x2 = x2 * growth;
    talk(c, dic, ta, pt, sit, x1, flo, unused);
    talk(c, dic, ta, pt, sit, x2, fhi, unused);
  }
  const bool neg_at_x1 = flo < T(0);
  T xlo = neg_at_x1 ? x1 : x2;
  T xhi = neg_at_x1 ? x2 : x1;

  T soln = T(0.5) * (xlo + xhi);
  T dxold = m_abs(xlo - xhi);
  T dx = dxold;
  T f, df;
  talk(c, dic, ta, pt, sit, soln, f, df);
  for (int it = 0; it < kMaxit; ++it) {
    // bisect when Newton would leave the bracket or converges too slowly
    const bool leave_bracket =
        ((soln - xhi) * df - f) * ((soln - xlo) * df - f) >= T(0);
    const bool dx_decrease = m_abs(T(2) * f) <= m_abs(dxold * df);
    const bool bisect = leave_bracket || !dx_decrease;
    dxold = dx;
    const T dx_bis = T(0.5) * (xhi - xlo);
    const T dx_newt = -f / df;
    const T soln_n = bisect ? xlo + dx_bis : soln + dx_newt;
    const bool stalled = bisect ? (xlo == soln_n) : (soln == soln_n);
    dx = bisect ? dx_bis : dx_newt;
    soln = soln_n;
    if (stalled || m_abs(dx) < xacc) break;
    talk(c, dic, ta, pt, sit, soln, f, df);
    if (f < T(0)) {
      xlo = soln;
    } else if (f >= T(0)) {
      xhi = soln;
    }
  }
  return soln;
}

template <typename T>
__global__ void carbonate_dual_kernel(Args<T> a, int64_t n, T xacc) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T dic = clamp_min(a.in[0][i], T(kDicMin)) * T(kVolToMass);
    const T ta = clamp_min(a.in[1][i], T(kAlkMin)) * T(kVolToMass);
    const T pt = clamp_min(a.in[2][i], T(0)) * T(kVolToMass);
    const T sit = clamp_min(a.in[3][i], T(0)) * T(kVolToMass);
    const T* const* k = a.in + 6;
    const Coeffs<T> c{k[0][i],  k[1][i],  k[2][i],  k[3][i],  k[4][i],
                      k[5][i],  k[6][i],  k[7][i],  k[8][i],  k[9][i],
                      k[10][i], k[11][i], k[12][i], k[13][i], k[14][i]};

#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const T ph_prev = a.in[4 + s][i];
      const bool warm = ph_prev != T(0);
      const T phlo = warm ? ph_prev - T(kDelPh) : T(kPhlo3dInit);
      const T phhi = warm ? ph_prev + T(kDelPh) : T(kPhhi3dInit);
      const T x1 = m_exp(T(-kLn10) * phhi);
      const T x2 = m_exp(T(-kLn10) * phlo);
      const T h = solve_htotal(c, dic, ta, pt, sit, x1, x2, xacc);

      const T h2 = h * h;
      const T k12 = c.k1 * c.k2;
      const T denom = T(1) / (h2 + c.k1 * h + k12);
      T* const* out = a.out + 4 * s;
      out[0][i] = -m_log10(h);
      out[1][i] = dic * h2 * denom * T(kMassToVol);
      out[2][i] = dic * c.k1 * h * denom * T(kMassToVol);
      out[3][i] = dic * k12 * denom * T(kMassToVol);
    }
  }
}

template <typename T>
int launch(const void* const* ins, void* const* outs, int64_t n,
           cudaStream_t stream, T xacc) {
  Args<T> a;
  for (int j = 0; j < kNumIn; ++j) a.in[j] = static_cast<const T*>(ins[j]);
  for (int j = 0; j < kNumOut; ++j) a.out[j] = static_cast<T*>(outs[j]);
  constexpr int kThreads = 256;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  carbonate_dual_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(a, n, xacc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  ``ins`` holds 21 device pointers and
// ``outs`` 8, all contiguous arrays of ``n`` elements of one type
// (double if ``is_double``, else float).  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success).
extern "C" int obgc_carbonate_dual(int is_double, const void* const* ins,
                                   void* const* outs, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) return launch<double>(ins, outs, n, s, kXaccF64);
  return launch<float>(ins, outs, n, s, static_cast<float>(kXaccF32));
}

extern "C" const char* obgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
