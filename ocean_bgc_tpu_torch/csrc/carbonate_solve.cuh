// The per-cell interior pH solve, shared by K1 (carbonate_dual.cu) and K2
// (interior_step.cu), so that both kernels run one device routine.
//
// Device counterpart of ops/carbonate.py: ``talk`` (the total-alkalinity
// residual and its slope, same association order term by term),
// ``_solve_htotal_impl`` for one lane (bracket growth, orientation, the
// bracketed safe-Newton iteration that stops on |dx| < xacc or a stall),
// ``_to_mass_units`` and the pH-space bracket of
// ops/cuda_carbonate.py::_ph_brackets.  Built with --fmad=false and IEEE
// division, each lane follows the plain version's iterate sequence.
//
// The constants (obgc_constants.h) are generated from
// ocean_bgc_tpu_torch/constants.py by ops/_kernels.py at build time.

#pragma once

#include <cuda_runtime.h>

#include "obgc_constants.h"

namespace obgc {

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log10(float x) { return log10f(x); }
__device__ __forceinline__ double m_log10(double x) { return log10(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double m_pow(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

// max(x, lo) that keeps a NaN x, like torch.clamp_min
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }

// the solver tolerance in H (ops/carbonate.py::solver_xacc)
template <typename T>
__device__ __forceinline__ T solver_xacc();
template <>
__device__ __forceinline__ double solver_xacc<double>() { return cst::XACC; }
template <>
__device__ __forceinline__ float solver_xacc<float>() {
  return static_cast<float>(cst::XACC_F32);
}

template <typename T>
struct Coeffs {
  T k0, k1, k2, ff, kb, k1p, k2p, k3p, ksi, kw, ks, kf, bt, st, ft;
};

// DIC, ALK, PO4, SiO3 of one cell in mol/kg
template <typename T>
struct MassUnits {
  T dic, ta, pt, sit;
};

// Floor the tracers (mmol/m^3) and convert to mol/kg
// (ops/carbonate.py::_to_mass_units).
template <typename T>
__device__ __forceinline__ MassUnits<T> to_mass_units(T dic, T alk, T po4,
                                                       T sio3) {
  return {clamp_min(dic, T(cst::DIC_MIN)) * T(cst::VOL_TO_MASS),
          clamp_min(alk, T(cst::ALK_MIN)) * T(cst::VOL_TO_MASS),
          clamp_min(po4, T(0)) * T(cst::VOL_TO_MASS),
          clamp_min(sio3, T(0)) * T(cst::VOL_TO_MASS)};
}

// Total alkalinity residual fn(H) and its slope (ops/carbonate.py::talk),
// same association order term by term.
template <typename T>
__device__ __forceinline__ void talk(const Coeffs<T>& c, const MassUnits<T>& m,
                                     T h, T& fn, T& df) {
  const T dic = m.dic, ta = m.ta, pt = m.pt, sit = m.sit;
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
__device__ T solve_htotal(const Coeffs<T>& c, const MassUnits<T>& m, T x1,
                          T x2, T xacc) {
  T flo, fhi, unused;
  talk(c, m, x1, flo, unused);
  talk(c, m, x2, fhi, unused);
  for (int it = 0; it < cst::BRACKET_GROW_GUARD && not_bracketed(flo, fhi);
       ++it) {
    const T growth = m_sqrt(x2 / x1);
    x1 = x1 / growth;
    x2 = x2 * growth;
    talk(c, m, x1, flo, unused);
    talk(c, m, x2, fhi, unused);
  }
  const bool neg_at_x1 = flo < T(0);
  T xlo = neg_at_x1 ? x1 : x2;
  T xhi = neg_at_x1 ? x2 : x1;

  T soln = T(0.5) * (xlo + xhi);
  T dxold = m_abs(xlo - xhi);
  T dx = dxold;
  T f, df;
  talk(c, m, soln, f, df);
  for (int it = 0; it < cst::MAXIT; ++it) {
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
    talk(c, m, soln, f, df);
    if (f < T(0)) {
      xlo = soln;
    } else if (f >= T(0)) {
      xhi = soln;
    }
  }
  return soln;
}

// H of one scenario of one cell: the pH-space bracket ph_prev -/+ DEL_PH
// (the cold [PHLO_3D_INIT, PHHI_3D_INIT] window where ph_prev is the 0
// sentinel), each end converted with one exp
// (ops/cuda_carbonate.py::_ph_brackets), then the bracketed root.
template <typename T>
__device__ __forceinline__ T solve_scenario(const Coeffs<T>& c,
                                            const MassUnits<T>& m,
                                            T ph_prev) {
  const bool warm = ph_prev != T(0);
  const T phlo = warm ? ph_prev - T(cst::DEL_PH) : T(cst::PHLO_3D_INIT);
  const T phhi = warm ? ph_prev + T(cst::DEL_PH) : T(cst::PHHI_3D_INIT);
  const T x1 = m_exp(T(-cst::LN10) * phhi);
  const T x2 = m_exp(T(-cst::LN10) * phlo);
  return solve_htotal(c, m, x1, x2, solver_xacc<T>());
}

}  // namespace obgc
