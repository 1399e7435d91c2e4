// The carbonate system's equilibrium constants and saturation values of one
// cell, evaluated on the device: the device counterparts of
// ops/carbonate.py::carbonate_coeffs (its k1_k2_ph_tot=True branch, the
// interior's) and ops/carbonate.py::co3_sat_vals, for K1's constants
// kernel (carbonate_coeffs.cu).
//
// Each expression repeats the plain version's as PyTorch's CUDA ops
// evaluate it, one rounding per operation in Python's order:
//   - a Python scalar over a tensor (c / x) is reciprocal(x) * c
//     (Tensor.__rtruediv__): rdiv();
//   - a tensor over a Python scalar (x / c) is x * (1 / c), the reciprocal
//     formed in double and rounded to the tensor's type (PyTorch's CUDA
//     division by a CPU scalar): carbonate_solve.cuh's div_scalar() (at
//     f32 a reciprocal formed in float moved the saturation values by up
//     to ~600 ulps on the H100);
//   - a Python scalar is rounded to the tensor's type before it meets the
//     tensor, and a product of two Python scalars is formed in double
//     first (the T(0.5 * kappa) of a scalar kappa).
// Built with --fmad=false and IEEE division and square root, with the CUDA
// math library's exp and log that PyTorch's ops call, the constants are
// those of the plain version on the card bit for bit.
//
// The constants (obgc_constants.h) are generated from
// ocean_bgc_tpu_torch/constants.py by ops/_kernels.py at build time.

#pragma once

#include "carbonate_solve.cuh"

namespace obgc {

// c / x for a Python scalar c and a tensor x
template <typename T>
__device__ __forceinline__ T rdiv(double c, T x) {
  return (T(1) / x) * T(c);
}

// POP reference pressure (bars) at depth (m)
// (ops/carbonate.py::press_bar_from_depth)
template <typename T>
__device__ __forceinline__ T press_bar_from_depth(T depth) {
  return T(0.059808) * (m_exp(T(-0.025) * depth) - T(1)) +
         T(0.100766) * depth + T(2.28405e-7) * (depth * depth);
}

// The log of the Millero pressure correction factor, gated by the
// subsurface flag (ops/carbonate.py::_pressure_ln_factor and the where()
// of padd/gate): (-dV + 0.5 kappa P) P / (R T), or 0 at the surface.
template <typename T>
__device__ __forceinline__ T pressure_ln(bool pressure, T delta_v,
                                         T half_kappa, T press, T inv_rtk) {
  const T ln_fac = (-delta_v + half_kappa * press) * press * inv_rtk;
  return pressure ? ln_fac : T(0);
}

// The 15 constants of one cell at depth (m), temperature and salinity,
// pressure corrections where ``pressure`` (ops/carbonate.py::
// carbonate_coeffs with k1_k2_ph_tot=True).
template <typename T>
__device__ Coeffs<T> carbonate_coeffs(T depth, T temp, T salt,
                                      bool pressure) {
  const T press = press_bar_from_depth(depth);

  const T salt_lim = clamp_min(salt, T(cst::SALT_MIN));
  const T tk = T(cst::T0_KELVIN) + temp;
  const T tk100 = tk * T(1e-2);
  const T tk1002 = tk100 * tk100;
  const T invtk = T(1) / tk;
  const T dlogtk = m_log(tk);
  const T inv_rtk = T(cst::INV_R_GAS) * invtk;

  const T ionic = (T(19.924) * salt_lim) / (T(1000.0) - T(1.005) * salt_lim);
  const T ionic2 = ionic * ionic;
  const T sqrtis = m_sqrt(ionic);
  const T sqrts = m_sqrt(salt_lim);
  const T s2 = salt_lim * salt_lim;
  const T scl = div_scalar(salt_lim, 1.80655);
  const T log_1_m_1p005em3_s = m_log(T(1) - T(0.001005) * salt_lim);
  const T ln_001 = T(cst::LN_001);   // ln(1e-2)

  auto padd = [&](T delta_v, T half_kappa) {
    return pressure_ln(pressure, delta_v, half_kappa, press, inv_rtk);
  };
  // the boric-acid correction, shared by kb and ksi (kappa a scalar)
  const T padd_boric =
      padd(T(-29.48) + (T(0.1622) - T(0.002608) * temp) * temp,
           T(0.5 * -2.84e-3));

  Coeffs<T> c;
  // ff: Weiss & Price 1980
  c.ff = m_exp(T(-162.8301) + rdiv(218.2968, tk100) +
               T(90.9241) * (dlogtk + ln_001) - T(1.47696) * tk1002 +
               salt_lim * (T(0.025695) - T(0.025225) * tk100 +
                           T(0.0049867) * tk1002));
  // k0: Weiss 1974
  c.k0 = m_exp(rdiv(93.4517, tk100) - T(60.2409) +
               T(23.3585) * (dlogtk + ln_001) +
               salt_lim * (T(0.023517) - T(0.023656) * tk100 +
                           T(0.0047036) * tk1002));
  // k1, k2: Lueker 2000 (total scale), Millero 1995 pressure correction
  const T arg1 = T(3633.86) * invtk - T(61.2172) + T(9.67770) * dlogtk -
                 T(0.011555) * salt_lim + T(0.0001152) * s2;
  const T arg2 = T(471.78) * invtk + T(25.9290) - T(3.16967) * dlogtk -
                 T(0.01781) * salt_lim + T(0.0001122) * s2;
  c.k1 = m_exp(T(-cst::LN10) * arg1 +
               padd(T(-25.5) + T(0.1271) * temp,
                    T(0.5) * ((T(-3.08) + T(0.0877) * temp) * T(1e-3))));
  c.k2 = m_exp(T(-cst::LN10) * arg2 +
               padd(T(-15.82) - T(0.0219) * temp,
                    T(0.5) * ((T(1.13) - T(0.1475) * temp) * T(1e-3))));
  // kb: Millero 1995 / Dickson 1990
  c.kb = m_exp((T(-8966.90) - T(2890.53) * sqrts - T(77.942) * salt_lim +
                T(1.728) * salt_lim * sqrts - T(0.0996) * s2) *
                   invtk +
               (T(148.0248) + T(137.1942) * sqrts + T(1.62142) * salt_lim) +
               (T(-24.4344) - T(25.085) * sqrts - T(0.2474) * salt_lim) *
                   dlogtk +
               T(0.053105) * sqrts * tk + padd_boric);
  // k1p, k2p, k3p: DOE 1994 eqs 7.2.20, 7.2.23, 7.2.26
  c.k1p = m_exp(T(-4576.752) * invtk + T(115.525) - T(18.453) * dlogtk +
                (T(-106.736) * invtk + T(0.69171)) * sqrts +
                (T(-0.65643) * invtk - T(0.01844)) * salt_lim +
                padd(T(-14.51) + (T(0.1211) - T(0.000321) * temp) * temp,
                     T(0.5) * ((T(-2.67) + T(0.0427) * temp) * T(1e-3))));
  c.k2p = m_exp(T(-8814.715) * invtk + T(172.0883) - T(27.927) * dlogtk +
                (T(-160.340) * invtk + T(1.3566)) * sqrts +
                (T(0.37335) * invtk - T(0.05778)) * salt_lim +
                padd(T(-23.12) + (T(0.1758) - T(0.002647) * temp) * temp,
                     T(0.5) * ((T(-5.15) + T(0.09) * temp) * T(1e-3))));
  c.k3p = m_exp(T(-3070.75) * invtk - T(18.141) +
                (T(17.27039) * invtk + T(2.81197)) * sqrts +
                (T(-44.99486) * invtk - T(0.09984)) * salt_lim +
                padd(T(-26.57) + (T(0.202) - T(0.003042) * temp) * temp,
                     T(0.5) * ((T(-4.08) + T(0.0714) * temp) * T(1e-3))));
  // ksi: Millero 1995 / Yao & Millero (the boric-acid pressure correction)
  c.ksi = m_exp(T(-8904.2) * invtk + T(117.385) - T(19.334) * dlogtk +
                (T(-458.79) * invtk + T(3.5913)) * sqrtis +
                (T(188.74) * invtk - T(1.5998)) * ionic +
                (T(-12.1652) * invtk + T(0.07871)) * ionic2 +
                log_1_m_1p005em3_s + padd_boric);
  // kw: Millero 1995 composite
  c.kw = m_exp(T(-13847.26) * invtk + T(148.9652) - T(23.6521) * dlogtk +
               (T(118.67) * invtk - T(5.977) + T(1.0495) * dlogtk) * sqrts -
               T(0.01615) * salt_lim +
               padd(T(-20.02) + (T(0.1119) - T(0.001409) * temp) * temp,
                    T(0.5) * ((T(-5.13) + T(0.0794) * temp) * T(1e-3))));
  // ks: Dickson 1990, free scale
  c.ks = m_exp(T(-4276.1) * invtk + T(141.328) - T(23.093) * dlogtk +
               (T(-13856.0) * invtk + T(324.57) - T(47.986) * dlogtk) *
                   sqrtis +
               (T(35474.0) * invtk - T(771.54) + T(114.723) * dlogtk) *
                   ionic -
               T(2698.0) * invtk * ionic * sqrtis +
               T(1776.0) * invtk * ionic2 + log_1_m_1p005em3_s +
               padd(T(-18.03) + (T(0.0466) + T(0.000316) * temp) * temp,
                    T(0.5) * ((T(-4.53) + T(0.09) * temp) * T(1e-3))));
  // kf: Dickson & Riley 1979, converted to the total scale with ks
  const T log_1_p_tot_sulfate_div_ks =
      m_log(T(1) + (T(0.1400 / 96.062) * scl) / c.ks);
  c.kf = m_exp(T(1590.2) * invtk - T(12.641) + T(1.525) * sqrtis +
               log_1_m_1p005em3_s + log_1_p_tot_sulfate_div_ks +
               padd(T(-9.78) - (T(0.009) + T(0.000942) * temp) * temp,
                    T(0.5) * ((T(-3.91) + T(0.054) * temp) * T(1e-3))));
  // total borate, sulfate and fluoride
  c.bt = T(0.000232 / 10.811) * scl;
  c.st = T(0.14 / 96.062) * scl;
  c.ft = T(0.000067 / 18.9984) * scl;
  return c;
}

// CO3= at calcite and aragonite saturation (mmol/m^3) of one cell
// (ops/carbonate.py::co3_sat_vals): Mucci 1983 with Millero 1979 pressure
// corrections, the aragonite's with deltaV shifted by +2.8.
template <typename T>
__device__ void co3_sat_vals(T depth, T temp, T salt, bool pressure,
                             T& sat_calc, T& sat_arag) {
  const T press = press_bar_from_depth(depth);

  const T salt_lim = clamp_min(salt, T(cst::SALT_MIN));
  const T tk = T(cst::T0_KELVIN) + temp;
  const T log10tk = div_scalar(m_log(tk), cst::LN10);
  const T invtk = T(1) / tk;
  const T inv_rtk = T(cst::INV_R_GAS) * invtk;
  const T sqrts = m_sqrt(salt_lim);
  const T s15 = sqrts * salt_lim;

  const T delta_v_calc = T(-48.76) + T(0.5304) * temp;
  const T half_kappa = T(0.5) * ((T(-11.76) + T(0.3692) * temp) * T(1e-3));
  const T k_calc = m_exp(
      T(cst::LN10) *
          (T(-171.9065) - T(0.077993) * tk + T(2839.319) * invtk +
           T(71.595) * log10tk +
           (T(-0.77712) + T(0.0028426) * tk + T(178.34) * invtk) * sqrts -
           T(0.07711) * salt_lim + T(0.0041249) * s15) +
      pressure_ln(pressure, delta_v_calc, half_kappa, press, inv_rtk));
  const T k_arag = m_exp(
      T(cst::LN10) *
          (T(-171.945) - T(0.077993) * tk + T(2903.293) * invtk +
           T(71.595) * log10tk +
           (T(-0.068393) + T(0.0017276) * tk + T(88.135) * invtk) * sqrts -
           T(0.10018) * salt_lim + T(0.0059415) * s15) +
      pressure_ln(pressure, delta_v_calc + T(2.8), half_kappa, press,
                  inv_rtk));

  const T inv_ca = rdiv(35.0 / 0.01028, salt_lim);
  sat_calc = k_calc * inv_ca * T(cst::MASS_TO_VOL);
  sat_arag = k_arag * inv_ca * T(cst::MASS_TO_VOL);
}

}  // namespace obgc
