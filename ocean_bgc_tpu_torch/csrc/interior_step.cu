// K2: the whole diagnostics-off BGC interior, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   ocean_bgc_tpu/ops/pallas_step.py::_step_kernel (:146),
// and computes what ops/bgc.py::bgc_source_sink(compute_diags=False)
// computes: the active and bottom masks from kmax, clipped tracers, the
// dual pH solve (pH only, through carbonate_solve.cuh, the routine K1
// runs), PAR, the ecosystem kinetics of the 4 autotroph groups, Fe
// scavenging from the incoming sinking flux, the sinking-particle level
// update, nutrient restoring and the 30 tendency expressions.
//
// Design.  Two kernels per step, both cell-parallel.  With diagnostics
// off the pH solve feeds nothing else here, so it is its own kernel: the
// solve kernel runs the dual solve of every active cell as lanes of
// carbonate_solve.cuh (the routine K1 runs, one lane per thread), and
// copies the previous pH below the bottom, where it reads nothing else.
// The biology kernel gives each block of 128 threads all levels of a few
// whole columns (16 at f64 and 32 at f32 for 60 levels; threads loop over
// the tile's cells) and runs five phases separated by barriers, staging 8
// values per cell in dynamic shared memory: (1) per cell, the clipped
// tracers' PAR attenuation; (2) per column, one thread, PAR's running
// product of the attenuation in level order, the rounding order of the
// plain version's sequential cumprod; (3) per cell, the kinetics'
// particulate sources; (4) per column, one thread, Fe scavenging and the
// sinking-particle level update down the active levels, with the
// 11-field carry in registers and each level's other inputs loaded from
// device memory one level ahead; (5) per cell, the kinetics again,
// restoring and the 30 tendencies (zero below the bottom).  Phase 5
// recomputes the kinetics: a thread holds several cells, and one cell's
// ~200 live values across two barriers already spill at f64.  Columns
// are the fastest axis of every array and a tile's neighbouring threads
// take neighbouring columns, so global loads are coalesced in groups of
// ``cols``; the ragged edge is masked by col < ncol.  Each expression
// keeps the plain version's operation order, with PyTorch's CUDA
// semantics: a tensor divided by a Python scalar is multiplied by the
// scalar's reciprocal formed in double and rounded to the working type
// (div_scalar, carbonate_solve.cuh), selects and clamps keep NaN.  The equilibrium constants, the Q10 response and the
// 8 dissolution factors are read precomputed (the env cache, or the
// wrapper's torch evaluation of the same expressions), so the kernels
// hold no copy of carbonate_coeffs.  Parameters arrive by value, in
// double (ops/kernel_params.py); each product of parameters is formed
// in double and rounded to the working type, as Python and PyTorch do.
// Templated on float and double; built with --fmad=false and IEEE
// division.
//
// Bound.  Per active cell the pair must read 61 fields (30 tracers, 7
// per-level fields, 15 constants, the Q10 response and 8 dissolution
// factors), per inactive cell the 2 previous pH fields, and per cell
// write 32 (30 tendencies, 2 pH): ~93 * sizeof(T) bytes per active cell,
// ~0.1 / 0.05 ms at 3.35 TB/s for the 60 x 8192 flagship world at f64 /
// f32 (chip_smoke.py computes it from the run's kmax).  Its arithmetic
// is ~1,700 operations per active cell besides the pH solve (counted in
// chip_smoke.py, OPS_K2_CELL, with each division, exp and log as one),
// ~0.04 ms at the f64 rate.  What held the first version (one thread per
// column, 1.66 / 1.96 ms at f64 / f32 on the H100) far above that: 8192
// threads for 491,520 cells, two warps per SM, each thread's pH solves,
// kinetics and sinking in series down 60 levels.  This design gives
// every cell a thread in the solve and the kinetics.  What bounds it now
// (PERF.md): the kinetics need ~200-255 registers, so an SM holds 8
// warps of the biology kernel, and the per-column scans run on ``cols``
// threads of a block while its other threads wait at the barrier; the
// tile is sized so that two blocks fit on an SM and one block's scans
// overlap the other's per-cell phases.  The tracers are read three times
// per cell (phases 1, 3 and 5), the repeats mostly from L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "carbonate_solve.cuh"

namespace obgc {
namespace {

using namespace cst;

// ---- launch arguments -------------------------------------------------

// The packed parameters (ops/kernel_params.py::GLOBAL_FIELDS), then per
// autotroph group the traits (ops/kernel_params.py::TRAIT_FIELDS).
enum GlobalParam : int {
  P_parm_o2_min,
  P_parm_o2_min_delta,
  P_parm_kappa_nitrif,
  P_parm_nitrif_par_lim,
  P_parm_z_mort_0,
  P_parm_z_mort2_0,
  P_parm_labile_ratio,
  P_parm_POMbury,
  P_parm_BSIbury,
  P_parm_fe_scavenge_rate0,
  P_parm_f_prod_sp_CaCO3,
  P_parm_POC_diss,
  P_lrest_po4,
  P_lrest_no3,
  P_lrest_sio3,
  P_alt_co2_use_eco,
  P_COUNT
};

enum TraitParam : int {
  A_nfixer,
  A_imp_calcifier,
  A_exp_calcifier,
  A_grazee_ind,
  A_temp_function,
  A_has_si,
  A_kFe,
  A_kPO4,
  A_kDOP,
  A_kNO3,
  A_kNH4,
  A_kSiO3,
  A_Qp,
  A_gQfe_0,
  A_gQfe_min,
  A_alphaPI,
  A_PCref,
  A_thetaN_max,
  A_loss_thres,
  A_loss_thres2,
  A_temp_thres,
  A_temp_thresN,
  A_temp_thresS,
  A_temp_optN,
  A_temp_optS,
  A_mort,
  A_mort2,
  A_agg_rate_max,
  A_agg_rate_min,
  A_z_umax_0,
  A_z_grz,
  A_graze_zoo,
  A_graze_poc,
  A_graze_doc,
  A_loss_poc,
  A_f_zoo_detr,
  A_COUNT
};

constexpr int kNumAuto = AUTOTROPH_CNT;
constexpr int kNumParams = P_COUNT + kNumAuto * A_COUNT;

struct Params {
  double v[kNumParams];
  __device__ __forceinline__ double g(int i) const { return v[i]; }
  __device__ __forceinline__ double a(int grp, int i) const {
    return v[P_COUNT + grp * A_COUNT + i];
  }
  __device__ __forceinline__ bool on(int grp, int i) const {
    return a(grp, i) != 0.0;
  }
};

// The device pointers, in the order of ops/cuda_step.py::KERNEL_FIELDS:
// (nlev, 30, ncol) tracers; (nlev, ncol) fields; (ncol,) rows; the 15
// equilibrium constants in CarbCoeffs order; the Q10 response; the 8
// dissolution factors in DissolutionCache order; the 4 restoring fields
// (null where the lrest_* gate is off); the 3 outputs.
enum Field : int {
  F_tracers,
  F_temp,
  F_dz,
  F_center,
  F_bottom,
  F_fesed,
  F_ph_prev,
  F_ph_prev_alt,
  F_kmax,
  F_lat,
  F_dust,
  F_shortwave,
  F_k0,
  F_k1,
  F_k2,
  F_ff,
  F_kb,
  F_k1p,
  F_k2p,
  F_k3p,
  F_ksi,
  F_kw,
  F_ks,
  F_kf,
  F_bt,
  F_st,
  F_ft,
  F_tfunc,
  F_scalelength,
  F_decay_hard,
  F_decay_hard_dust,
  F_decay_caco3,
  F_caco3_diss,
  F_decay_sio2,
  F_sio2_diss,
  F_decay_dust,
  F_rtau,
  F_no3_clim,
  F_po4_clim,
  F_sio3_clim,
  F_tend,
  F_ph,
  F_ph_alt,
  F_COUNT
};

struct Ptrs {
  const void* p[F_COUNT];
};

template <typename T>
__device__ __forceinline__ const T* in(const Ptrs& f, int i) {
  return static_cast<const T*>(f.p[i]);
}

template <typename T>
__device__ __forceinline__ T* out(const Ptrs& f, int i) {
  return static_cast<T*>(const_cast<void*>(f.p[i]));
}

// ---- PyTorch's elementwise semantics ----------------------------------

// min(x, hi) that keeps a NaN x, like torch.clamp_max
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) { return x > hi ? hi : x; }

// torch.maximum / torch.minimum: NaN if either operand is NaN
template <typename T>
__device__ __forceinline__ T t_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T t_min(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// ops/numerics.py::safe_div: num/den, 0 where den == 0
template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  return den != T(0) ? num / den : T(0);
}

// The ecosystem's exp, log and pow (ops/numerics.py: exp, log, pow),
// where the pH solve's m_exp and m_log are not: at float64 as they are, at
// float32 evaluated at float64 and rounded once, as the plain version
// evaluates them (the single-precision functions are not correctly
// rounded).  e_pow's base is a double, as a Python scalar is to torch.pow.
__device__ __forceinline__ float e_exp(float x) {
  return static_cast<float>(exp(static_cast<double>(x)));
}
__device__ __forceinline__ double e_exp(double x) { return exp(x); }
__device__ __forceinline__ float e_log(float x) {
  return static_cast<float>(log(static_cast<double>(x)));
}
__device__ __forceinline__ double e_log(double x) { return log(x); }
template <typename T>
__device__ __forceinline__ T e_pow(double base, T x) {
  return static_cast<T>(pow(base, static_cast<double>(x)));
}

// ops/numerics.py::morel_kpar: the PAR attenuation coefficient (1/cm)
// from chlorophyll, exp(log(a) + p log(chl)) with one shared log
template <typename T>
__device__ __forceinline__ T morel_kpar(T chl) {
  const T log_chl = e_log(chl);
  return e_exp(chl < T(MOREL_BREAK) ? T(LOG_MOREL_A1) + log_chl * T(MOREL_P1)
                                    : T(LOG_MOREL_A2) + log_chl * T(MOREL_P2));
}

// the sedimentary denitrification's 0.99 ** (O2 - NO3)
// (ops/particulates.py, numerics.pow with a scalar base)
template <typename T>
__device__ __forceinline__ T sed_pow(T x) { return e_pow(0.99, x); }

// ---- PAR attenuation of a cell, which the level scan of PAR reads and
// the kinetics repeat ----------------------------------------------------

// True where group g's coupled pools are masked to zero (a zero
// chlorophyll, carbon, iron or silica pool; BGC_mod.F90:826-844).
template <typename T>
__device__ __forceinline__ bool pools_zero(const T (&tr)[TR_CNT], int g) {
  bool zero = tr[TR_CHL_IND[g]] == T(0) || tr[TR_C_IND[g]] == T(0) ||
              tr[TR_FE_IND[g]] == T(0);
  if (TR_SI_IND[g] >= 0) zero = zero || tr[TR_SI_IND[g]] == T(0);
  return zero;
}

// The chlorophyll of each group after the zero mask.
template <typename T>
__device__ __forceinline__ void active_chl(const T (&tr)[TR_CNT],
                                           T (&a_chl)[kNumAuto]) {
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    a_chl[g] = pools_zero(tr, g) ? T(0) : tr[TR_CHL_IND[g]];
  }
}

// exp(-KPARdz) of a cell from its masked chlorophyll (BGC_mod.F90:
// 907-924); sets ``kpar_dz``.
template <typename T>
__device__ __forceinline__ T attenuation(const T (&a_chl)[kNumAuto], T dz,
                                         T& kpar_dz) {
  T total_chl = T(0);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) total_chl = total_chl + a_chl[g];
  const T kpar = morel_kpar(clamp_min(total_chl, T(0.02)));
  kpar_dz = kpar * dz;
  return e_exp(-kpar_dz);
}

// ---- the per-cell ecosystem kinetics (ops/bgc.py::ecosystem_kinetics,
// BGC_mod.F90:826-1529) -------------------------------------------------

// What the sinking update and the tendency assembly read.
template <typename T>
struct Kinetics {
  T par_in, par_out, kpar_dz, att;
  T zoo_loss, zoo_loss_dic;
  T doc_prod, don_prod, dop_prod, dofe_prod;
  T doc_remin, don_remin, dofe_remin, dop_remin, donr_remin, dopr_remin;
  T poc_prod, caco3_prod, sio2_prod, fe_prod_base;
  T thetaC[kNumAuto], qfe[kNumAuto], qsi[kNumAuto], qcaco3[kNumAuto];
  T no3_v[kNumAuto], nh4_v[kNumAuto], po4_v[kNumAuto], dop_v[kNumAuto];
  T photoC[kNumAuto], photoFe[kNumAuto], photoSi[kNumAuto];
  T photoacc[kNumAuto], caco3_prod_g[kNumAuto];
  T auto_graze[kNumAuto], auto_loss[kNumAuto], auto_agg[kNumAuto];
  T graze_zoo[kNumAuto], graze_dic[kNumAuto], loss_dic_g[kNumAuto];
  T nfix[kNumAuto], nexcrete[kNumAuto], rem_p_dip[kNumAuto];
};

// ``par_prod`` is the product of the attenuation of the levels above (1
// at the surface): _par_field's exclusive cumulative product, carried
// down the column.  Called for active cells only.
template <typename T>
__device__ __forceinline__ Kinetics<T> ecosystem_kinetics(
    const T (&tr)[TR_CNT], T temp, T dz, T center, bool north,
    bool south, T par_surf, T par_prod, T tfunc, const Params& p) {
  Kinetics<T> K;
  const T no3 = tr[TR_NO3], sio3 = tr[TR_SIO3], nh4 = tr[TR_NH4];
  const T fe = tr[TR_FE], doc = tr[TR_DOC], zooC = tr[TR_ZOOC];
  const T don = tr[TR_DON], dofe = tr[TR_DOFE], dop = tr[TR_DOP];
  const T dopr = tr[TR_DOPR], donr = tr[TR_DONR], po4 = tr[TR_PO4];
  const double labile = p.g(P_parm_labile_ratio);

  // zero-mask coupled phyto pools (BGC_mod.F90:826-844)
  T a_chl[kNumAuto], a_c[kNumAuto], a_fe[kNumAuto], a_si[kNumAuto],
      a_caco3[kNumAuto];
  active_chl(tr, a_chl);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    const T c_g = tr[TR_C_IND[g]];
    const T fe_g = tr[TR_FE_IND[g]];
    const bool zero = pools_zero(tr, g);
    a_c[g] = zero ? T(0) : c_g;
    a_fe[g] = zero ? T(0) : fe_g;
    a_si[g] = (TR_SI_IND[g] >= 0 && !zero) ? tr[TR_SI_IND[g]] : T(0);
    a_caco3[g] =
        (TR_CACO3_IND[g] >= 0 && !zero) ? tr[TR_CACO3_IND[g]] : T(0);
  }

  // quota ratios (BGC_mod.F90:850-898)
  T gqfe[kNumAuto], gqsi[kNumAuto];
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    const double kFe = p.a(g, A_kFe);
    K.thetaC[g] = a_chl[g] / (a_c[g] + T(EPSC));
    K.qfe[g] = a_fe[g] / (a_c[g] + T(EPSC));
    K.qsi[g] = p.on(g, A_has_si)
                   ? clamp_max(a_si[g] / (a_c[g] + T(EPSC)), T(GQSI_MAX))
                   : T(0);
    // growth Fe quota, reduced under low ambient Fe
    gqfe[g] = fe < T(CKS * kFe)
                  ? clamp_min(div_scalar(fe * T(p.a(g, A_gQfe_0)), CKS * kFe),
                              T(p.a(g, A_gQfe_min)))
                  : T(p.a(g, A_gQfe_0));
    gqsi[g] = T(0);
    if (p.on(g, A_has_si)) {
      const double kSiO3 = p.a(g, A_kSiO3);
      T gs = T(GQSI_0);
      gs = (fe < T(CKSI * kFe) && fe > T(0) && sio3 > T(CKSI * kSiO3))
               ? clamp_max(safe_div(T(GQSI_0 * CKSI * kFe), fe), T(GQSI_MAX))
               : gs;
      gs = fe == T(0) ? T(GQSI_MAX) : gs;
      gs = sio3 < T(CKSI * kSiO3)
               ? clamp_min(div_scalar(gs * sio3, CKSI * kSiO3), T(GQSI_MIN))
               : gs;
      gqsi[g] = gs;
    }
    K.qcaco3[g] = (p.on(g, A_imp_calcifier) || p.on(g, A_exp_calcifier))
                      ? clamp_max(a_caco3[g] / (a_c[g] + T(EPSC)),
                                  T(QCACO3_MAX))
                      : T(0);
  }

  // PAR attenuation (BGC_mod.F90:907-924)
  const T att = attenuation(a_chl, dz, K.kpar_dz);
  K.att = att;
  K.par_in = par_surf * par_prod;
  K.par_out = K.par_in * att;
  const T par_avg = (K.par_in * (T(1) - att)) / K.kpar_dz;

  // depth-tapered loss threshold (BGC_mod.F90:1047-1055)
  const T f_loss_thres =
      center > T(THRES_Z1)
          ? (center < T(THRES_Z2)
                 ? div_scalar(T(THRES_Z2) - center, THRES_Z2 - THRES_Z1)
                 : T(0))
          : T(1);

  // Pprime per autotroph (BGC_mod.F90:1072-1094)
  T pprime[kNumAuto];
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    T thres = f_loss_thres * T(p.a(g, A_loss_thres));
    const T thres2 = f_loss_thres * T(p.a(g, A_loss_thres2));
    if (p.a(g, A_temp_function) == TFNC_QUASI_MMRT) {
      const T tmax = north ? T(p.a(g, A_temp_thresN))
                           : T(p.a(g, A_temp_thresS));
      thres = temp > tmax ? thres2 : thres;
    } else {
      thres = temp < T(p.a(g, A_temp_thres)) ? thres2 : thres;
    }
    pprime[g] = clamp_min(a_c[g] - thres, T(0));
  }

  // uptake, photosynthesis, losses per autotroph (BGC_mod.F90:1107-1290)
  const double f_prod_sp_caco3 = p.g(P_parm_f_prod_sp_CaCO3);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    const double kNO3 = p.a(g, A_kNO3), kNH4 = p.a(g, A_kNH4);
    const double kPO4 = p.a(g, A_kPO4), kDOP = p.a(g, A_kDOP);
    const double alphaPI = p.a(g, A_alphaPI);
    const T vn3 = div_scalar(no3, kNO3) /
                  ((T(1) + div_scalar(no3, kNO3)) + div_scalar(nh4, kNH4));
    const T vn4 = div_scalar(nh4, kNH4) /
                  ((T(1) + div_scalar(no3, kNO3)) + div_scalar(nh4, kNH4));
    const T vnt = p.on(g, A_nfixer) ? T(1) : vn3 + vn4;
    const T vfe = fe / (fe + T(p.a(g, A_kFe)));
    T f_nut = t_min(vnt, vfe);
    const T vpo4 = div_scalar(po4, kPO4) /
                   ((T(1) + div_scalar(po4, kPO4)) + div_scalar(dop, kDOP));
    const T vdop = div_scalar(dop, kDOP) /
                   ((T(1) + div_scalar(po4, kPO4)) + div_scalar(dop, kDOP));
    const T vptot = vpo4 + vdop;
    f_nut = t_min(f_nut, vptot);
    if (p.on(g, A_has_si)) {
      const T vsio3 = sio3 / (sio3 + T(p.a(g, A_kSiO3)));
      f_nut = t_min(f_nut, vsio3);
    }

    // photosynthesis rate (BGC_mod.F90:1146-1177)
    T pcmax = (f_nut * T(p.a(g, A_PCref))) * tfunc;
    pcmax = temp < T(p.a(g, A_temp_thres)) ? T(0) : pcmax;
    if (p.a(g, A_temp_function) == TFNC_QUASI_MMRT) {
      const T topt = north ? T(p.a(g, A_temp_optN)) : T(p.a(g, A_temp_optS));
      const T tmax = north ? T(p.a(g, A_temp_thresN))
                           : T(p.a(g, A_temp_thresS));
      pcmax = pcmax * clamp_max((tmax - temp) / (tmax - topt), T(1));
      pcmax = temp > tmax ? T(0) : pcmax;
    }
    const T light_lim =
        T(1) - e_exp(((K.thetaC[g] * T(-1.0 * alphaPI)) * par_avg) /
                     (pcmax + T(EPSTINV)));
    const T pcphoto = pcmax * light_lim;
    const T pc = pcphoto * a_c[g];
    K.photoC[g] = pc;

    // N/P uptake partition (BGC_mod.F90:1193-1221)
    const bool has_n = vnt > T(0);
    K.no3_v[g] = has_n ? (safe_div(vn3, vnt) * pc) * T(Q) : T(0);
    K.nh4_v[g] = has_n ? (safe_div(vn4, vnt) * pc) * T(Q) : T(0);
    const T vnc = has_n ? pcphoto * T(Q) : T(0);
    const bool has_p = vptot > T(0);
    const double qp = p.a(g, A_Qp);
    K.po4_v[g] = has_p ? (safe_div(vpo4, vptot) * pc) * T(qp) : T(0);
    K.dop_v[g] = has_p ? (safe_div(vdop, vptot) * pc) * T(qp) : T(0);
    K.photoFe[g] = pc * gqfe[g];
    K.photoSi[g] = p.on(g, A_has_si) ? pc * gqsi[g] : T(0);

    // photoadaptation (BGC_mod.F90:1240-1246)
    const T work1 = (K.thetaC[g] * T(alphaPI)) * par_avg;
    const T pchl = safe_div(pcphoto, work1) * T(p.a(g, A_thetaN_max));
    K.photoacc[g] =
        work1 > T(0) ? safe_div(pchl * vnc, K.thetaC[g]) * a_chl[g] : T(0);

    // CaCO3 production (BGC_mod.F90:1255-1278)
    K.caco3_prod_g[g] = T(0);
    if (p.on(g, A_imp_calcifier)) {
      T cap = (pc * T(f_prod_sp_caco3)) * f_nut;
      cap = temp < T(CACO3_TEMP_THRES1)
                ? div_scalar(cap * clamp_min(temp - T(CACO3_TEMP_THRES2), T(0)),
                             CACO3_TEMP_THRES1 - CACO3_TEMP_THRES2)
                : cap;
      cap = a_c[g] > T(CACO3_SP_THRES)
                ? t_min(div_scalar(cap * a_c[g], CACO3_SP_THRES),
                        pc * T(F_PHOTOSP_CACO3))
                : cap;
      K.caco3_prod_g[g] = cap;
    }

    // losses (BGC_mod.F90:1285-1290)
    K.auto_loss[g] = (pprime[g] * T(p.a(g, A_mort))) * tfunc;
    T agg = t_min(pprime[g] * T(p.a(g, A_agg_rate_max) * DPS),
                  (pprime[g] * T(p.a(g, A_mort2))) * pprime[g]);
    K.auto_agg[g] = t_max(pprime[g] * T(p.a(g, A_agg_rate_min) * DPS), agg);
  }

  // grazing over the shared grazee classes, routing
  // (BGC_mod.F90:1297-1386)
  T graze_poc[kNumAuto], graze_doc[kNumAuto], loss_poc_g[kNumAuto],
      loss_doc_g[kNumAuto], rem_p_dop[kNumAuto];
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    T grazee_sum = T(0);
#pragma unroll
    for (int g2 = 0; g2 < kNumAuto; ++g2) {
      if (p.a(g2, A_grazee_ind) == p.a(g, A_grazee_ind)) {
        grazee_sum = grazee_sum + pprime[g2];
      }
    }
    T z_umax = T(p.a(g, A_z_umax_0)) * tfunc;
    if (g == DIAT) {   // diatoms: phaeo-linked grazing relief
      const double thres_n = p.a(g, A_temp_thresN);
      const double thres_s = p.a(g, A_temp_thresS);
      const double opt_n = p.a(g, A_temp_optN), opt_s = p.a(g, A_temp_optS);
      const T relief_n =
          clamp_min(div_scalar(T(thres_n) - temp, thres_n - opt_n), T(0.95));
      const T relief_s =
          clamp_min(div_scalar(T(thres_s) - temp, thres_s - opt_s), T(0.95));
      z_umax = (north && temp > T(opt_n))
                   ? z_umax * relief_n
                   : ((south && temp > T(opt_s)) ? z_umax * relief_s : z_umax);
    }
    const T graze =
        grazee_sum > T(0)
            ? (((safe_div(pprime[g], grazee_sum) * z_umax) * zooC) *
               grazee_sum) / (grazee_sum + T(p.a(g, A_z_grz)))
            : T(0);
    K.auto_graze[g] = graze;

    // N fixation (BGC_mod.F90:1331-1338)
    K.nfix[g] = T(0);
    K.nexcrete[g] = T(0);
    if (p.on(g, A_nfixer)) {
      const T wn = K.photoC[g] * T(Q);
      const T nf = (wn * T(R_NFIX_PHOTO) - K.no3_v[g]) - K.nh4_v[g];
      K.nfix[g] = nf;
      K.nexcrete[g] = ((nf + K.no3_v[g]) + K.nh4_v[g]) - wn;
    }

    // grazing / loss routing (BGC_mod.F90:1354-1372)
    const T gz = graze * T(p.a(g, A_graze_zoo));
    const T gp =
        p.on(g, A_imp_calcifier)
            ? graze * t_max(K.qcaco3[g] * T(CACO3_POC_MIN),
                            clamp_max(clamp_min(pprime[g], T(1)) *
                                          T(SPC_POC_FAC),
                                      T(F_GRAZE_SP_POC_LIM)))
            : graze * T(p.a(g, A_graze_poc));
    const T gd = graze * T(p.a(g, A_graze_doc));
    K.graze_zoo[g] = gz;
    graze_poc[g] = gp;
    graze_doc[g] = gd;
    K.graze_dic[g] = graze - ((gz + gp) + gd);

    const T lp = p.on(g, A_imp_calcifier)
                     ? K.qcaco3[g] * K.auto_loss[g]
                     : K.auto_loss[g] * T(p.a(g, A_loss_poc));
    loss_poc_g[g] = lp;
    loss_doc_g[g] = T(1.0 - labile) * (K.auto_loss[g] - lp);
    K.loss_dic_g[g] = T(labile) * (K.auto_loss[g] - lp);

    // non-Redfield P routing (BGC_mod.F90:1380-1386)
    rem_p_dop[g] = T(0);
    K.rem_p_dip[g] = T(0);
    if (p.a(g, A_Qp) != QP_ZOO_POM) {
      const T rem_p =
          ((((graze + K.auto_loss[g]) + K.auto_agg[g]) * T(p.a(g, A_Qp)) -
            K.graze_zoo[g] * T(QP_ZOO_POM)) -
           ((graze_poc[g] + loss_poc_g[g]) + K.auto_agg[g]) * T(QP_ZOO_POM));
      rem_p_dop[g] = T(1.0 - labile) * rem_p;
      K.rem_p_dip[g] = T(labile) * rem_p;
    }
  }

  // zooplankton (BGC_mod.F90:1395-1415)
  T w1 = T(0), w2 = T(0);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    w1 = w1 + (K.auto_graze[g] + T(EPSC * EPSTINV)) *
                  T(p.a(g, A_f_zoo_detr));
  }
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    w2 = w2 + (K.auto_graze[g] + T(EPSC * EPSTINV));
  }
  const T f_zoo_detr = w1 / w2;
  const T zprime = clamp_min(zooC - f_loss_thres * T(LOSS_THRES_ZOO), T(0));
  K.zoo_loss = ((zprime * m_sqrt(zprime)) * T(p.g(P_parm_z_mort2_0)) +
                zprime * T(p.g(P_parm_z_mort_0))) * tfunc;
  const T zoo_loss_doc = (T(1.0 - labile) * (T(1) - f_zoo_detr)) * K.zoo_loss;
  K.zoo_loss_dic = (T(labile) * (T(1) - f_zoo_detr)) * K.zoo_loss;

  // DOM production & remineralization (BGC_mod.F90:1421-1461)
  T sum_loss_doc = T(0), sum_graze_doc = T(0);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) sum_loss_doc = sum_loss_doc + loss_doc_g[g];
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    sum_graze_doc = sum_graze_doc + graze_doc[g];
  }
  K.doc_prod = (zoo_loss_doc + sum_loss_doc) + sum_graze_doc;
  K.don_prod = K.doc_prod * T(Q);
  T dop_prod = zoo_loss_doc * T(QP_ZOO_POM);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    dop_prod = p.a(g, A_Qp) == QP_ZOO_POM
                   ? dop_prod + (loss_doc_g[g] + graze_doc[g]) *
                                    T(p.a(g, A_Qp))
                   : dop_prod + rem_p_dop[g];
  }
  K.dop_prod = dop_prod;
  T dofe_prod = zoo_loss_doc * T(QFE_ZOO);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    dofe_prod = dofe_prod + K.qfe[g] * (loss_doc_g[g] + graze_doc[g]);
  }
  K.dofe_prod = dofe_prod;

  const bool lit = par_avg > T(1);   // euphotic-zone photochemistry switch
  K.doc_remin = (doc * T(DOC_REMINR)) * (lit ? T(1) : T(DOC_REMIN_DARK_FAC));
  K.don_remin = (don * T(DON_REMINR)) * (lit ? T(1) : T(DON_REMIN_DARK_FAC));
  K.dofe_remin =
      (dofe * T(DOFE_REMINR)) * (lit ? T(1) : T(DOFE_REMIN_DARK_FAC));
  K.dop_remin = (dop * T(DOP_REMINR)) * (lit ? T(1) : T(DOP_REMIN_DARK_FAC));
  K.donr_remin = donr * (lit ? T(DONR_REMINR) : T(DONR_REMINR_DARK));
  K.dopr_remin = dopr * (lit ? T(DOPR_REMINR) : T(DOPR_REMINR_DARK));

  // particulate production (BGC_mod.F90:1467-1529)
  T sum_graze_poc = T(0), sum_agg = T(0), sum_loss_poc = T(0);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) sum_graze_poc = sum_graze_poc + graze_poc[g];
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) sum_agg = sum_agg + K.auto_agg[g];
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) sum_loss_poc = sum_loss_poc + loss_poc_g[g];
  K.poc_prod = ((f_zoo_detr * K.zoo_loss + sum_graze_poc) + sum_agg) +
               sum_loss_poc;
  K.caco3_prod = T(0);
  K.sio2_prod = T(0);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    if (p.on(g, A_imp_calcifier) || p.on(g, A_exp_calcifier)) {
      K.caco3_prod = ((K.auto_graze[g] * T(1.0 - F_GRAZE_CACO3_REMIN) +
                       K.auto_loss[g]) + K.auto_agg[g]) * K.qcaco3[g];
    }
    if (p.on(g, A_has_si)) {
      K.sio2_prod = K.qsi[g] *
                    ((K.auto_graze[g] * T(1.0 - F_GRAZE_SI_REMIN) +
                      K.auto_agg[g]) + K.auto_loss[g] * T(p.a(g, A_loss_poc)));
    }
  }
  // iron production except scavenging, which scales with the sinking
  // flux entering the level (BGC_mod.F90:1510-1522)
  T fe_prod_base = (K.zoo_loss * f_zoo_detr) * T(QFE_ZOO);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    fe_prod_base = fe_prod_base +
                   K.qfe[g] * ((K.auto_agg[g] + graze_poc[g]) + loss_poc_g[g]);
  }
  K.fe_prod_base = fe_prod_base;
  return K;
}

// ---- the sinking-particle level update (ops/particulates.py,
// BGC_mod.F90:2072-2631) -----------------------------------------------

// The fluxes entering a level (the outgoing fluxes of the level above)
// and the QA dust deficit.
template <typename T>
struct Carry {
  T poc_s, poc_h, caco3_s, caco3_h, sio2_s, sio2_h, dust_s, dust_h, fe_s,
      fe_h, qa_dust_def;
};

// The per-level results the tendency assembly reads.
template <typename T>
struct ParticleOut {
  T poc_remin, caco3_remin, sio2_remin, fe_remin, sed_denitrif, other_remin;
};

// init_particle_carry (BGC_mod.F90:2072-2104)
template <typename T>
__device__ __forceinline__ Carry<T> init_carry(T dust_flux_in) {
  const bool nz = dust_flux_in != T(0);
  Carry<T> c{};
  c.dust_s = nz ? dust_flux_in * T(1.0 - DUST_GAMMA) : T(0);
  c.dust_h = nz ? dust_flux_in * T(DUST_GAMMA) : T(0);
  c.qa_dust_def = (c.dust_s + c.dust_h) * T(RHO_DUST);
  return c;
}

// The dissolution factors of one cell, in DissolutionCache order.
template <typename T>
struct Dissolution {
  T scalelength, decay_hard, decay_hard_dust, decay_caco3, caco3_diss,
      decay_sio2, sio2_diss, decay_dust;
};

// particulate_level_update with precomputed dissolution factors, for an
// active cell; updates ``cr`` to the carry of the next level.
template <typename T>
__device__ __forceinline__ ParticleOut<T> particulate_level_update(
    Carry<T>& cr, T poc_prod, T caco3_prod, T sio2_prod, T fe_prod, T o2_loc,
    T no3_loc, T dz, T cell_bottom_depth, T fesedflux, bool bot,
    const Dissolution<T>& d, const Params& p) {
  const T dzr = T(1) / dz;
  const double poc_diss0 = p.g(P_parm_POC_diss);

  // O2-dependent POC dissolution lengthening (BGC_mod.F90:2311-2315)
  T poc_diss =
      (o2_loc >= T(5) && o2_loc < T(40))
          ? T(poc_diss0) *
                (T(1) + div_scalar((T(40) - o2_loc) * T(3.3 - 1.0), 35.0))
          : (o2_loc < T(5) ? T(poc_diss0 * 3.3) : T(poc_diss0));
  poc_diss = d.scalelength * poc_diss;
  const T decay_poc_e = e_exp(-dz / poc_diss);

  // ballast out-fluxes (BGC_mod.F90:2349-2365)
  const T caco3_s_out =
      cr.caco3_s * d.decay_caco3 +
      caco3_prod * (((T(1) - d.decay_caco3) * T(1.0 - P_CACO3_GAMMA)) *
                    d.caco3_diss);
  const T caco3_h_out =
      cr.caco3_h * d.decay_hard + caco3_prod * (dz * T(P_CACO3_GAMMA));
  const T sio2_s_out =
      cr.sio2_s * d.decay_sio2 +
      sio2_prod * (((T(1) - d.decay_sio2) * T(1.0 - P_SIO2_GAMMA)) *
                   d.sio2_diss);
  const T sio2_h_out =
      cr.sio2_h * d.decay_hard + sio2_prod * (dz * T(P_SIO2_GAMMA));
  const T dust_s_out = cr.dust_s * d.decay_dust;
  const T dust_h_out = cr.dust_h * d.decay_hard_dust;

  // QA(dust) deficit bookkeeping (BGC_mod.F90:2373-2412)
  T poc_prod_avail = (poc_prod - caco3_prod * T(RHO_CACO3)) -
                     sio2_prod * T(RHO_SIO2);
  const T dust_in_tot = cr.dust_s + cr.dust_h;
  const T qa_ratio = safe_div(dust_s_out + dust_h_out, dust_in_tot);
  T new_qa = cr.qa_dust_def > T(0) ? cr.qa_dust_def * qa_ratio : T(0);
  const bool reduce = new_qa > T(0);
  const T qa_reduced = new_qa - poc_prod_avail * dz;
  poc_prod_avail = reduce ? (qa_reduced < T(0) ? (-qa_reduced) * dzr : T(0))
                          : poc_prod_avail;
  new_qa = reduce ? clamp_min(qa_reduced, T(0)) : new_qa;

  // POC out-fluxes: hard = QA, soft = excess (BGC_mod.F90:2423-2438)
  T poc_h_out = (((caco3_s_out + caco3_h_out) * T(RHO_CACO3) +
                  (sio2_s_out + sio2_h_out) * T(RHO_SIO2)) +
                 (dust_s_out + dust_h_out) * T(RHO_DUST)) -
                new_qa;
  poc_h_out = (cr.poc_h == T(0) && poc_prod == T(0))
                  ? T(0)
                  : clamp_min(poc_h_out, T(0));
  const T poc_s_out = cr.poc_s * decay_poc_e +
                      poc_prod_avail * ((T(1) - decay_poc_e) * poc_diss);

  // remineralization by conservation (BGC_mod.F90:2445-2463)
  T caco3_remin = caco3_prod + ((cr.caco3_s - caco3_s_out) +
                                (cr.caco3_h - caco3_h_out)) * dzr;
  T sio2_remin = sio2_prod + ((cr.sio2_s - sio2_s_out) +
                              (cr.sio2_h - sio2_h_out)) * dzr;
  T poc_remin = poc_prod + ((cr.poc_s - poc_s_out) +
                            (cr.poc_h - poc_h_out)) * dzr;
  const T dust_remin = ((cr.dust_s - dust_s_out) +
                        (cr.dust_h - dust_h_out)) * dzr;

  // iron: remin proportional to POC remin (BGC_mod.F90:2469-2501)
  const T poc_in_tot = cr.poc_s + cr.poc_h;
  T fe_remin = poc_in_tot == T(0)
                   ? poc_remin * T(PARM_RED_FE_C)
                   : safe_div(poc_remin * (cr.fe_s + cr.fe_h), poc_in_tot);
  fe_remin = fe_remin + cr.fe_s * T(FE_SFLUX_REMIN_RATE);
  T fe_s_out = cr.fe_s + dz * (fe_prod - fe_remin);
  fe_remin = fe_s_out < T(0) ? cr.fe_s * dzr + fe_prod : fe_remin;
  fe_s_out = clamp_min(fe_s_out, T(0));
  fe_remin = (fe_remin + dust_remin * T(DUST_TO_FE)) + fesedflux * dzr;
  const T fe_h_out = cr.fe_h;

  // bottom cell: burial, sedimentary denitrification, anoxic remin
  // (BGC_mod.F90:2522-2631)
  const T poc_flux = poc_s_out + poc_h_out;
  const bool bot_poc = bot && poc_flux > T(0);
  const T flux_alt_day = (poc_flux * T(MPERCM)) * T(SPD);
  const T day_den = T(7) + flux_alt_day;
  const T poc_sed_loss =
      bot_poc ? poc_flux *
                    clamp_max(T(p.g(P_parm_POMbury)) *
                                  (T(0.013) + ((flux_alt_day * T(0.53)) *
                                               flux_alt_day) /
                                                  (day_den * day_den)),
                              T(0.8))
              : T(0);
  T sed_denitrif =
      bot_poc ? (dzr * poc_flux) * (T(0.06) + sed_pow(o2_loc - no3_loc) *
                                                  T(0.19))
              : T(0);
  sed_denitrif = no3_loc < T(5) ? T(0) : sed_denitrif;

  const T flux_alt_yr = ((poc_flux * T(1.0e-6)) * T(SPD)) * T(365);
  const T poc_left = (poc_flux - poc_sed_loss) -
                     (sed_denitrif * dz) * T(DENITRIF_C_N);
  T other_remin =
      bot_poc ? dzr * t_min(clamp_max(T(0.1) + flux_alt_yr, T(0.5)) *
                                (poc_flux - poc_sed_loss),
                            poc_left)
              : T(0);
  // anoxic bottom water: all remaining remin is denitrif + other
  other_remin = (bot_poc && o2_loc < T(1)) ? dzr * poc_left : other_remin;

  const T sio2_flux = sio2_s_out + sio2_h_out;
  const T sio2_bury_eff =
      (sio2_flux * T(MPERCM)) * T(SPD) > T(2) ? T(0.2) : T(0.04);
  const T sio2_sed_loss =
      bot ? (sio2_flux * T(p.g(P_parm_BSIbury))) * sio2_bury_eff : T(0);
  const T caco3_flux = caco3_s_out + caco3_h_out;
  const T caco3_sed_loss =
      (bot && cell_bottom_depth < T(LYSOCLINE_DEPTH)) ? caco3_flux : T(0);

  // re-inject the unburied bottom flux as remin (BGC_mod.F90:2574-2590)
  caco3_remin = (bot && caco3_flux > T(0))
                    ? caco3_remin + (caco3_flux - caco3_sed_loss) * dzr
                    : caco3_remin;
  sio2_remin = (bot && sio2_flux > T(0))
                   ? sio2_remin + (sio2_flux - sio2_sed_loss) * dzr
                   : sio2_remin;
  poc_remin = bot_poc ? poc_remin + (poc_flux - poc_sed_loss) * dzr
                      : poc_remin;

  // the bottom cell zeroes all outgoing fluxes (BGC_mod.F90:2615-2628)
  cr.poc_s = bot ? T(0) : poc_s_out;
  cr.poc_h = bot ? T(0) : poc_h_out;
  cr.caco3_s = bot ? T(0) : caco3_s_out;
  cr.caco3_h = bot ? T(0) : caco3_h_out;
  cr.sio2_s = bot ? T(0) : sio2_s_out;
  cr.sio2_h = bot ? T(0) : sio2_h_out;
  cr.dust_s = bot ? T(0) : dust_s_out;
  cr.dust_h = bot ? T(0) : dust_h_out;
  cr.fe_s = bot ? T(0) : fe_s_out;
  cr.fe_h = bot ? T(0) : fe_h_out;
  cr.qa_dust_def = new_qa;
  return {poc_remin, caco3_remin, sio2_remin, fe_remin, sed_denitrif,
          other_remin};
}

// ---- the 30 tendency expressions (ops/bgc.py::assemble_tendencies,
// BGC_mod.F90:1545-1790), unmasked ------------------------------------

template <typename T>
__device__ __forceinline__ void assemble_tendencies(
    const Kinetics<T>& K, const ParticleOut<T>& pt, T fe_scavenge,
    const T (&tr)[TR_CNT], T restore_no3, T restore_sio3, T restore_po4,
    const Params& p, T (&tend)[TR_CNT]) {
  const T no3 = tr[TR_NO3], nh4 = tr[TR_NH4], o2 = tr[TR_O2];
  const double o2_min = p.g(P_parm_o2_min);
  const double o2_min_delta = p.g(P_parm_o2_min_delta);
  const double par_lim = p.g(P_parm_nitrif_par_lim);

  T s_no3_v = T(0), s_nh4_v = T(0), s_loss_dic = T(0), s_graze_dic = T(0);
  T s_photo_fe = T(0), s_po4_v = T(0), s_graze_zoo = T(0), s_dop_v = T(0);
  T s_photo_c = T(0);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    s_no3_v = s_no3_v + K.no3_v[g];
    s_nh4_v = s_nh4_v + K.nh4_v[g];
    s_loss_dic = s_loss_dic + K.loss_dic_g[g];
    s_graze_dic = s_graze_dic + K.graze_dic[g];
    s_photo_fe = s_photo_fe + K.photoFe[g];
    s_po4_v = s_po4_v + K.po4_v[g];
    s_graze_zoo = s_graze_zoo + K.graze_zoo[g];
    s_dop_v = s_dop_v + K.dop_v[g];
    s_photo_c = s_photo_c + K.photoC[g];
  }

  // nitrate & ammonium (BGC_mod.F90:1545-1592), with the euphotic-zone
  // taper log(PAR_out/lim)/KPARdz
  T nitrif = nh4 * T(p.g(P_parm_kappa_nitrif));
  const bool taper_sel = K.par_in > T(par_lim);
  const T par_for_log =
      taper_sel ? clamp_min(K.par_out, T(1e-37)) : T(par_lim);
  const T taper = e_log(div_scalar(par_for_log, par_lim)) / (-K.kpar_dz);
  nitrif = taper_sel ? nitrif * taper : nitrif;
  nitrif = K.par_out < T(par_lim) ? nitrif : T(0);

  T denitrif_fac = clamp_max(
      clamp_min(div_scalar(T(o2_min + o2_min_delta) - o2, o2_min_delta),
                T(0)),
      T(1));
  denitrif_fac = no3 == T(0) ? T(0) : denitrif_fac;
  const T denitrif =
      denitrif_fac * (div_scalar((K.doc_remin + pt.poc_remin) - pt.other_remin,
                                 DENITRIF_C_N) -
                      pt.sed_denitrif);

  tend[TR_NO3] = (((restore_no3 + nitrif) - denitrif) - pt.sed_denitrif) -
                 s_no3_v;
  T t_nh4 = ((((-s_nh4_v) - nitrif) + K.don_remin) + K.donr_remin) +
            (((K.zoo_loss_dic + s_loss_dic) + s_graze_dic) +
             pt.poc_remin * T(1.0 - DONREFRACT)) * T(Q);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    if (p.on(g, A_nfixer)) t_nh4 = t_nh4 + K.nexcrete[g];
  }
  tend[TR_NH4] = t_nh4;

  // dissolved iron (BGC_mod.F90:1598-1605)
  T t_fe = (((pt.fe_remin + K.zoo_loss_dic * T(QFE_ZOO)) + K.dofe_remin) -
            s_photo_fe) - fe_scavenge;
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    t_fe = (t_fe + K.qfe[g] * (K.loss_dic_g[g] + K.graze_dic[g])) +
           K.graze_zoo[g] * (K.qfe[g] - T(QFE_ZOO));
  }
  tend[TR_FE] = t_fe;

  // dissolved SiO3 (BGC_mod.F90:1611-1628)
  T t_sio3 = restore_sio3 + pt.sio2_remin;
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    if (p.on(g, A_has_si)) {
      t_sio3 = (t_sio3 - K.photoSi[g]) +
               K.qsi[g] * (K.auto_graze[g] * T(F_GRAZE_SI_REMIN) +
                           K.auto_loss[g] * T(1.0 - p.a(g, A_loss_poc)));
    }
  }
  tend[TR_SIO3] = t_sio3;

  // phosphate (BGC_mod.F90:1634-1661)
  T t_po4 = (((restore_po4 + K.dop_remin) + K.dopr_remin) - s_po4_v) +
            (pt.poc_remin * T(1.0 - DOPREFRACT) + K.zoo_loss_dic) *
                T(QP_ZOO_POM);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    t_po4 = p.a(g, A_Qp) == QP_ZOO_POM
                ? t_po4 + (K.loss_dic_g[g] + K.graze_dic[g]) * T(p.a(g, A_Qp))
                : t_po4 + K.rem_p_dip[g];
  }
  tend[TR_PO4] = t_po4;

  // autotroph pools (BGC_mod.F90:1676-1697)
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    const T wloss = (K.auto_graze[g] + K.auto_loss[g]) + K.auto_agg[g];
    tend[TR_C_IND[g]] = K.photoC[g] - wloss;
    tend[TR_CHL_IND[g]] = K.photoacc[g] - K.thetaC[g] * wloss;
    tend[TR_FE_IND[g]] = K.photoFe[g] - K.qfe[g] * wloss;
    if (TR_SI_IND[g] >= 0) {
      tend[TR_SI_IND[g]] = K.photoSi[g] - K.qsi[g] * wloss;
    }
    if (TR_CACO3_IND[g] >= 0) {
      tend[TR_CACO3_IND[g]] = K.caco3_prod_g[g] - K.qcaco3[g] * wloss;
    }
  }

  // zooC & DOM pools (BGC_mod.F90:1703-1723)
  tend[TR_ZOOC] = s_graze_zoo - K.zoo_loss;
  tend[TR_DOC] = K.doc_prod - K.doc_remin;
  tend[TR_DON] = K.don_prod * T(1.0 - DONREFRACT) - K.don_remin;
  tend[TR_DONR] = (K.don_prod * T(DONREFRACT) - K.donr_remin) +
                  (pt.poc_remin * T(DONREFRACT)) * T(Q);
  tend[TR_DOP] = (K.dop_prod * T(1.0 - DOPREFRACT) - K.dop_remin) - s_dop_v;
  tend[TR_DOPR] = (K.dop_prod * T(DOPREFRACT) - K.dopr_remin) +
                  (pt.poc_remin * T(DOPREFRACT)) * T(QP_ZOO_POM);
  tend[TR_DOFE] = K.dofe_prod - K.dofe_remin;

  // DIC (BGC_mod.F90:1729-1745)
  T t_dic = (((((s_loss_dic + s_graze_dic) - s_photo_c) + K.doc_remin) +
              pt.poc_remin) + K.zoo_loss_dic) + pt.caco3_remin;
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    if (TR_CACO3_IND[g] >= 0) {
      t_dic = (t_dic + (K.auto_graze[g] * T(F_GRAZE_CACO3_REMIN)) *
                           K.qcaco3[g]) - K.caco3_prod_g[g];
    }
  }
  tend[TR_DIC] = t_dic;
  tend[TR_DIC_ALT_CO2] = p.g(P_alt_co2_use_eco) != 0.0 ? t_dic : T(0);

  // alkalinity (BGC_mod.F90:1751-1759)
  T t_alk = ((-tend[TR_NO3]) + tend[TR_NH4]) + pt.caco3_remin * T(2);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    if (TR_CACO3_IND[g] >= 0) {
      t_alk = t_alk + ((K.auto_graze[g] * T(F_GRAZE_CACO3_REMIN)) *
                           K.qcaco3[g] - K.caco3_prod_g[g]) * T(2);
    }
  }
  tend[TR_ALK] = t_alk;

  // oxygen (BGC_mod.F90:1765-1790)
  T o2_production = T(0);
#pragma unroll
  for (int g = 0; g < kNumAuto; ++g) {
    T contrib;
    if (!p.on(g, A_nfixer)) {
      const T denom = K.no3_v[g] + K.nh4_v[g];
      contrib = K.photoC[g] *
                (div_scalar(safe_div(K.no3_v[g], denom), PARM_RED_D_C_O2) +
                 div_scalar(safe_div(K.nh4_v[g], denom), PARM_REMIN_D_C_O2));
    } else {
      const T denom = (K.no3_v[g] + K.nh4_v[g]) + K.nfix[g];
      contrib = K.photoC[g] *
                ((div_scalar(safe_div(K.no3_v[g], denom), PARM_RED_D_C_O2) +
                  div_scalar(safe_div(K.nh4_v[g], denom),
                             PARM_REMIN_D_C_O2)) +
                 div_scalar(safe_div(K.nfix[g], denom),
                            PARM_RED_D_C_O2_DIAZ));
    }
    o2_production = o2_production + (K.photoC[g] > T(0) ? contrib : T(0));
  }
  const T o2_fac = clamp_max(
      clamp_min(div_scalar(o2 - T(o2_min), o2_min_delta), T(0)), T(1));
  const T o2_consumption =
      o2_fac * (div_scalar((((((pt.poc_remin + K.doc_remin) -
                                pt.sed_denitrif * T(DENITRIF_C_N)) -
                               pt.other_remin) + K.zoo_loss_dic) +
                             s_loss_dic) + s_graze_dic,
                           PARM_REMIN_D_C_O2) +
                nitrif * T(2));
  tend[TR_O2] = o2_production - o2_consumption;
}

// ---- the solve kernel: the dual pH solve of every cell, cell-parallel --

// Lane i is cell i = k * ncol + col: ambient, then ALT_CO2 on the same
// constants; a cell below its column's bottom copies both previous pH
// fields and reads nothing else.
template <typename T>
struct InteriorLanes {
  Ptrs f;
  int64_t ncol;

  __device__ __forceinline__ bool begin(int64_t i, Lane<T>& s) const {
    const int64_t k = i / ncol, col = i - k * ncol;
    const T ph_prev = in<T>(f, F_ph_prev)[i];
    const T ph_prev_alt = in<T>(f, F_ph_prev_alt)[i];
    if (k >= in<int32_t>(f, F_kmax)[col]) {
      out<T>(f, F_ph)[i] = ph_prev;
      out<T>(f, F_ph_alt)[i] = ph_prev_alt;
      return false;
    }
    const T* tr = in<T>(f, F_tracers) + k * TR_CNT * ncol + col;
    // clip the tracers (BGC_mod.F90:747-785), then ops/bgc.py::
    // carbonate_inputs' mass units
    s.t = talk_terms(
        coeffs_from<T>([&](int j) { return in<T>(f, F_k0 + j)[i]; }),
        to_mass_units(clamp_min(tr[TR_DIC * ncol], T(0)),
                      clamp_min(tr[TR_ALK * ncol], T(0)),
                      clamp_min(tr[TR_PO4 * ncol], T(0)),
                      clamp_min(tr[TR_SIO3 * ncol], T(0))));
    s.ph_alt = ph_prev_alt;
    s.part = 0;
    ph_bracket(ph_prev, s.x1, s.x2);
    return true;
  }

  __device__ __forceinline__ bool finish(int64_t i, Lane<T>& s) const {
    out<T>(f, s.part == 0 ? F_ph : F_ph_alt)[i] = -m_log10(s.soln);
    if (s.part == 1) return true;
    s.part = 1;
    ph_bracket(s.ph_alt, s.x1, s.x2);
    return false;
  }
};

constexpr int kSolveThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
    interior_solve_kernel(InteriorLanes<T> src, int64_t n) {
  solve_lanes<T>(src, n);
}

// ---- the biology kernel: a tile of whole columns per block ------------

// The per-cell values staged in shared memory, one slot of cols * nlev
// values each (ops/cuda_step.py::STAGED_FIELDS counts them).  The sinking
// scan (phase 4) reads a level's particulate sources and then writes
// that level's results over them.
enum Stage : int {
  S_par_prod,      // att (phase 1), then the product of the levels above
  S_poc,           // poc_prod, then poc_remin
  S_caco3,         // caco3_prod, then caco3_remin
  S_sio2,          // sio2_prod, then sio2_remin
  S_fe,            // fe_prod_base, then fe_remin
  S_sed_denitrif,
  S_other_remin,
  S_fe_scavenge,
  S_COUNT
};

// ops/cuda_step.py::BIO_THREADS
constexpr int kBioThreads = 128;

template <typename T>
__device__ __forceinline__ void load_tracers(const Ptrs& f, int64_t k,
                                             int64_t col, int64_t n,
                                             T (&tr)[TR_CNT]) {
  const T* trk = in<T>(f, F_tracers) + k * TR_CNT * n + col;
#pragma unroll
  for (int i = 0; i < TR_CNT; ++i) tr[i] = clamp_min(trk[i * n], T(0));
}

// The kinetics of the active cell (k, col), PAR from its staged product.
template <typename T>
__device__ __forceinline__ Kinetics<T> cell_kinetics(
    const Ptrs& f, const Params& p, int64_t k, int64_t col, int64_t n,
    const T (&tr)[TR_CNT], T par_prod) {
  const int64_t cell = k * n + col;
  const T lat = in<T>(f, F_lat)[col];
  // surface initializations (BGC_mod.F90:808-814)
  const T par_surf =
      clamp_min(in<T>(f, F_shortwave)[col], T(0)) * T(F_QSW_PAR);
  return ecosystem_kinetics(tr, in<T>(f, F_temp)[cell], in<T>(f, F_dz)[cell],
                            in<T>(f, F_center)[cell], lat >= T(0),
                            lat <= T(0), par_surf, par_prod,
                            in<T>(f, F_tfunc)[cell], p);
}

// What the sinking scan reads of a level from device memory: the clipped
// Fe, O2 and NO3 and the per-level fields.  The scan loads the next
// level's while it computes this one's.
template <typename T>
struct LevelIn {
  T fe, o2, no3, dz, bottom, fesed;
  Dissolution<T> d;

  __device__ __forceinline__ void load(const Ptrs& f, int64_t k, int64_t col,
                                       int64_t n) {
    const T* trk = in<T>(f, F_tracers) + k * TR_CNT * n + col;
    const int64_t cell = k * n + col;
    fe = clamp_min(trk[TR_FE * n], T(0));
    o2 = clamp_min(trk[TR_O2 * n], T(0));
    no3 = clamp_min(trk[TR_NO3 * n], T(0));
    dz = in<T>(f, F_dz)[cell];
    bottom = in<T>(f, F_bottom)[cell];
    fesed = in<T>(f, F_fesed)[cell];
    d = {in<T>(f, F_scalelength)[cell],  in<T>(f, F_decay_hard)[cell],
         in<T>(f, F_decay_hard_dust)[cell], in<T>(f, F_decay_caco3)[cell],
         in<T>(f, F_caco3_diss)[cell],   in<T>(f, F_decay_sio2)[cell],
         in<T>(f, F_sio2_diss)[cell],    in<T>(f, F_decay_dust)[cell]};
  }
};

// Block b holds columns [b * cols, b * cols + cols) at every level: tile
// cell i is level i / cols of column b * cols + i % cols, so neighbouring
// threads read neighbouring columns.  Threads loop over the tile's cells.
// The phases are separated by barriers, and every thread reaches every
// barrier.  Two blocks are kept resident per SM.
template <typename T>
__global__ void __launch_bounds__(kBioThreads, 2)
    interior_bio_kernel(Ptrs f, Params p, int nlev, int ncol, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const st = reinterpret_cast<T*>(smem);
  const int tile = cols * nlev;
  const int64_t n = ncol;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int32_t* const kmax = in<int32_t>(f, F_kmax);
  auto at = [&](int slot, int i) -> T& { return st[slot * tile + i]; };

  // 1. per cell: clip the tracers, the cell's PAR attenuation
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int64_t k = i / cols, col = col0 + i % cols;
    if (col >= n || k >= kmax[col]) continue;
    T tr[TR_CNT];
    load_tracers(f, k, col, n, tr);
    T a_chl[kNumAuto], kpar_dz;
    active_chl(tr, a_chl);
    at(S_par_prod, i) = attenuation(a_chl, in<T>(f, F_dz)[k * n + col],
                                    kpar_dz);
  }
  __syncthreads();

  // 2. per column, one thread: PAR's running product of the attenuation
  // of the levels above, in level order (_par_field's exclusive cumprod)
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const int64_t col = col0 + c;
    if (col >= n) continue;
    T par_prod = T(1);
    for (int k = 0; k < nlev && k < kmax[col]; ++k) {
      T& slot = at(S_par_prod, k * cols + c);
      const T att = slot;
      slot = par_prod;
      par_prod = par_prod * att;
    }
  }
  __syncthreads();

  // 3. per cell: the kinetics' particulate sources
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int64_t k = i / cols, col = col0 + i % cols;
    if (col >= n || k >= kmax[col]) continue;
    T tr[TR_CNT];
    load_tracers(f, k, col, n, tr);
    const Kinetics<T> K =
        cell_kinetics(f, p, k, col, n, tr, at(S_par_prod, i));
    at(S_poc, i) = K.poc_prod;
    at(S_caco3, i) = K.caco3_prod;
    at(S_sio2, i) = K.sio2_prod;
    at(S_fe, i) = K.fe_prod_base;
  }
  __syncthreads();

  // 4. per column, one thread: Fe scavenging and the sinking-particle
  // level update down the active levels, the carry in registers
  const double fe_scav0 = p.g(P_parm_fe_scavenge_rate0);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const int64_t col = col0 + c;
    if (col >= n) continue;
    const int kbot = kmax[col];
    const int kend = kbot < nlev ? kbot : nlev;
    Carry<T> cr = init_carry(clamp_min(in<T>(f, F_dust)[col], T(0)));
    LevelIn<T> next;
    if (kend > 0) next.load(f, 0, col, n);
    for (int k = 0; k < kend; ++k) {
      const int i = k * cols + c;
      const LevelIn<T> lv = next;
      if (k + 1 < kend) next.load(f, k + 1, col, n);
      // iron scavenging scales with the sinking mass flux entering this
      // level, i.e. the carry (BGC_mod.F90:1510-1522)
      T fe_scavenge_rate =
          T(fe_scav0) * ((((cr.poc_s + cr.poc_h) * T(120.1) +
                           (cr.caco3_s + cr.caco3_h) * T(P_CACO3_MASS)) +
                          (cr.sio2_s + cr.sio2_h) * T(P_SIO2_MASS)) +
                         (cr.dust_s + cr.dust_h) * T(DUST_FESCAV_SCALE));
      fe_scavenge_rate =
          lv.fe > T(FE_SCAVENGE_THRES1)
              ? fe_scavenge_rate +
                    (lv.fe - T(FE_SCAVENGE_THRES1)) * T(FE_MAX_SCALE2)
              : fe_scavenge_rate;
      const T fe_scavenge = (lv.fe * T(YPS)) * fe_scavenge_rate;
      const ParticleOut<T> pt = particulate_level_update(
          cr, at(S_poc, i), at(S_caco3, i), at(S_sio2, i),
          at(S_fe, i) + fe_scavenge, lv.o2, lv.no3, lv.dz, lv.bottom,
          lv.fesed, k + 1 == kbot, lv.d, p);
      at(S_poc, i) = pt.poc_remin;
      at(S_caco3, i) = pt.caco3_remin;
      at(S_sio2, i) = pt.sio2_remin;
      at(S_fe, i) = pt.fe_remin;
      at(S_sed_denitrif, i) = pt.sed_denitrif;
      at(S_other_remin, i) = pt.other_remin;
      at(S_fe_scavenge, i) = fe_scavenge;
    }
  }
  __syncthreads();

  // 5. per cell: the kinetics again, restoring and the 30 tendencies;
  // zero below the bottom (all levels of land columns)
  const bool rest_no3 = p.g(P_lrest_no3) != 0.0;
  const bool rest_po4 = p.g(P_lrest_po4) != 0.0;
  const bool rest_sio3 = p.g(P_lrest_sio3) != 0.0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int64_t k = i / cols, col = col0 + i % cols;
    if (col >= n) continue;
    const int64_t cell = k * n + col;
    T* tk = out<T>(f, F_tend) + k * TR_CNT * n + col;
    if (k >= kmax[col]) {
#pragma unroll
      for (int j = 0; j < TR_CNT; ++j) tk[j * n] = T(0);
      continue;
    }
    T tr[TR_CNT];
    load_tracers(f, k, col, n, tr);
    const Kinetics<T> K =
        cell_kinetics(f, p, k, col, n, tr, at(S_par_prod, i));
    const ParticleOut<T> pt{at(S_poc, i),          at(S_caco3, i),
                            at(S_sio2, i),         at(S_fe, i),
                            at(S_sed_denitrif, i), at(S_other_remin, i)};
    // nutrient restoring, gated by the static lrest_* flags
    // (ops/bgc.py::compute_restoring); the fields are read only when on
    const T restore_no3 =
        rest_no3 ? in<T>(f, F_rtau)[cell] *
                       (in<T>(f, F_no3_clim)[cell] - tr[TR_NO3])
                 : T(0);
    const T restore_sio3 =
        rest_sio3 ? in<T>(f, F_rtau)[cell] *
                        (in<T>(f, F_sio3_clim)[cell] - tr[TR_SIO3])
                  : T(0);
    const T restore_po4 =
        rest_po4 ? in<T>(f, F_rtau)[cell] *
                       (in<T>(f, F_po4_clim)[cell] - tr[TR_PO4])
                 : T(0);
    T tend[TR_CNT];
    assemble_tendencies(K, pt, at(S_fe_scavenge, i), tr, restore_no3,
                        restore_sio3, restore_po4, p, tend);
#pragma unroll
    for (int j = 0; j < TR_CNT; ++j) tk[j * n] = tend[j];
  }
}

// Shared memory of one block of ``cols`` columns.
template <typename T>
size_t bio_smem_bytes(int nlev, int cols) {
  return static_cast<size_t>(S_COUNT) * nlev * cols * sizeof(T);
}

template <typename T>
int launch_solve(const void* const* fields, int nlev, int ncol,
                 cudaStream_t stream) {
  InteriorLanes<T> src;
  for (int j = 0; j < F_COUNT; ++j) src.f.p[j] = fields[j];
  src.ncol = ncol;
  const int64_t n = static_cast<int64_t>(nlev) * ncol;
  const unsigned blocks = lane_blocks(kSolveThreads, n);
  interior_solve_kernel<T><<<blocks, kSolveThreads, 0, stream>>>(src, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bio(const void* const* fields, const double* params, int nlev,
               int ncol, int cols, cudaStream_t stream) {
  Ptrs f;
  for (int j = 0; j < F_COUNT; ++j) f.p[j] = fields[j];
  Params p;
  for (int j = 0; j < kNumParams; ++j) p.v[j] = params[j];
  const size_t smem = bio_smem_bytes<T>(nlev, cols);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        interior_bio_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tile = cols * nlev;
  const int threads = tile < kBioThreads ? tile : kBioThreads;
  const unsigned blocks = static_cast<unsigned>((ncol + cols - 1) / cols);
  interior_bio_kernel<T><<<blocks, threads, smem, stream>>>(f, p, nlev, ncol,
                                                            cols);
  return static_cast<int>(cudaGetLastError());
}

// Test hook, on no path of the model: the kernel's device functions at
// the sites where PyTorch's CUDA ops special-case their arguments,
// elementwise over n values, for the card tests to hold against the
// torch ops: site 0 is sed_pow (torch.pow with the scalar base 0.99),
// site 1 morel_kpar (ops/numerics.py::morel_kpar).
template <typename T>
__global__ void site_test_kernel(int site, const T* x, T* y, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  y[i] = site == 0 ? sed_pow(x[i]) : morel_kpar(x[i]);
}

}  // namespace
}  // namespace obgc

// Plain C interface for ctypes.  ``fields`` holds the obgc::Field
// pointers (ops/cuda_step.py::KERNEL_FIELDS).  All floating fields are
// of one type (double if ``is_double``, else float), kmax is int32.  Each
// launches on ``stream`` and returns cudaGetLastError() (0 on success).

// The solve kernel: the pH fields of every cell.
extern "C" int obgc_interior_solve(int is_double, const void* const* fields,
                                   int nlev, int ncol, void* stream) {
  if (ncol <= 0 || nlev <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) return obgc::launch_solve<double>(fields, nlev, ncol, s);
  return obgc::launch_solve<float>(fields, nlev, ncol, s);
}

// The biology kernel: the tendencies of every cell, ``cols`` columns per
// block; ``params`` holds the obgc_interior_num_params() host doubles of
// ops/kernel_params.py::pack_bgc_params.
extern "C" int obgc_interior_bio(int is_double, const void* const* fields,
                                 const double* params, int nlev, int ncol,
                                 int cols, void* stream) {
  if (ncol <= 0 || nlev <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return obgc::launch_bio<double>(fields, params, nlev, ncol, cols, s);
  }
  return obgc::launch_bio<float>(fields, params, nlev, ncol, cols, s);
}

// The biology kernel's shared memory for a block of ``cols`` columns of
// ``nlev`` levels, in bytes.
extern "C" long long obgc_interior_bio_smem(int is_double, int nlev,
                                            int cols) {
  return static_cast<long long>(
      is_double ? obgc::bio_smem_bytes<double>(nlev, cols)
                : obgc::bio_smem_bytes<float>(nlev, cols));
}

// The most dynamic shared memory a block of the current device may use.
extern "C" long long obgc_interior_smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

extern "C" int obgc_interior_num_params() { return obgc::kNumParams; }

extern "C" int obgc_interior_num_fields() { return obgc::F_COUNT; }

// The test hook's launcher (ops/cuda_step.py::site_test_hook).
extern "C" int obgc_interior_site_test_hook(int is_double, int site,
                                       const void* x, void* y, long long n,
                                       void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  if (is_double) {
    obgc::site_test_kernel<double><<<blocks, 256, 0, s>>>(
        site, static_cast<const double*>(x), static_cast<double*>(y), n);
  } else {
    obgc::site_test_kernel<float><<<blocks, 256, 0, s>>>(
        site, static_cast<const float*>(x), static_cast<float*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* obgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
