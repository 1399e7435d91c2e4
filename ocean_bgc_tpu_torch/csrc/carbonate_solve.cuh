// The per-cell interior pH solve, shared by K1 (carbonate_dual.cu) and K2
// (interior_step.cu), so that both kernels run one device routine.
//
// Device counterpart of ops/carbonate.py: ``talk`` (the total-alkalinity
// residual and its slope, same association order term by term),
// ``_solve_htotal_impl`` for one lane (bracket growth, orientation, the
// bracketed safe-Newton iteration that stops on |dx| < xacc or a stall),
// with its H-independent terms formed once per problem; the driver that
// runs lanes over a grid, one per thread;
// ``_to_mass_units`` and the pH-space bracket of
// ops/cuda_carbonate.py::_ph_brackets.  Built with
// --fmad=false and IEEE division, each lane follows the plain version's
// iterate sequence.
//
// The constants (obgc_constants.h) are generated from
// ocean_bgc_tpu_torch/constants.py by ops/_kernels.py at build time.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

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

// x / c for a tensor x and a Python scalar c, as PyTorch's CUDA division
// by a CPU scalar computes it: x times the reciprocal of c, formed in
// double and rounded to the working type (at f32 a reciprocal formed in
// float can be an ulp off: 1.80655 and ln 10 are)
template <typename T>
__device__ __forceinline__ T div_scalar(T x, double c) {
  return x * T(1.0 / c);
}

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

// The terms of the total-alkalinity residual that do not depend on H,
// formed once per problem: the products talk would otherwise form at
// every evaluation, each in the association order of ops/carbonate.py::
// talk, so the residual keeps its bits.
template <typename T>
struct TalkTerms {
  T ta, pt, k1, k1p, k1p2, k12, k12p, k123p, kb, ksi, kw, kf, st, ft;
  T k1_dic, dic2_k12, bt_kb, pt_k12p, pt2_k123p, sit_ksi;
  T htot_ks, hfree_per_htot;
};

template <typename T>
__device__ __forceinline__ TalkTerms<T> talk_terms(const Coeffs<T>& c,
                                                   const MassUnits<T>& m) {
  TalkTerms<T> t;
  t.ta = m.ta;
  t.pt = m.pt;
  t.k1 = c.k1;
  t.k1p = c.k1p;
  t.k1p2 = T(2) * c.k1p;
  t.k12 = c.k1 * c.k2;
  t.k12p = c.k1p * c.k2p;
  t.k123p = t.k12p * c.k3p;
  t.kb = c.kb;
  t.ksi = c.ksi;
  t.kw = c.kw;
  t.kf = c.kf;
  t.st = c.st;
  t.ft = c.ft;
  t.k1_dic = c.k1 * m.dic;
  t.dic2_k12 = T(2) * m.dic * t.k12;
  t.bt_kb = c.bt * c.kb;
  t.pt_k12p = m.pt * t.k12p;
  t.pt2_k123p = T(2) * m.pt * t.k123p;
  t.sit_ksi = m.sit * c.ksi;
  const T htot_per_hfree = T(1) + c.st / c.ks;
  t.htot_ks = htot_per_hfree * c.ks;
  t.hfree_per_htot = T(1) / htot_per_hfree;
  return t;
}

// Total alkalinity residual fn(H) and its slope (ops/carbonate.py::talk),
// same association order term by term.
template <typename T>
__device__ __forceinline__ void talk(const TalkTerms<T>& t, T h, T& fn,
                                     T& df) {
  const T inv_h = T(1) / h;
  const T h2 = h * h;
  const T inv_h2 = inv_h * inv_h;
  const T h3 = h2 * h;
  const T phos_den = h3 + t.k1p * h2 + t.k12p * h + t.k123p;
  const T inv_phos_den = T(1) / phos_den;
  const T inv_phos_den2 = inv_phos_den * inv_phos_den;
  const T dphos_den = T(3) * h2 + t.k1p2 * h + t.k12p;
  const T carb_den = h2 + t.k1 * h + t.k12;
  const T inv_carb_den = T(1) / carb_den;
  const T inv_carb_den2 = inv_carb_den * inv_carb_den;
  const T dcarb_den = T(2) * h + t.k1;
  const T inv_borate_den = T(1) / (t.kb + h);
  const T inv_sili_den = T(1) / (t.ksi + h);
  const T hso4_frac = T(1) / (T(1) + t.htot_ks * inv_h);
  const T hf_frac = T(1) / (T(1) + t.kf * inv_h);

  fn = t.k1_dic * h * inv_carb_den
     + t.dic2_k12 * inv_carb_den
     + t.bt_kb * inv_borate_den
     + t.kw * inv_h
     + t.pt_k12p * h * inv_phos_den
     + t.pt2_k123p * inv_phos_den
     + t.sit_ksi * inv_sili_den
     - h * t.hfree_per_htot
     - t.st * hso4_frac
     - t.ft * hf_frac
     - t.pt * h3 * inv_phos_den
     - t.ta;

  df = t.k1_dic * (carb_den - h * dcarb_den) * inv_carb_den2
     - t.dic2_k12 * dcarb_den * inv_carb_den2
     - t.bt_kb * inv_borate_den * inv_borate_den
     - t.kw * inv_h2
     + (t.pt_k12p * (phos_den - h * dphos_den)) * inv_phos_den2
     - t.pt2_k123p * dphos_den * inv_phos_den2
     - t.sit_ksi * inv_sili_den * inv_sili_den
     - T(1) * t.hfree_per_htot
     - t.st * hso4_frac * hso4_frac * (t.htot_ks * inv_h2)
     - t.ft * hf_frac * hf_frac * t.kf * inv_h2
     - t.pt * h2 * (T(3) * phos_den - h * dphos_den) * inv_phos_den2;
}

template <typename T>
__device__ __forceinline__ bool not_bracketed(T flo, T fhi) {
  return (flo > T(0) && fhi > T(0)) || (flo < T(0) && fhi < T(0));
}

// One problem of ops/carbonate.py::_solve_htotal_impl, cut at its steps
// so that another thread may take the problem on between two of them
// (solve_lanes_parked): its state between two Newton-or-bisection steps
// (Newton), its start (newton_start: bracket growth, orientation, the
// first iterate and its residual) and its steps (newton_steps).  A
// problem's iterates are the same bits whichever thread takes which step.
// ``Seed``: the opt-in iteration seed (x0_seed_enabled) — a problem with
// x0 > 0 starts at x0 clamped into its oriented bracket instead of the
// midpoint; without it x0 is not read and the routine is the unseeded
// one.

// The iterate, the oriented bracket (f(xlo) < 0), the last two steps,
// the residual and slope at the iterate, and the steps taken.
template <typename T>
struct Newton {
  T soln, xlo, xhi, dx, dxold, f, df;
  int it;
};

// A problem up to its first step.
template <typename T, bool Seed>
__device__ __forceinline__ Newton<T> newton_start(const TalkTerms<T>& t, T x1,
                                                  T x2, T x0) {
  T flo, fhi, unused;
  talk(t, x1, flo, unused);
  talk(t, x2, fhi, unused);
  for (int it = 0; it < cst::BRACKET_GROW_GUARD && not_bracketed(flo, fhi);
       ++it) {
    const T growth = m_sqrt(x2 / x1);
    x1 = x1 / growth;
    x2 = x2 * growth;
    talk(t, x1, flo, unused);
    talk(t, x2, fhi, unused);
  }
  const bool neg_at_x1 = flo < T(0);
  T xlo = neg_at_x1 ? x1 : x2;
  T xhi = neg_at_x1 ? x2 : x1;

  T soln = T(0.5) * (xlo + xhi);
  if constexpr (Seed) {
    if (x0 > T(0)) {
      // torch.clamp(x0, torch.minimum(xlo, xhi), torch.maximum(xlo, xhi))
      const T lo = xlo < xhi ? xlo : xhi;
      const T hi = xlo < xhi ? xhi : xlo;
      soln = x0 < lo ? lo : (x0 > hi ? hi : x0);
    }
  }
  T dxold = m_abs(xlo - xhi);
  T dx = dxold;
  T f, df;
  talk(t, soln, f, df);
  return Newton<T>{soln, xlo, xhi, dx, dxold, f, df, 0};
}

// The steps of problem ``s`` until its step is below ``xacc`` or stalls,
// or it has taken ``stop`` steps in all (at most MAXIT); true once the
// problem is done: converged, stalled or at MAXIT.  The state is iterated
// in locals and stored back once: so written, solve_htotal's kernels
// compile to the same SASS as one undivided loop, where iterating the
// fields of ``s`` in place moved registers and slowed the f32 surface
// pair by 4% (PERF.md).  ``Stats`` (the statistics sources): also store
// in ``*converged`` whether the problem stopped by converging or
// stalling, not at MAXIT or ``stop`` (the plain version's ``converged``);
// without it the pointer is not read and the routine is the one above.
template <typename T, bool Stats = false>
__device__ __forceinline__ bool newton_steps(const TalkTerms<T>& t,
                                             Newton<T>& s, T xacc, int stop,
                                             bool* converged = nullptr) {
  T soln = s.soln, xlo = s.xlo, xhi = s.xhi, dx = s.dx, dxold = s.dxold;
  T f = s.f, df = s.df;
  int it = s.it;
  bool done = false;
  for (; it < stop; ++it) {
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
    if (stalled || m_abs(dx) < xacc) {
      ++it;
      done = true;
      break;
    }
    talk(t, soln, f, df);
    if (f < T(0)) {
      xlo = soln;
    } else if (f >= T(0)) {
      xhi = soln;
    }
  }
  s = Newton<T>{soln, xlo, xhi, dx, dxold, f, df, it};
  if constexpr (Stats) *converged = done;
  return done || it >= cst::MAXIT;
}

// One problem start to end in one thread.
template <typename T, bool Seed = false>
__device__ T solve_htotal(const TalkTerms<T>& t, T x1, T x2, T xacc,
                          T x0 = T(0)) {
  Newton<T> s = newton_start<T, Seed>(t, x1, x2, x0);
  newton_steps(t, s, xacc, cst::MAXIT);
  return s.soln;
}

// The 15 constants in CarbCoeffs order, constant j read as at(j).
template <typename T, typename At>
__device__ __forceinline__ Coeffs<T> coeffs_from(const At& at) {
  return {at(0), at(1), at(2),  at(3),  at(4),  at(5),  at(6), at(7),
          at(8), at(9), at(10), at(11), at(12), at(13), at(14)};
}

// The H-space bracket of one scenario of one cell: the pH-space window
// ph_prev -/+ DEL_PH (the cold [PHLO_3D_INIT, PHHI_3D_INIT] window where
// ph_prev is the 0 sentinel), each end converted with one exp
// (ops/cuda_carbonate.py::_ph_brackets).
template <typename T>
__device__ __forceinline__ void ph_bracket(T ph_prev, T& x1, T& x2) {
  const bool warm = ph_prev != T(0);
  const T phlo = warm ? ph_prev - T(cst::DEL_PH) : T(cst::PHLO_3D_INIT);
  const T phhi = warm ? ph_prev + T(cst::DEL_PH) : T(cst::PHHI_3D_INIT);
  x1 = m_exp(T(-cst::LN10) * phhi);
  x2 = m_exp(T(-cst::LN10) * phlo);
}

// The iteration seed of that bracket, as the TPU kernel recovers it
// (ocean_bgc_tpu/ops/pallas_carbonate.py::x0_of, :87-97): H at the
// pH-space window's midpoint where the window is narrower than 1 (a warm
// window, whose midpoint is the previous pH), else the 0 sentinel
// (ops/cuda_carbonate.py::_ph_brackets).
template <typename T>
__device__ __forceinline__ T ph_seed(T ph_prev) {
  const bool warm = ph_prev != T(0);
  const T phlo = warm ? ph_prev - T(cst::DEL_PH) : T(cst::PHLO_3D_INIT);
  const T phhi = warm ? ph_prev + T(cst::DEL_PH) : T(cst::PHHI_3D_INIT);
  const T mid = T(0.5) * (phlo + phhi);
  return (phhi - phlo) < T(1) ? m_exp(T(-cst::LN10) * mid) : T(0);
}

// ---- lanes over the threads of a grid, one per thread
//
// A lane is one cell's problems (or one problem); each thread solves its
// lane's problems, so a warp runs as long as its slowest lane.  Two
// schedules:
//
// - One lane per thread (solve_lanes), every unseeded source and a
//   seeded one at a cap of MAXIT or more: each thread solves its lane's
//   problems start to end.  Unseeded, the slow problems are the bulk,
//   not a tail: at f32 35.7% of the flagship world's warm interior
//   problems take 14-24 steps (mean 8.78, p50 4, p90 19: a bisection
//   tail near the f32 rounding of the residual; chip_smoke.py's step
//   distribution on the H100, PERF.md), so nearly every warp holds
//   several and there is little idle time to reclaim.
//   Refill (a thread whose lane is done takes the next unstarted lane
//   from a device counter) and a per-step lane state machine measured no
//   faster on the H100 at either type (PERF.md).
// - The parked tail (solve_lanes_parked), the seeded f32 dual instance
//   at a cap below MAXIT: a seeded warm problem mostly converges in one
//   step, and the slow ones are sparse (f32: mean 1.85 steps per
//   problem, p99 18; cold lanes and lanes whose bracket grows), yet one
//   of them holds a whole warp.  Each problem runs up to ``cap`` steps in
//   its own thread; one still iterating is parked in shared memory, and
//   after the block's barrier the block's first warps resume the parked
//   problems densely, one per thread, to the same stopping rule.  A
//   problem is handed over once, and only if it reaches the cap.  The
//   other seeded instances measured no faster parked (PERF.md) and keep
//   one lane per thread.
//
// A lane source ``Src`` gives ``begin(i, s)``, which reads lane i's
// inputs, sets up its first problem in s and returns true, or writes a
// result that needs no solve and returns false; and ``finish(i, s)``,
// which writes the root s.soln of problem s.part and returns true, or
// sets up the lane's next problem in s and returns false.  A seeded
// source sets each problem's seed s.x0, and its begin(i, s) may be
// called again for a lane it set up (the parked schedule recomputes a
// parked lane's terms from its inputs instead of storing them).

template <typename T>
struct Lane {
  TalkTerms<T> t;
  T dic;                          // mol/kg, for the speciation
  T x1, x2, soln;                 // the problem's bracket and root
  T x0;                           // its iteration seed (seeded sources)
  int part;                       // which of a lane's problems (scenario)
  T ph_alt;                       // the second scenario's previous pH
};

// Solve lanes [0, n), one per thread of the grid (strided past the grid).
// ``Seed``: each problem starts from its seed s.x0, which the source sets
// (solve_htotal); unseeded sources leave it unset and unread.  ``Stats``:
// the source also takes each problem's steps and whether it converged
// (or stalled) before MAXIT, by ``count(i, steps, converged)`` before its
// ``finish(i, s)``; the steps are the plain version's ``iters``, the step
// that converges counted.
template <typename T, bool Seed = false, bool Stats = false, typename Src>
__device__ __forceinline__ void solve_lanes(const Src& src, int64_t n) {
  const T xacc = solver_xacc<T>();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       lane < n; lane += stride) {
    Lane<T> s;
    if (!src.begin(lane, s)) continue;
    do {
      if constexpr (Stats) {
        Newton<T> st =
            newton_start<T, Seed>(s.t, s.x1, s.x2, Seed ? s.x0 : T(0));
        bool converged;
        newton_steps<T, true>(s.t, st, xacc, cst::MAXIT, &converged);
        s.soln = st.soln;
        src.count(lane, st.it, converged);
      } else if constexpr (Seed) {
        s.soln = solve_htotal<T, true>(s.t, s.x1, s.x2, xacc, s.x0);
      } else {
        s.soln = solve_htotal(s.t, s.x1, s.x2, xacc);
      }
    } while (!src.finish(lane, s));
  }
}

// ---- the parked-tail schedule

// Dynamic shared memory of a parked-schedule block of ``threads``: per
// slot the Newton state's seven values, then per slot the parked lane's
// offset in the block with its part (offset * 2 + part), then per slot
// its steps taken.
template <typename T>
constexpr size_t park_bytes(int threads) {
  return static_cast<size_t>(threads) * (7 * sizeof(T) + 2 * sizeof(int));
}

// Slot k's j-th Newton value, its lane, its steps, in ``smem`` laid out
// as park_bytes says for blocks of ``slots`` threads.
template <typename T>
__device__ __forceinline__ T& park_value(unsigned char* smem, int slots,
                                         int j, int k) {
  return reinterpret_cast<T*>(smem)[j * slots + k];
}
template <typename T>
__device__ __forceinline__ int& park_who(unsigned char* smem, int slots,
                                         int k) {
  return reinterpret_cast<int*>(smem + 7 * sizeof(T) * slots)[k];
}
template <typename T>
__device__ __forceinline__ int& park_steps(unsigned char* smem, int slots,
                                           int k) {
  return reinterpret_cast<int*>(smem + 7 * sizeof(T) * slots)[slots + k];
}

// Solve lanes [0, n) of a seeded source, one per thread of a grid of at
// least n threads, on the parked-tail schedule: a problem still iterating
// after ``cap`` (< MAXIT) steps is parked, and resumed after the block's
// barrier by the block's first threads, which then solve the rest of its
// lane without a cap.  blockDim.x is a multiple of 32, and the block has
// park_bytes<T>(blockDim.x) of dynamic shared memory.  (One round, not a
// grid-stride loop: the loop's live values made the f32 kernel spill at
// its 64 registers.)
template <typename T, typename Src>
__device__ __forceinline__ void solve_lanes_parked(const Src& src, int64_t n,
                                                   int cap) {
  extern __shared__ __align__(16) unsigned char park_smem[];
  __shared__ int parked;
  const T xacc = solver_xacc<T>();
  const int threads = blockDim.x;
  const int me = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * threads;
  if (me == 0) parked = 0;
  __syncthreads();
  // phase 1: this thread's lane, each problem up to ``cap`` steps
  const int64_t lane = base + me;
  Lane<T> s;
  Newton<T> st;
  bool park = false;
  if (lane < n && src.begin(lane, s)) {
    for (;;) {
      st = newton_start<T, true>(s.t, s.x1, s.x2, s.x0);
      park = !newton_steps(s.t, st, xacc, cap);
      if (park) break;
      s.soln = st.soln;
      if (src.finish(lane, s)) break;
    }
  }
  // a slot per parked problem: one add to the block's count per warp
  const unsigned ballot = __ballot_sync(0xffffffffu, park);
  int first = 0;
  if ((me & 31) == 0 && ballot != 0u) {
    first = atomicAdd(&parked, __popc(ballot));
  }
  first = __shfl_sync(0xffffffffu, first, 0);
  if (park) {
    const int k = first + __popc(ballot & ((1u << (me & 31)) - 1u));
    park_value<T>(park_smem, threads, 0, k) = st.soln;
    park_value<T>(park_smem, threads, 1, k) = st.xlo;
    park_value<T>(park_smem, threads, 2, k) = st.xhi;
    park_value<T>(park_smem, threads, 3, k) = st.dx;
    park_value<T>(park_smem, threads, 4, k) = st.dxold;
    park_value<T>(park_smem, threads, 5, k) = st.f;
    park_value<T>(park_smem, threads, 6, k) = st.df;
    park_who<T>(park_smem, threads, k) = me * 2 + s.part;
    park_steps<T>(park_smem, threads, k) = st.it;
  }
  __syncthreads();
  // phase 2: the parked problems, one per thread of the first warps,
  // each with the rest of its lane
  if (me < parked) {
    const int who = park_who<T>(park_smem, threads, me);
    const int64_t plane = base + (who >> 1);
    src.begin(plane, s);   // the lane's terms again, from its inputs
    s.part = who & 1;
    st.soln = park_value<T>(park_smem, threads, 0, me);
    st.xlo = park_value<T>(park_smem, threads, 1, me);
    st.xhi = park_value<T>(park_smem, threads, 2, me);
    st.dx = park_value<T>(park_smem, threads, 3, me);
    st.dxold = park_value<T>(park_smem, threads, 4, me);
    st.f = park_value<T>(park_smem, threads, 5, me);
    st.df = park_value<T>(park_smem, threads, 6, me);
    st.it = park_steps<T>(park_smem, threads, me);
    newton_steps(s.t, st, xacc, cst::MAXIT);
    s.soln = st.soln;
    while (!src.finish(plane, s)) {
      st = newton_start<T, true>(s.t, s.x1, s.x2, s.x0);
      newton_steps(s.t, st, xacc, cst::MAXIT);
      s.soln = st.soln;
    }
  }
}

// Blocks of ``threads`` for ``n`` lanes, one thread per lane.
inline unsigned lane_blocks(int threads, int64_t n) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace obgc
