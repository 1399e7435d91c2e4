// K1: the pH solve, CUDA C++ for Hopper (sm_90a), in two instances, each
// with an unseeded and a seeded variant; the bracket-in instance also has
// a statistics variant.
//
// Replaces the Pallas TPU kernel
//   ocean_bgc_tpu/ops/pallas_carbonate.py::_carbonate_kernel (:63).
//
// The dual interior instance (obgc_carbonate_dual) reads the 15
// equilibrium constants per cell: from the env cache in the step with one
// (the TPU kernel's coeffs_in=True, with_sat=False), and from the
// constants kernel (carbonate_coeffs.cu, launched just before it) in the
// step without one (the TPU kernel's coeffs_in=False, with_sat=True
// variant, whose constants and saturation values that kernel writes).
// Per cell: tracers to mass units, then for each of the two scenarios
// (ambient, ALT_CO2) the pH bracket (previous pH +/- DEL_PH, or the cold
// [6, 9] window where the previous pH is the 0 sentinel), the bracketed
// safe-Newton root of the total-alkalinity residual (drtsafe_row,
// co2calc.F90:872-997) and the speciation into pH, H2CO3, HCO3 and CO3.
//
// The bracket-in instance (obgc_solve_htotal_brackets) is
// ops/carbonate.py::_solve_htotal_impl itself: H of every lane from
// H-space brackets given as input.  It solves the surface pair of every
// step (ambient and ALT_CO2 over all columns, co2calc_surface_dual), the
// env cache's stand-in problem (precompute_env) and the single-point
// calls (comp_htotal, co3_terms, co2calc_surface: one lane per cell).
// Its statistics variant (obgc_solve_htotal_brackets_stats,
// solve_htotal_stats) also writes each lane's steps and whether it
// converged, counted as the plain version counts them; it is a lane
// source of its own, so the other instances keep their code.  Lanes whose
// alkalinity, nutrients and constants are shared (the surface pair's two
// scenarios) read them in place: lane l reads element l % m of each
// shared field, so nothing is expanded in memory.
//
// Design.  Each lane freezes on its own convergence in the reference too
// (ocean_bgc_tpu/ops/carbonate.py:416-425), so a lane may be solved by
// any thread, and a problem may be finished by another thread than the
// one that started it.  Both instances run carbonate_solve.cuh's lanes,
// one per thread (the seeded variants handing their slow problems on,
// below).  The TPU kernel's 128-lane tiles, padding and stacked/
// sequential dual choice have no counterpart here.  Templated on
// float/double with the solver tolerance chosen per type as the plain
// version chooses it (1e-10 at f64, 1e-13 at f32).  The alkalinity
// residual keeps the plain version's association order term by term;
// built with --fmad=false and IEEE division, each lane's iterates are
// bitwise those of the plain PyTorch version.  The TPU kernel evaluated
// the constants inside the solve to save HBM traffic; here they are a
// kernel of their own, because the solve's registers (116 at f64) would
// set their occupancy too (carbonate_coeffs.cu).
//
// Bound.  The dual instance must read 21 fields per cell (DIC, ALK, PO4,
// SiO3, the two previous pH fields, 15 constants) and write 8:
// 29 * sizeof(T) bytes per cell, ~114 MB at f64 and ~57 MB at f32 for the
// 60 x 8192 flagship world, ~0.034 / 0.017 ms at 3.35 TB/s.  The
// bracket-in instance at the surface reads 3 fields per lane and 18 per
// column and writes one per lane (~1.7 MB at f64 for 8192 columns): it is
// bound by its launch and its slowest lanes, not by the card's rates.
//
// The unseeded tail.  Warm cells converge in 2-3 steps at f64 (mean
// 2.07); at f32 35.7% of them take 14-24 (mean 8.78, p50 4, p90 19: a
// bisection tail near the f32 rounding of the residual), as the
// statistics variant counts them on the H100 over the flagship world
// after 5 steps (chip_smoke.py's step distribution, PERF.md).  So with
// one lane per thread most of a warp waits for its slowest lane, and the
// f32 launch runs at 8.6x its bound.  There the
// slow lanes are the bulk: refilling finished threads with unstarted
// lanes from a device counter, per problem or per residual evaluation,
// measured no faster on the H100 at either type (PERF.md), so the
// unseeded variants keep one lane per thread, start to end.
//
// Seeded variants.  The TPU kernel's static x0_seed variant (launched
// under OBGC_X0_SEED=1) starts each problem's iteration at the previous
// root, clamped into the problem's bracket after bracket growth, instead
// of at the bracket midpoint: most warm problems then converge in one
// step instead of two or three.  Each instance here has that variant as
// a template argument of its lane source, so the unseeded variants
// compile to the code they had before.  The dual instance recovers the
// seed from the pH-space window as the TPU kernel does (x0_of,
// carbonate_solve.cuh::ph_seed): H at the window's midpoint where the
// window is warm (narrower than 1), else none; the bracket-in instance
// reads it as one more per-lane field (the surface pair's previous root,
// ops/carbonate.py::warm_brackets_h(with_seed=True)).  The seed costs one
// exp per problem and one per-lane field read, and saves residual
// evaluations, so the bounds above still hold for it.
//
// The seeded tail is sparse: at f32 the seeded warm problem takes 1.85
// steps on average but p99 18, and the env-off inputs' inactive cells
// solve cold from the [6, 9] window, scattered through the warps; one
// such problem holds its warp.  So the seeded f32 dual instance, below a
// cap of MAXIT, runs the parked-tail schedule
// (carbonate_solve.cuh::solve_lanes_parked): a problem still iterating
// after ``cap`` steps is parked in shared memory, and the block's first
// warps finish the parked problems densely.  At a cap of MAXIT or more it
// runs the one-lane kernel.  Every problem runs the same steps in the
// same order, so the outputs are bitwise the same at every cap.  On the
// H100 parking pays on env-off inputs, whose cold inactive lanes are the
// tail; on warm env-cache inputs its gain is within noise (PERF.md).  It
// does not pay at f64, where the seeded warm problem takes one step and
// the fixed work per problem (the residual at both bracket ends and at
// the first iterate) dominates, nor on the surface pair, whose time is
// its slowest lane's chain of steps; so only the f32 dual has a parked
// kernel, held to the one-lane kernel's occupancy (64 registers) by its
// launch bounds.  The seeded launches take their block size from the
// caller (ops/cuda_carbonate.py::seeded_launch_shape), so that the
// surface pair's 16,384 lanes spread over every SM (512 blocks of 32
// threads instead of 64 of 256).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "carbonate_solve.cuh"

namespace obgc {
namespace {

constexpr int kNumCoeffs = 15;
constexpr int kNumIn = 6 + kNumCoeffs;
constexpr int kNumOut = 8;
constexpr int kThreads = 256;

template <typename T, bool Seed>
struct DualLanes {
  static constexpr bool kSeed = Seed;
  static constexpr bool kStats = false;
  // dic, ta, pt, sit (mmol/m^3), ph_prev_a, ph_prev_b, then the 15
  // coefficients in CarbCoeffs order
  const T* in[kNumIn];
  // ph_a, h2co3_a, hco3_a, co3_a, ph_b, h2co3_b, hco3_b, co3_b
  T* out[kNumOut];

  // lane i is cell i: ambient first, then ALT_CO2 on the same constants
  __device__ __forceinline__ bool begin(int64_t i, Lane<T>& s) const {
    const MassUnits<T> m =
        to_mass_units(in[0][i], in[1][i], in[2][i], in[3][i]);
    s.t = talk_terms(coeffs_from<T>([&](int j) { return in[6 + j][i]; }),
                     m);
    s.dic = m.dic;
    s.ph_alt = in[5][i];
    s.part = 0;
    const T ph_prev = in[4][i];
    ph_bracket(ph_prev, s.x1, s.x2);
    if constexpr (Seed) s.x0 = ph_seed(ph_prev);
    return true;
  }

  // Write the speciation of problem s.part of lane i (the ambient
  // scenario into out[0..3], ALT_CO2 into out[4..7]) and, after the
  // ambient one, set up the ALT_CO2 problem; true once both are written.
  __device__ __forceinline__ bool finish(int64_t i, Lane<T>& s) const {
    const T h = s.soln;
    const T h2 = h * h;
    const T k12 = s.t.k12;
    const T denom = T(1) / (h2 + s.t.k1 * h + k12);
    // constant indices keep the pointers in the kernel's parameters
    const bool a = s.part == 0;
    (a ? out[0] : out[4])[i] = -m_log10(h);
    (a ? out[1] : out[5])[i] = s.dic * h2 * denom * T(cst::MASS_TO_VOL);
    (a ? out[2] : out[6])[i] =
        s.dic * s.t.k1 * h * denom * T(cst::MASS_TO_VOL);
    (a ? out[3] : out[7])[i] = s.dic * k12 * denom * T(cst::MASS_TO_VOL);
    if (s.part == 1) return true;
    s.part = 1;
    ph_bracket(s.ph_alt, s.x1, s.x2);
    if constexpr (Seed) s.x0 = ph_seed(s.ph_alt);
    return false;
  }
};

// The bracket-in instance's pointers, in the order of
// ops/cuda_carbonate.py::BRACKET_FIELDS (tests/test_torch_carbonate.py
// holds the two equal): per lane dic, x1, x2 and the seed x0 (read by the
// seeded variant only); per shared element ta, pt, sit and the 15
// constants; the output H per lane.
enum BracketField : int {
  B_dic,
  B_x1,
  B_x2,
  B_x0,
  B_ta,
  B_pt,
  B_sit,
  B_k0,
  B_k1,
  B_k2,
  B_ff,
  B_kb,
  B_k1p,
  B_k2p,
  B_k3p,
  B_ksi,
  B_kw,
  B_ks,
  B_kf,
  B_bt,
  B_st,
  B_ft,
  B_h,
  B_COUNT
};

template <typename T, bool Seed>
struct BracketLanes {
  static constexpr bool kSeed = Seed;
  static constexpr bool kStats = false;
  const T* in[B_h];
  T* h;
  int64_t m;   // elements of each shared field

  // lane l reads dic, x1, x2 of lane l, then ta, pt, sit and the 15
  // constants of shared element l % m
  __device__ __forceinline__ bool begin(int64_t l, Lane<T>& s) const {
    const int64_t e = l % m;
    s.t = talk_terms(
        coeffs_from<T>([&](int j) { return in[B_k0 + j][e]; }),
        MassUnits<T>{in[B_dic][l], in[B_ta][e], in[B_pt][e], in[B_sit][e]});
    s.part = 0;
    s.x1 = in[B_x1][l];
    s.x2 = in[B_x2][l];
    if constexpr (Seed) s.x0 = in[B_x0][l];
    return true;
  }

  __device__ __forceinline__ bool finish(int64_t l, Lane<T>& s) const {
    h[l] = s.soln;
    return true;
  }
};

// The bracket-in instance's statistics variant (solve_htotal_stats): the
// same lanes, and per lane also its steps and whether it converged (or
// stalled) before MAXIT, the plain version's ``iters`` and
// ``converged``.  A type of its own, so that the instances above keep
// their kernels' parameters and names.
template <typename T, bool Seed>
struct BracketStatsLanes : BracketLanes<T, Seed> {
  static constexpr bool kStats = true;
  int* iters;
  bool* converged;

  __device__ __forceinline__ void count(int64_t l, int steps,
                                        bool conv) const {
    iters[l] = steps;
    converged[l] = conv;
  }
};

template <typename T, typename Src>
__global__ void __launch_bounds__(kThreads)
    lanes_kernel(Src src, int64_t n) {
  solve_lanes<T, Src::kSeed, Src::kStats>(src, n);
}

// Four blocks of kThreads to an SM: at most 64 registers, those of the
// one-lane f32 kernel's occupancy.
template <typename T, typename Src>
__global__ void __launch_bounds__(kThreads, 4)
    parked_lanes_kernel(Src src, int64_t n, int cap) {
  solve_lanes_parked<T>(src, n, cap);
}

// The schedule of a seeded launch (unread by an unseeded one, which
// takes blocks of kThreads): the parked-tail cap, below MAXIT on the
// seeded f32 dual's parked kernel, else one lane per thread start to end;
// and the launch shape.
struct Schedule {
  int cap;
  unsigned blocks;
  int threads;
};

template <typename T, typename Src>
int launch(const Src& src, int64_t n, const Schedule& sch,
           cudaStream_t stream) {
  if constexpr (!Src::kSeed) {
    const unsigned blocks = lane_blocks(kThreads, n);
    lanes_kernel<T, Src><<<blocks, kThreads, 0, stream>>>(src, n);
  } else if constexpr (std::is_same_v<Src, DualLanes<float, true>>) {
    if (sch.cap < cst::MAXIT) {
      parked_lanes_kernel<T, Src>
          <<<sch.blocks, sch.threads, park_bytes<T>(sch.threads), stream>>>(
              src, n, sch.cap);
    } else {
      lanes_kernel<T, Src><<<sch.blocks, sch.threads, 0, stream>>>(src, n);
    }
  } else {
    lanes_kernel<T, Src><<<sch.blocks, sch.threads, 0, stream>>>(src, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Seed>
int launch_dual(const void* const* ins, void* const* outs, int64_t n,
                const Schedule& sch, cudaStream_t stream) {
  DualLanes<T, Seed> src;
  for (int j = 0; j < kNumIn; ++j) src.in[j] = static_cast<const T*>(ins[j]);
  for (int j = 0; j < kNumOut; ++j) src.out[j] = static_cast<T*>(outs[j]);
  return launch<T>(src, n, sch, stream);
}

template <typename T, bool Seed>
int launch_brackets(void* const* fields, int64_t n, int64_t m,
                    const Schedule& sch, cudaStream_t stream) {
  BracketLanes<T, Seed> src;
  for (int j = 0; j < B_h; ++j) src.in[j] = static_cast<const T*>(fields[j]);
  src.h = static_cast<T*>(fields[B_h]);
  src.m = m;
  return launch<T>(src, n, sch, stream);
}

template <typename T, bool Seed>
int launch_brackets_stats(void* const* fields, int* iters, bool* converged,
                          int64_t n, int64_t m, const Schedule& sch,
                          cudaStream_t stream) {
  BracketStatsLanes<T, Seed> src;
  for (int j = 0; j < B_h; ++j) src.in[j] = static_cast<const T*>(fields[j]);
  src.h = static_cast<T*>(fields[B_h]);
  src.m = m;
  src.iters = iters;
  src.converged = converged;
  return launch<T>(src, n, sch, stream);
}

// Whether a seeded launch of ``n`` lanes takes its schedule: at least
// one block of whole warps up to kThreads, and a cap of MAXIT or more or,
// where the instance has a parked kernel (``parks``), a cap of at least 0
// on a grid of a thread per lane (the parked kernel does not stride).
bool valid(const Schedule& sch, bool parks, int64_t n) {
  const bool shape = sch.blocks >= 1 && sch.threads >= 32 &&
                     sch.threads <= kThreads && sch.threads % 32 == 0;
  const bool parked = parks && sch.cap >= 0 &&
                      static_cast<int64_t>(sch.blocks) * sch.threads >= n;
  return shape && (sch.cap >= cst::MAXIT || parked);
}

__global__ void empty_kernel() {}

}  // namespace
}  // namespace obgc

// Plain C interface for ctypes.  All floating arrays are contiguous and of
// one type (double if ``is_double``, else float).  ``seed`` picks the
// seeded variant, which runs on ``blocks`` blocks of ``threads`` (a
// multiple of 32, at most 256); the unseeded variant does not read them.
// Each launches on ``stream`` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a seeded schedule it does not
// take.

// The dual instance: ``ins`` holds 21 device pointers and ``outs`` 8,
// each of ``n`` elements.  Its seeded f32 variant runs the parked-tail
// schedule with ``cap`` (steps before a problem is parked; >= MAXIT
// parks nothing; below MAXIT the grid must have a thread per lane); the
// seeded f64 variant takes only a cap >= MAXIT.
extern "C" int obgc_carbonate_dual(int is_double, int seed, int cap,
                                   unsigned blocks, int threads,
                                   const void* const* ins, void* const* outs,
                                   long long n, void* stream) {
  const obgc::Schedule sch{cap, blocks, threads};
  if (seed && !obgc::valid(sch, !is_double, n)) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return seed ? obgc::launch_dual<double, true>(ins, outs, n, sch, s)
                : obgc::launch_dual<double, false>(ins, outs, n, sch, s);
  }
  return seed ? obgc::launch_dual<float, true>(ins, outs, n, sch, s)
              : obgc::launch_dual<float, false>(ins, outs, n, sch, s);
}

// The bracket-in instance: ``fields`` holds the obgc::BracketField
// pointers (x0 may be null unless ``seed``); per-lane fields have ``n``
// elements, shared ones ``m``, and ``m`` divides ``n``.
extern "C" int obgc_solve_htotal_brackets(int is_double, int seed,
                                          unsigned blocks, int threads,
                                          void* const* fields, long long n,
                                          long long m, void* stream) {
  const obgc::Schedule sch{obgc::cst::MAXIT, blocks, threads};
  if (seed && !obgc::valid(sch, false, n)) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return seed ? obgc::launch_brackets<double, true>(fields, n, m, sch, s)
                : obgc::launch_brackets<double, false>(fields, n, m, sch, s);
  }
  return seed ? obgc::launch_brackets<float, true>(fields, n, m, sch, s)
              : obgc::launch_brackets<float, false>(fields, n, m, sch, s);
}

// The bracket-in instance's statistics variant: as
// obgc_solve_htotal_brackets, and per lane also its steps into ``iters``
// (int32) and whether it converged or stalled before MAXIT into
// ``converged`` (one byte, 0 or 1), ``n`` elements each.
extern "C" int obgc_solve_htotal_brackets_stats(int is_double, int seed,
                                                unsigned blocks, int threads,
                                                void* const* fields,
                                                void* iters, void* converged,
                                                long long n, long long m,
                                                void* stream) {
  const obgc::Schedule sch{obgc::cst::MAXIT, blocks, threads};
  if (seed && !obgc::valid(sch, false, n)) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto it = static_cast<int*>(iters);
  auto cv = static_cast<bool*>(converged);
  if (is_double) {
    return seed ? obgc::launch_brackets_stats<double, true>(fields, it, cv,
                                                            n, m, sch, s)
                : obgc::launch_brackets_stats<double, false>(fields, it, cv,
                                                             n, m, sch, s);
  }
  return seed ? obgc::launch_brackets_stats<float, true>(fields, it, cv, n,
                                                         m, sch, s)
              : obgc::launch_brackets_stats<float, false>(fields, it, cv, n,
                                                          m, sch, s);
}

extern "C" int obgc_brackets_num_fields() { return obgc::B_COUNT; }

// An empty kernel on ``blocks`` blocks of ``threads``: the launch floor
// that chip_smoke.py times beside the seeded launches.
extern "C" int obgc_empty_launch(unsigned blocks, int threads,
                                 void* stream) {
  obgc::empty_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* obgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
