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
// ALT_CO2.  The per-cell solve is carbonate_solve.cuh, which K2
// (interior_step.cu) runs too.  Templated on float/double with the solver
// tolerance chosen per type as the plain version chooses it (1e-10 at
// f64, 1e-13 at f32).
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

#include "carbonate_solve.cuh"

namespace obgc {
namespace {

constexpr int kNumCoeffs = 15;
constexpr int kNumIn = 6 + kNumCoeffs;
constexpr int kNumOut = 8;

template <typename T>
struct Args {
  // dic, ta, pt, sit (mmol/m^3), ph_prev_a, ph_prev_b, then the 15
  // coefficients in CarbCoeffs order
  const T* in[kNumIn];
  // ph_a, h2co3_a, hco3_a, co3_a, ph_b, h2co3_b, hco3_b, co3_b
  T* out[kNumOut];
};

template <typename T>
__global__ void carbonate_dual_kernel(Args<T> a, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const MassUnits<T> m =
        to_mass_units(a.in[0][i], a.in[1][i], a.in[2][i], a.in[3][i]);
    const T* const* k = a.in + 6;
    const Coeffs<T> c{k[0][i],  k[1][i],  k[2][i],  k[3][i],  k[4][i],
                      k[5][i],  k[6][i],  k[7][i],  k[8][i],  k[9][i],
                      k[10][i], k[11][i], k[12][i], k[13][i], k[14][i]};

#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const T h = solve_scenario(c, m, a.in[4 + s][i]);
      const T h2 = h * h;
      const T k12 = c.k1 * c.k2;
      const T denom = T(1) / (h2 + c.k1 * h + k12);
      T* const* out = a.out + 4 * s;
      out[0][i] = -m_log10(h);
      out[1][i] = m.dic * h2 * denom * T(cst::MASS_TO_VOL);
      out[2][i] = m.dic * c.k1 * h * denom * T(cst::MASS_TO_VOL);
      out[3][i] = m.dic * k12 * denom * T(cst::MASS_TO_VOL);
    }
  }
}

template <typename T>
int launch(const void* const* ins, void* const* outs, int64_t n,
           cudaStream_t stream) {
  Args<T> a;
  for (int j = 0; j < kNumIn; ++j) a.in[j] = static_cast<const T*>(ins[j]);
  for (int j = 0; j < kNumOut; ++j) a.out[j] = static_cast<T*>(outs[j]);
  constexpr int kThreads = 256;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  carbonate_dual_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace obgc

// Plain C interface for ctypes.  ``ins`` holds 21 device pointers and
// ``outs`` 8, all contiguous arrays of ``n`` elements of one type
// (double if ``is_double``, else float).  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success).
extern "C" int obgc_carbonate_dual(int is_double, const void* const* ins,
                                   void* const* outs, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) return obgc::launch<double>(ins, outs, n, s);
  return obgc::launch<float>(ins, outs, n, s);
}

extern "C" const char* obgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
