// K1's constants kernel, CUDA C++ for Hopper (sm_90a): the 15 equilibrium
// constants of every cell and, when asked, the calcite and aragonite
// saturation values, for K1's dual instance (carbonate_dual.cu) in the
// step without an env cache.  Replaces the constants part of the TPU
// kernel's coeffs_in=False, with_sat=True variant
// (ocean_bgc_tpu/ops/pallas_carbonate.py:63).  carbonate_coeffs.cuh holds
// the arithmetic, bitwise the plain version's under --fmad=false and IEEE
// division; cell i takes the pressure corrections where i >= ncol.
//
// Split from the solve for its registers: a kernel that holds the solve
// takes the solve's 116 at f64 (2 blocks of 256 threads per SM); this one
// 80 / 40 at f64 / f32 (3 / 6 blocks), no spills.  Bound: 3 fields read
// and 17 written per cell, 78.6 / 39.3 MB at f64 / f32 for 60 x 8192
// cells, ~0.0235 / 0.0117 ms at 3.35 TB/s; its ~0.2 Gop (339 + 68 per
// cell) take ~0.006 ms at 34 TFLOP/s.

#include <cuda_runtime.h>

#include <cstdint>

#include "carbonate_coeffs.cuh"

namespace obgc {
namespace {

// The outputs, each a (levels, ncol) field, in the order of
// ops/cuda_carbonate.py::COEFF_OUTPUTS (tests/test_torch_carbonate.py).
enum CoeffOut : int {
  O_k0, O_k1, O_k2, O_ff, O_kb, O_k1p, O_k2p, O_k3p, O_ksi, O_kw, O_ks,
  O_kf, O_bt, O_st, O_ft, O_sat_calc, O_sat_arag, O_COUNT
};

constexpr int kThreads = 256;

template <typename T>
struct CoeffArgs {
  const T* depth;
  const T* temp;
  const T* salt;
  T* out[O_COUNT];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    coeffs_kernel(CoeffArgs<T> a, int64_t n, int64_t ncol, bool with_sat) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const T depth = a.depth[i];
    const T temp = a.temp[i];
    const T salt = a.salt[i];
    const bool pressure = i >= ncol;
    const Coeffs<T> c = carbonate_coeffs(depth, temp, salt, pressure);
    const T vals[O_sat_calc] = {c.k0,  c.k1,  c.k2, c.ff, c.kb,
                                c.k1p, c.k2p, c.k3p, c.ksi, c.kw,
                                c.ks,  c.kf,  c.bt, c.st, c.ft};
#pragma unroll
    for (int j = 0; j < O_sat_calc; ++j) a.out[j][i] = vals[j];
    if (with_sat) {
      co3_sat_vals(depth, temp, salt, pressure, a.out[O_sat_calc][i],
                   a.out[O_sat_arag][i]);
    }
  }
}

template <typename T>
int launch(const void* depth, const void* temp, const void* salt,
           void* const* outs, int64_t n, int64_t ncol, bool with_sat,
           cudaStream_t stream) {
  CoeffArgs<T> a;
  a.depth = static_cast<const T*>(depth);
  a.temp = static_cast<const T*>(temp);
  a.salt = static_cast<const T*>(salt);
  for (int j = 0; j < O_COUNT; ++j)
    a.out[j] = j < O_sat_calc || with_sat ? static_cast<T*>(outs[j]) : nullptr;
  const unsigned blocks = lane_blocks(kThreads, n);
  coeffs_kernel<T><<<blocks, kThreads, 0, stream>>>(a, n, ncol, with_sat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace obgc

// Plain C interface for ctypes: contiguous (levels, ncol) arrays of n
// doubles (is_double) or floats; outs in CoeffOut order, the last two
// unused unless with_sat.  Returns cudaGetLastError() (0 on success).
extern "C" int obgc_carbonate_coeffs(int is_double, const void* depth,
                                     const void* temp, const void* salt,
                                     void* const* outs, long long n,
                                     long long ncol, int with_sat,
                                     void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool w = with_sat != 0;
  if (is_double) {
    return obgc::launch<double>(depth, temp, salt, outs, n, ncol, w, s);
  }
  return obgc::launch<float>(depth, temp, salt, outs, n, ncol, w, s);
}

extern "C" int obgc_coeffs_num_outputs() { return obgc::O_COUNT; }

extern "C" const char* obgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
