// P: the probe of K2's patterns, CUDA C++ for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel scripts/probe_mosaic.py::kernel (:35),
// a capability probe of the six patterns the whole-interior kernel needs,
// on synthetic algebra: masked algebra with selects, an exclusive cumsum
// over levels, a masked Newton sqrt (at most 20 iterations, each lane
// freezing on its own convergence), a level recurrence over a two-field
// carry, int32 kmax masks and stores into a (nlev, ntr, ncol) block.
//
// Design.  One thread per column with a loop over levels, as K2: the
// exclusive cumsum and the recurrence are running values in registers,
// and each cell's Newton loop ends on that lane's own convergence, which
// gives each lane the iterate sequence of the batched while_loop.
// Expressions keep the plain version's order with PyTorch's CUDA
// semantics (a tensor divided by a Python scalar is multiplied by its
// reciprocal).
//
// Bound.  It reads nlev * (ntr + 1) floats and ncol ints and writes
// nlev * (ntr + 1) floats; at the probe's 12 x 5 x 128 that is ~37 KB,
// so one launch is bound by launch latency, not by the card.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void probe_kernel(const float* tr, const float* temp,
                             const int32_t* kmax, float* out, float* tend,
                             int nlev, int ntr, int ncol) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const int64_t n = ncol;
  const int km = kmax[col];
  float cum = 0.0f;      // exclusive cumsum of kpar over the levels above
  float flux_s = 0.0f, flux_h = 0.0f;
  for (int k = 0; k < nlev; ++k) {
    const int64_t cell = k * n + col;
    const float t = temp[cell];
    const bool active = k < km;
    const bool is_bot = k + 1 == km;

    // (1) masked algebra with a select
    const float tf = active ? powf(2.0f, (t - 10.0f) * (1.0f / 10.0f)) : 1.0f;
    // (2) exclusive cumsum over levels
    const float kpar = active ? t * 0.01f : 0.0f;
    const float par_in = expf(-cum);
    cum = cum + kpar;
    // (4) masked Newton sqrt, frozen per lane
    float x = 1.0f;
    for (int it = 0; it < 20; ++it) {
      const float xn = 0.5f * (x + t / (x < 1e-6f ? 1e-6f : x));
      const bool conv = fabsf(xn - x) < 1e-4f;
      x = xn;
      if (conv) break;
    }
    // (3) level recurrence over a (1, C) carry, (6) dynamic level with a
    // static tracer slot
    const float src = par_in * tf;
    const float o2 = tr[(k * ntr + 3) * n + col];
    const float o2row = o2 < 0.0f ? 0.0f : o2;
    const float dec = expf((1.0f + o2row * 0.01f) * -0.1f);
    float f_s = flux_s * dec + src;
    float f_h = flux_h * 0.99f;
    const float remin = (flux_s - f_s) + (flux_h - f_h);
    f_s = is_bot ? 0.0f : f_s;
    f_h = is_bot ? 0.0f : f_h;
    flux_s = active ? f_s : flux_s;
    flux_h = active ? f_h : flux_h;
    const float remin_k = active ? remin : 0.0f;

    out[cell] = (par_in + x) + remin_k;
    for (int j = 0; j < ntr; ++j) {
      tend[(k * ntr + j) * n + col] = remin_k * static_cast<float>(j + 1);
    }
  }
}

}  // namespace

// Plain C interface for ctypes: tr (nlev, ntr, ncol), temp and out
// (nlev, ncol), tend (nlev, ntr, ncol), all float32; kmax (ncol,) int32.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int obgc_probe_patterns(const void* tr, const void* temp,
                                   const void* kmax, void* out, void* tend,
                                   int nlev, int ntr, int ncol,
                                   void* stream) {
  if (ncol <= 0 || nlev <= 0) return 0;
  const int blocks = (ncol + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  probe_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(tr), static_cast<const float*>(temp),
      static_cast<const int32_t*>(kmax), static_cast<float*>(out),
      static_cast<float*>(tend), nlev, ntr, ncol);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* obgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
