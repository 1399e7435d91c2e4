// P: the probe of K2's patterns, CUDA C++ for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel scripts/probe_mosaic.py::kernel (:35),
// a capability probe of the six patterns the whole-interior kernel needs,
// on synthetic algebra: masked algebra with selects, an exclusive cumsum
// over levels, a masked Newton sqrt (at most 20 iterations, each lane
// freezing on its own convergence), a level recurrence over a two-field
// carry, int32 kmax masks and stores into a (nlev, ntr, ncol) block.
//
// Bound.  It reads nlev * (ntr + 1) floats and ncol ints and writes
// nlev * (ntr + 1) floats; at the probe's 12 x 5 x 128 that is ~74 KB,
// so one launch is bound by its latency: the longest chain of dependent
// operations, not the card's bytes or operations.
//
// Design.  Only the exclusive cumsum and the two-field recurrence carry
// anything from one level to the next; the rest is per cell.  A block
// takes a tile of ``tile`` columns over all levels, its cells staged in
// shared memory, in five phases separated by __syncthreads:
//   1. one thread per cell (threads stride over the tile's cells, so any
//      nlev fits one block): the select, the temperature factor (powf),
//      kpar, the Newton sqrt with the lane's own stop and the decay
//      factor (expf), which needs only the cell's own tracer slot 3;
//   2. one thread per column: the exclusive cumsum over the levels, adds
//      only;
//   3. one thread per cell: par_in = expf(-cum), the source and
//      par_in + x;
//   4. one thread per column: the recurrence over the levels, multiplies
//      and adds only;
//   5. one thread per cell: the stores of out and the ntr tendency slots,
//      consecutive threads on consecutive columns.
// So the longest chain is one cell's Newton loop plus two scans of nlev
// adds and multiplies, where one thread per column walked nlev cells'
// Newton loops in a row.  Every expression, and the order of the scans'
// additions, is the one-thread-per-column kernel's, so each output keeps
// its rounding; expressions keep the plain version's order with
// PyTorch's CUDA semantics (a tensor divided by a Python scalar is
// multiplied by its reciprocal).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// the planes of a tile's cells in shared memory, each tile * nlev floats
constexpr int kPlanes = 4;
// the most shared memory a block takes without an opt-in
constexpr int kMaxSharedBytes = 48 * 1024;

__global__ void probe_kernel(const float* tr, const float* temp,
                             const int32_t* kmax, float* out, float* tend,
                             int nlev, int ntr, int ncol, int tile) {
  extern __shared__ float smem[];
  const int64_t n = ncol;
  const int col0 = blockIdx.x * tile;
  // the tile's columns; its cells are c = k * width + j, level k, column
  // col0 + j
  const int width = ncol - col0 < tile ? ncol - col0 : tile;
  const int cells = nlev * width;
  const int plane = nlev * tile;
  float* s_src = smem;               // tf, then par_in * tf, then remin_k
  float* s_x = smem + plane;         // x, then par_in + x
  float* s_dec = smem + 2 * plane;   // the decay factor
  float* s_cum = smem + 3 * plane;   // kpar, then the exclusive cumsum

  // 1. per cell: (1) masked algebra with a select, (4) masked Newton
  // sqrt, frozen per lane, (6) dynamic level with a static tracer slot
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int k = c / width;
    const int col = col0 + c % width;
    const float t = temp[k * n + col];
    const bool active = k < kmax[col];
    s_src[c] = active ? powf(2.0f, (t - 10.0f) * (1.0f / 10.0f)) : 1.0f;
    s_cum[c] = active ? t * 0.01f : 0.0f;
    float x = 1.0f;
    for (int it = 0; it < 20; ++it) {
      const float xn = 0.5f * (x + t / (x < 1e-6f ? 1e-6f : x));
      const bool conv = fabsf(xn - x) < 1e-4f;
      x = xn;
      if (conv) break;
    }
    s_x[c] = x;
    const float o2 = tr[(k * ntr + 3) * n + col];
    const float o2row = o2 < 0.0f ? 0.0f : o2;
    s_dec[c] = expf((1.0f + o2row * 0.01f) * -0.1f);
  }
  __syncthreads();

  // 2. per column: (2) exclusive cumsum over levels
  if (threadIdx.x < width) {
    float cum = 0.0f;
    for (int c = threadIdx.x; c < cells; c += width) {
      const float kpar = s_cum[c];
      s_cum[c] = cum;
      cum = cum + kpar;
    }
  }
  __syncthreads();

  // 3. per cell: the light entering the cell and the source it feeds
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const float par_in = expf(-s_cum[c]);
    s_src[c] = par_in * s_src[c];
    s_x[c] = par_in + s_x[c];
  }
  __syncthreads();

  // 4. per column: (3) level recurrence over a (1, C) carry, (5) kmax
  // masks
  if (threadIdx.x < width) {
    const int km = kmax[col0 + threadIdx.x];
    float flux_s = 0.0f, flux_h = 0.0f;
    for (int k = 0, c = threadIdx.x; k < nlev; ++k, c += width) {
      const bool active = k < km;
      const bool is_bot = k + 1 == km;
      float f_s = flux_s * s_dec[c] + s_src[c];
      float f_h = flux_h * 0.99f;
      const float remin = (flux_s - f_s) + (flux_h - f_h);
      f_s = is_bot ? 0.0f : f_s;
      f_h = is_bot ? 0.0f : f_h;
      flux_s = active ? f_s : flux_s;
      flux_h = active ? f_h : flux_h;
      s_src[c] = active ? remin : 0.0f;
    }
  }
  __syncthreads();

  // 5. per cell: the stores into (nlev, C) and (nlev, ntr, C)
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int k = c / width;
    const int col = col0 + c % width;
    const float remin_k = s_src[c];
    out[k * n + col] = s_x[c] + remin_k;
    for (int j = 0; j < ntr; ++j) {
      tend[(k * ntr + j) * n + col] = remin_k * static_cast<float>(j + 1);
    }
  }
}

}  // namespace

// Plain C interface for ctypes: tr (nlev, ntr, ncol), temp and out
// (nlev, ncol), tend (nlev, ntr, ncol), all float32; kmax (ncol,) int32
// (ntr >= 4: the probe reads tracer slot 3).  One block of ``threads``
// (a multiple of 32, at most 1024, at least ``tile``) for each ``tile``
// columns; the tile's cells take kPlanes * tile * nlev floats of shared
// memory, at most 48 KB.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a shape or launch it does not take.
extern "C" int obgc_probe_patterns(const void* tr, const void* temp,
                                   const void* kmax, void* out, void* tend,
                                   int nlev, int ntr, int ncol, int tile,
                                   int threads, void* stream) {
  if (ncol <= 0 || nlev <= 0) return 0;
  const long long smem = 4LL * kPlanes * tile * nlev;
  if (ntr < 4 || tile <= 0 || threads < tile || threads > 1024
      || threads % 32 != 0 || smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (ncol + tile - 1) / tile;
  auto s = static_cast<cudaStream_t>(stream);
  probe_kernel<<<blocks, threads, static_cast<size_t>(smem), s>>>(
      static_cast<const float*>(tr), static_cast<const float*>(temp),
      static_cast<const int32_t*>(kmax), static_cast<float*>(out),
      static_cast<float*>(tend), nlev, ntr, ncol, tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* obgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
