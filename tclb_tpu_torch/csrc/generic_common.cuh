// What the generic 2D and 3D kernels share (csrc/generic2d.cu,
// csrc/generic3d.cu and their reverse kernels): the argument layout, the
// periodic wrap, the stage write sets and the deterministic reduction of
// per-thread double sums.  Included after the model's device header, whose
// sizes (model::N_SETTINGS, N_TYPES, N_GROUPS) it reads.

#pragma once

#include <cuda_runtime.h>

// Everything a kernel reads besides the planes, the flags and the zone
// table; tclb_tpu_torch/ops/generic_kernels.py:c_args_type mirrors it
// field for field.  A 2D lattice has nz = 1.
struct GenericArgs {
  int nz, ny, nx;
  int zone_shift, zone_max;
  float setting[model::N_SETTINGS];          // registry order
  int nt_mask[model::N_TYPES], nt_val[model::N_TYPES];
  int group_mask[model::N_GROUPS];
};

// The <Control> time series flavour's launch arguments: `row[j * zone_max
// + z]` is the row of `ts` (n_series x len) that overrides zonal setting j
// in zone z, -1 where none does, and `t` the entry of this step (the
// iteration before the step, modulo the horizon `len`).  The plain flavours
// read the zone table only.  No stage reads a time derivative (the
// reference's _DT planes): a header that called c.setting_dt would not
// compile, since no node context has it.
struct SeriesArgs {
  const int* row;      // [N_ZONAL][zone_max]
  const float* ts;     // [n_series][len]
  int len, t;
};

// Zonal setting j at a node of zone `flag >> zone_shift`: the time series'
// entry where one overrides this zone (kSeries), else the zone table's.
template <bool kSeries>
__device__ __forceinline__ float zonal_value(const GenericArgs& a,
                                             const float* ztab,
                                             const SeriesArgs& s, int j,
                                             int flag) {
  const int z = flag >> a.zone_shift;
  if constexpr (kSeries) {
    const int r = __ldg(s.row + j * a.zone_max + z);
    if (r >= 0) return __ldg(s.ts + (size_t)r * s.len + s.t);
  }
  return __ldg(ztab + j * a.zone_max + z);
}

// The message of a CUDA error code a launch returned (each library exports
// its own copy; tclb_tpu_torch/ops/generic_kernels.py:check reads it).
extern "C" const char* generic_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// whether stage s writes storage plane k
__device__ __forceinline__ bool writes(int s, int k) {
  return (model::stage_writes(s) >> k) & 1u;
}

// Sum each thread's `acc[N]` over the block in a fixed order (warp
// shuffles, then the warps in order) into partials[block], and let the last
// block to arrive add the partials in block order and hand each total to
// `put(i, total)`.  No float atomics, so a run is deterministic.  NTHREADS
// is the block's size (a multiple of 32); threads and blocks are numbered
// x fastest.  One launch per arrival counter `done` at a time.
template <int N, int NTHREADS, class Put>
__device__ void finish_sums(const double* acc, double* partials,
                            unsigned int* done, Put put) {
  constexpr int WARPS = NTHREADS / 32;
  __shared__ double warp_sum[N][WARPS];
  __shared__ bool last;
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y
                                              + blockDim.y * threadIdx.z);
  const int lane = tid & 31, warp = tid >> 5;
  const int nblocks = gridDim.x * gridDim.y * gridDim.z;
  const int block = blockIdx.x + gridDim.x * (blockIdx.y
                                              + gridDim.y * blockIdx.z);
#pragma unroll
  for (int g = 0; g < N; ++g) {
    double v = acc[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sum[g][warp] = v;
  }
  __syncthreads();
  if (tid == 0) {
    for (int g = 0; g < N; ++g) {
      double v = 0.0;
      for (int w = 0; w < WARPS; ++w) v += warp_sum[g][w];
      partials[(size_t)block * N + g] = v;
    }
    __threadfence();
    last = atomicAdd(done, 1u) == (unsigned)nblocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int g = 0; g < N; ++g) {
    double v = 0.0;
    for (int b = tid; b < nblocks; b += NTHREADS)
      v += __ldcg(partials + (size_t)b * N + g);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    __syncthreads();
    if (lane == 0) warp_sum[g][warp] = v;
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int w = 0; w < WARPS; ++w) t += warp_sum[g][w];
      put(g, t);
    }
  }
  if (tid == 0) *done = 0;
}
