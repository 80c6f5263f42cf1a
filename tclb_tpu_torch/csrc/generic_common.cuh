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
