// The neighbour waits of the resident kernel (csrc/generic2d.cu's
// generic2d_resident).
//
// The resident kernel runs many steps in one cooperative launch.  Its
// lattice is cut into ty x tx tiles (row-major, ntx a row); block b of nb
// owns the tiles b, b + nb, ... for the whole launch, and publishes the
// steps it has finished in its counter.  Before the next steps a block
// waits only for the blocks that own a node within their reach of its
// tiles (the blocks whose output it reads, and, the relation being
// symmetric, the blocks that read the buffer it is about to overwrite),
// not for the whole grid.  The cooperative launch keeps every block
// resident, so the waits end.  A block's counter is reset at the start of
// the launch, before a grid barrier that orders the reset before every
// wait.
//
// The protocol: the block's threads finish the step's stores, a block
// barrier, and one thread stores the step number with release semantics;
// a waiting thread spins with relaxed loads until it reads the step, then
// one acquire fence orders the block's reads of that neighbour's data
// (read through L2 only, __ldcg) after it.

#pragma once

#include <cuda_runtime.h>

constexpr int RESIDENT_MAX_BLOCKS = 2048;   // blocks a launch, at most

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int wrap_index(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Mark in `waits` (a bit a block, shared memory) the owners of every node
// within `reach` of the tile at (ty0, tx0), the lattice's rows and columns
// wrapped; the block's NT threads share the work.
template <int NT>
__device__ void mark_waits(unsigned int* waits, int ty0, int tx0, int ty,
                           int tx, int ntx, int nb, int ny, int nx,
                           int reach) {
  const int rw = tx + 2 * reach, rh = ty + 2 * reach;
  for (int i = threadIdx.x; i < rw * rh; i += NT) {
    const int y = wrap_index(ty0 - reach + i / rw, ny);
    const int x = wrap_index(tx0 - reach + i % rw, nx);
    const int owner = (y / ty * ntx + x / tx) % nb;
    atomicOr(&waits[owner / 32], 1u << (owner % 32));
  }
}

// Wait until every block marked in `waits` has published step s.
template <int NT>
__device__ void wait_for(const unsigned int* waits, const int* counters,
                         int nb, int s) {
  bool waited = false;
  for (int j = threadIdx.x; j < nb; j += NT)
    if ((waits[j / 32] >> (j % 32)) & 1u) {
      while (load_relaxed(counters + j) < s) {
      }
      waited = true;
    }
  if (waited) fence_acquire();
  __syncthreads();
}

// Publish step s of block b, after its threads' stores.
__device__ __forceinline__ void publish(int* counters, int b, int s) {
  __syncthreads();
  if (threadIdx.x == 0) store_release(counters + b, s);
}

// Clear `waits` and the block's counter (ahead of the launch's one grid
// barrier).
template <int NT>
__device__ void reset_waits(unsigned int* waits, int* counters, int b) {
  for (int i = threadIdx.x; i < RESIDENT_MAX_BLOCKS / 32; i += NT)
    waits[i] = 0u;
  if (threadIdx.x == 0) counters[b] = 0;
  __syncthreads();
}

// The blocks of a cooperative launch of `kernel` with `threads` threads
// and `smem` bytes of dynamic shared memory for `tiles` tiles: as many as
// the device holds at once, no more than a tile each and
// RESIDENT_MAX_BLOCKS; 0 where the device cannot launch cooperatively (a
// negative CUDA error code where a query failed).
inline int resident_blocks(const void* kernel, int threads, size_t smem,
                           int tiles, int device) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = per_sm * sms;
  if (blocks > tiles) blocks = tiles;
  if (blocks > RESIDENT_MAX_BLOCKS) blocks = RESIDENT_MAX_BLOCKS;
  return blocks;
}
