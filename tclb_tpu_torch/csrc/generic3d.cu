// Generic 3D kernels for Hopper (sm_90a): a 3D model's whole Iteration
// action per launch, the model's physics compiled in from its device header
// (csrc/models/<model>.cuh, pre-included with nvcc -include), as
// csrc/generic2d.cu does for 2D models.
//
//   generic3d_step      one Iteration per launch over (n_storage, nz, ny, nx)
//                       (replaces tclb_tpu/ops/pallas_generic.py:
//                       make_pallas_iterate_3d, `call` and its
//                       in-kernel-globals flavour `call_g`, at fuse = 1;
//                       generic3d_step_series replaces the <Control> time
//                       series flavours `call_s` and `call_sg`, reading a
//                       zonal setting from the series where one overrides
//                       the node's zone, SeriesArgs in generic_common.cuh).
//                       One thread per node: a 32x8 (x, y) block per
//                       z-plane, the stage's pulls and the node's flag read
//                       from device memory through the read-only path with
//                       a periodic wrap on all three axes by index
//                       arithmetic; neighbouring blocks' reads overlap in
//                       L1/L2.  Bound by bytes: a d3q19_adj node reads its
//                       20 planes and int32 flag and writes 20 planes
//                       (164 B) for a few hundred flops.  The globals flavour
//                       (kGlobals) also sums each SUM global: per-thread
//                       double sums, a fixed-order block reduction into one
//                       partial per block, and the last block adds the
//                       partials in block order (finish_sums in
//                       generic_common.cuh) -- no float atomics, so a run is
//                       deterministic.
//   generic3d_step_b    the reverse of one generic3d_step for models with a
//                       hand-written reverse stage (csrc/generic3d_adjoint.
//                       cuh, built where the header defines
//                       TCLB_MODEL_ADJOINT).
//
// The template takes one-stage actions whose stage loads the streamed
// densities and reads no Field stencil (d3q19_adj; the reference's
// d3q19_heat is the same shape).  Nothing of the TPU's z-slab bands or
// (8,128) alignment is carried over: any nz, ny, nx, ragged edges masked.
// Marching up z with the planes in shared memory, as csrc/d3q27.cu does,
// is later work.
//
// Plain C interface (loaded with ctypes); every entry returns the CUDA error
// code of its launch.

#include <cuda_runtime.h>

#include "generic_common.cuh"

static_assert(model::N_STAGES == 1 && model::stage_ext(0) == 0,
              "generic3d runs one-stage actions on the node itself");

constexpr int BX = 32, BY = 8;               // threads of a block, one z
constexpr int NG = model::N_GLOBALS > 0 ? model::N_GLOBALS : 1;

// plane k at an unwrapped (z, y, x) of one buffer in device memory
struct Storage3 {
  const float* p;
  int nz, ny, nx;
  __device__ float get(int k, int z, int y, int x) const {
    return __ldg(p + (((size_t)k * nz + wrap(z, nz)) * ny + wrap(y, ny)) * nx
                 + wrap(x, nx));
  }
};

// The node context a model's stage function sees (the 3D form of
// generic2d.cu's Node; the header lists it)
template <bool kGlobals, bool kSeries>
struct Node3 {
  const GenericArgs& a;
  const Storage3& s;
  float* out;              // the output stack
  const float* ztab;       // [N_ZONAL][zone_max]
  const SeriesArgs& ser;   // read by the series flavours only
  double* acc;             // [NG] this thread's global sums
  size_t idx, n;           // the node and the plane size
  int z, y, x, flag;

  __device__ float pulled(int k) const {
    return s.get(k, z - model::ez(k), y - model::ey(k), x - model::ex(k));
  }
  __device__ float setting(int i) const { return a.setting[i]; }
  __device__ float zonal(int j) const {
    return zonal_value<kSeries>(a, ztab, ser, j, flag);
  }
  __device__ bool nt_is(int t) const {
    return (flag & a.nt_mask[t]) == a.nt_val[t];
  }
  __device__ bool nt_in_group(int g) const {
    return (flag & a.group_mask[g]) != 0;
  }
  __device__ void add_global(int g, float v) const {
    if (kGlobals) acc[g] += (double)v;
  }
  __device__ void store(int k, float v) const { out[k * n + idx] = v; }
};

__device__ unsigned int g_blocks_done3 = 0;   // globals flavours, per launch

template <bool kGlobals, bool kSeries>
__global__ void __launch_bounds__(BX * BY)
generic3d_step_kernel(const float* __restrict__ fin, float* __restrict__ fout,
                      const int* __restrict__ flags,
                      const float* __restrict__ ztab, const GenericArgs a,
                      const SeriesArgs ser, double* partials, float* gout) {
  const size_t n = (size_t)a.nz * a.ny * a.nx;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int z = blockIdx.z;
  double acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0;
  if (x < a.nx && y < a.ny) {
    const size_t idx = ((size_t)z * a.ny + y) * a.nx + x;
    const Storage3 in{fin, a.nz, a.ny, a.nx};
    Node3<kGlobals, kSeries> c{a, in, fout, ztab, ser, acc, idx, n, z, y, x,
                               __ldg(flags + idx)};
    model::stage<0>(c);
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k)
      if (!writes(0, k)) fout[k * n + idx] = fin[k * n + idx];
  }
  if constexpr (kGlobals)
    finish_sums<NG, BX * BY>(acc, partials, &g_blocks_done3,
                             [gout](int g, double t) { gout[g] = (float)t; });
}

extern "C" {

// The (x, y) extent of a generic3d_step block (one z each; its partials
// are one per block) and the layout sizes this library was built with,
// for the wrapper's checks.
void generic3d_layout(int* block_y, int* block_x, int* n_storage,
                      int* n_settings, int* n_types, int* n_groups,
                      int* n_zonal, int* n_globals) {
  *block_y = BY;
  *block_x = BX;
  *n_storage = model::N_STORAGE;
  *n_settings = model::N_SETTINGS;
  *n_types = model::N_TYPES;
  *n_groups = model::N_GROUPS;
  *n_zonal = model::N_ZONAL;
  *n_globals = model::N_GLOBALS;
}

// `partials` null: the plain flavour; else the globals flavour, with
// `partials` holding one double per block and global and `gout` the
// globals (n_globals floats).
int generic3d_step(const float* fin, float* fout, const int* flags,
                   const float* ztab, const GenericArgs* a,
                   double* partials, float* gout, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + BX - 1) / BX, (a->ny + BY - 1) / BY, a->nz);
  const dim3 block(BX, BY);
  const SeriesArgs none{};
  if (partials)
    generic3d_step_kernel<true, false>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, none, partials, gout);
  else
    generic3d_step_kernel<false, false>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, none, nullptr,
                                                   nullptr);
  return (int)cudaGetLastError();
}

// The <Control> time series flavours (generic3d_step_series): as
// generic3d_step, with zonal setting j in zone z read from ts[row[j][z]][t]
// where row[j][z] >= 0 (SeriesArgs); `partials` null for the plain series
// flavour, else the series + globals flavour.
int generic3d_step_series(const float* fin, float* fout, const int* flags,
                          const float* ztab, const GenericArgs* a,
                          const int* row, const float* ts, int len, int t,
                          double* partials, float* gout, int device,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + BX - 1) / BX, (a->ny + BY - 1) / BY, a->nz);
  const dim3 block(BX, BY);
  const SeriesArgs ser{row, ts, len, t};
  if (partials)
    generic3d_step_kernel<true, true>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, ser, partials, gout);
  else
    generic3d_step_kernel<false, true>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, ser, nullptr,
                                                   nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"

#ifdef TCLB_MODEL_ADJOINT
#include "generic3d_adjoint.cuh"
#endif
