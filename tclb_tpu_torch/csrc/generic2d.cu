// Generic 2D kernels for Hopper (sm_90a): a model's whole Iteration action
// per launch, the model's physics compiled in from its device header.
//
// The JAX package's generic engine traces a model's Python stage functions
// inside a Pallas band kernel.  CUDA cannot trace Python, so this file does
// what TCLB does with a model's Dynamics.c: a model-independent template
// (streaming, the stage plan, node types, zonal settings, globals) around
// one __device__ function per stage from csrc/models/<model>.cuh.  The
// build compiles this template once per model, with the model's header
// pre-included (nvcc -include csrc/models/<model>.cuh), into a library of
// its own.
//
//   generic2d_step      one Iteration per launch (replaces
//                       tclb_tpu/ops/pallas_generic.py:make_pallas_iterate,
//                       `call` and its in-kernel-globals flavour `call_g`;
//                       generic2d_step_series replaces the <Control> time
//                       series flavours `call_s` and `call_sg`: the same
//                       kernel reading a zonal setting from the series where
//                       one overrides the node's zone, SeriesArgs in
//                       generic_common.cuh).
//                       A two-stage action (d2q9_kuper): a 32x16 block runs
//                       stage 0 on its 30x14 output tile plus the one-node
//                       ring stage 1 pulls from, keeping stage 0's output
//                       planes in shared memory, then stage 1 on the tile.
//                       A one-stage action (d2q9_heat_adj) has no ring: the
//                       stage writes straight to the 32x16 output tile.
//                       Pulls and Field loads wrap periodically by index
//                       arithmetic.  Bound by bytes: a d2q9_kuper node reads
//                       its 10 planes and flag and writes 10 planes (84 B)
//                       for ~500 flops, a d2q9_heat_adj node 19 planes and
//                       a flag and writes 19 (156 B) for ~300 flops; stage 0
//                       reads stay in L1/L2 where neighbouring blocks
//                       overlap.  The globals flavour (kGlobals) also sums
//                       each SUM global over the output tiles: per-thread
//                       double sums, a fixed-order block reduction into one
//                       partial per block, and the last block to finish
//                       adds the partials in block order -- no float
//                       atomics, so a run is deterministic.
//   generic2d_resident  an even number of Iterations in one cooperative
//                       launch (replaces make_resident_iterate): every
//                       thread walks the lattice with a grid stride, a
//                       grid-wide barrier after each stage, and two global
//                       buffers ping-pong.  For lattices that fit half the
//                       50 MB L2 (drop.xml's 128x128 is 1.4 MB) the planes
//                       stay in L2: device memory sees one read and one
//                       write per launch, and the barriers set its time.
//                       Planes written during the launch are read through
//                       L2 only (__ldcg), never through the read-only path.
//   generic2d_step_b    the reverse of one generic2d_step for models with a
//                       hand-written reverse stage (csrc/generic2d_adjoint.cuh,
//                       built where the header defines TCLB_MODEL_ADJOINT).
//
// The storage ladder: generic2d_step (both flavours) and generic2d_resident
// also take a bf16 stack at rest (generic2d_step_bf16,
// generic2d_resident_bf16; the same templates with S = __nv_bfloat16).  A
// plane is widened where it is read from device memory and narrowed where it
// is written there, with its DDF shift, through csrc/storage.cuh only; the
// stages compute in f32 and the shared tile stays f32, so a step narrows
// once, after its last stage, as the narrowed eager engine does.  The
// resident kernel keeps stage 0's output of a two-stage step in an f32
// scratch stack for stage 1 to read, for the same reason.  A bf16 node moves
// half the bytes of an f32 one (d2q9: 48 B against 92 B).  f32 storage runs
// the same code as before the ladder (S = float: plain loads and stores).
//
// Like the JAX engine, the stage plan runs on shrinking rings: stage s
// computes its output on the tile plus model::stage_ext(s) nodes; the
// template runs one-stage actions and two-stage actions whose second stage
// reads a one-node ring of the first.  Nothing of the TPU's ghost rows or
// (8,128) alignment is carried over: any ny, nx, ragged edges masked.
//
// Plain C interface (loaded with ctypes); every entry returns the CUDA error
// code of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "generic_common.cuh"
#include "storage.cuh"

namespace cg = cooperative_groups;

using Shift = PlaneShift<model::N_STORAGE>;

static_assert((model::N_STAGES == 2 && model::stage_ext(1) == 0)
                  || (model::N_STAGES == 1 && model::stage_ext(0) == 0),
              "the template runs a stage with a ring, then one on the tile, "
              "or one stage on the tile");

constexpr bool TWO_STAGES = model::N_STAGES == 2;
constexpr int RING = TWO_STAGES ? model::stage_ext(0) : 0;
constexpr int BX = 32, BY = 16;                    // threads of a step block
constexpr int TX = BX - 2 * RING, TY = BY - 2 * RING;   // its output tile
constexpr int RESIDENT_THREADS = 256;
constexpr unsigned ALL_WRITES =
    model::stage_writes(0) | (TWO_STAGES ? model::stage_writes(1) : 0u);
constexpr int NG = model::N_GLOBALS > 0 ? model::N_GLOBALS : 1;

// ---------------------------------------------------------------------------
// What a stage reads: plane k at an unwrapped (y, x)
// ---------------------------------------------------------------------------

// every plane from one buffer in device memory, stored as S (f32, or bf16
// widened with the planes' shifts `w`); kCoherent reads through L2 only
// (the resident kernel's buffers change during the launch)
template <bool kCoherent, class S = float>
struct DeviceStorage {
  const S* p;
  int ny, nx;
  const float* w = nullptr;     // the planes' shifts (a bf16 stack)
  __device__ float get(int k, int y, int x) const {
    const S* q = p + ((size_t)k * ny + wrap(y, ny)) * nx + wrap(x, nx);
    return load_plane<kCoherent>(q, w, k);
  }
};

// generic2d_step's stage 1: stage 0's planes from the block's shared tile
// (origin at unwrapped (y0, x0)), the others from the launch's input
template <class S>
struct TileStorage {
  const float* tile;       // [N_STORAGE][BY][BX]
  int y0, x0;
  DeviceStorage<false, S> rest;
  __device__ float get(int k, int y, int x) const {
    if (writes(0, k)) return tile[(k * BY + (y - y0)) * BX + (x - x0)];
    return rest.get(k, y, x);
  }
};

// generic2d_resident's stage 1: stage 0's planes from this step's stage-0
// output (f32), the others from its input
template <class S>
struct StepStorage {
  DeviceStorage<true> fresh;
  DeviceStorage<true, S> rest;
  __device__ float get(int k, int y, int x) const {
    return writes(0, k) ? fresh.get(k, y, x) : rest.get(k, y, x);
  }
};

// ---------------------------------------------------------------------------
// Where a stage writes
// ---------------------------------------------------------------------------

struct TileOut {          // a plane of the shared tile
  float* tile;
  int ly, lx;
  __device__ void operator()(int k, float v) const {
    tile[(k * BY + ly) * BX + lx] = v;
  }
};

template <class S = float>
struct DeviceOut {        // a plane in device memory at node `idx`
  S* p;
  size_t idx, n;
  const float* w = nullptr;     // the planes' shifts (a bf16 stack)
  __device__ void operator()(int k, float v) const {
    store_plane(p + k * n + idx, v, w, k);
  }
};

// ---------------------------------------------------------------------------
// The node context a model's stage function sees
// ---------------------------------------------------------------------------

template <class Storage, class Out, bool kGlobals, bool kSeries>
struct Node {
  const GenericArgs& a;
  const Storage& s;
  const Out& out;
  const float* ztab;       // [N_ZONAL][zone_max]
  const SeriesArgs& ser;   // read by the series flavours only
  double* acc;             // [NG] this thread's global sums
  int y, x, flag;
  bool counts;             // the node's globals count (an output node)

  __device__ float pulled(int k) const {
    return s.get(k, y - model::ey(k), x - model::ex(k));
  }
  __device__ float load(int k, int dx, int dy) const {
    return s.get(k, y + dy, x + dx);
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
    if (kGlobals && counts) acc[g] += (double)v;
  }
  __device__ void store(int k, float v) const { out(k, v); }
};

template <int S, bool kGlobals, bool kSeries = false, class Storage,
          class Out>
__device__ __forceinline__ void run_stage(const GenericArgs& a,
                                          const Storage& s, const Out& out,
                                          const float* ztab,
                                          const SeriesArgs& ser, double* acc,
                                          int y, int x, int flag,
                                          bool counts) {
  Node<Storage, Out, kGlobals, kSeries> c{a, s, out, ztab, ser, acc, y, x,
                                          flag, counts};
  model::stage<S>(c);
}

// ---------------------------------------------------------------------------
// generic2d_step
// ---------------------------------------------------------------------------

__device__ unsigned int g_blocks_done = 0;   // globals flavours, per launch

template <class S, bool kGlobals, bool kSeries>
__global__ void __launch_bounds__(BX * BY)
generic2d_step_kernel(const S* __restrict__ fin, S* __restrict__ fout,
                      const int* __restrict__ flags,
                      const float* __restrict__ ztab, const GenericArgs a,
                      const SeriesArgs ser, double* partials, float* gout,
                      const __grid_constant__ Shift sh) {
  const size_t n = (size_t)a.ny * a.nx;
  const int ly = threadIdx.y, lx = threadIdx.x;
  // this thread's stage-0 node, unwrapped: the block's ring starts RING
  // nodes before its output tile
  const int y0 = blockIdx.y * TY - RING, x0 = blockIdx.x * TX - RING;
  const int y = y0 + ly, x = x0 + lx;
  const bool out_node = ly >= RING && ly < BY - RING && lx >= RING
                        && lx < BX - RING && y < a.ny && x < a.nx;
  const int flag = __ldg(flags + (size_t)wrap(y, a.ny) * a.nx
                         + wrap(x, a.nx));
  double acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0;

  const DeviceStorage<false, S> in{fin, a.ny, a.nx, sh.w};
  if constexpr (TWO_STAGES) {
    __shared__ float tile[model::N_STORAGE * BY * BX];
    run_stage<0, kGlobals, kSeries>(a, in, TileOut{tile, ly, lx}, ztab,
                                    ser, acc, y, x, flag, out_node);
    __syncthreads();
    if (out_node) {
      const size_t idx = (size_t)y * a.nx + x;
      run_stage<1, kGlobals, kSeries>(a, TileStorage<S>{tile, y0, x0, in},
                                      DeviceOut<S>{fout, idx, n, sh.w},
                                      ztab, ser, acc, y, x, flag, true);
#pragma unroll
      for (int k = 0; k < model::N_STORAGE; ++k) {
        if (writes(0, k) && !writes(1, k))
          store_plane(fout + k * n + idx, tile[(k * BY + ly) * BX + lx],
                      sh.w, k);
        else if (!((ALL_WRITES >> k) & 1u))   // no stage writes it
          store_plane(fout + k * n + idx,
                      load_plane<false>(fin + k * n + idx, sh.w, k), sh.w,
                      k);
      }
    }
  } else if (out_node) {
    // one stage, no ring: the stage writes the output tile itself
    const size_t idx = (size_t)y * a.nx + x;
    run_stage<0, kGlobals, kSeries>(a, in, DeviceOut<S>{fout, idx, n, sh.w},
                                    ztab, ser, acc, y, x, flag, true);
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k)
      if (!writes(0, k))
        store_plane(fout + k * n + idx,
                    load_plane<false>(fin + k * n + idx, sh.w, k), sh.w, k);
  }
  if constexpr (kGlobals)
    finish_sums<NG, BX * BY>(acc, partials, &g_blocks_done,
                    [gout](int g, double t) { gout[g] = (float)t; });
}

// ---------------------------------------------------------------------------
// generic2d_resident
// ---------------------------------------------------------------------------

// S = bf16 with two stages: `mid` (f32, n_storage planes) takes stage 0's
// output, so stage 1 reads it unrounded and the step narrows once.  With
// S = float, stage 0 writes `dst` and `mid` is unused.
template <class S>
__global__ void __launch_bounds__(RESIDENT_THREADS)
generic2d_resident_kernel(const S* __restrict__ fin, S* fout, S* scratch,
                          float* mid, const int* __restrict__ flags,
                          const float* __restrict__ ztab,
                          const GenericArgs a, int nsteps,
                          const __grid_constant__ Shift sh) {
  constexpr bool kMid = TWO_STAGES && sizeof(S) != sizeof(float);
  cg::grid_group grid = cg::this_grid();
  const size_t n = (size_t)a.ny * a.nx;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const SeriesArgs none{};
  // planes no stage writes are the same in both buffers
  for (int idx = first; idx < (int)n; idx += stride) {
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k)
      if (!((ALL_WRITES >> k) & 1u)) {
        const float v = load_plane<false>(fin + k * n + idx, sh.w, k);
        store_plane(scratch + k * n + idx, v, sh.w, k);
        store_plane(fout + k * n + idx, v, sh.w, k);
      }
  }
  // step 0 reads fin and writes scratch, odd steps write fout, even steps
  // scratch: an even nsteps ends in fout
  const S* src = fin;
  S* dst = scratch;
  for (int s = 0; s < nsteps; ++s) {
    const DeviceStorage<true, S> in{src, a.ny, a.nx, sh.w};
    for (int idx = first; idx < (int)n; idx += stride) {
      const int y = idx / a.nx, x = idx - y * a.nx;
      if constexpr (kMid)
        run_stage<0, false>(a, in, DeviceOut<float>{mid, (size_t)idx, n},
                            ztab, none, nullptr, y, x, __ldg(flags + idx),
                            false);
      else
        run_stage<0, false>(a, in, DeviceOut<S>{dst, (size_t)idx, n, sh.w},
                            ztab, none, nullptr, y, x, __ldg(flags + idx),
                            false);
    }
    grid.sync();
    if constexpr (TWO_STAGES) {
      const float* fresh;
      if constexpr (kMid) fresh = mid;
      else fresh = dst;
      const StepStorage<S> st{DeviceStorage<true>{fresh, a.ny, a.nx}, in};
      for (int idx = first; idx < (int)n; idx += stride) {
        const int y = idx / a.nx, x = idx - y * a.nx;
        run_stage<1, false>(a, st, DeviceOut<S>{dst, (size_t)idx, n, sh.w},
                            ztab, none, nullptr, y, x, __ldg(flags + idx),
                            false);
        if constexpr (kMid) {
#pragma unroll
          for (int k = 0; k < model::N_STORAGE; ++k)
            if (writes(0, k) && !writes(1, k))
              store_plane(dst + k * n + idx, __ldcg(mid + k * n + idx),
                          sh.w, k);
        }
      }
      grid.sync();
    }
    src = dst;
    dst = (dst == scratch) ? fout : scratch;
  }
}

template <class S>
static int launch_resident(const S* fin, S* fout, S* scratch, float* mid,
                           const int* flags, const float* ztab,
                           const GenericArgs* a, const Shift& shift,
                           int nsteps, int blocks, int device,
                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GenericArgs args = *a;
  Shift sh = shift;
  void* params[] = {(void*)&fin, (void*)&fout, (void*)&scratch,
                    (void*)&mid, (void*)&flags, (void*)&ztab,
                    (void*)&args, (void*)&nsteps, (void*)&sh};
  e = cudaLaunchCooperativeKernel((const void*)generic2d_resident_kernel<S>,
                                  dim3(blocks), dim3(RESIDENT_THREADS),
                                  params, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// The output tile of a generic2d_step block (its partials are one per block)
// and the layout sizes this library was built with, for the wrapper's checks.
void generic2d_layout(int* tile_y, int* tile_x, int* n_storage,
                      int* n_settings, int* n_types, int* n_groups,
                      int* n_zonal, int* n_globals) {
  *tile_y = TY;
  *tile_x = TX;
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
int generic2d_step(const float* fin, float* fout, const int* flags,
                   const float* ztab, const GenericArgs* a,
                   double* partials, float* gout, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + TX - 1) / TX, (a->ny + TY - 1) / TY);
  const dim3 block(BX, BY);
  const SeriesArgs none{};
  const Shift unused{};
  if (partials)
    generic2d_step_kernel<float, true, false>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, none, partials, gout,
                                                   unused);
  else
    generic2d_step_kernel<float, false, false>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, none, nullptr,
                                                   nullptr, unused);
  return (int)cudaGetLastError();
}

// generic2d_step on a bf16 stack at rest (`fin`, `fout`: n_storage bf16
// planes), with the planes' shifts `shift` (null: raw); the flavours as
// generic2d_step's.
int generic2d_step_bf16(const __nv_bfloat16* fin, __nv_bfloat16* fout,
                        const int* flags, const float* ztab,
                        const GenericArgs* a, const float* shift,
                        double* partials, float* gout, int device,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + TX - 1) / TX, (a->ny + TY - 1) / TY);
  const dim3 block(BX, BY);
  const SeriesArgs none{};
  const Shift sh = shift_arg<model::N_STORAGE>(shift);
  if (partials)
    generic2d_step_kernel<__nv_bfloat16, true, false>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, none, partials, gout,
                                                   sh);
  else
    generic2d_step_kernel<__nv_bfloat16, false, false>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, none, nullptr,
                                                   nullptr, sh);
  return (int)cudaGetLastError();
}

// The <Control> time series flavours (generic2d_step_series): as
// generic2d_step, with zonal setting j in zone z read from ts[row[j][z]][t]
// where row[j][z] >= 0 (SeriesArgs); `partials` null for the plain series
// flavour, else the series + globals flavour.
int generic2d_step_series(const float* fin, float* fout, const int* flags,
                          const float* ztab, const GenericArgs* a,
                          const int* row, const float* ts, int len, int t,
                          double* partials, float* gout, int device,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + TX - 1) / TX, (a->ny + TY - 1) / TY);
  const dim3 block(BX, BY);
  const SeriesArgs ser{row, ts, len, t};
  const Shift unused{};
  if (partials)
    generic2d_step_kernel<float, true, true>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, ser, partials, gout,
                                                   unused);
  else
    generic2d_step_kernel<float, false, true>
        <<<grid, block, 0, (cudaStream_t)stream>>>(fin, fout, flags, ztab,
                                                   *a, ser, nullptr,
                                                   nullptr, unused);
  return (int)cudaGetLastError();
}

// Whether the device can launch cooperative kernels, and how many blocks of
// generic2d_resident (`bf16` != 0: generic2d_resident_bf16) can be resident
// at once (the largest cooperative grid).
int generic2d_resident_capacity(int device, int bf16, int* cooperative,
                                int* max_blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch,
                             device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if (bf16)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, generic2d_resident_kernel<__nv_bfloat16>, RESIDENT_THREADS,
        0);
  else
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, generic2d_resident_kernel<float>, RESIDENT_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  *max_blocks = per_sm * sms;
  return 0;
}

int generic2d_resident(const float* fin, float* fout, float* scratch,
                       const int* flags, const float* ztab,
                       const GenericArgs* a, int nsteps, int blocks,
                       int device, void* stream) {
  return launch_resident<float>(fin, fout, scratch, nullptr, flags, ztab, a,
                                Shift{}, nsteps, blocks, device, stream);
}

// generic2d_resident on a bf16 stack at rest, with the planes' shifts
// `shift` (null: raw); `mid` is an f32 scratch of n_storage planes (read by
// a two-stage model only, may be null for a one-stage one).
int generic2d_resident_bf16(const __nv_bfloat16* fin, __nv_bfloat16* fout,
                            __nv_bfloat16* scratch, float* mid,
                            const int* flags, const float* ztab,
                            const GenericArgs* a, const float* shift,
                            int nsteps, int blocks, int device,
                            void* stream) {
  return launch_resident<__nv_bfloat16>(
      fin, fout, scratch, mid, flags, ztab, a,
      shift_arg<model::N_STORAGE>(shift), nsteps, blocks, device, stream);
}

}  // extern "C"

#ifdef TCLB_MODEL_ADJOINT
#include "generic2d_adjoint.cuh"
#endif
