// Generic 3D kernels for Hopper (sm_90a): a 3D model's whole Iteration
// action per call, the model's physics compiled in from its device header
// (csrc/models/<model>.cuh, pre-included with nvcc -include), as
// csrc/generic2d.cu does for 2D models.
//
//   generic3d_step      one Iteration per call over (n_storage, nz, ny, nx)
//                       (replaces tclb_tpu/ops/pallas_generic.py:
//                       make_pallas_iterate_3d, `call` and its
//                       in-kernel-globals flavour `call_g`, at fuse = 1;
//                       generic3d_step_series replaces the <Control> time
//                       series flavours `call_s` and `call_sg`, reading a
//                       zonal setting from the series where one overrides
//                       the node's zone, SeriesArgs in generic_common.cuh).
//                       One launch a stage of the plan (generic3d_pass_
//                       kernel, the passes), each over the whole lattice on
//                       the caller's stream, one thread per node: a 32x8
//                       (x, y) block per z-plane, the stage's pulls, its
//                       Field reads (Node3::load: a plane at an offset) and
//                       the node's flag read from device memory through the
//                       read-only path with a periodic wrap on all three
//                       axes by index arithmetic; neighbouring blocks' reads
//                       overlap in L1/L2.  Stage s reads a plane an earlier
//                       stage of the step wrote from the f32 scratch stack
//                       `mid` (the caller's), any other from the step's
//                       input, and writes `mid`; the last stage writes the
//                       output and copies the planes it leaves.  A one-stage
//                       plan (d3q19_adj, d3q19_heat, d3q27,
//                       d3q27_viscoplastic, d3q27_cumulant_qibb_small) is
//                       one pass that writes the output itself; a longer
//                       one (d3q19_kuper: Run, then CalcPhi) computes no
//                       node twice, whatever the reach, and moves one more
//                       write and read of the earlier stages' planes.
//                       Bound by bytes: a d3q19_adj node reads its 20
//                       planes and int32 flag and writes 20 planes (164 B)
//                       for a few hundred flops, a d3q27_cumulant_qibb_small
//                       node 53 planes each way (428 B).  The globals
//                       flavour (kGlobals) also sums each SUM global:
//                       per-thread double sums, a fixed-order block
//                       reduction into one partial per block, and the last
//                       block adds the partials in block order (finish_sums
//                       in generic_common.cuh) -- no float atomics, so a run
//                       is deterministic.  A multi-pass step sums each pass
//                       so and carries the running totals from pass to pass
//                       in the row after the partials.
//   generic3d_step_b    the reverse of one generic3d_step for models with a
//                       hand-written reverse stage (csrc/generic3d_adjoint.
//                       cuh, built where the header defines
//                       TCLB_MODEL_ADJOINT).
//
// Any plan whose last stage computes no ring runs (the passes need no ring:
// the reach the JAX engine caps at 8 does not bound them).  Nothing of the
// TPU's z-slab bands or (8,128) alignment is carried over: any nz, ny, nx,
// ragged edges masked.  Marching up z with the planes in shared memory, as
// csrc/d3q27.cu does, and several steps a launch are later work.
//
// Plain C interface (loaded with ctypes); every entry returns the CUDA error
// code of its launch.

#include <cuda_runtime.h>

#include "generic_common.cuh"

constexpr int BX = 32, BY = 8;               // threads of a block, one z
constexpr int LAST = model::N_STAGES - 1;    // the stage that writes the
                                             // step's output
constexpr int NG = model::N_GLOBALS > 0 ? model::N_GLOBALS : 1;

// the planes stages [0, s) write, one bit each (64 bits: a header returns
// an unsigned or, for more than 32 planes, an unsigned long long)
__host__ __device__ constexpr unsigned long long writes_before(int s) {
  unsigned long long w = 0;
  for (int j = 0; j < s; ++j)
    w |= (unsigned long long)model::stage_writes(j);
  return w;
}

// whether stages 1 .. LAST - 1 each write planes no earlier stage wrote
constexpr bool earlier_stages_disjoint() {
  for (int s = 1; s < LAST; ++s)
    if (writes_before(s) & (unsigned long long)model::stage_writes(s))
      return false;
  return true;
}

static_assert(model::N_STAGES >= 1 && model::stage_ext(LAST) == 0,
              "the last stage of the plan writes the output");
static_assert(earlier_stages_disjoint(),
              "the earlier stages' planes share one scratch stack: no two "
              "stages before the last may write the same plane");

// plane k at an unwrapped (z, y, x) of one buffer in device memory
struct Storage3 {
  const float* p;
  int nz, ny, nx;
  __device__ float get(int k, int z, int y, int x) const {
    return __ldg(p + (((size_t)k * nz + wrap(z, nz)) * ny + wrap(y, ny)) * nx
                 + wrap(x, nx));
  }
};

// stage s of the passes: a plane an earlier stage of the step wrote from
// the scratch stack `mid`, any other from the step's input
template <int s>
struct PassStorage3 {
  Storage3 mid, in;
  __device__ float get(int k, int z, int y, int x) const {
    return ((writes_before(s) >> k) & 1ull) ? mid.get(k, z, y, x)
                                            : in.get(k, z, y, x);
  }
};

// The node context a model's stage function sees (the 3D form of
// generic2d.cu's Node; the header lists it)
template <class Storage, bool kGlobals, bool kSeries>
struct Node3 {
  const GenericArgs& a;
  const Storage& s;
  float* out;              // the stage's output stack
  const float* ztab;       // [N_ZONAL][zone_max]
  const SeriesArgs& ser;   // read by the series flavours only
  double* acc;             // [NG] this thread's global sums
  size_t idx, n;           // the node and the plane size
  int z, y, x, flag;

  __device__ float pulled(int k) const {
    return s.get(k, z - model::ez(k), y - model::ey(k), x - model::ex(k));
  }
  // plane k at (z + dz, y + dy, x + dx), periodic
  __device__ float load(int k, int dz, int dy, int dx) const {
    return s.get(k, z + dz, y + dy, x + dx);
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

// Stage kStage of the plan over the whole lattice, one node a thread.  An
// earlier stage writes its planes to `mid`, the last writes the output and
// copies the planes it leaves: an earlier stage's from `mid`, the others
// from the input.  The globals flavour sums each pass's nodes and carries
// the running totals in the row after the partials (`carry`); the last
// pass writes them out.
template <int kStage, bool kGlobals, bool kSeries>
__global__ void __launch_bounds__(BX * BY)
generic3d_pass_kernel(const float* __restrict__ fin, float* __restrict__ fout,
                      float* mid, const int* __restrict__ flags,
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
    const PassStorage3<kStage> st{Storage3{mid, a.nz, a.ny, a.nx},
                                  Storage3{fin, a.nz, a.ny, a.nx}};
    Node3<PassStorage3<kStage>, kGlobals, kSeries> c{
        a, st, kStage < LAST ? mid : fout, ztab, ser, acc, idx, n, z, y, x,
        __ldg(flags + idx)};
    model::stage<kStage>(c);
    if constexpr (kStage == LAST) {
#pragma unroll
      for (int k = 0; k < model::N_STORAGE; ++k) {
        if (writes(LAST, k)) continue;
        fout[k * n + idx] = ((writes_before(LAST) >> k) & 1ull)
                                ? __ldg(mid + k * n + idx)
                                : __ldg(fin + k * n + idx);
      }
    }
  }
  if constexpr (kGlobals) {
    double* carry =
        partials + (size_t)gridDim.x * gridDim.y * gridDim.z * NG;
    finish_sums<NG, BX * BY>(acc, partials, &g_blocks_done3,
                             [carry, gout](int g, double t) {
                               const double c = kStage == 0 ? t
                                                            : carry[g] + t;
                               if (kStage == LAST) gout[g] = (float)c;
                               else carry[g] = c;
                             });
  }
}

// the passes of stages s .. LAST on `stream`, in order; stops at the first
// launch that fails
template <int s, bool kGlobals, bool kSeries>
static cudaError_t launch_passes(dim3 grid, cudaStream_t stream,
                                 const float* fin, float* fout, float* mid,
                                 const int* flags, const float* ztab,
                                 const GenericArgs& a, const SeriesArgs& ser,
                                 double* partials, float* gout) {
  generic3d_pass_kernel<s, kGlobals, kSeries>
      <<<grid, dim3(BX, BY), 0, stream>>>(fin, fout, mid, flags, ztab, a,
                                          ser, partials, gout);
  const cudaError_t e = cudaGetLastError();
  if constexpr (s < LAST) {
    if (e != cudaSuccess) return e;
    return launch_passes<s + 1, kGlobals, kSeries>(
        grid, stream, fin, fout, mid, flags, ztab, a, ser, partials, gout);
  }
  return e;
}

// one Iteration: the plan's passes (more than one needs the caller's
// scratch stack `mid`)
template <bool kGlobals, bool kSeries>
static int launch_step(const float* fin, float* fout, float* mid,
                       const int* flags, const float* ztab,
                       const GenericArgs& a, const SeriesArgs& ser,
                       double* partials, float* gout, int device,
                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (LAST > 0 && !mid) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.nx + BX - 1) / BX, (a.ny + BY - 1) / BY, a.nz);
  return (int)launch_passes<0, kGlobals, kSeries>(
      grid, (cudaStream_t)stream, fin, fout, mid, flags, ztab, a, ser,
      partials, gout);
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

// The plan this library runs: its stage count, which is the launches of
// one generic3d_step (more than one needs `mid`).
void generic3d_plan(int* n_stages) { *n_stages = model::N_STAGES; }

// `partials` null: the plain flavour; else the globals flavour, with
// `partials` holding one double per block and global, and one more row
// (the multi-pass carry), and `gout` the globals (n_globals floats).
// `mid`: an f32 scratch stack of n_storage planes where the plan has more
// than one stage, may be null otherwise.
int generic3d_step(const float* fin, float* fout, float* mid,
                   const int* flags, const float* ztab, const GenericArgs* a,
                   double* partials, float* gout, int device, void* stream) {
  const SeriesArgs none{};
  if (partials)
    return launch_step<true, false>(fin, fout, mid, flags, ztab, *a, none,
                                    partials, gout, device, stream);
  return launch_step<false, false>(fin, fout, mid, flags, ztab, *a, none,
                                   nullptr, nullptr, device, stream);
}

// The <Control> time series flavours (generic3d_step_series): as
// generic3d_step, with zonal setting j in zone z read from ts[row[j][z]][t]
// where row[j][z] >= 0 (SeriesArgs); `partials` null for the plain series
// flavour, else the series + globals flavour.
int generic3d_step_series(const float* fin, float* fout, float* mid,
                          const int* flags, const float* ztab,
                          const GenericArgs* a, const int* row,
                          const float* ts, int len, int t, double* partials,
                          float* gout, int device, void* stream) {
  const SeriesArgs ser{row, ts, len, t};
  if (partials)
    return launch_step<true, true>(fin, fout, mid, flags, ztab, *a, ser,
                                   partials, gout, device, stream);
  return launch_step<false, true>(fin, fout, mid, flags, ztab, *a, ser,
                                  nullptr, nullptr, device, stream);
}

}  // extern "C"

#ifdef TCLB_MODEL_ADJOINT
#include "generic3d_adjoint.cuh"
#endif
