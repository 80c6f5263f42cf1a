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
//                       A two-stage action whose first stage computes a
//                       ring of at most two nodes (d2q9_kuper,
//                       d2q9_pp_LBL, d2q9_pf_curvature: 1,
//                       d2q9_pf_pressureEvolution: 2) runs in one launch
//                       (the ring form, generic2d_step_kernel): a block of
//                       32x16 threads runs stage 0 on a 32x32 tile, two
//                       rows a thread, into shared memory (pf's 19 planes:
//                       77.8 KB), then stage 1 on the tile's inner nodes
//                       (28x28 for pf, 30x30 for kuper), at two blocks an
//                       SM (<= 64 registers): stage 0 runs 1.31 (pf) or
//                       1.14 (kuper) times an output node, not the 1.52
//                       or 1.22 of a 32x16 tile.  Any other plan of two
//                       stages or more (d2q9_pp_MCMP, d2q9_lee,
//                       d2q9_poison_boltzmann: three stages, reach 3 to 6)
//                       runs in one launch too (the staged form,
//                       generic2d_staged_kernel): a block stages, once,
//                       every plane of its output tile plus the plan's
//                       reach into shared memory (widened to f32), then
//                       runs stage s on the tile plus model::stage_ext(s)
//                       nodes from shared memory into shared memory (the
//                       earlier stages' planes: one stack over the tile
//                       plus stage_ext(0)), and the last stage writes the
//                       output and the planes the step leaves.  It
//                       recomputes the earlier stages' rings (lee's stage
//                       0 on 40x24 nodes for a 32x16 tile) to move each
//                       plane through device memory once.  A one-stage
//                       plan over many planes (TILED_MIN_PLANES:
//                       d2q9_npe_guo's 45) takes the tiled form
//                       (generic2d_tiled_kernel): its 32x8 tile's planes
//                       plus the header's reach staged into shared memory
//                       as f32, then the stage one node a thread from
//                       there, so its second pass over the groups re-reads
//                       shared memory, not L1 or L2.  Any other one-stage
//                       plan runs its stage one node a thread, its pulls
//                       from device memory (generic2d_pass_kernel), in
//                       32x16 blocks, or in 32x8 blocks at three an SM for
//                       a header of NARROW_MIN_PLANES planes or more
//                       (d2q9_solid's 29: the narrow pass, so that its 79
//                       registers a thread still leave 24 warps an SM).
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
//                       adds the partials, every global at once, in an
//                       order the grid fixes (reduce_globals in
//                       generic_common.cuh) -- no float atomics, so a run
//                       is deterministic.  The pass form's globals flavours
//                       run a persistent grid where a node moves few bytes
//                       (persistent_globals, step_grid): a block keeps its
//                       sums over several tiles and reduces once.  The
//                       staged form sums each stage's output nodes in the
//                       same per-thread sums (its order of the sums differs
//                       from a launch a stage's: globals agree to rounding).
//                       On a bf16 stack the pass form's node pulls from its
//                       rows and columns wrapped once, by a compare
//                       (NodeStorage): half the bytes no longer hide the
//                       modulo wraps of a pull; a header whose Field reads
//                       reach one node (wave, model::FIELD_REACH) reads
//                       them from the same rows and columns.
//   generic2d_resident  an even number of Iterations in one cooperative
//                       launch (replaces make_resident_iterate): each block
//                       owns its tiles for the whole launch and runs a
//                       step's stages on them as the staged form does (stage
//                       s on the tile plus stage_ext(s), the earlier
//                       stages' planes in shared memory, KRX x KRY threads,
//                       one stage-0 node each), reading the step's input
//                       from device memory through L2 only (__ldcg) and
//                       writing the other of two buffers.  In place of a
//                       grid barrier a stage, a block publishes each step in
//                       a counter (a release store) and, before the next,
//                       waits with acquire loads for the blocks that own
//                       the nodes within HALO of its tiles: one exchange a
//                       step, with its neighbours only.  For lattices that
//                       fit half the 50 MB L2 (drop.xml's 128x128 is 1.4 MB)
//                       the buffers stay in L2; the waits and the dependent
//                       round trips to L2 set its time.
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
// staged tile and the resident kernel keep the earlier stages' planes in
// f32 shared memory for the same reason.  A
// bf16 node moves half the bytes of an f32 one (d2q9: 48 B against 92 B).
// f32 storage runs the same code as before the ladder (S = float: plain
// loads and stores).
//
// Like the JAX engine, the ring form and the staged form run on shrinking
// rings: stage s computes its output on the tile plus model::stage_ext(s)
// nodes.  Nothing of the TPU's ghost rows or (8,128) alignment is carried
// over: any ny, nx, ragged edges masked.
//
// Plain C interface (loaded with ctypes); every entry returns the CUDA error
// code of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "generic_common.cuh"
#include "resident_sync.cuh"
#include "storage.cuh"

namespace cg = cooperative_groups;

using Shift = PlaneShift<model::N_STORAGE>;

constexpr int BX = 32, BY = 16;                    // threads of a step block
constexpr int LAST = model::N_STAGES - 1;          // the stage that writes
                                                   // the step's output
// the planes stages [0, s) write, one bit each (64 bits: d2q9_npe_guo's
// stage writes 45 planes; the other headers return an unsigned)
__host__ __device__ constexpr unsigned long long writes_before(int s) {
  unsigned long long w = 0;
  for (int j = 0; j < s; ++j)
    w |= (unsigned long long)model::stage_writes(j);
  return w;
}
constexpr unsigned long long ALL_WRITES = writes_before(model::N_STAGES);

// The ring form's tile (generic_kernels.ring_tile mirrors it): RTY rows of
// RTX nodes, stage 0 on all of them into shared memory, stage 1 on the
// inner (RTX - 2 RING) x (RTY - 2 RING); a block of RBY rows of RTX
// threads, RTY / RBY rows a thread; RING_BLOCKS blocks an SM at least.
constexpr int RTX = 32, RTY = 32, RBY = 16, RING_BLOCKS = 2;
// The ring form: two stages, the first computing a ring of at most two
// nodes whose planes over a 32x16 tile fit 40 KB; any other plan of two
// stages or more takes the staged form
constexpr bool RING_FORM =
    model::N_STAGES == 2 && model::stage_ext(0) <= 2
    && model::N_STORAGE * BY * BX * sizeof(float) <= 40 * 1024;
constexpr bool STAGED_FORM = model::N_STAGES > 1 && !RING_FORM;
constexpr int RING = RING_FORM ? model::stage_ext(0) : 0;
constexpr int TX = RTX - 2 * RING, TY = RTY - 2 * RING;  // its output tile
constexpr size_t RING_SMEM = sizeof(float) * model::N_STORAGE * RTY * RTX;
// The one-stage forms: a plan of one stage over at least TILED_MIN_PLANES
// planes takes the tiled form (its block's planes staged in shared
// memory); any other runs one node a thread, its pulls from device memory,
// in 32x16 blocks, or, over at least NARROW_MIN_PLANES planes, in 32x8
// blocks at three an SM (the narrow pass: <= 85 registers; such a header
// takes more than 64 registers a thread, so 32x16 blocks would leave one
// block, 16 warps, an SM)
constexpr int TILED_MIN_PLANES = 40, NARROW_MIN_PLANES = 20;
constexpr bool TILED_FORM =
    model::N_STAGES == 1 && model::N_STORAGE >= TILED_MIN_PLANES;
constexpr bool NARROW_FORM = model::N_STAGES == 1 && !TILED_FORM
                             && model::N_STORAGE >= NARROW_MIN_PLANES;
constexpr int NBY = 8, NARROW_BLOCKS = 3;         // the narrow pass's rows,
                                                  // its blocks an SM
constexpr bool PASS_FORM = model::N_STAGES == 1 && !TILED_FORM && !NARROW_FORM;
// The pass form's globals flavours run a persistent grid of blocks built
// for PASS_GLOBALS_BLOCKS an SM (<= 64 registers: the cap the one-tile
// flavour kept without one; uncapped, the tile loop's hoisted values took
// 62-82) where a node moves fewer than PERSISTENT_MAX_BYTES of planes (in
// and out): under that cap an f32 node of 18 planes or more (the heat
// family) lost 2-6% to the grid, which every other pass-form flavour,
// bf16 and f32, gained 6-38% from
constexpr int PASS_GLOBALS_BLOCKS = 2, PERSISTENT_MAX_BYTES = 128;
template <class S>
constexpr bool persistent_globals() {
  return PASS_FORM
         && 2 * sizeof(S) * model::N_STORAGE < PERSISTENT_MAX_BYTES;
}
constexpr int NG = model::N_GLOBALS > 0 ? model::N_GLOBALS : 1;

// A staged plan's header declares model::REACH, the rows of input its
// plan reads beyond the output (generic_kernels.action_plan's reach); a
// pass-form header that reads a Field (c.load) declares
// model::FIELD_REACH, the nodes its reads reach (at most 1: the bf16 pass
// form serves them from its node's rows and columns).  A header that
// declares neither finds these defaults through the using-directive
// (qualified lookup reads a namespace's own declaration first).
namespace model {
namespace plan_defaults {
constexpr int REACH = -1;
constexpr int FIELD_REACH = 0;
}
using namespace plan_defaults;
}  // namespace model

// The staged form's tile (generic_kernels.staged_tile mirrors it): a
// 32-wide output tile 16 rows high where two blocks' shared memory fits an
// SM, else 8; the input staged over the tile plus the reach SH, the
// earlier stages' planes over the tile plus stage_ext(0) = SE (every plane
// of both stacks in f32); 512 threads a block, so two blocks an SM give
// each thread 64 registers.
constexpr int STAGED_THREADS = 512;
constexpr int SH = STAGED_FORM ? model::REACH : 0;
constexpr int SE = STAGED_FORM ? model::stage_ext(0) : 0;
constexpr int STX = 32;
constexpr size_t staged_smem(int ty) {
  return sizeof(float) * model::N_STORAGE
         * ((size_t)(ty + 2 * SH) * (STX + 2 * SH)
            + (size_t)(ty + 2 * SE) * (STX + 2 * SE));
}
constexpr size_t TWO_BLOCKS_SMEM = 113 * 1024;    // half an SM's 228 KB,
                                                  // less 1 KB a block
constexpr int STY = staged_smem(16) <= TWO_BLOCKS_SMEM ? 16 : 8;
constexpr int SIW = STX + 2 * SH, SIH = STY + 2 * SH;   // staged input
constexpr int SMW = STX + 2 * SE, SMH = STY + 2 * SE;   // earlier stages'
constexpr size_t STAGED_SMEM = staged_smem(STY);

// The tiled form's tile (generic_kernels.tiled_tile mirrors it): a 32x8
// output tile, one node a thread, its planes staged over the tile plus
// the header's reach TH (model::REACH) in f32; TILED_BLOCKS blocks an SM
// at least.
constexpr int TTX = 32, TTY = 8, TILED_THREADS = TTX * TTY;
constexpr int TILED_BLOCKS = 2;
constexpr int TH = TILED_FORM ? model::REACH : 0;
constexpr int TIW = TTX + 2 * TH, TIH = TTY + 2 * TH;   // staged input
constexpr size_t TILED_SMEM = sizeof(float) * model::N_STORAGE * TIH * TIW;

// The resident kernel's tile (generic_kernels.resident_tile mirrors it):
// the first stage of a group's first step on a KRX x KRY region, one node
// a thread of a block of as many threads (8 rows for a one-stage plan:
// more blocks, fewer nodes an SM), the output tile the region less the
// ring the group's steps compute (resident_plan); the earlier stages'
// planes and a step's result over the region in shared memory (f32).  A
// block waits for the owners of the nodes within the group's reach (at
// most 2 HALO; generic_kernels.HALO) of its tiles.
constexpr int KE = model::stage_ext(0);
constexpr int KRX = 32, KRY = model::N_STAGES > 1 ? 16 : 8;
constexpr int RESIDENT_THREADS = KRX * KRY;
constexpr int HALO = 8;
// floats of the stack of the earlier stages' planes and of the state a
// step of a group hands the next (both over the region)
constexpr int RESIDENT_STACK =
    model::N_STAGES > 1 ? model::N_STORAGE * KRY * KRX : 0;
constexpr int RESIDENT_STATE = model::N_STORAGE * KRY * KRX;

// whether each stage reads no further than the stage before it computed
constexpr bool rings_shrink() {
  for (int s = 1; s < model::N_STAGES; ++s)
    if (model::stage_ext(s) > model::stage_ext(s - 1)) return false;
  return true;
}

static_assert(model::N_STAGES >= 1 && model::stage_ext(LAST) == 0,
              "the last stage of the plan writes the output tile");
static_assert(!RING_FORM
                  || (model::stage_writes(0) & model::stage_writes(1)) == 0,
              "the f32 resident kernel's stage 1 writes the buffer it reads "
              "stage 0's planes from: the two write sets must be disjoint");
static_assert(!STAGED_FORM
                  || (model::REACH > model::stage_ext(0) && rings_shrink()),
              "a staged plan's header declares its reach (model::REACH), "
              "beyond its first stage's ring");
static_assert(STAGED_SMEM <= 227 * 1024,
              "the staged tile's planes fit a block's shared memory");
static_assert(!TILED_FORM || model::REACH >= 1,
              "a tiled one-stage header declares its reach (model::REACH)");
static_assert(!TILED_FORM || TILED_BLOCKS * (TILED_SMEM + 1024) <= 228 * 1024,
              "TILED_BLOCKS tiles' planes fit an SM's shared memory");
static_assert(KRY - 2 * KE >= 2,
              "the resident tile has output nodes inside stage 0's ring");
static_assert(rings_shrink(),
              "each stage's ring lies inside the one before");
static_assert(sizeof(float) * (RESIDENT_STACK + RESIDENT_STATE)
                  <= 227 * 1024,
              "the resident region's stack and state fit a block's shared "
              "memory");
static_assert(RTY % RBY == 0 && RTY > 2 * RING && RTX > 2 * RING,
              "the ring form's tile has inner nodes and whole rows a thread");
static_assert(!RING_FORM || RING_BLOCKS * (RING_SMEM + 1024) <= 228 * 1024,
              "RING_BLOCKS tiles' planes fit an SM's shared memory");

// whether stages 1 .. LAST - 1 each write planes no earlier stage wrote
constexpr bool earlier_stages_disjoint() {
  for (int s = 1; s < LAST; ++s)
    if (writes_before(s) & (unsigned long long)model::stage_writes(s))
      return false;
  return true;
}

static_assert(earlier_stages_disjoint(),
              "the earlier stages' planes share one scratch stack: no two "
              "stages before the last may write the same plane");

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

// the ring form's stage 1: stage 0's planes from the block's shared tile
// (origin at unwrapped (y0, x0)), the others from the launch's input
template <class S>
struct TileStorage {
  const float* tile;       // [N_STORAGE][RTY][RTX]
  int y0, x0;
  DeviceStorage<false, S> rest;
  __device__ float get(int k, int y, int x) const {
    if (writes(0, k)) return tile[(k * RTY + (y - y0)) * RTX + (x - x0)];
    return rest.get(k, y, x);
  }
};

// the tiled form's stage: every plane from the block's staged input
// (origin at unwrapped (iy0, ix0))
struct TiledStorage {
  const float* in;         // [N_STORAGE][TIH][TIW]
  int iy0, ix0;
  __device__ float get(int k, int y, int x) const {
    return in[(k * TIH + (y - iy0)) * TIW + (x - ix0)];
  }
};

// stage s of the staged form: a plane an earlier stage wrote from the
// block's stack of them (origin at unwrapped (my0, mx0)), any other from
// the staged input (origin at (iy0, ix0))
template <int s>
struct StagedStorage {
  const float* in;         // [N_STORAGE][SIH][SIW]
  const float* mid;        // [N_STORAGE][SMH][SMW]
  int iy0, ix0, my0, mx0;
  __device__ float get(int k, int y, int x) const {
    if ((writes_before(s) >> k) & 1ull)
      return mid[(k * SMH + (y - my0)) * SMW + (x - mx0)];
    return in[(k * SIH + (y - iy0)) * SIW + (x - ix0)];
  }
};

// a node's pulls from device memory (a bf16 stack), its three rows and
// columns about (y, x) wrapped once, by a compare: plane k from row
// 1 - ey_k and column 1 - ex_k (the offsets of y + dy, x + dx at dy + 1,
// dx + 1).  A pull (get), or a Field read one node away at most (at).
struct NodeStorage {
  const __nv_bfloat16* p;
  size_t n;
  size_t row[3];
  int col[3];
  const float* w;
  __device__ float get(int k, int, int) const {
    return load_plane<false>(
        p + k * n + row[1 - model::ey(k)] + col[1 - model::ex(k)], w, k);
  }
  __device__ float at(int k, int dx, int dy) const {
    return load_plane<false>(p + k * n + row[1 + dy] + col[1 + dx], w, k);
  }
};

// whether a stage reads through NodeStorage (its Field reads by `at`)
template <class Storage>
constexpr bool kNodeStorage = false;
template <>
constexpr bool kNodeStorage<NodeStorage> = true;

// ---------------------------------------------------------------------------
// Where a stage writes
// ---------------------------------------------------------------------------

struct TileOut {          // a plane of the ring form's shared tile
  float* tile;
  int ly, lx;
  __device__ void operator()(int k, float v) const {
    tile[(k * RTY + ly) * RTX + lx] = v;
  }
};

struct StackOut {         // a plane of the staged form's earlier stages
  float* mid;
  int my, mx;
  __device__ void operator()(int k, float v) const {
    mid[(k * SMH + my) * SMW + mx] = v;
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
    if constexpr (kNodeStorage<Storage>) {
      static_assert(kNodeStorage<Storage> && model::FIELD_REACH == 1,
                    "the bf16 pass form serves Field reads one node away "
                    "at most: the header declares FIELD_REACH 1");
      return s.at(k, dx, dy);
    } else {
      return s.get(k, y + dy, x + dx);
    }
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

// The tiles a step block runs, as body(tile row, tile column): its own
// (blockIdx); on a persistent grid (kPersistent, step_grid) block b runs
// the tiles b, b + gridDim.x, ... of the nty x ntx tiles (row-major) in
// that order, keeping its sums over them, so that it reduces them once.
template <bool kPersistent, class Body>
__device__ __forceinline__ void for_tiles(int nty, int ntx, Body body) {
  if constexpr (kPersistent) {
    const int ntiles = nty * ntx;
#pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int ty = t / ntx;
      body(ty, t - ty * ntx);
    }
  } else {
    body((int)blockIdx.y, (int)blockIdx.x);
  }
}

// the globals flavours' end: the block's sums into the launch's globals
template <int NTHREADS>
__device__ __forceinline__ void reduce_step_globals(const double* acc,
                                                    double* partials,
                                                    float* gout) {
  reduce_globals<NG, NTHREADS>(acc, partials, &g_blocks_done,
                               [gout](int g, double t) { gout[g] = (float)t; });
}

// generic2d_step's ring form: stage 0 on the block's RTY x RTX tile (its
// output tile plus the ring) into shared memory, RTY / RBY rows a thread,
// then stage 1 on the output tile
template <class S, bool kGlobals, bool kSeries>
__global__ void __launch_bounds__(RTX * RBY, RING_BLOCKS)
generic2d_step_kernel(const S* __restrict__ fin, S* __restrict__ fout,
                      const int* __restrict__ flags,
                      const float* __restrict__ ztab, const GenericArgs a,
                      const SeriesArgs ser, double* partials, float* gout,
                      const __grid_constant__ Shift sh) {
  extern __shared__ float tile[];                      // [N][RTY][RTX]
  const size_t n = (size_t)a.ny * a.nx;
  const int lx = threadIdx.x % RTX, ly0 = threadIdx.x / RTX;
  // the block's ring starts RING nodes before its output tile (unwrapped)
  const int y0 = blockIdx.y * TY - RING, x0 = blockIdx.x * TX - RING;
  const int x = x0 + lx, wx = wrap(x, a.nx);
  const bool out_col = lx >= RING && lx < RTX - RING && x < a.nx;
  double acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0;
  const DeviceStorage<false, S> in{fin, a.ny, a.nx, sh.w};
#pragma unroll 1
  for (int ly = ly0; ly < RTY; ly += RBY) {
    const int y = y0 + ly;
    const bool out_node = out_col && ly >= RING && ly < RTY - RING
                          && y < a.ny;
    run_stage<0, kGlobals, kSeries>(
        a, in, TileOut{tile, ly, lx}, ztab, ser, acc, y, x,
        __ldg(flags + (size_t)wrap(y, a.ny) * a.nx + wx), out_node);
  }
  __syncthreads();
  const TileStorage<S> st{tile, y0, x0, in};
#pragma unroll 1
  for (int ly = ly0; ly < RTY; ly += RBY) {
    const int y = y0 + ly;
    if (!(out_col && ly >= RING && ly < RTY - RING && y < a.ny)) continue;
    const size_t idx = (size_t)y * a.nx + x;
    run_stage<1, kGlobals, kSeries>(a, st, DeviceOut<S>{fout, idx, n, sh.w},
                                    ztab, ser, acc, y, x, __ldg(flags + idx),
                                    true);
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k) {
      if (writes(0, k) && !writes(1, k))
        store_plane(fout + k * n + idx, st.get(k, y, x), sh.w, k);
      else if (!((ALL_WRITES >> k) & 1ull))   // no stage writes it
        store_plane(fout + k * n + idx,
                    load_plane<false>(fin + k * n + idx, sh.w, k), sh.w, k);
    }
  }
  if constexpr (kGlobals) reduce_step_globals<RTX * RBY>(acc, partials, gout);
}

// generic2d_step's one-stage form: the plan's stage over the whole
// lattice, one node a thread, no ring, in blocks of ROWS rows of BX; the
// planes it leaves are copied from the input.  The globals flavour sums
// the nodes, over the tiles of a persistent grid where kPersistent.  The
// pass form on a bf16 stack pulls through NodeStorage: its node's rows and
// columns wrapped once, by a compare (an f32 stack's bytes hide the
// modulo wraps of DeviceStorage; half of them do not).
template <int ROWS, class S, bool kGlobals, bool kSeries,
          bool kPersistent = false>
__device__ __forceinline__ void pass_nodes(const S* __restrict__ fin,
                                           S* __restrict__ fout,
                                           const int* __restrict__ flags,
                                           const float* __restrict__ ztab,
                                           const GenericArgs& a,
                                           const SeriesArgs& ser,
                                           double* partials, float* gout,
                                           const Shift& sh) {
  const size_t n = (size_t)a.ny * a.nx;
  double acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0;
  for_tiles<kPersistent>(
      (a.ny + ROWS - 1) / ROWS, (a.nx + BX - 1) / BX, [&](int by, int bx) {
    const int y = by * ROWS + threadIdx.y;
    const int x = bx * BX + threadIdx.x;
    if (y >= a.ny || x >= a.nx) return;
    const size_t idx = (size_t)y * a.nx + x;
    const int flag = __ldg(flags + idx);
    const DeviceOut<S> out{fout, idx, n, sh.w};
    if constexpr (sizeof(S) != sizeof(float) && PASS_FORM) {
      const int ym = y > 0 ? y - 1 : a.ny - 1, yp = y + 1 < a.ny ? y + 1 : 0;
      const int xm = x > 0 ? x - 1 : a.nx - 1, xp = x + 1 < a.nx ? x + 1 : 0;
      const NodeStorage st{fin, n,
                           {(size_t)ym * a.nx, (size_t)y * a.nx,
                            (size_t)yp * a.nx},
                           {xm, x, xp}, sh.w};
      run_stage<0, kGlobals, kSeries>(a, st, out, ztab, ser, acc, y, x, flag,
                                      true);
    } else {
      run_stage<0, kGlobals, kSeries>(
          a, DeviceStorage<false, S>{fin, a.ny, a.nx, sh.w}, out, ztab, ser,
          acc, y, x, flag, true);
    }
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k)
      if (!writes(0, k))
        store_plane(fout + k * n + idx,
                    load_plane<false>(fin + k * n + idx, sh.w, k), sh.w, k);
  });
  if constexpr (kGlobals) reduce_step_globals<BX * ROWS>(acc, partials, gout);
}

// the pass form: 32x16 blocks
template <class S, bool kGlobals, bool kSeries>
__global__ void __launch_bounds__(BX * BY)
generic2d_pass_kernel(const S* __restrict__ fin, S* __restrict__ fout,
                      const int* __restrict__ flags,
                      const float* __restrict__ ztab, const GenericArgs a,
                      const SeriesArgs ser, double* partials, float* gout,
                      const __grid_constant__ Shift sh) {
  pass_nodes<BY, S, kGlobals, kSeries>(fin, fout, flags, ztab, a, ser,
                                       partials, gout, sh);
}

// the pass form's globals flavours where persistent_globals: 32x16 blocks
// on a persistent grid, PASS_GLOBALS_BLOCKS an SM
template <class S, bool kSeries>
__global__ void __launch_bounds__(BX * BY, PASS_GLOBALS_BLOCKS)
generic2d_pass_globals_kernel(const S* __restrict__ fin,
                              S* __restrict__ fout,
                              const int* __restrict__ flags,
                              const float* __restrict__ ztab,
                              const GenericArgs a, const SeriesArgs ser,
                              double* partials, float* gout,
                              const __grid_constant__ Shift sh) {
  pass_nodes<BY, S, true, kSeries, true>(fin, fout, flags, ztab, a, ser,
                                         partials, gout, sh);
}

// the narrow pass: 32x8 blocks, NARROW_BLOCKS an SM
template <class S, bool kGlobals, bool kSeries>
__global__ void __launch_bounds__(BX * NBY, NARROW_BLOCKS)
generic2d_narrow_kernel(const S* __restrict__ fin, S* __restrict__ fout,
                        const int* __restrict__ flags,
                        const float* __restrict__ ztab, const GenericArgs a,
                        const SeriesArgs ser, double* partials, float* gout,
                        const __grid_constant__ Shift sh) {
  pass_nodes<NBY, S, kGlobals, kSeries>(fin, fout, flags, ztab, a, ser,
                                        partials, gout, sh);
}

// generic2d_step's tiled form: the block's planes over its 32x8 tile plus
// the reach staged into shared memory, then the plan's one stage, one
// node a thread, from there (a header that pulls a group of planes more
// than once reads shared memory again, not L1 or L2)
template <class S, bool kGlobals, bool kSeries>
__global__ void __launch_bounds__(TILED_THREADS, TILED_BLOCKS)
generic2d_tiled_kernel(const S* __restrict__ fin, S* __restrict__ fout,
                       const int* __restrict__ flags,
                       const float* __restrict__ ztab, const GenericArgs a,
                       const SeriesArgs ser, double* partials, float* gout,
                       const __grid_constant__ Shift sh) {
  extern __shared__ float tiled[];                     // [N][TIH][TIW]
  __shared__ size_t rows[TIH];
  __shared__ int cols[TIW];
  const size_t n = (size_t)a.ny * a.nx;
  const int ty0 = blockIdx.y * TTY, tx0 = blockIdx.x * TTX;
  for (int i = threadIdx.x; i < TIH + TIW; i += TILED_THREADS) {
    if (i < TIH) rows[i] = (size_t)wrap(ty0 - TH + i, a.ny) * a.nx;
    else cols[i - TIH] = wrap(tx0 - TH + i - TIH, a.nx);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TIH * TIW; i += TILED_THREADS) {
    const int ly = i / TIW, lx = i - ly * TIW;
    const S* q = fin + rows[ly] + cols[lx];
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k)
      tiled[k * TIH * TIW + i] = load_plane<false>(q + k * n, sh.w, k);
  }
  __syncthreads();
  const int y = ty0 + (int)threadIdx.x / TTX;
  const int x = tx0 + (int)threadIdx.x % TTX;
  double acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0;
  if (y < a.ny && x < a.nx) {
    const TiledStorage st{tiled, ty0 - TH, tx0 - TH};
    const size_t idx = (size_t)y * a.nx + x;
    run_stage<0, kGlobals, kSeries>(a, st, DeviceOut<S>{fout, idx, n, sh.w},
                                    ztab, ser, acc, y, x, __ldg(flags + idx),
                                    true);
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k)
      if (!writes(0, k))
        store_plane(fout + k * n + idx, st.get(k, y, x), sh.w, k);
  }
  if constexpr (kGlobals)
    reduce_step_globals<TILED_THREADS>(acc, partials, gout);
}

// Stage s of the staged form on the block's tile plus stage_ext(s) nodes
// (nodes i of that region in row order, a stride of STAGED_THREADS), then
// the stages after it, a block barrier between two.  An earlier stage
// writes the block's stack `mid`; the last writes the output nodes inside
// the lattice and the planes the step leaves (an earlier stage's from
// `mid`, any other from the staged input).  A node's globals count where
// it is an output node.  rows/cols: the staged input's wrapped rows (as
// offsets) and columns.
template <int s, class S, bool kGlobals, bool kSeries>
__device__ __forceinline__ void staged_stages(
    const GenericArgs& a, const float* in, float* mid, S* __restrict__ fout,
    const int* __restrict__ flags, const float* __restrict__ ztab,
    const SeriesArgs& ser, const Shift& sh, const size_t* rows,
    const int* cols, int ty0, int tx0, double* acc) {
  constexpr int e = model::stage_ext(s);
  constexpr int W = STX + 2 * e, H = STY + 2 * e;
  const StagedStorage<s> st{in, mid, ty0 - SH, tx0 - SH, ty0 - SE,
                            tx0 - SE};
  for (int i = threadIdx.x; i < W * H; i += STAGED_THREADS) {
    const int ly = i / W, lx = i - ly * W;
    const int y = ty0 - e + ly, x = tx0 - e + lx;      // unwrapped
    const bool inside = y < a.ny && x < a.nx;
    const int flag = __ldg(flags + rows[ly + SH - e] + cols[lx + SH - e]);
    if constexpr (s < LAST) {
      const bool counts = ly >= e && ly < e + STY && lx >= e
                          && lx < e + STX && inside;
      run_stage<s, kGlobals, kSeries>(
          a, st, StackOut{mid, y - (ty0 - SE), x - (tx0 - SE)}, ztab, ser,
          acc, y, x, flag, counts);
    } else if (inside) {
      const size_t n = (size_t)a.ny * a.nx;
      const size_t idx = (size_t)y * a.nx + x;
      run_stage<s, kGlobals, kSeries>(a, st, DeviceOut<S>{fout, idx, n, sh.w},
                                      ztab, ser, acc, y, x, flag, true);
#pragma unroll
      for (int k = 0; k < model::N_STORAGE; ++k)
        if (!writes(LAST, k))
          store_plane(fout + k * n + idx, st.get(k, y, x), sh.w, k);
    }
  }
  if constexpr (s < LAST) {
    __syncthreads();
    staged_stages<s + 1, S, kGlobals, kSeries>(a, in, mid, fout, flags,
                                               ztab, ser, sh, rows, cols,
                                               ty0, tx0, acc);
  }
}

// generic2d_step's staged form: the block's input planes over the tile
// plus the reach into shared memory (widened to f32; each node's planes
// loaded together), then every stage from there
template <class S, bool kGlobals, bool kSeries>
__global__ void __launch_bounds__(STAGED_THREADS)
generic2d_staged_kernel(const S* __restrict__ fin, S* __restrict__ fout,
                        const int* __restrict__ flags,
                        const float* __restrict__ ztab, const GenericArgs a,
                        const SeriesArgs ser, double* partials, float* gout,
                        const __grid_constant__ Shift sh) {
  extern __shared__ float staged[];
  float* in = staged;                                  // [N][SIH][SIW]
  float* mid = staged + model::N_STORAGE * SIH * SIW;  // [N][SMH][SMW]
  __shared__ size_t rows[SIH];
  __shared__ int cols[SIW];
  const size_t n = (size_t)a.ny * a.nx;
  const int ty0 = blockIdx.y * STY, tx0 = blockIdx.x * STX;
  for (int i = threadIdx.x; i < SIH + SIW; i += STAGED_THREADS) {
    if (i < SIH) rows[i] = (size_t)wrap(ty0 - SH + i, a.ny) * a.nx;
    else cols[i - SIH] = wrap(tx0 - SH + i - SIH, a.nx);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SIH * SIW; i += STAGED_THREADS) {
    const int ly = i / SIW, lx = i - ly * SIW;
    const S* q = fin + rows[ly] + cols[lx];
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k)
      in[k * SIH * SIW + i] = load_plane<false>(q + k * n, sh.w, k);
  }
  __syncthreads();
  double acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0;
  staged_stages<0, S, kGlobals, kSeries>(a, in, mid, fout, flags, ztab, ser,
                                         sh, rows, cols, ty0, tx0, acc);
  if constexpr (kGlobals)
    reduce_step_globals<STAGED_THREADS>(acc, partials, gout);
}

// A generic2d_step launch's geometry: its output tile (ty x tx nodes), its
// block (bx x by threads) and its dynamic shared memory, in the form the
// header's plan takes
struct StepGeometry {
  int ty, tx, bx, by;
  size_t smem;
};

static StepGeometry step_geometry() {
  if constexpr (RING_FORM) return {TY, TX, RTX * RBY, 1, RING_SMEM};
  else if constexpr (STAGED_FORM)
    return {STY, STX, STAGED_THREADS, 1, STAGED_SMEM};
  else if constexpr (TILED_FORM)
    return {TTY, TTX, TILED_THREADS, 1, TILED_SMEM};
  else if constexpr (NARROW_FORM) return {NBY, BX, BX, NBY, 0};
  else return {BY, BX, BX, BY, 0};
}

// the kernel of that form and flavour
template <class S, bool kGlobals, bool kSeries>
static auto step_kernel() {
  if constexpr (RING_FORM) return generic2d_step_kernel<S, kGlobals, kSeries>;
  else if constexpr (STAGED_FORM)
    return generic2d_staged_kernel<S, kGlobals, kSeries>;
  else if constexpr (TILED_FORM)
    return generic2d_tiled_kernel<S, kGlobals, kSeries>;
  else if constexpr (NARROW_FORM)
    return generic2d_narrow_kernel<S, kGlobals, kSeries>;
  else if constexpr (kGlobals && persistent_globals<S>())
    return generic2d_pass_globals_kernel<S, kSeries>;
  else return generic2d_pass_kernel<S, kGlobals, kSeries>;
}

constexpr int MAX_DEVICES = 64;

// The grid of a generic2d_step launch on `a`'s lattice: a block a tile,
// but in the pass form's globals flavours (persistent_globals) a
// persistent grid of as many blocks as the device holds at once (the
// occupancy API, for this build's kernel), at most a tile each -- so a
// block reduces its sums once, over several tiles at 1024x1024, and the
// last block adds that many partials.  The wrapper sizes the globals'
// partials from it (generic2d_step_blocks).
template <class S, bool kGlobals, bool kSeries>
static int step_grid(const GenericArgs& a, dim3* grid) {
  const StepGeometry g = step_geometry();
  const int nty = (a.ny + g.ty - 1) / g.ty, ntx = (a.nx + g.tx - 1) / g.tx;
  if constexpr (!kGlobals || !persistent_globals<S>()) {
    *grid = dim3(ntx, nty);
    return 0;
  } else {
    static int capacity[MAX_DEVICES];     // blocks the device holds at once
    int device;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return (int)e;
    if (device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (capacity[device] == 0) {
      const auto kernel = step_kernel<S, kGlobals, kSeries>();
      int sms = 0, per_sm = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
      if (e != cudaSuccess) return (int)e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, g.bx * g.by, 0);
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      capacity[device] = sms * per_sm;
    }
    const int tiles = nty * ntx;
    *grid = dim3(tiles < capacity[device] ? tiles : capacity[device]);
    return 0;
  }
}

// one Iteration, in one launch, in the form the header's plan takes
template <class S, bool kGlobals, bool kSeries>
static int launch_step(const S* fin, S* fout, const int* flags,
                       const float* ztab, const GenericArgs& a,
                       const SeriesArgs& ser, double* partials, float* gout,
                       const Shift& sh, void* stream) {
  const auto kernel = step_kernel<S, kGlobals, kSeries>();
  const StepGeometry g = step_geometry();
  if (g.smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid;
  const int rc = step_grid<S, kGlobals, kSeries>(a, &grid);
  if (rc) return rc;
  kernel<<<grid, dim3(g.bx, g.by), g.smem, (cudaStream_t)stream>>>(
      fin, fout, flags, ztab, a, ser, partials, gout, sh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// generic2d_resident
// ---------------------------------------------------------------------------

// Stage s of a step of the resident kernel's tile: a plane an earlier
// stage of the step wrote from the block's stack, a plane some stage writes
// from the step's input -- the block's state of the step before (kIn), or
// the buffer other blocks wrote (read through L2 only) -- any other from
// the launch's input (it never changes).  The stack and the state share
// the region's layout, origin at unwrapped (sy0, sx0).
template <int s, class S, bool kIn>
struct ResidentStorage {
  const float* stack;      // [N_STORAGE][KRY][KRX]
  const float* state;      // [N_STORAGE][KRY][KRX] (kIn)
  int sy0, sx0;
  DeviceStorage<true, S> src;
  DeviceStorage<false, S> fin;
  __device__ float get(int k, int y, int x) const {
    const int at = (k * KRY + (y - sy0)) * KRX + (x - sx0);
    if ((writes_before(s) >> k) & 1ull) return stack[at];
    if ((ALL_WRITES >> k) & 1ull) return kIn ? state[at] : src.get(k, y, x);
    return fin.get(k, y, x);
  }
};

// a plane of the block's stack (an earlier stage) or state (a step's
// result the next step of the launch reads; stored as the stack at rest
// rounds it, so a bf16 step narrows once, as chained launches do)
template <class S, bool kState>
struct ResidentOut {
  float* buf;              // [N_STORAGE][KRY][KRX]
  int at;                  // the node's offset in a plane
  const float* w;
  __device__ void operator()(int k, float v) const {
    if constexpr (kState && sizeof(S) != sizeof(float))
      v = widen(narrow<S>(v, w[k]), w[k]);
    buf[k * KRY * KRX + at] = v;
  }
};

// Stages s .. LAST of one step on the tile at (ty0, tx0), on the tile plus
// `ring` nodes (the steps after it in the group read them) plus
// stage_ext(s): an earlier stage into the stack; the last into `dst` at
// the lattice's nodes (kOut false) or into the state over the whole region
// (kOut), with the planes an earlier stage wrote and it leaves.  The
// region's origin (sy0, sx0); a block barrier between two stages.
template <int s, class S, bool kIn, bool kOut>
__device__ __forceinline__ void resident_stages(
    const GenericArgs& a, const S* src, const S* __restrict__ fin, S* dst,
    float* stack, float* state, const int* __restrict__ flags,
    const float* __restrict__ ztab, const Shift& sh, int ty0, int tx0,
    int ty, int tx, int ring, int sy0, int sx0) {
  constexpr int e0 = model::stage_ext(s);
  const int e = ring + e0, W = tx + 2 * e, H = ty + 2 * e;
  const SeriesArgs none{};
  const ResidentStorage<s, S, kIn> st{stack, state, sy0, sx0,
                                      {src, a.ny, a.nx, sh.w},
                                      {fin, a.ny, a.nx, sh.w}};
  for (int i = threadIdx.x; i < W * H; i += RESIDENT_THREADS) {
    const int ly = i / W, lx = i - ly * W;
    const int y = ty0 - e + ly, x = tx0 - e + lx;     // unwrapped
    const int at = (y - sy0) * KRX + (x - sx0);
    if constexpr (s < LAST || kOut) {
      const int flag =
          __ldg(flags + (size_t)wrap(y, a.ny) * a.nx + wrap(x, a.nx));
      if constexpr (s < LAST) {
        run_stage<s, false>(a, st, ResidentOut<S, false>{stack, at, sh.w},
                            ztab, none, nullptr, y, x, flag, false);
      } else {
        const ResidentOut<S, true> out{state, at, sh.w};
        run_stage<s, false>(a, st, out, ztab, none, nullptr, y, x, flag,
                            false);
#pragma unroll
        for (int k = 0; k < model::N_STORAGE; ++k)
          if (!writes(LAST, k) && ((writes_before(LAST) >> k) & 1ull))
            out(k, st.get(k, y, x));
      }
    } else if (y < a.ny && x < a.nx) {
      const size_t n = (size_t)a.ny * a.nx;
      const size_t idx = (size_t)y * a.nx + x;
      run_stage<s, false>(a, st, DeviceOut<S>{dst, idx, n, sh.w}, ztab, none,
                          nullptr, y, x, __ldg(flags + idx), false);
#pragma unroll
      for (int k = 0; k < model::N_STORAGE; ++k)
        if (!writes(LAST, k) && ((writes_before(LAST) >> k) & 1ull))
          store_plane(dst + k * n + idx, st.get(k, y, x), sh.w, k);
    }
  }
  __syncthreads();
  if constexpr (s < LAST)
    resident_stages<s + 1, S, kIn, kOut>(a, src, fin, dst, stack, state,
                                         flags, ztab, sh, ty0, tx0, ty, tx,
                                         ring, sy0, sx0);
}

// An even number of steps in one cooperative launch, `fuse` (1 or 2) steps
// between two waits.  Block b owns the tiles t = b, b + gridDim.x, ...
// (row-major, ty x tx nodes each: the region less ring0 = (fuse - 1) *
// reach + stage_ext(0) a side) for the whole launch.  A group of `fuse`
// steps reads the launch's input (the first group) or the buffer the group
// before wrote and writes the other (the last group fout); its first step
// runs on the tile plus `reach` nodes into the block's state, its second
// from there on the tile.  After its group the block publishes the steps
// done in its counter; before the next it waits for every block owning a
// node within fuse * reach of its tiles (csrc/resident_sync.cuh).  A
// neighbour has then written the group's input and read the buffer the
// group overwrites, so two buffers suffice.
template <class S>
__global__ void __launch_bounds__(RESIDENT_THREADS)
generic2d_resident_kernel(const S* __restrict__ fin, S* fout, S* scratch,
                          int* counters, const int* __restrict__ flags,
                          const float* __restrict__ ztab,
                          const GenericArgs a, int nsteps, int reach,
                          int fuse, const __grid_constant__ Shift sh) {
  extern __shared__ float resident_smem[];
  float* stack = resident_smem;                    // [N][KRY][KRX]
  float* state = resident_smem + RESIDENT_STACK;   // [N][KRY][KRX]
  __shared__ unsigned int waits[RESIDENT_MAX_BLOCKS / 32];
  const int nb = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int ring0 = (fuse - 1) * reach + KE;
  const int ty = KRY - 2 * ring0, tx = KRX - 2 * ring0;
  const int ntx = (a.nx + tx - 1) / tx;
  const int ntiles = ntx * ((a.ny + ty - 1) / ty);
  const size_t n = (size_t)a.ny * a.nx;
  reset_waits<RESIDENT_THREADS>(waits, counters, b);
  // the blocks to wait for, and the planes no stage writes, to fout once
  for (int t = b; t < ntiles; t += nb) {
    const int ty0 = t / ntx * ty, tx0 = t % ntx * tx;
    mark_waits<RESIDENT_THREADS>(waits, ty0, tx0, ty, tx, ntx, nb, a.ny,
                                 a.nx, fuse * reach);
    for (int i = tid; i < ty * tx; i += RESIDENT_THREADS) {
      const int y = ty0 + i / tx, x = tx0 + i % tx;
      if (y >= a.ny || x >= a.nx) continue;
      const size_t idx = (size_t)y * a.nx + x;
#pragma unroll
      for (int k = 0; k < model::N_STORAGE; ++k)
        if (!((ALL_WRITES >> k) & 1ull))
          store_plane(fout + k * n + idx,
                      load_plane<false>(fin + k * n + idx, sh.w, k), sh.w, k);
    }
  }
  cg::this_grid().sync();            // every counter is 0
  const int groups = nsteps / fuse;
  for (int g = 0; g < groups; ++g) {
    const S* src = g == 0 ? fin : ((groups - g) % 2 ? scratch : fout);
    S* dst = (groups - 1 - g) % 2 ? scratch : fout;
    if (g > 0) wait_for<RESIDENT_THREADS>(waits, counters, nb, g * fuse);
    for (int t = b; t < ntiles; t += nb) {
      const int ty0 = t / ntx * ty, tx0 = t % ntx * tx;
      const int sy0 = ty0 - ring0, sx0 = tx0 - ring0;
      if (fuse == 1) {
        resident_stages<0, S, false, false>(a, src, fin, dst, stack, state,
                                            flags, ztab, sh, ty0, tx0, ty,
                                            tx, 0, sy0, sx0);
      } else {
        resident_stages<0, S, false, true>(a, src, fin, dst, stack, state,
                                           flags, ztab, sh, ty0, tx0, ty,
                                           tx, reach, sy0, sx0);
        resident_stages<0, S, true, false>(a, src, fin, dst, stack, state,
                                           flags, ztab, sh, ty0, tx0, ty,
                                           tx, 0, sy0, sx0);
      }
    }
    publish(counters, b, (g + 1) * fuse);
  }
}

// The resident tile for a plan of `reach` (at most HALO): two steps a wait
// where the tile that leaves (the region less reach + stage_ext(0) a side)
// keeps at least half of the region's nodes, else one
// (generic_kernels.resident_tile mirrors it).
static void resident_plan(int reach, int* fuse, int* ty, int* tx) {
  *fuse = 2;
  int ring0 = reach + KE;
  if (KRY - 2 * ring0 < 2
      || 2 * (KRY - 2 * ring0) * (KRX - 2 * ring0) < KRY * KRX) {
    *fuse = 1;
    ring0 = KE;
  }
  *ty = KRY - 2 * ring0;
  *tx = KRX - 2 * ring0;
}

template <class S>
static int launch_resident(const S* fin, S* fout, S* scratch, int* counters,
                           const int* flags, const float* ztab,
                           const GenericArgs* a, const Shift& shift,
                           int nsteps, int reach, int device, void* stream) {
  if (nsteps < 2 || nsteps % 2 || reach < 0 || reach > HALO)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int fuse, ty, tx;
  resident_plan(reach, &fuse, &ty, &tx);
  const size_t smem = sizeof(float)
                      * (RESIDENT_STACK + (fuse > 1 ? RESIDENT_STATE : 0));
  const void* kernel = (const void*)generic2d_resident_kernel<S>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((a->nx + tx - 1) / tx) * ((a->ny + ty - 1) / ty);
  const int blocks = resident_blocks(kernel, RESIDENT_THREADS, smem, tiles,
                                     device);
  if (blocks < 0) return -blocks;
  if (blocks == 0) return (int)cudaErrorNotSupported;
  GenericArgs args = *a;
  Shift sh = shift;
  void* params[] = {(void*)&fin, (void*)&fout, (void*)&scratch,
                    (void*)&counters, (void*)&flags, (void*)&ztab,
                    (void*)&args, (void*)&nsteps, (void*)&reach,
                    (void*)&fuse, (void*)&sh};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks),
                                  dim3(RESIDENT_THREADS), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// The output tile of a generic2d_step block (its partials are one per block)
// and the layout sizes this library was built with, for the wrapper's checks.
void generic2d_layout(int* tile_y, int* tile_x, int* n_storage,
                      int* n_settings, int* n_types, int* n_groups,
                      int* n_zonal, int* n_globals) {
  *tile_y = RING_FORM    ? TY
            : STAGED_FORM ? STY
            : TILED_FORM  ? TTY
            : NARROW_FORM ? NBY
                          : BY;
  *tile_x = RING_FORM ? TX : STAGED_FORM ? STX : TILED_FORM ? TTX : BX;
  *n_storage = model::N_STORAGE;
  *n_settings = model::N_SETTINGS;
  *n_types = model::N_TYPES;
  *n_groups = model::N_GROUPS;
  *n_zonal = model::N_ZONAL;
  *n_globals = model::N_GLOBALS;
}

// The plan this library runs: its stage count (generic2d_step runs it in
// one launch, in the form generic_kernels.step_form names).
void generic2d_plan(int* n_stages) { *n_stages = model::N_STAGES; }

// `partials` null: the plain flavour; else the globals flavour, with
// `partials` holding one double per block and global, and `gout` the
// globals (n_globals floats).
int generic2d_step(const float* fin, float* fout, const int* flags,
                   const float* ztab, const GenericArgs* a, double* partials,
                   float* gout, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const SeriesArgs none{};
  const Shift unused{};
  if (partials)
    return launch_step<float, true, false>(fin, fout, flags, ztab, *a,
                                           none, partials, gout, unused,
                                           stream);
  return launch_step<float, false, false>(fin, fout, flags, ztab, *a,
                                          none, nullptr, nullptr, unused,
                                          stream);
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
  const SeriesArgs none{};
  const Shift sh = shift_arg<model::N_STORAGE>(shift);
  if (partials)
    return launch_step<__nv_bfloat16, true, false>(
        fin, fout, flags, ztab, *a, none, partials, gout, sh, stream);
  return launch_step<__nv_bfloat16, false, false>(
      fin, fout, flags, ztab, *a, none, nullptr, nullptr, sh, stream);
}

// The blocks of a globals flavour's launch of generic2d_step on an ny x nx
// lattice (`bf16`: generic2d_step_bf16; `series`: generic2d_step_series)
// on `device`, in `blocks`: its partials hold a row of n_globals doubles
// (at least one) a block.
int generic2d_step_blocks(int ny, int nx, int bf16, int series, int device,
                          int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bf16 && series) return (int)cudaErrorInvalidValue;
  GenericArgs a{};
  a.ny = ny;
  a.nx = nx;
  dim3 grid;
  const int rc = bf16     ? step_grid<__nv_bfloat16, true, false>(a, &grid)
                 : series ? step_grid<float, true, true>(a, &grid)
                          : step_grid<float, true, false>(a, &grid);
  *blocks = (int)(grid.x * grid.y * grid.z);
  return rc;
}

// The <Control> time series flavours (generic2d_step_series): as
// generic2d_step, with zonal setting j in zone z read from ts[row[j][z]][t]
// where row[j][z] >= 0 (SeriesArgs); `partials` null for the plain series
// flavour, else the series + globals flavour.
int generic2d_step_series(const float* fin, float* fout, const int* flags,
                          const float* ztab, const GenericArgs* a,
                          const int* row,
                          const float* ts, int len, int t, double* partials,
                          float* gout, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const SeriesArgs ser{row, ts, len, t};
  const Shift unused{};
  if (partials)
    return launch_step<float, true, true>(fin, fout, flags, ztab, *a,
                                          ser, partials, gout, unused,
                                          stream);
  return launch_step<float, false, true>(fin, fout, flags, ztab, *a,
                                         ser, nullptr, nullptr, unused,
                                         stream);
}

// The resident kernel's tile (rows, columns) and the steps between two
// waits for a plan of `reach`, and its threads a block.
void generic2d_resident_tile(int reach, int* ty, int* tx, int* fuse,
                             int* threads) {
  resident_plan(reach, fuse, ty, tx);
  *threads = RESIDENT_THREADS;
}

// `nsteps` (even, at least 2) Iterations in one cooperative launch;
// `scratch` is a second field stack, `counters` one int a tile (the
// kernel resets those it uses), `reach` the plan's (at most HALO).
int generic2d_resident(const float* fin, float* fout, float* scratch,
                       int* counters, const int* flags, const float* ztab,
                       const GenericArgs* a, int nsteps, int reach,
                       int device, void* stream) {
  return launch_resident<float>(fin, fout, scratch, counters, flags, ztab,
                                a, Shift{}, nsteps, reach, device, stream);
}

// generic2d_resident on a bf16 stack at rest, with the planes' shifts
// `shift` (null: raw).
int generic2d_resident_bf16(const __nv_bfloat16* fin, __nv_bfloat16* fout,
                            __nv_bfloat16* scratch, int* counters,
                            const int* flags, const float* ztab,
                            const GenericArgs* a, const float* shift,
                            int nsteps, int reach, int device,
                            void* stream) {
  return launch_resident<__nv_bfloat16>(
      fin, fout, scratch, counters, flags, ztab, a,
      shift_arg<model::N_STORAGE>(shift), nsteps, reach, device, stream);
}

}  // extern "C"

#ifdef TCLB_MODEL_ADJOINT
#include "generic2d_adjoint.cuh"
#endif
