// generic2d_step_b: the reverse of one generic2d_step, for a model whose
// device header has a hand-written reverse stage_b<s> for each stage of
// its plan, one or two (included at the end of csrc/generic2d.cu where the
// header defines TCLB_MODEL_ADJOINT).
//
// Replaces tclb_tpu/ops/pallas_adjoint.py:make_diff_step's backward band
// kernel (`call_bwd`) at chunk k = 1: given the primal input of the step,
// the cotangent lam_out of its output planes and lam_g of its SUM globals,
//
//   lam_in = (d step / d fields)^T lam_out + (d globals / d fields)^T lam_g
//
// and the cotangent of the settings vector.  Pull streaming makes the
// transpose a gather: with q(x) = J(x)^T [lam_out(x), lam_g] over the
// planes the stage pulls at node x (stage_b<0>), lam_in[k](y) =
// q[k](y + e_k) with the forward's periodic wrap, plus lam_out[k](y) for a
// plane the stage does not write (it passes through).  A block computes
// q on a 32x32 tile into dynamic shared memory (19 planes x 1024 nodes x
// 4 B = 77.8 KB for d2q9_heat_adj), then each of its 30x30 output nodes
// (the tile inside the one-node ring) gathers, at two blocks an SM: 32x16
// threads, two rows a thread (<= 64 registers), or, for a stage whose q
// has B_NARROW_MIN_PLANES slots or more (d2q9_heat_adj's reverse spills
// 168 B at 64), 32x8 threads, four rows a thread (<= 128).  The settings
// cotangent counts the output nodes only, never the ring (the reference
// masks its band margins the same way, pallas_adjoint.py:882-889):
// per-thread double sums over the thread's nodes, one partial per block,
// the last block adds the partials in block order, all sums at once (no
// float atomics; finish_sums' kAllSums: one sum at a time made the sums
// cost more than the reverse physics).  Zonal and aux cotangents are not
// emitted (the reference's aux_grad is false outside its series
// flavour).
//
// Bound by bytes: a node reads the primal's 19 planes, its flag and
// lam_out's 19 planes and writes lam_in's 19 (232 B); the recompute and
// reverse are a few hundred flops.  The ring's q is computed twice where
// blocks overlap: 1024 nodes of q for 900 output nodes (1.14; a 32x16
// tile: 1.22), and one block reduction for 900 (was 420).
//
// Field reads.  A stage that reads a Field through c.load (d2q9_kuper_adj's
// Run: phi over the psi stencil) returns the cotangent of each read
// through c.set_load(j, v): the header lists the reads, b_loads(s) of them,
// read j of plane load_k(s, j) at (load_dx(s, j), load_dy(s, j)), each at
// most one node away.  A read at x + d lands its cotangent on x + d, so
// the gather adds q_load_j(y - d) into plane load_k's cotangent at y: a
// slot of the q tile each, as a pull's.
//
// Two stages (d2q9_kuper_adj: Run, then CalcPhi).  The
// step's output holds stage 0's planes (stage 1 writes others), so stage
// 1's inputs are the primal output's planes stage 0 writes and the primal
// input's others.  Two launches of the one-stage kernel, one for each
// stage's reverse, last stage first: stage 1's reverse on the primal
// output gathers lam_mid, the cotangent of the state after stage 0 (lam_out
// passing through where stage 1 does not write); stage 0's on the primal
// input gathers lam_in from lam_mid.  lam_mid is a scratch stack of
// N_STORAGE planes, written once and read once (it adds 8 B a plane and
// node to the 12 of one launch); each launch's settings sums are its own
// and the second adds the first's totals to its own, so a run stays
// deterministic.  One launch that recomputes stage 0 over a wider ring
// would spare the scratch and read the primal once, but computes stage 0
// 1.3 times a node and needs both stages' q in shared memory.

static_assert(model::N_STAGES <= 2
                  && model::stage_ext(model::N_STAGES - 1) == 0,
              "generic2d_step_b reverses a one- or two-stage action");
static_assert(model::N_STAGES == 1
                  || (model::stage_writes(0) & model::stage_writes(1)) == 0,
              "a two-stage reverse reads stage 0's planes from the step's "
              "output: the stages write disjoint planes");

// A header without Field reads to reverse finds these defaults through
// the using-directive (qualified lookup reads a namespace's own
// declaration first).
namespace model {
namespace reverse_defaults {
__host__ __device__ constexpr int b_loads(int) { return 0; }
__host__ __device__ constexpr int load_k(int, int) { return 0; }
__host__ __device__ constexpr int load_dx(int, int) { return 0; }
__host__ __device__ constexpr int load_dy(int, int) { return 0; }
}  // namespace reverse_defaults
using namespace reverse_defaults;
}  // namespace model

// The reverse tile (ops/generic_kernels.py:step_b_tile mirrors it): q on
// BQ x BQ nodes, a block of b_rows rows of BQ threads, BQ / b_rows rows a
// thread, at least B_BLOCKS blocks an SM; the output tile inside the ring
// B_RING, the stage's pull reach.  q has a slot for each plane and for
// each Field read of the stage (b_nq).
constexpr int B_NARROW_MIN_PLANES = 16;
constexpr int BQ = 32, B_BLOCKS = 2;
constexpr int B_RING = 1;
constexpr int BTX = BQ - 2 * B_RING, BTY = BQ - 2 * B_RING;
constexpr int NS_SETT = model::N_SETTINGS;
template <int S>
__host__ __device__ constexpr int b_nq() {
  return model::N_STORAGE + model::b_loads(S);
}
template <int S>
__host__ __device__ constexpr int b_rows() {
  return b_nq<S>() >= B_NARROW_MIN_PLANES ? 8 : 16;
}
template <int S>
__host__ __device__ constexpr int b_threads() {
  return BQ * b_rows<S>();
}
template <int S>
__host__ __device__ constexpr size_t b_smem() {
  return sizeof(float) * b_nq<S>() * BQ * BQ;
}
__host__ __device__ constexpr bool loads_one_node(int s) {
  for (int j = 0; j < model::b_loads(s); ++j)
    if (model::load_dx(s, j) < -1 || model::load_dx(s, j) > 1
        || model::load_dy(s, j) < -1 || model::load_dy(s, j) > 1)
      return false;
  return true;
}
static_assert(loads_one_node(0) && loads_one_node(model::N_STAGES - 1),
              "a reversed Field read lies one node away at most");
static_assert(BQ % b_rows<0>() == 0 && BQ % b_rows<model::N_STAGES - 1>()
                  == 0, "whole rows a thread");
static_assert(B_BLOCKS * (b_smem<0>() + 1024) <= 228 * 1024
                  && B_BLOCKS * (b_smem<model::N_STAGES - 1>() + 1024)
                         <= 228 * 1024,
              "B_BLOCKS tiles of q fit an SM's shared memory");

// what stage S of the reverse reads: a plane an earlier stage wrote from
// the step's output, any other from the step's input
template <int S>
struct StepStorageB {
  DeviceStorage<false> out, in;
  __device__ float get(int k, int y, int x) const {
    return (S > 0 && writes(0, k)) ? out.get(k, y, x) : in.get(k, y, x);
  }
};

// what stage_b<S> sees: the forward's node context, plus the cotangents
// it reads and writes
template <int S>
struct NodeB {
  const GenericArgs& a;
  const StepStorageB<S>& s;
  const float* ztab;       // [N_ZONAL][zone_max]
  const float* lam_out;    // [N_STORAGE][ny][nx] the stage's output's
  const float* lam_g;      // [N_GLOBALS]
  float* q;                // [b_nq<S>()] this node's pulled and read
                           // planes' cotangents
  double* sacc;            // [N_SETTINGS] this thread's settings sums
  int y, x, flag;
  size_t idx;              // the node, wrapped
  bool counts;             // an output node: its settings cotangent counts

  __device__ float pulled(int k) const {
    return s.get(k, y - model::ey(k), x - model::ex(k));
  }
  __device__ float load(int k, int dx, int dy) const {
    return s.get(k, y + dy, x + dx);
  }
  __device__ float setting(int i) const { return a.setting[i]; }
  __device__ float zonal(int j) const {
    return zonal_value<false>(a, ztab, SeriesArgs{}, j, flag);
  }
  __device__ bool nt_is(int t) const {
    return (flag & a.nt_mask[t]) == a.nt_val[t];
  }
  __device__ bool nt_in_group(int g) const {
    return (flag & a.group_mask[g]) != 0;
  }
  __device__ float lam(int k) const {
    return __ldg(lam_out + k * (size_t)a.ny * a.nx + idx);
  }
  __device__ float lam_global(int g) const { return __ldg(lam_g + g); }
  __device__ void add_setting(int i, float v) const {
    if (counts) sacc[i] += (double)v;
  }
  __device__ void set_q(int k, float v) const { q[k] = v; }
  // the cotangent of the header's Field read j of this stage
  __device__ void set_load(int j, float v) const {
    q[model::N_STORAGE + j] = v;
  }
};

__device__ unsigned int g_blocks_done_b = 0;   // one launch at a time

// The reverse of stage S over the lattice: lam_dst = the gathered q plus
// lam_src where stage S does not write the plane; the settings cotangent
// of stage S, plus sett_prev's totals where given, into sett_out.
template <int S>
__global__ void __launch_bounds__(b_threads<S>(), B_BLOCKS)
generic2d_step_b_kernel(const float* __restrict__ fin,
                        const float* __restrict__ fout,
                        const float* __restrict__ lam_src,
                        const int* __restrict__ flags,
                        const float* __restrict__ ztab, const GenericArgs a,
                        const float* __restrict__ lam_g,
                        float* __restrict__ lam_dst, double* partials,
                        const double* sett_prev, double* sett_out) {
  constexpr int NQ = b_nq<S>(), ROWS = b_rows<S>();
  extern __shared__ float qtile[];                 // [NQ][BQ][BQ]
  const size_t n = (size_t)a.ny * a.nx;
  const int lx = threadIdx.x % BQ, ly0 = threadIdx.x / BQ;
  // the block's tile starts B_RING nodes before its output tile
  const int y0 = blockIdx.y * BTY - B_RING, x0 = blockIdx.x * BTX - B_RING;
  const int x = x0 + lx, wx = wrap(x, a.nx);
  const bool out_col = lx >= B_RING && lx < BQ - B_RING && x < a.nx;
  double sacc[NS_SETT];
#pragma unroll
  for (int i = 0; i < NS_SETT; ++i) sacc[i] = 0.0;
  const StepStorageB<S> in{DeviceStorage<false>{fout, a.ny, a.nx},
                           DeviceStorage<false>{fin, a.ny, a.nx}};
#pragma unroll 1
  for (int ly = ly0; ly < BQ; ly += ROWS) {
    const int y = y0 + ly;
    const bool out_node = out_col && ly >= B_RING && ly < BQ - B_RING
                          && y < a.ny;
    const size_t node = (size_t)wrap(y, a.ny) * a.nx + wx;
    float q[NQ];
    NodeB<S> c{a, in, ztab, lam_src, lam_g, q, sacc, y, x,
               __ldg(flags + node), node, out_node};
    model::stage_b<S>(c);
#pragma unroll
    for (int k = 0; k < NQ; ++k)
      qtile[(k * BQ + ly) * BQ + lx] = q[k];
  }
  __syncthreads();
#pragma unroll 1
  for (int ly = ly0; ly < BQ; ly += ROWS) {
    const int y = y0 + ly;
    if (!(out_col && ly >= B_RING && ly < BQ - B_RING && y < a.ny)) continue;
    const size_t idx = (size_t)y * a.nx + x;
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k) {
      float v = qtile[(k * BQ + ly + model::ey(k)) * BQ + lx + model::ex(k)];
#pragma unroll
      for (int j = 0; j < model::b_loads(S); ++j)
        if (model::load_k(S, j) == k)
          v += qtile[((model::N_STORAGE + j) * BQ + ly
                      - model::load_dy(S, j)) * BQ
                     + lx - model::load_dx(S, j)];
      if (!writes(S, k)) v += lam_src[k * n + idx];
      lam_dst[k * n + idx] = v;
    }
  }
  finish_sums<NS_SETT, b_threads<S>(), true>(
      sacc, partials, &g_blocks_done_b, [sett_prev, sett_out](int i,
                                                              double t) {
        sett_out[i] = sett_prev ? sett_prev[i] + t : t;
      });
}

// one launch of the reverse of stage S on `stream`
template <int S>
static cudaError_t launch_step_b(const float* fin, const float* fout,
                                 const float* lam_src, const int* flags,
                                 const float* ztab, const GenericArgs& a,
                                 const float* lam_g, float* lam_dst,
                                 double* partials, const double* sett_prev,
                                 double* sett_out, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      generic2d_step_b_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b_smem<S>());
  if (e != cudaSuccess) return e;
  const dim3 grid((a.nx + BTX - 1) / BTX, (a.ny + BTY - 1) / BTY);
  generic2d_step_b_kernel<S><<<grid, b_threads<S>(), b_smem<S>(), stream>>>(
      fin, fout, lam_src, flags, ztab, a, lam_g, lam_dst, partials,
      sett_prev, sett_out);
  return cudaGetLastError();
}

// The launches of a plan of NST stages (a template, so that a library
// instantiates its own plan's only): a two-stage plan's stage 1 reverse
// into lam_mid and sett_mid, then stage 0's from them; a one-stage plan's
// stage 0 reverse from lam_out.
template <int NST>
static cudaError_t launch_reverse(const float* fin, const float* fout,
                                  const float* lam_out, const int* flags,
                                  const float* ztab, const GenericArgs& a,
                                  const float* lam_g, float* lam_mid,
                                  float* lam_in, double* partials,
                                  double* sett_mid, double* sett_out,
                                  cudaStream_t stream) {
  if constexpr (NST == 2) {
    const cudaError_t e = launch_step_b<1>(fin, fout, lam_out, flags, ztab,
                                           a, lam_g, lam_mid, partials,
                                           nullptr, sett_mid, stream);
    if (e != cudaSuccess) return e;
    return launch_step_b<0>(fin, nullptr, lam_mid, flags, ztab, a, lam_g,
                            lam_in, partials, sett_mid, sett_out, stream);
  } else {
    return launch_step_b<0>(fin, nullptr, lam_out, flags, ztab, a, lam_g,
                            lam_in, partials, nullptr, sett_out, stream);
  }
}

extern "C" {

// The output tile of a generic2d_step_b block (its partials are one per
// block, in each launch).
void generic2d_step_b_tile(int* tile_y, int* tile_x) {
  *tile_y = BTY;
  *tile_x = BTX;
}

// The slots of q in the reverse of stage s (a plane each, and a Field
// read each of the stage's; 4 B a slot and node of the BQ x BQ tile in
// shared memory), -1 for a stage the plan has not.
int generic2d_step_b_slots(int s) {
  if (s == 0) return b_nq<0>();
  if (s == 1 && model::N_STAGES == 2) return b_nq<model::N_STAGES - 1>();
  return -1;
}

// The zonal settings generic2d_step_b reads from its zone table (a
// library built before the backward read zonal settings exports no such
// entry, and its generic2d_step_b takes no zone table).
int generic2d_step_b_zonal() { return model::N_ZONAL; }

// lam_in (n_storage planes), partials (one double per block and setting)
// and sett_out (n_settings doubles) are written; fin, lam_out, flags, the
// zone table ztab (n_zonal x zone_max floats) and lam_g (n_globals floats)
// are read.  A two-stage plan also reads the step's primal output fout
// and launches twice on `stream` (launch_reverse), writing lam_mid
// (n_storage planes) and sett_mid (n_settings doubles) on the way, and
// sett_out is the sum of both stages'; a one-stage plan launches once and
// touches none of fout, lam_mid and sett_mid.
int generic2d_step_b(const float* fin, const float* fout,
                     const float* lam_out, const int* flags,
                     const float* ztab, const GenericArgs* a,
                     const float* lam_g, float* lam_mid, float* lam_in,
                     double* partials, double* sett_mid, double* sett_out,
                     int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reverse<model::N_STAGES>(
      fin, fout, lam_out, flags, ztab, *a, lam_g, lam_mid, lam_in, partials,
      sett_mid, sett_out, (cudaStream_t)stream);
}

}  // extern "C"
