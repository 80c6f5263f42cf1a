// generic2d_step_b: the reverse of one generic2d_step, for a one-stage
// model whose device header has a hand-written reverse stage_b<0>
// (included at the end of csrc/generic2d.cu where the header defines
// TCLB_MODEL_ADJOINT).
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
// threads, two rows a thread (<= 64 registers), or, for a header of
// B_NARROW_MIN_PLANES planes or more (d2q9_heat_adj's reverse spills 168
// B at 64), 32x8 threads, four rows a thread (<= 128).  The settings
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

static_assert(model::N_STAGES == 1 && model::stage_ext(0) == 0,
              "generic2d_step_b reverses a one-stage action");

// The reverse tile (ops/generic_kernels.py:step_b_tile mirrors it): q on
// BQ x BQ nodes, a block of BQ_ROWS rows of BQ threads, BQ / BQ_ROWS rows
// a thread, at least B_BLOCKS blocks an SM; the output tile inside the
// ring B_RING, the stage's pull reach.
constexpr int B_NARROW_MIN_PLANES = 16;
constexpr int BQ = 32, B_BLOCKS = 2;
constexpr int BQ_ROWS = model::N_STORAGE >= B_NARROW_MIN_PLANES ? 8 : 16;
constexpr int B_RING = 1;
constexpr int BTX = BQ - 2 * B_RING, BTY = BQ - 2 * B_RING;
constexpr int B_THREADS = BQ * BQ_ROWS;
constexpr size_t B_SMEM = sizeof(float) * model::N_STORAGE * BQ * BQ;
constexpr int NS_SETT = model::N_SETTINGS;
static_assert(BQ % BQ_ROWS == 0, "whole rows a thread");
static_assert(B_BLOCKS * (B_SMEM + 1024) <= 228 * 1024,
              "B_BLOCKS tiles of q fit an SM's shared memory");

// what stage_b<0> sees: the forward's node context, plus the cotangents
// it reads and writes
struct NodeB {
  const GenericArgs& a;
  const DeviceStorage<false>& s;
  const float* ztab;       // [N_ZONAL][zone_max]
  const float* lam_out;    // [N_STORAGE][ny][nx]
  const float* lam_g;      // [N_GLOBALS]
  float* q;                // [N_STORAGE] this node's pulled cotangents
  double* sacc;            // [N_SETTINGS] this thread's settings sums
  int y, x, flag;
  size_t idx;              // the node, wrapped
  bool counts;             // an output node: its settings cotangent counts

  __device__ float pulled(int k) const {
    return s.get(k, y - model::ey(k), x - model::ex(k));
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
};

__device__ unsigned int g_blocks_done_b = 0;   // one launch at a time

__global__ void __launch_bounds__(B_THREADS, B_BLOCKS)
generic2d_step_b_kernel(const float* __restrict__ fin,
                        const float* __restrict__ lam_out,
                        const int* __restrict__ flags,
                        const float* __restrict__ ztab, const GenericArgs a,
                        const float* __restrict__ lam_g,
                        float* __restrict__ lam_in, double* partials,
                        double* sett_out) {
  extern __shared__ float qtile[];                 // [N_STORAGE][BQ][BQ]
  const size_t n = (size_t)a.ny * a.nx;
  const int lx = threadIdx.x % BQ, ly0 = threadIdx.x / BQ;
  // the block's tile starts B_RING nodes before its output tile
  const int y0 = blockIdx.y * BTY - B_RING, x0 = blockIdx.x * BTX - B_RING;
  const int x = x0 + lx, wx = wrap(x, a.nx);
  const bool out_col = lx >= B_RING && lx < BQ - B_RING && x < a.nx;
  double sacc[NS_SETT];
#pragma unroll
  for (int i = 0; i < NS_SETT; ++i) sacc[i] = 0.0;
  const DeviceStorage<false> in{fin, a.ny, a.nx};
#pragma unroll 1
  for (int ly = ly0; ly < BQ; ly += BQ_ROWS) {
    const int y = y0 + ly;
    const bool out_node = out_col && ly >= B_RING && ly < BQ - B_RING
                          && y < a.ny;
    const size_t node = (size_t)wrap(y, a.ny) * a.nx + wx;
    float q[model::N_STORAGE];
    NodeB c{a, in, ztab, lam_out, lam_g, q, sacc, y, x,
            __ldg(flags + node), node, out_node};
    model::stage_b<0>(c);
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k)
      qtile[(k * BQ + ly) * BQ + lx] = q[k];
  }
  __syncthreads();
#pragma unroll 1
  for (int ly = ly0; ly < BQ; ly += BQ_ROWS) {
    const int y = y0 + ly;
    if (!(out_col && ly >= B_RING && ly < BQ - B_RING && y < a.ny)) continue;
    const size_t idx = (size_t)y * a.nx + x;
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k) {
      float v = qtile[(k * BQ + ly + model::ey(k)) * BQ + lx + model::ex(k)];
      if (!writes(0, k)) v += lam_out[k * n + idx];
      lam_in[k * n + idx] = v;
    }
  }
  finish_sums<NS_SETT, B_THREADS, true>(
      sacc, partials, &g_blocks_done_b,
      [sett_out](int i, double t) { sett_out[i] = t; });
}

extern "C" {

// The output tile of a generic2d_step_b block (its partials are one per
// block).
void generic2d_step_b_tile(int* tile_y, int* tile_x) {
  *tile_y = BTY;
  *tile_x = BTX;
}

// The zonal settings generic2d_step_b reads from its zone table (a
// library built before the backward read zonal settings exports no such
// entry, and its generic2d_step_b takes no zone table).
int generic2d_step_b_zonal() { return model::N_ZONAL; }

// lam_in (n_storage planes), partials (one double per block and setting)
// and sett_out (n_settings doubles) are written; fin, lam_out, flags, the
// zone table ztab (n_zonal x zone_max floats) and lam_g (n_globals floats)
// are read.
int generic2d_step_b(const float* fin, const float* lam_out, const int* flags,
                     const float* ztab, const GenericArgs* a,
                     const float* lam_g, float* lam_in, double* partials,
                     double* sett_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(generic2d_step_b_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)B_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + BTX - 1) / BTX, (a->ny + BTY - 1) / BTY);
  generic2d_step_b_kernel<<<grid, B_THREADS, B_SMEM,
                            (cudaStream_t)stream>>>(
      fin, lam_out, flags, ztab, *a, lam_g, lam_in, partials, sett_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
