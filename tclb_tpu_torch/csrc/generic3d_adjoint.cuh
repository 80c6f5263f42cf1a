// generic3d_step_b: the reverse of one generic3d_step, for a one-stage 3D
// model whose device header has a hand-written reverse stage_b<0>
// (included at the end of csrc/generic3d.cu where the header defines
// TCLB_MODEL_ADJOINT).
//
// Replaces tclb_tpu/ops/pallas_adjoint.py:_mk_call_bwd_3d (the z-slab
// backward kernel of _make_diff_step_3d) at chunk k = 1: given the primal
// input of the step, the cotangent lam_out of its output planes and lam_g
// of its SUM globals,
//
//   lam_in = (d step / d fields)^T lam_out + (d globals / d fields)^T lam_g
//
// and the cotangent of the settings vector.  Pull streaming makes the
// transpose a gather: with q(x) = J(x)^T [lam_out(x), lam_g] over the
// planes the stage pulls at node x (stage_b<0>), lam_in[k](y) =
// q[k](y + e_k) with the forward's periodic wrap on all three axes, plus
// lam_out[k](y) for a plane the stage does not write (it passes through).
//
// Design: the gather run backwards, a push.  Each q[k](x) is read by one
// node only, y = x - e_k, so the thread that computes q at x writes it
// straight to lam_in[k](x - e_k) (adding lam_out there for a plane that
// passes through, in the gather's order): one launch, no scratch, no ring
// and no node computed twice.  A warp's stores of a plane land on 32
// neighbouring floats shifted by at most one node, in sectors the next
// warp's stores share.  One thread a (x, y) column of a 32x8 block walks
// B_PLANES z-planes, so its settings sums cover that many nodes before the
// block reduces them, and the grid holds B_PLANES times fewer blocks,
// partials and block reductions; the last block adds the partials all
// sums at once (finish_sums' kAllSums).  A thread's sums live in shared
// memory over the walk (a column of doubles a thread, 34,816 B a block
// for d3q19_adj's 17 settings): held in registers, they made the reverse
// spill 156 B a thread at two blocks an SM.  Each node's upstream and
// downstream neighbours are wrapped once a node, not once a plane.
//
// Bound by bytes: a d3q19_adj node reads the primal's 20 planes, its flag
// and lam_out's 20 planes and writes lam_in's 20 (244 B), the recomputed
// forward and the reverse a few thousand flops.  The settings cotangent
// counts each node once: per-thread double sums, one partial per block,
// the last block adds the partials in block order (no float atomics, so a
// run is deterministic).  Zonal and aux cotangents are not emitted (the
// reference's non-series 3D flavour returns zeros there,
// pallas_adjoint.py:381-388).

static_assert(model::N_STAGES == 1 && model::stage_ext(0) == 0,
              "generic3d_step_b reverses a one-stage action");

__host__ __device__ constexpr bool pulls_one_node() {
  for (int k = 0; k < model::N_STORAGE; ++k)
    if (model::ex(k) < -1 || model::ex(k) > 1 || model::ey(k) < -1
        || model::ey(k) > 1 || model::ez(k) < -1 || model::ez(k) > 1)
      return false;
  return true;
}
static_assert(pulls_one_node(), "the reverse pushes one node far");

// The reverse grid (generic3d_step_b_tile exports it): a
// BX x BY block of threads, each walking B_PLANES z-planes of its column,
// at least B_BLOCKS blocks an SM.
constexpr int B_PLANES = 8, B_BLOCKS = 2;
constexpr int NS_SETT = model::N_SETTINGS;

// (z, y, x) - 1, itself and + 1, each wrapped, as offsets of the node
// index (int: generic3d_step_b takes fewer than 2^31 nodes); element
// 1 + d of each axis is the neighbour at d
struct Around3 {
  int z[3], y[3], x[3];
  __device__ Around3(int zi, int yi, int xi, const GenericArgs& a) {
    const int plane = a.ny * a.nx;
    z[0] = (zi == 0 ? a.nz - 1 : zi - 1) * plane;
    z[1] = zi * plane;
    z[2] = (zi == a.nz - 1 ? 0 : zi + 1) * plane;
    y[0] = (yi == 0 ? a.ny - 1 : yi - 1) * a.nx;
    y[1] = yi * a.nx;
    y[2] = (yi == a.ny - 1 ? 0 : yi + 1) * a.nx;
    x[0] = xi == 0 ? a.nx - 1 : xi - 1;
    x[1] = xi;
    x[2] = xi == a.nx - 1 ? 0 : xi + 1;
  }
  // the node at (dz, dy, dx), each in -1 .. 1
  __device__ size_t at(int dz, int dy, int dx) const {
    return (size_t)(unsigned)(z[1 + dz] + y[1 + dy] + x[1 + dx]);
  }
};

// what stage_b<0> sees: the forward's node context, plus the cotangents
// it reads and writes
struct Node3B {
  const GenericArgs& a;
  const float* fin;        // [N_STORAGE][nz][ny][nx]
  const Around3& nb;
  const float* ztab;
  const float* lam_out;    // [N_STORAGE][nz][ny][nx]
  const float* lam_g;      // [N_GLOBALS]
  float* q;                // [N_STORAGE] this node's pulled cotangents
  double* sacc;            // this thread's settings sums, BX * BY apart
  size_t idx, n;
  int flag;

  __device__ float pulled(int k) const {
    return __ldg(fin + k * n
                 + nb.at(-model::ez(k), -model::ey(k), -model::ex(k)));
  }
  __device__ float setting(int i) const { return a.setting[i]; }
  __device__ float zonal(int j) const {
    return __ldg(ztab + j * a.zone_max + (flag >> a.zone_shift));
  }
  __device__ bool nt_is(int t) const {
    return (flag & a.nt_mask[t]) == a.nt_val[t];
  }
  __device__ bool nt_in_group(int g) const {
    return (flag & a.group_mask[g]) != 0;
  }
  __device__ float lam(int k) const { return __ldg(lam_out + k * n + idx); }
  __device__ float lam_global(int g) const { return __ldg(lam_g + g); }
  __device__ void add_setting(int i, float v) const {
    sacc[i * (BX * BY)] += (double)v;
  }
  __device__ void set_q(int k, float v) const { q[k] = v; }
};

__device__ unsigned int g_blocks_done3_b = 0;   // one launch at a time

__global__ void __launch_bounds__(BX * BY, B_BLOCKS)
generic3d_step_b_kernel(const float* __restrict__ fin,
                        const float* __restrict__ lam_out,
                        const int* __restrict__ flags,
                        const float* __restrict__ ztab, const GenericArgs a,
                        const float* __restrict__ lam_g,
                        float* __restrict__ lam_in, double* partials,
                        double* sett_out) {
  // each thread's settings sums, a column of doubles a thread: out of the
  // registers the reverse needs over the z walk
  __shared__ double ssum[NS_SETT][BX * BY];
  const size_t n = (size_t)a.nz * a.ny * a.nx;
  const int tid = threadIdx.x + BX * threadIdx.y;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int z0 = blockIdx.z * B_PLANES;
  const int z1 = min(z0 + B_PLANES, a.nz);
#pragma unroll
  for (int i = 0; i < NS_SETT; ++i) ssum[i][tid] = 0.0;
  if (x < a.nx && y < a.ny) {
#pragma unroll 1
    for (int z = z0; z < z1; ++z) {
      const Around3 nb(z, y, x, a);
      const size_t idx = nb.at(0, 0, 0);
      float q[model::N_STORAGE];
      Node3B c{a, fin, nb, ztab, lam_out, lam_g, q, &ssum[0][tid], idx, n,
               __ldg(flags + idx)};
      model::stage_b<0>(c);
      // lam_in[k](x - e_k) = q[k](x), plus lam_out there where the stage
      // does not write plane k
#pragma unroll
      for (int k = 0; k < model::N_STORAGE; ++k) {
        const size_t to = k * n + nb.at(-model::ez(k), -model::ey(k),
                                        -model::ex(k));
        float v = q[k];
        if (!writes(0, k)) v += lam_out[to];
        lam_in[to] = v;
      }
    }
  }
  double sacc[NS_SETT];
#pragma unroll
  for (int i = 0; i < NS_SETT; ++i) sacc[i] = ssum[i][tid];
  finish_sums<NS_SETT, BX * BY, true>(sacc, partials, &g_blocks_done3_b,
                                      [sett_out](int i, double t) {
                                        sett_out[i] = t;
                                      });
}

extern "C" {

// The grid of a generic3d_step_b launch: a block's z-planes and (y, x)
// extent (its partials are one per block).
void generic3d_step_b_tile(int* tile_z, int* tile_y, int* tile_x) {
  *tile_z = B_PLANES;
  *tile_y = BY;
  *tile_x = BX;
}

// lam_in (n_storage planes), partials (one double per block and setting)
// and sett_out (n_settings doubles) are written; fin, lam_out, flags,
// ztab and lam_g (n_globals floats) are read.  One launch on `stream`.
int generic3d_step_b(const float* fin, const float* lam_out, const int* flags,
                     const float* ztab, const GenericArgs* a,
                     const float* lam_g, float* lam_in, double* partials,
                     double* sett_out, int device, void* stream) {
  if ((long long)a->nz * a->ny * a->nx > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + BX - 1) / BX, (a->ny + BY - 1) / BY,
                  (a->nz + B_PLANES - 1) / B_PLANES);
  generic3d_step_b_kernel<<<grid, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      fin, lam_out, flags, ztab, *a, lam_g, lam_in, partials, sett_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
