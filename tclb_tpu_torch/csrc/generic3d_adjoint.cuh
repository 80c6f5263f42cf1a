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
// Design: q goes through a device scratch.  generic3d_step_b_q computes q
// at every node (one thread per node, 32x8 (x, y) blocks per z-plane, as
// the forward) into the scratch stack and sums the settings cotangent;
// generic3d_step_b_gather then reads q at each node's 19 upstream
// neighbours through L1/L2.  Every node's q is computed once (no ring
// recompute); the price is the scratch's write and read, 160 B a node of
// d3q19_adj on top of the 244 B the function must move (the primal's 20
// planes, the flag and lam_out's 20 planes read, lam_in's 20 written).
// Keeping q of a tile and its ring in shared memory while marching up z is
// later work.
//
// The settings cotangent counts each node once: per-thread double sums, one
// partial per block, the last block adds the partials in block order (no
// float atomics).  Zonal and aux cotangents are not emitted (the
// reference's non-series 3D flavour returns zeros there,
// pallas_adjoint.py:381-388).

static_assert(model::N_STAGES == 1 && model::stage_ext(0) == 0,
              "generic3d_step_b reverses a one-stage action");

constexpr int NS_SETT = model::N_SETTINGS;

// what stage_b<0> sees: the forward's node context, plus the cotangents
// it reads and writes
struct Node3B {
  const GenericArgs& a;
  const Storage3& s;
  const float* ztab;
  const float* lam_out;    // [N_STORAGE][nz][ny][nx]
  const float* lam_g;      // [N_GLOBALS]
  float* q;                // [N_STORAGE] this node's pulled cotangents
  double* sacc;            // [N_SETTINGS] this thread's settings sums
  size_t idx, n;
  int z, y, x, flag;

  __device__ float pulled(int k) const {
    return s.get(k, z - model::ez(k), y - model::ey(k), x - model::ex(k));
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
  __device__ void add_setting(int i, float v) const { sacc[i] += (double)v; }
  __device__ void set_q(int k, float v) const { q[k] = v; }
};

__device__ unsigned int g_blocks_done3_b = 0;   // one launch at a time

__global__ void __launch_bounds__(BX * BY)
generic3d_step_b_q_kernel(const float* __restrict__ fin,
                          const float* __restrict__ lam_out,
                          const int* __restrict__ flags,
                          const float* __restrict__ ztab, const GenericArgs a,
                          const float* __restrict__ lam_g,
                          float* __restrict__ qout, double* partials,
                          double* sett_out) {
  const size_t n = (size_t)a.nz * a.ny * a.nx;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int z = blockIdx.z;
  double sacc[NS_SETT];
#pragma unroll
  for (int i = 0; i < NS_SETT; ++i) sacc[i] = 0.0;
  if (x < a.nx && y < a.ny) {
    const size_t idx = ((size_t)z * a.ny + y) * a.nx + x;
    const Storage3 in{fin, a.nz, a.ny, a.nx};
    float q[model::N_STORAGE];
    Node3B c{a, in, ztab, lam_out, lam_g, q, sacc, idx, n, z, y, x,
             __ldg(flags + idx)};
    model::stage_b<0>(c);
#pragma unroll
    for (int k = 0; k < model::N_STORAGE; ++k) qout[k * n + idx] = q[k];
  }
  finish_sums<NS_SETT, BX * BY>(sacc, partials, &g_blocks_done3_b,
                                [sett_out](int i, double t) {
                                  sett_out[i] = t;
                                });
}

__global__ void __launch_bounds__(BX * BY)
generic3d_step_b_gather_kernel(const float* __restrict__ q,
                               const float* __restrict__ lam_out,
                               const GenericArgs a,
                               float* __restrict__ lam_in) {
  const size_t n = (size_t)a.nz * a.ny * a.nx;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= a.nx || y >= a.ny) return;
  const size_t idx = ((size_t)z * a.ny + y) * a.nx + x;
  const Storage3 qs{q, a.nz, a.ny, a.nx};
#pragma unroll
  for (int k = 0; k < model::N_STORAGE; ++k) {
    float v = qs.get(k, z + model::ez(k), y + model::ey(k), x + model::ex(k));
    if (!writes(0, k)) v += lam_out[k * n + idx];
    lam_in[k * n + idx] = v;
  }
}

extern "C" {

// lam_in (n_storage planes), q (the scratch, n_storage planes), partials
// (one double per generic3d_step block and setting) and sett_out
// (n_settings doubles) are written; fin, lam_out, flags, ztab and lam_g
// (n_globals floats) are read.  Two launches on `stream`, q then the
// gather.
int generic3d_step_b(const float* fin, const float* lam_out, const int* flags,
                     const float* ztab, const GenericArgs* a,
                     const float* lam_g, float* lam_in, float* q,
                     double* partials, double* sett_out, int device,
                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + BX - 1) / BX, (a->ny + BY - 1) / BY, a->nz);
  const dim3 block(BX, BY);
  generic3d_step_b_q_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      fin, lam_out, flags, ztab, *a, lam_g, q, partials, sett_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  generic3d_step_b_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      q, lam_out, *a, lam_in);
  return (int)cudaGetLastError();
}

}  // extern "C"
