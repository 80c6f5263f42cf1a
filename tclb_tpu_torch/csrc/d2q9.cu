// d2q9 collide-stream kernels for Hopper (sm_90a).
//
// One node update (pull, boundary dispatch on the node's flag, MRT collision
// with body force) shared by three kernels:
//
//   d2q9_step       one thread per node, one step, periodic pulls straight
//                   from global memory into a second buffer
//                   (replaces tclb_tpu/ops/pallas_d2q9.py:make_pallas_iterate,
//                   the single-step `call`);
//   d2q9_step2      two fused steps per 32x8 tile: the tile plus a two-node
//                   ring of all 9 populations and the statics of the one-node
//                   ring are staged in shared memory; step 1 runs on the tile
//                   extended by one node, step 2 on the tile
//                   (replaces make_pallas_iterate's fused `call2`);
//   d2q9_resident8  a persistent cooperative kernel running 8 steps with a
//                   grid-wide barrier between them; two global buffers
//                   ping-pong and, for lattices the size of karman.xml, stay
//                   in the 50 MB L2 (replaces make_resident_iterate).
//
// Every kernel reads the BC coupling planes, copies every plane past the 9
// populations through unchanged, and computes no globals (the NoGlobals
// flavour: the engine's trailing eager step computes them).
//
// Nothing about the model is hard-coded beyond the d2q9 population order the
// Zou/He and symmetry closures are written for: streaming vectors, weights,
// bounce-back pairs, node-type masks/values, the MRT basis rows and the
// inverse-basis columns all arrive in D2q9Args, filled from the registry and
// from the same numpy code the plain PyTorch version uses.
//
// Plain C interface (loaded with ctypes); every entry returns the CUDA error
// code of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// node-type cases, in the order the model applies them
enum {
  CASE_WALL = 0, CASE_SOLID, CASE_EVELOCITY, CASE_WPRESSURE, CASE_WVELOCITY,
  CASE_EPRESSURE, CASE_TOPSYM, CASE_BOTTOMSYM, N_CASES
};

struct D2q9Args {
  int ny, nx;
  int n_storage;           // planes in the field stack
  int bc[2];               // planes of BC[0], BC[1]
  int ex[9], ey[9];        // streaming vectors
  int opp[9];              // bounce-back pairs
  float w[9];              // lattice weights
  float m[6][9];           // MRT basis rows 3..8
  float minv[9][6];        // inverse-basis columns 3..8
  float rate[6];           // S3, S4, S56, S56, S78, S78
  float gx, gy;            // GravitationX, GravitationY
  int case_mask[N_CASES], case_val[N_CASES];
  int mrt_mask, mrt_val;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ bool is_type(const D2q9Args& a, int flag, int c) {
  return (flag & a.case_mask[c]) == a.case_val[c];
}

__device__ __forceinline__ void equilibrium(const D2q9Args& a, float rho,
                                            float ux, float uy, float* feq) {
  const float usq = ux * ux + uy * uy;
  const float base = 1.f - 1.5f * usq;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eu = a.ex[k] * ux + a.ey[k] * uy;
    feq[k] = a.w[k] * rho * (base + eu * (3.f + 4.5f * eu));
  }
}

// Zou/He on an x-normal face; `west` selects the face, `velocity` whether
// `value` is the imposed ux (else the imposed density).
__device__ __forceinline__ void zou_he_x(float* f, float value, bool west,
                                         bool velocity) {
  const float tang = f[0] + f[2] + f[4];
  if (west) {
    const float known = f[3] + f[7] + f[6];
    float rho, ux;
    if (velocity) { ux = value; rho = (tang + 2.f * known) / (1.f - ux); }
    else { rho = value; ux = 1.f - (tang + 2.f * known) / rho; }
    const float ru = rho * ux;
    f[1] = f[3] + (2.f / 3.f) * ru;
    f[5] = f[7] + (1.f / 6.f) * ru + 0.5f * (f[4] - f[2]);
    f[8] = f[6] + (1.f / 6.f) * ru + 0.5f * (f[2] - f[4]);
  } else {
    const float known = f[1] + f[5] + f[8];
    float rho, ux;
    if (velocity) { ux = value; rho = (tang + 2.f * known) / (1.f + ux); }
    else { rho = value; ux = -1.f + (tang + 2.f * known) / rho; }
    const float ru = rho * ux;
    const float f7 = f[5] - (1.f / 6.f) * ru + 0.5f * (f[2] - f[4]);
    const float f6 = f[8] - (1.f / 6.f) * ru + 0.5f * (f[4] - f[2]);
    f[3] = f[1] - (2.f / 3.f) * ru;
    f[7] = f7;
    f[6] = f6;
  }
}

// One node: `f` holds the pulled populations on entry and the updated ones
// on exit.  Boundary cases apply in the model's order, each to the result of
// the previous one (a node matches at most one), then MRT where its bit is
// set.
__device__ __forceinline__ void node_update(const D2q9Args& a, float* f,
                                            int flag, float vel, float den,
                                            float bc0, float bc1) {
  if (is_type(a, flag, CASE_WALL) || is_type(a, flag, CASE_SOLID)) {
    // g[k] = f[opp[k]] as selects: a runtime index into f would move the
    // populations out of registers into local memory
    float g[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float v = f[0];
#pragma unroll
      for (int j = 1; j < 9; ++j) v = (a.opp[k] == j) ? f[j] : v;
      g[k] = v;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = g[k];
  }
  if (is_type(a, flag, CASE_EVELOCITY)) zou_he_x(f, vel, false, true);
  if (is_type(a, flag, CASE_WPRESSURE)) zou_he_x(f, den, true, false);
  if (is_type(a, flag, CASE_WVELOCITY)) zou_he_x(f, vel, true, true);
  if (is_type(a, flag, CASE_EPRESSURE)) zou_he_x(f, den, false, false);
  if (is_type(a, flag, CASE_TOPSYM)) {
    f[4] = f[2]; f[7] = f[6]; f[8] = f[5];
  }
  if (is_type(a, flag, CASE_BOTTOMSYM)) {
    f[2] = f[4]; f[5] = f[8]; f[6] = f[7];
  }
  if ((flag & a.mrt_mask) != a.mrt_val) return;

  float rho = f[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += f[k];
  float jx = 0.f, jy = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) { jx += a.ex[k] * f[k]; jy += a.ey[k] * f[k]; }
  const float ux = jx / rho, uy = jy / rho;
  float feq[9];
  equilibrium(a, rho, ux, uy, feq);
  float mneq[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) acc += a.m[i][k] * (f[k] - feq[k]);
    mneq[i] = acc * a.rate[i];
  }
  // the post-force equilibrium: Minv @ (m_neq + M @ feq2) == Minv @ m_neq
  // + feq2, and the conserved moments drop out of Minv @ m_neq
  equilibrium(a, rho, ux + a.gx + bc0, uy + a.gy + bc1, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float acc = feq[k];
#pragma unroll
    for (int i = 0; i < 6; ++i) acc += a.minv[k][i] * mneq[i];
    f[k] = acc;
  }
}

// One node of one step from global memory (periodic pulls).  `src` is
// written by other blocks between the steps of the resident kernel, so there
// (kCoherent) it is read through L2 only (__ldcg), never through the
// read-only path that assumes the data cannot change during the kernel.
template <bool kCoherent>
__device__ __forceinline__ void step_node(const D2q9Args& a, int y, int x,
                                          const float* src, float* dst,
                                          const float* __restrict__ fin,
                                          const int* __restrict__ flags,
                                          const float* __restrict__ vel,
                                          const float* __restrict__ den) {
  const size_t n = (size_t)a.ny * a.nx;
  const size_t idx = (size_t)y * a.nx + x;
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float* p = src + k * n + (size_t)wrap(y - a.ey[k], a.ny) * a.nx
                     + wrap(x - a.ex[k], a.nx);
    f[k] = kCoherent ? __ldcg(p) : __ldg(p);
  }
  node_update(a, f, __ldg(flags + idx), __ldg(vel + idx), __ldg(den + idx),
              __ldg(fin + a.bc[0] * n + idx), __ldg(fin + a.bc[1] * n + idx));
#pragma unroll
  for (int k = 0; k < 9; ++k) dst[k * n + idx] = f[k];
}

__device__ __forceinline__ void copy_static_planes(const D2q9Args& a,
                                                   size_t idx,
                                                   const float* __restrict__ fin,
                                                   float* __restrict__ fout) {
  const size_t n = (size_t)a.ny * a.nx;
  for (int p = 9; p < a.n_storage; ++p) fout[p * n + idx] = fin[p * n + idx];
}

__global__ void __launch_bounds__(256)
d2q9_step_kernel(const float* __restrict__ fin, float* __restrict__ fout,
                 const int* __restrict__ flags, const float* __restrict__ vel,
                 const float* __restrict__ den, const D2q9Args a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.nx || y >= a.ny) return;
  step_node<false>(a, y, x, fin, fout, fin, flags, vel, den);
  copy_static_planes(a, (size_t)y * a.nx + x, fin, fout);
}

#define TX 32
#define TY 8
#define RX (TX + 4)   // tile + two-node ring (step-1 pulls)
#define RY (TY + 4)
#define EX (TX + 2)   // tile + one-node ring (step-1 nodes)
#define EY (TY + 2)

__global__ void __launch_bounds__(TX * TY)
d2q9_step2_kernel(const float* __restrict__ fin, float* __restrict__ fout,
                  const int* __restrict__ flags, const float* __restrict__ vel,
                  const float* __restrict__ den, const D2q9Args a) {
  __shared__ float sf[9][RY][RX];     // input populations, ring 2
  __shared__ float s1[9][EY][EX];     // step-1 populations, ring 1
  __shared__ int sflag[EY][EX];
  __shared__ float svel[EY][EX], sden[EY][EX], sbc0[EY][EX], sbc1[EY][EX];
  const size_t n = (size_t)a.ny * a.nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.x;

  for (int i = tid; i < RY * RX; i += TX * TY) {
    const int ly = i / RX, lx = i - ly * RX;
    const size_t g = (size_t)wrap(y0 - 2 + ly, a.ny) * a.nx
                     + wrap(x0 - 2 + lx, a.nx);
#pragma unroll
    for (int k = 0; k < 9; ++k) sf[k][ly][lx] = fin[k * n + g];
  }
  for (int i = tid; i < EY * EX; i += TX * TY) {
    const int ly = i / EX, lx = i - ly * EX;
    const size_t g = (size_t)wrap(y0 - 1 + ly, a.ny) * a.nx
                     + wrap(x0 - 1 + lx, a.nx);
    sflag[ly][lx] = flags[g];
    svel[ly][lx] = vel[g];
    sden[ly][lx] = den[g];
    sbc0[ly][lx] = fin[a.bc[0] * n + g];
    sbc1[ly][lx] = fin[a.bc[1] * n + g];
  }
  __syncthreads();

  // step 1 on the tile extended by one node
  for (int i = tid; i < EY * EX; i += TX * TY) {
    const int ly = i / EX, lx = i - ly * EX;
    float f[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = sf[k][ly + 1 - a.ey[k]][lx + 1 - a.ex[k]];
    node_update(a, f, sflag[ly][lx], svel[ly][lx], sden[ly][lx],
                sbc0[ly][lx], sbc1[ly][lx]);
#pragma unroll
    for (int k = 0; k < 9; ++k) s1[k][ly][lx] = f[k];
  }
  __syncthreads();

  // step 2 on the tile, one node per thread; the ragged edge is masked
  const int ty = tid / TX, tx = tid - ty * TX;
  const int y = y0 + ty, x = x0 + tx;
  if (y >= a.ny || x >= a.nx) return;
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = s1[k][ty + 1 - a.ey[k]][tx + 1 - a.ex[k]];
  node_update(a, f, sflag[ty + 1][tx + 1], svel[ty + 1][tx + 1],
              sden[ty + 1][tx + 1], sbc0[ty + 1][tx + 1], sbc1[ty + 1][tx + 1]);
  const size_t idx = (size_t)y * a.nx + x;
#pragma unroll
  for (int k = 0; k < 9; ++k) fout[k * n + idx] = f[k];
  copy_static_planes(a, idx, fin, fout);
}

#define RESIDENT_STEPS 8   // even: the ping-pong ends in fout

__global__ void __launch_bounds__(256)
d2q9_resident8_kernel(const float* __restrict__ fin, float* fout,
                      float* scratch, const int* __restrict__ flags,
                      const float* __restrict__ vel,
                      const float* __restrict__ den, const D2q9Args a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.ny * a.nx;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int idx = first; idx < n; idx += stride)
    copy_static_planes(a, idx, fin, fout);
  const float* src = fin;
  float* dst = scratch;
  for (int s = 0; s < RESIDENT_STEPS; ++s) {
    for (int idx = first; idx < n; idx += stride) {
      const int y = idx / a.nx, x = idx - y * a.nx;
      step_node<true>(a, y, x, src, dst, fin, flags, vel, den);
    }
    grid.sync();
    src = dst;
    dst = (dst == scratch) ? fout : scratch;
  }
}

extern "C" {

const char* d2q9_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Whether the device can launch cooperative kernels, and how many blocks of
// d2q9_resident8 can be resident at once (the largest cooperative grid).
int d2q9_resident8_capacity(int device, int* cooperative, int* max_blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, d2q9_resident8_kernel, 256, 0);
  if (e != cudaSuccess) return (int)e;
  *max_blocks = per_sm * sms;
  return 0;
}

int d2q9_step(const float* fin, float* fout, const int* flags,
              const float* vel, const float* den, const D2q9Args* a,
              int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(32, 8);
  const dim3 grid((a->nx + 31) / 32, (a->ny + 7) / 8);
  d2q9_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      fin, fout, flags, vel, den, *a);
  return (int)cudaGetLastError();
}

int d2q9_step2(const float* fin, float* fout, const int* flags,
               const float* vel, const float* den, const D2q9Args* a,
               int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + TX - 1) / TX, (a->ny + TY - 1) / TY);
  d2q9_step2_kernel<<<grid, TX * TY, 0, (cudaStream_t)stream>>>(
      fin, fout, flags, vel, den, *a);
  return (int)cudaGetLastError();
}

int d2q9_resident8(const float* fin, float* fout, float* scratch,
                   const int* flags, const float* vel, const float* den,
                   const D2q9Args* a, int blocks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  D2q9Args args = *a;
  void* params[] = {(void*)&fin, (void*)&fout, (void*)&scratch,
                    (void*)&flags, (void*)&vel, (void*)&den, (void*)&args};
  e = cudaLaunchCooperativeKernel((const void*)d2q9_resident8_kernel,
                                  dim3(blocks), dim3(256), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
