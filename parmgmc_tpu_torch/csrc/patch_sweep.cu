// One coloured vertex-star patch-Gibbs sweep x -> x' of the squared
// link-count FD operator A = F^2, F = kappa2 + hinv2 * links, with the
// patch systems rebuilt in closed form.
//
// Replaces two Pallas kernels with one kernel body and two launches:
//   parmgmc_tpu/kernels/patch_sweep.py fused_patch_sweep_sqfd (body
//     _kernel, closed form _group_slab): the whole 125-colour sweep with
//     the state resident on chip -> pmg_patch_sweep, ONE cooperative
//     launch whose grid strides over each colour's centres and meets at a
//     grid barrier between colours (the state stays in L2, the GPU's
//     counterpart of the TPU's VMEM);
//   parmgmc_tpu/kernels/patch_sweep.py fused_patch_sweep_sqfd_streamed
//     (body _kernel_streamed): the state in device memory ->
//     pmg_patch_sweep_streamed, one launch per colour, all 125 enqueued
//     by one C call.
// Both copy x into out and update out in place, colour by colour; the
// math is kernels/patch_sweep.py's (its docstring gives the closed form
// of A_SS).  Since both routes run the very same kernel code on the same
// draws, they agree bit for bit.
//
// One thread per patch centre (a0 + 5i, a1 + 5j, a2 + 5k) of colour
// c = 25 a0 + 5 a1 + a2: it reads x on the L1 ball of radius 3 around the
// centre, forms F x on the 25 points of the ball of radius 2, the
// residual b - F(F x) at the 7 members, the 7x7 system and its unrolled
// Cholesky in registers, adds the member draws between the two solves
// and writes the in-grid members.
//
// Race freedom of the in-place update: same-colour centres differ by a
// nonzero multiple of 5 on some axis, so they are at least 5 apart in
// the L1 norm; a patch writes within L1 distance 1 of its centre and
// reads within 3, so no patch reads a cell that another patch of its
// colour writes.  Reads of out use __ldcg (L2, coherent): after the grid
// barrier a block must see the other blocks' writes, which the
// non-coherent read-only path (__ldg, const __restrict__) does not
// promise.
//
// What bounds it on an H100: operations.  A patch costs ~900 float32
// operations (FLOPS_PATCH in chip_smoke.py) and every point is a centre
// once per sweep, so 256^3 needs ~1.5e10 operations (0.23 ms at 67
// TFLOP/s) against 134 MB moved (0.04 ms at 3.35 TB/s).  This is the
// simple first version: no shared memory, neighbour reads through L1/L2,
// and the per-colour route rereads x (67 MB at 256^3, beyond the 50 MB
// L2) from device memory in each of its 125 passes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int M = 5;  // colour base: stencil radius 2 + 3
constexpr int NCOLOR = M * M * M;
constexpr int K = 7;  // members: centre, -e0, +e0, -e1, +e1, -e2, +e2
constexpr int NT = 128;

struct Prefixes {
  uint32_t p[K];  // hash prefix of member j's draws (PATCH_DOMAIN + j)
};

__host__ __device__ constexpr int member_off(int j, int ax) {
  return j == 0 ? 0 : ((j - 1) / 2 == ax ? ((j - 1) % 2 ? 1 : -1) : 0);
}

__host__ __device__ constexpr int iabs(int v) { return v < 0 ? -v : v; }

// centres of residue a along an axis of extent n
__host__ __device__ inline int centres(int n, int a) {
  return n > a ? (n - a + M - 1) / M : 0;
}

__device__ __forceinline__ bool inside(int i, int j, int k, int n0, int n1, int n2) {
  return (unsigned)i < (unsigned)n0 && (unsigned)j < (unsigned)n1 &&
         (unsigned)k < (unsigned)n2;
}

__device__ __forceinline__ int links(int i, int j, int k, int n0, int n1, int n2) {
  return (i >= 1) + (i <= n0 - 2) + (j >= 1) + (j <= n1 - 2) + (k >= 1) +
         (k <= n2 - 2);
}

// resample the patch centred at (c0, c1, c2) in place
__device__ __forceinline__ void update_patch(float* xs, const float* __restrict__ b,
                                             int n0, int n1, int n2, int c0, int c1,
                                             int c2, float k2, float h2,
                                             const Prefixes& pre, int with_noise) {
  // 1. x on the L1 ball of radius 3 (zero outside the grid); every index
  //    below is a compile-time constant once the loops unroll
  float xv[7][7][7];
#pragma unroll
  for (int u = 0; u < 7; ++u)
#pragma unroll
    for (int v = 0; v < 7; ++v)
#pragma unroll
      for (int w = 0; w < 7; ++w) {
        if (iabs(u - 3) + iabs(v - 3) + iabs(w - 3) > 3) continue;
        const int i = c0 + u - 3, j = c1 + v - 3, k = c2 + w - 3;
        xv[u][v][w] = inside(i, j, k, n0, n1, n2)
                          ? __ldcg(xs + ((size_t)i * n1 + j) * n2 + k)
                          : 0.f;
      }

  // 2. F x on the L1 ball of radius 2, zero outside the grid
  float fx[5][5][5];
#pragma unroll
  for (int u = 0; u < 5; ++u)
#pragma unroll
    for (int v = 0; v < 5; ++v)
#pragma unroll
      for (int w = 0; w < 5; ++w) {
        if (iabs(u - 2) + iabs(v - 2) + iabs(w - 2) > 2) continue;
        const int i = c0 + u - 2, j = c1 + v - 2, k = c2 + w - 2;
        const int U = u + 1, V = v + 1, W = w + 1;
        const float d = k2 + h2 * (float)links(i, j, k, n0, n1, n2);
        const float f = d * xv[U][V][W] -
                        h2 * (xv[U - 1][V][W] + xv[U + 1][V][W] + xv[U][V - 1][W] +
                              xv[U][V + 1][W] + xv[U][V][W - 1] + xv[U][V][W + 1]);
        fx[u][v][w] = inside(i, j, k, n0, n1, n2) ? f : 0.f;
      }

  // 3. per member: in-grid flag, F's diagonal, links, x and b - F(F x)
  bool in[K];
  float dm[K], lk[K], xm[K], rm[K];
  size_t id[K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int o0 = member_off(m, 0), o1 = member_off(m, 1), o2 = member_off(m, 2);
    const int i = c0 + o0, j = c1 + o1, k = c2 + o2;
    const int U = o0 + 2, V = o1 + 2, W = o2 + 2;
    in[m] = inside(i, j, k, n0, n1, n2);
    id[m] = in[m] ? ((size_t)i * n1 + j) * n2 + k : 0;
    const int l = links(i, j, k, n0, n1, n2);
    lk[m] = (float)l;
    dm[m] = k2 + h2 * lk[m];
    xm[m] = xv[o0 + 3][o1 + 3][o2 + 3];
    const float ffx = dm[m] * fx[U][V][W] -
                      h2 * (fx[U - 1][V][W] + fx[U + 1][V][W] + fx[U][V - 1][W] +
                            fx[U][V + 1][W] + fx[U][V][W - 1] + fx[U][V][W + 1]);
    rm[m] = ((b && in[m]) ? __ldg(b + id[m]) : 0.f) - ffx;
  }

  // 4. A_SS in closed form (lower triangle); out-of-grid members are
  //    identity rows
  const float hh = h2 * h2;
  float A[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (i == j) {
        A[i][i] = in[i] ? dm[i] * dm[i] + hh * lk[i] : 1.f;
        continue;
      }
      const int r0 = member_off(j, 0) - member_off(i, 0);
      const int r1 = member_off(j, 1) - member_off(i, 1);
      const int r2 = member_off(j, 2) - member_off(i, 2);
      float e;
      if (iabs(r0) + iabs(r1) + iabs(r2) == 1) {
        e = -h2 * (dm[i] + dm[j]);
      } else if ((r0 != 0) + (r1 != 0) + (r2 != 0) == 1) {
        e = hh;  // 2e apart: the path via the centre
      } else {  // mixed: via the centre and via the corner c + o_i + o_j
        const bool corner =
            inside(c0 + member_off(i, 0) + member_off(j, 0),
                   c1 + member_off(i, 1) + member_off(j, 1),
                   c2 + member_off(i, 2) + member_off(j, 2), n0, n1, n2);
        e = hh * (corner ? 2.f : 1.f);
      }
      A[i][j] = (in[i] && in[j]) ? e : 0.f;
    }

  // 5. rhs = mask (b - A x)_S + A_SS x_S
  float z[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float acc = in[i] ? rm[i] : 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) acc = acc + (j <= i ? A[i][j] : A[j][i]) * xm[j];
    z[i] = acc;
  }

  // 6. Cholesky A_SS = L L^T (row by row, in place in A's lower triangle)
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int t = 0; t < j; ++t) s = s - A[i][t] * A[j][t];
      A[i][j] = i == j ? sqrtf(s) : s / A[j][j];
    }

  // 7. z = L^{-1} rhs; x_S = L^{-T} (z + eta)
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = z[i];
#pragma unroll
    for (int j = 0; j < i; ++j) s = s - A[i][j] * z[j];
    z[i] = s / A[i][i];
  }
  const uint32_t p = (uint32_t)(((size_t)c0 * n1 + c1) * n2 + c2);
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float s = z[i] + (with_noise ? pmg::eta(pre.p[i], p) : 0.f);
#pragma unroll
    for (int j = i + 1; j < K; ++j) s = s - A[j][i] * z[j];
    z[i] = s / A[i][i];
  }
#pragma unroll
  for (int m = 0; m < K; ++m)
    if (in[m]) xs[id[m]] = z[m];
}

// colours [c_begin, c_end) in turn; a grid barrier between two colours
// (only the cooperative launch spans more than one)
__global__ void __launch_bounds__(NT)
    patch_sweep_kernel(float* xs, const float* __restrict__ b, int n0, int n1, int n2,
                       float k2, float h2, Prefixes pre, int with_noise, int c_begin,
                       int c_end) {
  for (int c = c_begin; c < c_end; ++c) {
    if (c > c_begin) cg::this_grid().sync();
    const int a0 = c / (M * M), a1 = (c / M) % M, a2 = c % M;
    const int m1 = centres(n1, a1), m2 = centres(n2, a2);
    const long long nc = (long long)centres(n0, a0) * m1 * m2;
    for (long long t = (long long)blockIdx.x * NT + threadIdx.x; t < nc;
         t += (long long)gridDim.x * NT) {
      const int k = (int)(t % m2);
      const long long r = t / m2;
      const int j = (int)(r % m1), i = (int)(r / m1);
      update_patch(xs, b, n0, n1, n2, a0 + M * i, a1 + M * j, a2 + M * k, k2, h2, pre,
                   with_noise);
    }
  }
}

Prefixes load_prefixes(const unsigned int* prefixes) {
  Prefixes pre;
  for (int j = 0; j < K; ++j) pre.p[j] = prefixes[j];
  return pre;
}

long long colour_centres(int c, int n0, int n1, int n2) {
  return (long long)centres(n0, c / (M * M)) * centres(n1, (c / M) % M) *
         centres(n2, c % M);
}

}  // namespace

extern "C" {

// #11: copy x to out, then one launch per colour on the caller's stream
int pmg_patch_sweep_streamed(const float* x, const float* b, float* out, int n0, int n1,
                             int n2, float kappa2, float hinv2,
                             const unsigned int* prefixes, int with_noise,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(out, x, sizeof(float) * (size_t)n0 * n1 * n2,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const Prefixes pre = load_prefixes(prefixes);
  for (int c = 0; c < NCOLOR; ++c) {
    const long long nc = colour_centres(c, n0, n1, n2);
    if (nc == 0) continue;
    patch_sweep_kernel<<<(unsigned)((nc + NT - 1) / NT), NT, 0, s>>>(
        out, b, n0, n1, n2, kappa2, hinv2, pre, with_noise, c, c + 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// #10: copy x to out, then one cooperative launch for all 125 colours.
// The grid is as large as the card keeps resident at once (occupancy x
// SMs) and no larger than the largest colour needs; a grid that cannot
// be co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
int pmg_patch_sweep(const float* x, const float* b, float* out, int n0, int n1, int n2,
                    float kappa2, float hinv2, const unsigned int* prefixes,
                    int with_noise, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(out, x, sizeof(float) * (size_t)n0 * n1 * n2,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, patch_sweep_kernel,
                                                           NT, 0)) != cudaSuccess)
    return (int)err;
  long long need = 1;
  for (int c = 0; c < NCOLOR; ++c) {
    const long long nb = (colour_centres(c, n0, n1, n2) + NT - 1) / NT;
    if (nb > need) need = nb;
  }
  const long long most = (long long)per_sm * sms;
  if (most < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const unsigned blocks = (unsigned)(need < most ? need : most);

  float* xs = out;
  Prefixes pre = load_prefixes(prefixes);
  int c_begin = 0, c_end = NCOLOR;
  void* args[] = {&xs,     &b,   &n0,         &n1,      &n2,   &kappa2,
                  &hinv2,  &pre, &with_noise, &c_begin, &c_end};
  err = cudaLaunchCooperativeKernel((const void*)patch_sweep_kernel, dim3(blocks),
                                    dim3(NT), args, 0, s);
  return (int)err;
}

}  // extern "C"
