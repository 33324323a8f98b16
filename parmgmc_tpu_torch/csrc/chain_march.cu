// MGMC down-phase of one level by plane marching, one launch.
//
// Replaces three Pallas kernels of parmgmc_tpu/kernels/mg_sweep.py with
// one body in three launch modes:
//
//   fused_chain_down_2d_staged  (#5)  one block per (T1, T2) column strip
//                                     walks all of axis 0;
//   fused_chain_down_2d         (#4)  the same body over windows of T0
//                                     planes, each block recomputing a
//                                     3-plane axis-0 halo;
//   fused_zero_gibbs_restrict_fd (#3) the windowed launch with no x
//                                     stream: the level's cycle from zero.
//
// For the chain state x = x_in + P z (x_in == nullptr: x = 0; z optional,
// compact (N0/2, N1/2, N2/2), P the 2x2x2 aggregate prolongation) it
// computes, as csrc/chain_down.cu does,
//
//   r    = b - A x                                (b == nullptr: b = 0)
//   r~   = r + nscale * sqrt(D) * eta             (counter-hash noise)
//   y    = one red/black SOR sweep from zero on r~
//   xpy  = x + y
//   rc   = 2x2x2 aggregate sum of (r - A y)       (N0/2, N1/2, N2/2)
//
// plus optional per-block partial sums of xpy (xsum) and of z (zsum),
// each block summing in a fixed order.  Every grid point is computed by
// the same instructions in every mode, so #4 equals #5 bit for bit and
// #3(b) equals #5(x = 0, b).
//
// What bounds it on an H100: device memory.  At 768^3 the chain (#5,
// b = None, z) reads x (1.81 GB) and z (0.23 GB) and writes xpy and rc
// (2.04 GB): ~1.2 ms at 3.35 TB/s.
//
// Design.  The TPU kernels stream column strips down axis 0 to keep the
// working set in VMEM; here the same 2.5D marching keeps it in shared
// memory.  A block owns a (T1, T2) strip of the plane, aligned to the
// aggregates, and one thread owns one 2x2 in-plane aggregate column.
// The block marches along axis 0 with rolling rings of planes: at step s
// it loads x (+ P z) of plane s on the strip + 3 ring, forms r~ of plane
// s - 1 on the strip + 2 ring and applies the colour-0 phase (it needs x
// at s - 2 .. s), runs the colour-1 phase of plane s - 2 on the strip + 1
// ring (it needs the colour-0 values at s - 3 .. s - 1), and emits xpy
// and A y of plane s - 3 on the strip (y at s - 4 .. s - 2, x at s - 4 ..
// s - 2).  Each thread keeps the residual of an even plane in registers
// and writes rc once the odd plane after it is done.  The in-plane halo
// is recomputed by the neighbouring strips (x loads are (T1+6)(T2+6) /
// (T1 T2) = 1.41x the strip at 32 x 32); along axis 0 nothing is
// recomputed in the staged mode, 6 planes per window in the windowed
// one.  The noise hash makes every recomputed draw identical.  Each
// thread loads the next x plane into registers while the block computes
// the current one, and D, omega / D and nscale sqrt(D) come from 7-entry
// tables (one per link count) instead of a division and a square root a
// cell.  Still simple: no TMA, four block barriers a plane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace {

constexpr int T0 = 16;                 // windowed mode: planes per block
constexpr int T1 = 32, T2 = 32;        // strip; kernels.TILES["chain_march"]
constexpr int X1 = T1 + 6, X2 = T2 + 6;  // x (+ P z) ring, strip + 3
constexpr int R1 = T1 + 4, R2 = T2 + 4;  // r~ after the colour-0 phase, + 2
constexpr int Y1 = T1 + 2, Y2 = T2 + 2;  // y, strip + 1
// planes held in each ring: x at s - 5 .. s (step 4 still reads s - 4
// while a thread past it stores s + 1), r~ at s - 3 .. s - 1, y at s - 4 .. s - 2
constexpr int NX = 6, NR = 3, NY = 3;
constexpr int NT = (T1 / 2) * (T2 / 2);  // one thread per aggregate column
constexpr int XPT = (X1 * X2 + NT - 1) / NT;  // x ring values a thread loads
constexpr int SMEM_BYTES =
    (NX * X1 * X2 + NR * R1 * R2 + NY * Y1 * Y2) * (int)sizeof(float);

struct Coeffs {
  float c0lo, c0hi, c1lo, c1hi, c2lo, c2hi;
};

// in-grid link count of a cell: D = kappa2 + hinv2 * links takes one of 7
// values, so D, omega / D and nscale * sqrt(D) come from per-block tables
__device__ __forceinline__ int links_at(int i, int j, int k, int n0, int n1,
                                        int n2) {
  return (i >= 1) + (i <= n0 - 2) + (j >= 1) + (j <= n1 - 2) + (k >= 1) +
         (k <= n2 - 2);
}

// off-diagonal star sum at in-plane cell c of plane ring entries lo (i-1),
// mid (i), hi (i+1) with row stride s1; cells outside the grid hold 0
__device__ __forceinline__ float neigh(const float* lo, const float* mid,
                                       const float* hi, int c, int s1,
                                       const Coeffs& q) {
  return q.c0lo * lo[c] + q.c0hi * hi[c] + q.c1lo * mid[c - s1] +
         q.c1hi * mid[c + s1] + q.c2lo * mid[c - 1] + q.c2hi * mid[c + 1];
}

// ring slot of plane i (i >= -3)
template <int N>
__device__ __forceinline__ int slot(int i) {
  return (i + 3) % N;
}

// deterministic block sum (fixed shuffle tree, then warp 0)
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < NT / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(NT, 3)
    chain_march_kernel(const float* __restrict__ x, const float* __restrict__ b,
                       const float* __restrict__ z, float* __restrict__ xpy,
                       float* __restrict__ rc, float* __restrict__ xsum,
                       float* __restrict__ zsum, int n0, int n1, int n2,
                       int t0, Coeffs q, float kappa2, float hinv2,
                       float omega, float nscale, uint32_t prefix, int color0,
                       int with_noise) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  float* xs = smem;                      // NX planes of (X1, X2)
  float* vs = xs + NX * X1 * X2;         // NR planes of (R1, R2)
  float* ys = vs + NR * R1 * R2;         // NY planes of (Y1, Y2)
  __shared__ float red[NT / 32];
  // per link count: D, omega / D, nscale * sqrt(D) (csrc/chain_down.cu's
  // per-cell float operations, evaluated once per link count)
  __shared__ float dtab[7], wtab[7], ntab[7];
  if (tid < 7) {
    const float d = kappa2 + hinv2 * (float)tid;
    dtab[tid] = d;
    wtab[tid] = omega / d;
    ntab[tid] = nscale * sqrtf(d);
  }
  const int g1 = blockIdx.y * T1, g2 = blockIdx.x * T2;
  const int o_lo = blockIdx.z * t0, o_hi = min(o_lo + t0, n0);
  const int m1 = n1 >> 1, m2 = n2 >> 1;
  const int cj = tid / (T2 / 2), ck = tid % (T2 / 2);
  const int j0 = g1 + 2 * cj, k0 = g2 + 2 * ck;
  const bool owner = j0 < n1 && k0 < n2;  // even extents: whole aggregate
  float reven[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float xacc = 0.f, zacc = 0.f;

  // x (+ P z) of one plane on the strip + 3 ring, XPT values a thread, in
  // registers: plane s + 1 is loaded while plane s is being computed
  float xr[XPT];
  auto fetch = [&](int i) {
    const bool in0 = x != nullptr && i >= 0 && i < n0;
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const int t = tid + u * NT;
      const int j = g1 + t / X2 - 3, k = g2 + t % X2 - 3;
      float v = 0.f;
      if (in0 && t < X1 * X2 && j >= 0 && j < n1 && k >= 0 && k < n2) {
        v = x[((size_t)i * n1 + j) * n2 + k];
        if (z) v += z[((size_t)(i >> 1) * m1 + (j >> 1)) * m2 + (k >> 1)];
      }
      xr[u] = v;
    }
  };
  fetch(o_lo - 3);

  for (int s = o_lo - 3; s <= o_hi + 2; ++s) {
    // 1. plane s into the x ring (zero outside the grid); fetch plane s + 1
    {
      float* xp = xs + slot<NX>(s) * (X1 * X2);
#pragma unroll
      for (int u = 0; u < XPT; ++u) {
        const int t = tid + u * NT;
        if (t < X1 * X2) xp[t] = xr[u];
      }
      if (s < o_hi + 2) fetch(s + 1);
    }
    __syncthreads();

    // 2. r~ = (b - A x) + noise of plane s - 1 on the strip + 2 ring; the
    //    colour-0 phase from zero in place
    if (s - 1 >= o_lo - 2) {
      const int i = s - 1;
      const float* xl = xs + slot<NX>(i - 1) * (X1 * X2);
      const float* xm = xs + slot<NX>(i) * (X1 * X2);
      const float* xh = xs + slot<NX>(i + 1) * (X1 * X2);
      float* vp = vs + slot<NR>(i) * (R1 * R2);
      const bool in0 = i >= 0 && i < n0;
      for (int t = tid; t < R1 * R2; t += NT) {
        const int a1 = t / R2, a2 = t % R2;
        const int j = g1 + a1 - 2, k = g2 + a2 - 2;
        float v = 0.f;
        if (in0 && j >= 0 && j < n1 && k >= 0 && k < n2) {
          const int c = (a1 + 1) * X2 + (a2 + 1);
          const size_t id = ((size_t)i * n1 + j) * n2 + k;
          const int l = links_at(i, j, k, n0, n1, n2);
          const float ax = dtab[l] * xm[c] + neigh(xl, xm, xh, c, X2, q);
          v = (b ? b[id] : 0.f) - ax;
          if (with_noise) v = v + ntab[l] * pmg::eta(prefix, (uint32_t)id);
          if (((i + j + k) & 1) == color0) v = wtab[l] * v;
        }
        vp[t] = v;
      }
    }
    __syncthreads();

    // 3. colour-1 phase of plane s - 2 on the strip + 1 ring (reads only
    //    colour-0 neighbours); colour-0 cells copy their value
    if (s - 2 >= o_lo - 1) {
      const int i = s - 2;
      const float* vl = vs + slot<NR>(i - 1) * (R1 * R2);
      const float* vm = vs + slot<NR>(i) * (R1 * R2);
      const float* vh = vs + slot<NR>(i + 1) * (R1 * R2);
      float* yp = ys + slot<NY>(i) * (Y1 * Y2);
      const bool in0 = i >= 0 && i < n0;
      for (int t = tid; t < Y1 * Y2; t += NT) {
        const int a1 = t / Y2, a2 = t % Y2;
        const int j = g1 + a1 - 1, k = g2 + a2 - 1;
        float v = 0.f;
        if (in0 && j >= 0 && j < n1 && k >= 0 && k < n2) {
          const int c = (a1 + 1) * R2 + (a2 + 1);
          v = vm[c];
          if (((i + j + k) & 1) != color0)
            v = wtab[links_at(i, j, k, n0, n1, n2)] * (v - neigh(vl, vm, vh, c, R2, q));
        }
        yp[t] = v;
      }
    }
    __syncthreads();

    // 4. outputs of plane s - 3 on the strip: xpy, and r - A y restricted
    //    once both planes of the aggregate are done
    if (s - 3 >= o_lo && owner) {
      const int i = s - 3;
      const float* xl = xs + slot<NX>(i - 1) * (X1 * X2);
      const float* xm = xs + slot<NX>(i) * (X1 * X2);
      const float* xh = xs + slot<NX>(i + 1) * (X1 * X2);
      const float* yl = ys + slot<NY>(i - 1) * (Y1 * Y2);
      const float* ym = ys + slot<NY>(i) * (Y1 * Y2);
      const float* yh = ys + slot<NY>(i + 1) * (Y1 * Y2);
      float r[2][2], o[2][2];
#pragma unroll
      for (int dj = 0; dj < 2; ++dj)
#pragma unroll
        for (int dk = 0; dk < 2; ++dk) {
          const int j = j0 + dj, k = k0 + dk;
          const int cx = (j - g1 + 3) * X2 + (k - g2 + 3);
          const int cy = (j - g1 + 1) * Y2 + (k - g2 + 1);
          const size_t id = ((size_t)i * n1 + j) * n2 + k;
          const float d = dtab[links_at(i, j, k, n0, n1, n2)];
          const float xv = xm[cx], yv = ym[cy];
          const float ax = d * xv + neigh(xl, xm, xh, cx, X2, q);
          const float ay = d * yv + neigh(yl, ym, yh, cy, Y2, q);
          r[dj][dk] = ((b ? b[id] : 0.f) - ax) - ay;
          o[dj][dk] = xv + yv;
        }
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const size_t id = ((size_t)i * n1 + (j0 + dj)) * n2 + k0;
        *reinterpret_cast<float2*>(xpy + id) = make_float2(o[dj][0], o[dj][1]);
      }
      if ((i & 1) == 0) {
#pragma unroll
        for (int dj = 0; dj < 2; ++dj)
#pragma unroll
          for (int dk = 0; dk < 2; ++dk) reven[dj][dk] = r[dj][dk];
      } else {
        const size_t cid = ((size_t)(i >> 1) * m1 + (j0 >> 1)) * m2 + (k0 >> 1);
        // axis-0 pairs, then axis 1, then axis 2 (AggregateTransfer.restrict)
        rc[cid] = ((reven[0][0] + r[0][0]) + (reven[1][0] + r[1][0])) +
                  ((reven[0][1] + r[0][1]) + (reven[1][1] + r[1][1]));
        if (z) zacc += z[cid];
      }
      xacc += (o[0][0] + o[0][1]) + (o[1][0] + o[1][1]);
    }
  }
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (xsum) {
    const float s = block_sum(xacc, red);
    if (tid == 0) xsum[blk] = s;
  }
  if (zsum) {
    const float s = block_sum(zacc, red);
    if (tid == 0) zsum[blk] = s;
  }
}

}  // namespace

extern "C" {

// (T0 of the windowed mode, T1, T2), so the loader can check them
void pmg_chain_march_tile(int* out) {
  out[0] = T0;
  out[1] = T1;
  out[2] = T2;
}

// t0 = planes per block: n0 for the staged mode (#5), 0 for the windowed
// mode (#4, #3; windows of T0 planes)
int pmg_chain_march(const float* x, const float* b, const float* z,
                    float* xpy, float* rc, float* xsum, float* zsum, int n0,
                    int n1, int n2, int t0, float c0lo, float c0hi,
                    float c1lo, float c1hi, float c2lo, float c2hi,
                    float kappa2, float hinv2, float omega, float nscale,
                    unsigned int prefix, int color0, int with_noise,
                    void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (t0 == 0) t0 = T0;
  if (t0 <= 0 || (t0 & 1)) return (int)cudaErrorInvalidValue;
  const dim3 grid((n2 + T2 - 1) / T2, (n1 + T1 - 1) / T1, (n0 + t0 - 1) / t0);
  const Coeffs q{c0lo, c0hi, c1lo, c1hi, c2lo, c2hi};
  chain_march_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, b, z, xpy, rc, xsum, zsum, n0, n1, n2, t0, q, kappa2, hinv2, omega,
      nscale, (uint32_t)prefix, color0, with_noise);
  return (int)cudaGetLastError();
}

}  // extern "C"
