// One full stochastic red/black SOR (Gibbs) sweep x -> x' by plane
// marching, out of place, for grids with large planes.
//
// Replaces two Pallas kernels of parmgmc_tpu/kernels/rb_gibbs.py with one
// body in two launch modes, each with its own entry point:
//
//   fused_rb_gibbs_sweep_2d_staged (#9)  FD only: one block per (T1, T2)
//                                        column strip walks all of axis 0;
//   fused_rb_gibbs_sweep_2d        (#8)  the same body over windows of T0
//                                        planes, each block recomputing a
//                                        2-plane axis-0 halo; the diagonal
//                                        rebuilt from (kappa2, hinv2) and the
//                                        in-grid link count, or streamed
//                                        from a tensor (kStreamD).
//
// Both compute what csrc/rb_gibbs.cu (#7, #6) computes: for b (b ==
// nullptr: b = 0)
//
//   b~ = b + nscale * sqrt(D) * eta                 (counter-hash noise)
//   colour color0, then the other colour, each cell of the colour set to
//   (1 - omega) x + (omega / D) (b~ - sum_nbr c x_nbr)
//
// with the neighbours outside the grid taken as 0 and parity (i+j+k) % 2
// of global indices.  Every cell is updated by sweep.cuh's sor_cell on
// the same values as in rb_gibbs.cu, so #9, #8 and #7 (#8 and #6 with the
// diagonal streamed) agree bit for bit.
//
// What bounds it on an H100: device memory.  At 768^3 it reads x and
// writes x' (3.62 GB, ~1.08 ms at 3.35 TB/s), plus 1.81 GB for b and as
// much for a streamed D; its 48 float operations a cell take ~0.32 ms at
// 67 TFLOP/s.
//
// Design.  The TPU kernels tile the plane in 2D because a whole 768^2
// plane does not fit VMEM; here the same 2.5D marching keeps the working
// set in shared memory.  A block owns a (T1, T2) strip of the plane and
// loops over planes with two rolling rings of three planes each: x on the
// strip + 2 ring, and the plane after the colour-0 phase on the strip + 1
// ring (colour-0 cells updated, colour-1 cells copied).  At step s it
// stores x of plane s, runs the colour-0 phase of plane s - 1 (it needs x
// at s - 2 .. s), and runs the colour-1 phase of plane s - 2 on the strip
// (it needs the colour-0 results at s - 3 .. s - 1), writing the plane
// out: two block barriers a plane, one after the store and one after the
// colour-0 phase.  The in-plane halo is recomputed by the neighbouring
// strips ((T1 + 4)(T2 + 4) / (T1 T2) = 1.27x the x loads at 32 x 32);
// along axis 0 nothing is recomputed in the staged mode, 4 x planes and
// 2 colour-0 planes per window in the windowed one.  b~ is formed where a
// cell is updated and the noise hash makes every recomputed draw
// identical.  Each thread loads the next x plane into registers while the
// block computes the current one.  Still simple: no TMA, scalar loads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"

namespace {

constexpr int T0 = 16;                   // windowed mode: planes per block
constexpr int T1 = 32, T2 = 32;          // strip; kernels.TILES["sweep_march"]
constexpr int X1 = T1 + 4, X2 = T2 + 4;  // x ring, strip + 2
constexpr int Y1 = T1 + 2, Y2 = T2 + 2;  // after the colour-0 phase, strip + 1
// planes held in each ring: x at s - 2 .. s, colour-0 results at s - 3 ..
// s - 1 (step s + 1 overwrites the oldest only after its first barrier)
constexpr int NX = 3, NY = 3;
constexpr int NT = 256;
constexpr int XPT = (X1 * X2 + NT - 1) / NT;  // x ring values a thread loads

// ring slot of plane i (i >= -3)
template <int N>
__device__ __forceinline__ int slot(int i) {
  return (i + 3) % N;
}

template <bool kStreamD>
__global__ void __launch_bounds__(NT)
    sweep_march_kernel(const float* __restrict__ x, const float* __restrict__ b,
                       const float* __restrict__ d, float* __restrict__ out,
                       int n0, int n1, int n2, int t0, pmg::StarCoeffs q,
                       float kappa2, float hinv2, float omega, float nscale,
                       uint32_t prefix, int color0, int with_noise) {
  __shared__ float xs[NX * X1 * X2];
  __shared__ float ys[NY * Y1 * Y2];
  const int tid = threadIdx.x;
  const int g1 = blockIdx.y * T1, g2 = blockIdx.x * T2;
  const int o_lo = blockIdx.z * t0, o_hi = min(o_lo + t0, n0);

  // x of one plane on the strip + 2 ring, XPT values a thread, in
  // registers: plane s + 1 is loaded while plane s is being computed
  float xr[XPT];
  auto fetch = [&](int i) {
    const bool in0 = i >= 0 && i < n0;
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const int t = tid + u * NT;
      const int j = g1 + t / X2 - 2, k = g2 + t % X2 - 2;
      float v = 0.f;
      if (in0 && t < X1 * X2 && j >= 0 && j < n1 && k >= 0 && k < n2)
        v = x[((size_t)i * n1 + j) * n2 + k];
      xr[u] = v;
    }
  };
  fetch(o_lo - 2);

  for (int s = o_lo - 2; s <= o_hi + 1; ++s) {
    // 1. plane s into the x ring (zero outside the grid); fetch plane s + 1
    {
      float* xp = xs + slot<NX>(s) * (X1 * X2);
#pragma unroll
      for (int u = 0; u < XPT; ++u) {
        const int t = tid + u * NT;
        if (t < X1 * X2) xp[t] = xr[u];
      }
      if (s <= o_hi) fetch(s + 1);
    }
    __syncthreads();

    // 2. colour-0 phase of plane s - 1 on the strip + 1 ring: colour-0
    //    cells updated from x, colour-1 cells copied, 0 outside the grid
    if (s >= o_lo) {
      const int i = s - 1;
      const float* xl = xs + slot<NX>(i - 1) * (X1 * X2);
      const float* xm = xs + slot<NX>(i) * (X1 * X2);
      const float* xh = xs + slot<NX>(i + 1) * (X1 * X2);
      float* yp = ys + slot<NY>(i) * (Y1 * Y2);
      const bool in0 = i >= 0 && i < n0;
      for (int t = tid; t < Y1 * Y2; t += NT) {
        const int a1 = t / Y2, a2 = t % Y2;
        const int j = g1 + a1 - 1, k = g2 + a2 - 1;
        float v = 0.f;
        if (in0 && j >= 0 && j < n1 && k >= 0 && k < n2) {
          const int c = (a1 + 1) * X2 + (a2 + 1);
          v = xm[c];
          if (((i + j + k) & 1) == color0) {
            const size_t id = ((size_t)i * n1 + j) * n2 + k;
            v = pmg::sor_cell(
                v, xl[c], xh[c], xm[c - X2], xm[c + X2], xm[c - 1], xm[c + 1],
                q,
                pmg::sweep_diag<kStreamD>(d, id, i, j, k, n0, n1, n2, kappa2,
                                          hinv2),
                b ? b[id] : 0.f, omega, nscale, prefix, (uint32_t)id,
                with_noise);
          }
        }
        yp[t] = v;
      }
    }
    __syncthreads();

    // 3. colour-1 phase of plane s - 2 on the strip (it reads only colour-0
    //    neighbours); every strip cell is written out
    if (s >= o_lo + 2) {
      const int i = s - 2;
      const float* yl = ys + slot<NY>(i - 1) * (Y1 * Y2);
      const float* ym = ys + slot<NY>(i) * (Y1 * Y2);
      const float* yh = ys + slot<NY>(i + 1) * (Y1 * Y2);
      for (int t = tid; t < T1 * T2; t += NT) {
        const int a1 = t / T2, a2 = t % T2;
        const int j = g1 + a1, k = g2 + a2;
        if (j < n1 && k < n2) {
          const int c = (a1 + 1) * Y2 + (a2 + 1);
          const size_t id = ((size_t)i * n1 + j) * n2 + k;
          float v = ym[c];
          if (((i + j + k) & 1) != color0)
            v = pmg::sor_cell(
                v, yl[c], yh[c], ym[c - Y2], ym[c + Y2], ym[c - 1], ym[c + 1],
                q,
                pmg::sweep_diag<kStreamD>(d, id, i, j, k, n0, n1, n2, kappa2,
                                          hinv2),
                b ? b[id] : 0.f, omega, nscale, prefix, (uint32_t)id,
                with_noise);
          out[id] = v;
        }
      }
    }
  }
}

int launch(const float* x, const float* b, const float* d, float* out, int n0,
           int n1, int n2, int t0, const pmg::StarCoeffs& q, float kappa2,
           float hinv2, float omega, float nscale, unsigned int prefix,
           int color0, int with_noise, void* stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || t0 <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n2 + T2 - 1) / T2, (n1 + T1 - 1) / T1, (n0 + t0 - 1) / t0);
  if (d)
    sweep_march_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        x, b, d, out, n0, n1, n2, t0, q, kappa2, hinv2, omega, nscale,
        (uint32_t)prefix, color0, with_noise);
  else
    sweep_march_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
        x, b, d, out, n0, n1, n2, t0, q, kappa2, hinv2, omega, nscale,
        (uint32_t)prefix, color0, with_noise);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (T0 of the windowed mode, T1, T2), so the loader can check them
void pmg_sweep_march_tile(int* out) {
  out[0] = T0;
  out[1] = T1;
  out[2] = T2;
}

// #9: FD only (d must be nullptr); one block per strip over all of axis 0
int pmg_sweep_march_staged(const float* x, const float* b, const float* d,
                           float* out, int n0, int n1, int n2, float c0lo,
                           float c0hi, float c1lo, float c1hi, float c2lo,
                           float c2hi, float kappa2, float hinv2, float omega,
                           float nscale, unsigned int prefix, int color0,
                           int with_noise, void* stream) {
  if (d) return (int)cudaErrorInvalidValue;
  const pmg::StarCoeffs q{c0lo, c0hi, c1lo, c1hi, c2lo, c2hi};
  return launch(x, b, nullptr, out, n0, n1, n2, n0, q, kappa2, hinv2, omega,
                nscale, prefix, color0, with_noise, stream);
}

// #8: windows of T0 planes; d == nullptr: FD mode (D from kappa2, hinv2),
// else D is read from d
int pmg_sweep_march_windowed(const float* x, const float* b, const float* d,
                             float* out, int n0, int n1, int n2, float c0lo,
                             float c0hi, float c1lo, float c1hi, float c2lo,
                             float c2hi, float kappa2, float hinv2,
                             float omega, float nscale, unsigned int prefix,
                             int color0, int with_noise, void* stream) {
  const pmg::StarCoeffs q{c0lo, c0hi, c1lo, c1hi, c2lo, c2hi};
  return launch(x, b, d, out, n0, n1, n2, T0, q, kappa2, hinv2, omega, nscale,
                prefix, color0, with_noise, stream);
}

}  // extern "C"
