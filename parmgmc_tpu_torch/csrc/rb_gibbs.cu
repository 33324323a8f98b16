// One full stochastic red/black SOR (Gibbs) sweep x -> x' on a 7-point
// star stencil with scalar off-diagonals, one launch, out of place.
//
// Replaces two Pallas kernels with one source and a template flag on
// where the diagonal D comes from:
//   parmgmc_tpu/kernels/rb_gibbs.py fused_rb_gibbs_sweep_fd (body
//     _kernel_v2): D = kappa2 + hinv2 * (in-grid link count), rebuilt
//     on the device, no D read (kStreamD = false);
//   parmgmc_tpu/kernels/rb_gibbs.py fused_rb_gibbs_sweep (body _kernel):
//     D read from a tensor (kStreamD = true).
// For b (b == nullptr: b = 0) it computes
//
//   b~ = b + nscale * sqrt(D) * eta                 (counter-hash noise)
//   colour color0, then the other colour, each cell of the colour set to
//   (1 - omega) x + (omega / D) (b~ - sum_nbr c x_nbr)
//
// with the neighbours outside the grid taken as 0 and parity (i+j+k) % 2
// of global indices.  nscale = noise_mult * sqrt((2 - omega) / omega).
//
// What bounds it on an H100: device memory.  At 256^3 it reads x and b
// and writes x' (201 MB; 134 MB with b = None; +67 MB for the streamed
// D): ~67 us at the 3.0 TB/s a 1 GiB device copy reaches.
//
// Design.  Each block owns an (8, 8, 32) output tile and loads x on the
// tile + 2 ring into shared memory (zero outside the grid).  The first
// colour is updated in place on the tile + 1 ring: its cells read only
// cells of the other colour, which this phase leaves alone.  The second
// colour is updated on the tile and written straight out; it reads only
// first-colour cells, now final.  b~ is formed where a cell is updated
// (each cell of tile + 1 at most once), so it needs no shared memory;
// noise for halo cells is recomputed by each block that needs it, and
// the hash makes those draws identical.  This is the simple first
// version: the x halo is read 2.5 times through L2, and the loads are
// not vectorised.  The cell update is sweep.cuh's, shared with the
// large-plane sweep kernel (sweep_march.cu), so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"

namespace {

constexpr int T0 = 8, T1 = 8, T2 = 32;  // output tile; kernels.TILES["rb_gibbs"]
constexpr int X0 = T0 + 4, X1 = T1 + 4, X2 = T2 + 4;  // x window, tile + 2
constexpr int Y0 = T0 + 2, Y1 = T1 + 2, Y2 = T2 + 2;  // first colour, tile + 1
constexpr int NT = 256;

// the SOR update of the cell at window index c (global (i, j, k), flat id)
template <bool kStreamD>
__device__ __forceinline__ float update(const float* xs, int c, size_t id,
                                        int i, int j, int k, int n0, int n1,
                                        int n2, const float* __restrict__ b,
                                        const float* __restrict__ d,
                                        const pmg::StarCoeffs& q, float kappa2,
                                        float hinv2, float omega, float nscale,
                                        uint32_t prefix, int with_noise) {
  constexpr int s1 = X2, s0 = X1 * X2;
  return pmg::sor_cell(
      xs[c], xs[c - s0], xs[c + s0], xs[c - s1], xs[c + s1], xs[c - 1],
      xs[c + 1], q,
      pmg::sweep_diag<kStreamD>(d, id, i, j, k, n0, n1, n2, kappa2, hinv2),
      b ? b[id] : 0.f, omega, nscale, prefix, (uint32_t)id, with_noise);
}

template <bool kStreamD>
__global__ void __launch_bounds__(NT)
    rb_gibbs_kernel(const float* __restrict__ x, const float* __restrict__ b,
                    const float* __restrict__ d, float* __restrict__ out,
                    int n0, int n1, int n2, pmg::StarCoeffs q, float kappa2,
                    float hinv2, float omega, float nscale, uint32_t prefix,
                    int color0, int with_noise) {
  __shared__ float xs[X0 * X1 * X2];
  const int g0 = blockIdx.z * T0, g1 = blockIdx.y * T1, g2 = blockIdx.x * T2;
  const int tid = threadIdx.x;

  // 1. x on tile + 2, zero outside the grid
  for (int t = tid; t < X0 * X1 * X2; t += NT) {
    const int a2 = t % X2, a1 = (t / X2) % X1, a0 = t / (X2 * X1);
    const int i = g0 + a0 - 2, j = g1 + a1 - 2, k = g2 + a2 - 2;
    float v = 0.f;
    if (i >= 0 && i < n0 && j >= 0 && j < n1 && k >= 0 && k < n2)
      v = x[((size_t)i * n1 + j) * n2 + k];
    xs[t] = v;
  }
  __syncthreads();

  // 2. colour color0 on tile + 1, in place
  for (int t = tid; t < Y0 * Y1 * Y2; t += NT) {
    const int a2 = t % Y2, a1 = (t / Y2) % Y1, a0 = t / (Y2 * Y1);
    const int i = g0 + a0 - 1, j = g1 + a1 - 1, k = g2 + a2 - 1;
    if (i >= 0 && i < n0 && j >= 0 && j < n1 && k >= 0 && k < n2 &&
        ((i + j + k) & 1) == color0) {
      const int c = ((a0 + 1) * X1 + (a1 + 1)) * X2 + (a2 + 1);
      const size_t id = ((size_t)i * n1 + j) * n2 + k;
      xs[c] = update<kStreamD>(xs, c, id, i, j, k, n0, n1, n2, b, d, q, kappa2,
                               hinv2, omega, nscale, prefix, with_noise);
    }
  }
  __syncthreads();

  // 3. the other colour on the tile; every tile cell is written out
  for (int t = tid; t < T0 * T1 * T2; t += NT) {
    const int a2 = t % T2, a1 = (t / T2) % T1, a0 = t / (T2 * T1);
    const int i = g0 + a0, j = g1 + a1, k = g2 + a2;
    if (i < n0 && j < n1 && k < n2) {
      const int c = ((a0 + 2) * X1 + (a1 + 2)) * X2 + (a2 + 2);
      const size_t id = ((size_t)i * n1 + j) * n2 + k;
      float v = xs[c];
      if (((i + j + k) & 1) != color0)
        v = update<kStreamD>(xs, c, id, i, j, k, n0, n1, n2, b, d, q, kappa2,
                             hinv2, omega, nscale, prefix, with_noise);
      out[id] = v;
    }
  }
}

}  // namespace

extern "C" {

// tile extents, so the loader can check them against the Python side
void pmg_rb_gibbs_tile(int* out) {
  out[0] = T0;
  out[1] = T1;
  out[2] = T2;
}

// d == nullptr: FD mode (D from kappa2, hinv2); else D is read from d
int pmg_rb_gibbs(const float* x, const float* b, const float* d, float* out,
                 int n0, int n1, int n2, float c0lo, float c0hi, float c1lo,
                 float c1hi, float c2lo, float c2hi, float kappa2, float hinv2,
                 float omega, float nscale, unsigned int prefix, int color0,
                 int with_noise, void* stream) {
  const dim3 grid((n2 + T2 - 1) / T2, (n1 + T1 - 1) / T1, (n0 + T0 - 1) / T0);
  const pmg::StarCoeffs q{c0lo, c0hi, c1lo, c1hi, c2lo, c2hi};
  if (d)
    rb_gibbs_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        x, b, d, out, n0, n1, n2, q, kappa2, hinv2, omega, nscale,
        (uint32_t)prefix, color0, with_noise);
  else
    rb_gibbs_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
        x, b, d, out, n0, n1, n2, q, kappa2, hinv2, omega, nscale,
        (uint32_t)prefix, color0, with_noise);
  return (int)cudaGetLastError();
}

}  // extern "C"
