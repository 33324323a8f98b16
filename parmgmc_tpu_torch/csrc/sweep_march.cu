// One full stochastic red/black SOR (Gibbs) sweep x -> x' by plane
// marching, out of place, on any 3D grid.
//
// Replaces four Pallas kernels of parmgmc_tpu/kernels/rb_gibbs.py with one
// body, each with its own entry point, wrapper and launch counter:
//
//   fused_rb_gibbs_sweep_2d_staged (#9)  planes over the plane limit, FD
//                                        only: the diagonal rebuilt from
//                                        (kappa2, hinv2) and the in-grid
//                                        link count;
//   fused_rb_gibbs_sweep_2d        (#8)  planes over the limit, FD or the
//                                        diagonal streamed from a tensor
//                                        (kStreamD);
//   fused_rb_gibbs_sweep_fd        (#7)  smaller planes, FD;
//   fused_rb_gibbs_sweep           (#6)  smaller planes, D streamed.
//
// A work item is a (T1, T2) column strip over a segment of t0 planes of
// axis 0, one block each, recomputing a 2-plane axis-0 halo on each side.
// #9 and #8 take the long segments of kernels/_march.py's plan (up to 96
// planes, for 768^3); #7 and #6 those of full_plan (a twentieth of axis 0,
// at least 2 planes), which fill the card from 384^3 down to the 12^3 of
// a V(2,2) hierarchy.  All four compute, for b (b == nullptr: b = 0)
//
//   b~ = b + nscale * sqrt(D) * eta                 (counter-hash noise)
//   colour color0, then the other colour, each cell of the colour set to
//   (1 - omega) x + (omega / D) (b~ - sum_nbr c x_nbr)
//
// with the neighbours outside the grid taken as 0 and parity (i+j+k) % 2
// of global indices.  Every cell is updated by sweep.cuh's sor_cell on
// the same values whatever the plan, so #9, #8 and #7 (#8 and #6 with the
// diagonal streamed) agree bit for bit.
//
// The array may be a block of a larger grid (a halo-extended shard of
// parmgmc_tpu_torch/parallel/fused.py): array plane i is global row g =
// row_offset + i of n0g rows (row_offset = 0, n0g = n0 for a whole grid).
// The parity, the FD link count and the noise counter follow g.  Planes
// outside the global grid (the first and last shards' outer halos, vlo
// and vhi below) are outside the grid: they are streamed as zeros (the
// tensor maps and copies start at plane vlo), no cell of theirs is
// updated, and their output is 0; so no cell reads a neighbour across a
// global end.  For a whole grid nothing changes: the same instructions
// run on the same values.
//
// What bounds it on an H100: device memory by the count, instruction
// issue in fact.  At 768^3 it reads x and b and writes x' (5.44 GB, 1.62
// ms at 3.35 TB/s; a streamed D adds 1.81 GB).  Each cell costs 48 float
// operations (0.32 ms at 67 TFLOP/s) plus the noise hash's integer work,
// two mix rounds of ~10 integer operations each (noise.cuh), at half the
// float rate (~0.3 ms), and the draw's log and square root; counted in
// issued instructions (~120 a cell with its bookkeeping) that is ~1.9 ms
// at the SMs' 4 warp-instructions a clock.
//
// Design (csrc/march.cuh).  Loads issued by the computing threads stall
// their phase, and whole-axis strips (576 at 768^3) leave a partial last
// wave of block slots.  So one producer warp streams x (36 x 40 boxes,
// strip + 2) and b and D (34 x 40 boxes, strip + 1) into rings of
// shared-memory stages (6 x planes, 4 b/D planes) with TMA, or with cp.async where the
// row stride is not a multiple of 16 B; each stage completes on an
// mbarrier, so 8 consumer warps wait on data, not on their own loads.
// 4,608 work items at 768^3 fill 3 blocks an SM in 11.6 waves.  With the
// loads out of the way the cell update bounds it: the noise draw is ~70
// instructions.  So each consumer thread updates cells of one colour only
// (no lane idles through the other colour's draw), in batches whose
// draws the compiler interleaves: at step i the colour-0 cells of plane
// i on the strip + 1 (578, 3 a thread) into a ring of 4 colour-0 planes,
// then, after the one block barrier of the step (colour 1 needs its
// colour-0 neighbours from other threads), the colour-1 cells of plane
// i - 1 on the strip (512, 2 a thread), each written out with its
// pair's colour-0 cell as one float2.  FD tabulates nscale sqrt(D) and
// omega / D for the 7 link counts (sweep.cuh's sor_cell_pre, the same
// roundings); a block inside the grid skips the link counts and bound
// tests; the noise flag is a template flag and the draw's square root
// has no branch (noise.cuh).  The in-plane halo is recomputed by the
// neighbouring strips (578 colour-0 cells for 512), the axis-0 halo costs
// 4 x planes a segment (4 % at 96 planes).  b~ is formed where a cell is
// updated and the noise hash makes every recomputed draw identical.  #7
// and #6's short segments trade halo for items: 12 planes at 256^3 recompute
// 2 colour-0 planes in 12 and give 1,408 work items (3.6 waves); at 64^3
// and below a block's run of seg + 2 plane steps is the launch's latency,
// and 2-plane segments keep it short.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "march.cuh"
#include "sweep.cuh"

namespace {

constexpr int HALO = 2;                  // axis-0 halo planes of a segment
constexpr int T1 = 32, T2 = 32;          // strip; kernels.TILES["sweep_march"]
// TMA boxes start on a 16-B column (k % 4 == 0): x on the strip + 2 rows
// at (g1-2, g2-4), b and D on the strip + 1 rows at (g1-1, g2-4), both 40
// columns wide
constexpr int X1 = T1 + 4, X2 = T2 + 8;
constexpr int B1 = T1 + 2, B2 = T2 + 8;
constexpr int Y1 = T1 + 2, Y2 = T2 + 2;  // after the colour-0 phase, strip + 1
constexpr int XSF = pmg::stage_floats(X1, X2), BSF = pmg::stage_floats(B1, B2);
// x planes i - 1 .. i + 1 in use and 3 in flight; b (and D) i - 1, i and
// 2 in flight; colour-0 results i - 3 .. i (step i + 1 overwrites i - 3
// only after the barrier of step i, which follows its last reader)
constexpr int NX = 6, NB = 4, NY = 4;
constexpr int NCONS = 256, NT = NCONS + 32;  // 8 consumer warps, 1 producer
// cells a consumer thread updates a step, in one unrolled batch: colour 0
// on the strip + 1 (34 x 17 = 578), colour 1 on the strip (512)
constexpr int C0_PER_THREAD = (Y1 * (Y2 / 2) + NCONS - 1) / NCONS;
constexpr int C1_PER_THREAD = T1 * T2 / 2 / NCONS;

int smem_bytes(int nbox) {
  return (NX * XSF + NB * nbox * BSF + NY * Y1 * Y2) * (int)sizeof(float);
}

// kStreamD: D streamed from a tensor (else rebuilt, FD); kNoise: the
// noise draw.  Template flags, so the per-cell batches have no branches
template <bool kStreamD, bool kNoise>
__global__ void __launch_bounds__(NT, 3)
    sweep_march_kernel(const float* __restrict__ x, const float* __restrict__ b,
                       const float* __restrict__ d, float* __restrict__ out,
                       int n0, int n1, int n2, int t0, int use_tma, pmg::StarCoeffs q,
                       float kappa2, float hinv2, float omega, float nscale,
                       uint32_t prefix_arg, const uint32_t* __restrict__ prefix_at,
                       int color0, int row_offset, int n0g, int vlo, int vhi,
                       const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mb,
                       const __grid_constant__ CUtensorMap md) {
  extern __shared__ __align__(128) float smem[];
  __shared__ pmg::Ring<NX> rx;
  __shared__ pmg::Ring<NB> rb;
  // FD: nscale sqrt(D) and omega / D per link count, as sor_cell rounds them
  __shared__ float nstab[7], wtab[7];
  const bool has_b = b != nullptr;
  const int nbox = (int)has_b + (int)kStreamD;  // boxes in a b/D stage
  // planes vlo .. vhi - 1 lie inside the global grid; loads start there
  const size_t skip = (size_t)vlo * n1 * n2;
  const int nin = vhi - vlo;
  float* xs = smem;
  float* bs = xs + NX * XSF;
  float* ys = bs + NB * nbox * BSF;
  // the noise key: read from device memory when given (a replayed graph's
  // step), else the launch argument
  const uint32_t prefix = prefix_at ? __ldg(prefix_at) : prefix_arg;
  const int tid = threadIdx.x;
  const int g1 = blockIdx.y * T1, g2 = blockIdx.x * T2;
  const int o_lo = blockIdx.z * t0, o_hi = min(o_lo + t0, n0);
  const int xfirst = o_lo - HALO, bfirst = o_lo - 1;  // first x, b plane
  if (!kStreamD && tid < 7) {
    const float dv = kappa2 + hinv2 * (float)tid;
    nstab[tid] = nscale * sqrtf(dv);
    wtab[tid] = omega / dv;
  }
  if (tid == 0) {
    rx.init(use_tma ? 1 : 32, NCONS / 32);
    rb.init(use_tma ? 1 : 32, NCONS / 32);
    pmg::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // producer warp: x planes o_lo - 2 .. o_hi + 1; with x plane p, the
    // b/D plane p - 1 (planes o_lo - 1 .. o_hi), which step p - 1 needs
    const int lane = tid - NCONS;
    const int nxp = o_hi + HALO - xfirst;
    for (int u = 0; u < nxp; ++u) {
      const int p = xfirst + u;
      rx.wait_empty(u);
      float* dst = xs + (u % NX) * XSF;
      if (use_tma) {
        if (lane == 0) {
          pmg::mbar_expect_tx(&rx.full[u % NX], X1 * X2 * 4);
          pmg::tma_load_3d(dst, &mx, &rx.full[u % NX], g2 - 4, g1 - 2, p - vlo);
        }
      } else {
        pmg::cpasync_box(dst, x + skip, X1, X2, g2 - 4, g1 - 2, p - vlo, nin, n1, n2, lane);
        pmg::cpasync_arrive(&rx.full[u % NX]);
      }
      const int v = u - 2, pb = p - 1;  // b/D plane bfirst + v
      if (nbox == 0 || v < 0) continue;
      rb.wait_empty(v);
      float* bdst = bs + (v % NB) * nbox * BSF;
      uint64_t* bar = &rb.full[v % NB];
      if (use_tma) {
        if (lane == 0) {
          pmg::mbar_expect_tx(bar, nbox * B1 * B2 * 4);
          if (has_b) pmg::tma_load_3d(bdst, &mb, bar, g2 - 4, g1 - 1, pb - vlo);
          if (kStreamD)
            pmg::tma_load_3d(bdst + (has_b ? BSF : 0), &md, bar, g2 - 4, g1 - 1, pb - vlo);
        }
      } else {
        if (has_b)
          pmg::cpasync_box(bdst, b + skip, B1, B2, g2 - 4, g1 - 1, pb - vlo, nin, n1, n2, lane);
        if (kStreamD)
          pmg::cpasync_box(bdst + (has_b ? BSF : 0), d + skip, B1, B2, g2 - 4, g1 - 1, pb - vlo,
                           nin, n1, n2, lane);
        pmg::cpasync_arrive(bar);
      }
    }
    if (!use_tma) pmg::cpasync_wait_all();
    return;
  }

  __builtin_assume(tid < NCONS);
  // consumer warps: step i runs colour 0 on plane i (o_lo - 1 .. o_hi)
  // and colour 1 on plane i - 1 (o_lo .. o_hi - 1), each thread on cells of
  // the colour being updated only (no divergence between the colours)
  // the cell update; F (compile time): the cell is inside the grid with
  // 6 links (an inner block's plane of global row 1 .. n0g - 2)
  const int rp = row_offset & 1;  // parity of the global row of plane 0
  const auto update = [&](auto tag, float xc, float lo0, float hi0, float lo1, float hi1,
                          float lo2, float hi2, const float* bp, const float* dp, int cb, int i,
                          int j, int k) {
    constexpr bool F = decltype(tag)::value;
    const int g = row_offset + i;
    const uint32_t id = ((uint32_t)g * n1 + j) * n2 + k;  // the noise counter
    const float bv = has_b ? bp[cb] : 0.f;
    if (kStreamD)
      return pmg::sor_cell(xc, lo0, hi0, lo1, hi1, lo2, hi2, q, dp[cb], bv, omega, nscale,
                           prefix, id, kNoise);
    const int l = F ? 6
                    : (g >= 1) + (g <= n0g - 2) + (j >= 1) + (j <= n1 - 2) + (k >= 1) +
                          (k <= n2 - 2);
    return pmg::sor_cell_pre(xc, lo0, hi0, lo1, hi1, lo2, hi2, q, nstab[l], wtab[l], bv, omega,
                             prefix, id, kNoise);
  };
  // every row and column of the strip + 1 is inside the grid with both
  // in-plane links
  const bool inner = g1 >= 2 && g1 + T1 + 2 <= n1 && g2 >= 2 && g2 + T2 + 2 <= n2;
  // plane i of an inner block takes the 6-link path: two axis-0 links in
  // the global grid (so inside it) and inside the array
  const auto full = [&](int i) {
    return inner && i >= vlo && i < vhi && row_offset + i >= 1 && row_offset + i <= n0g - 2;
  };
  for (int i = o_lo - 1; i <= o_hi; ++i) {
    const int ux = i - xfirst, ub = i - bfirst, uy = i - (o_lo - 1);
    if (i == o_lo - 1) {
      rx.wait_full(ux - 1);
      rx.wait_full(ux);
    }
    rx.wait_full(ux + 1);
    if (nbox) rb.wait_full(ub);
    {
      // colour 0 of plane i on the strip + 1: 17 cells a row of 34, the
      // colour-1 places of the ring left unwritten (nothing reads them)
      const float* xl = xs + ((ux - 1) % NX) * XSF;
      const float* xm = xs + (ux % NX) * XSF;
      const float* xh = xs + ((ux + 1) % NX) * XSF;
      const float* bp = bs + (ub % NB) * nbox * BSF;
      const float* dp = bp + (has_b ? BSF : 0);
      float* yp = ys + (uy % NY) * (Y1 * Y2);
      const bool in0 = i >= vlo && i < vhi;
      const auto run = [&](auto tag) {
        constexpr bool F = decltype(tag)::value;
        float v[C0_PER_THREAD];
        int at[C0_PER_THREAD];
#pragma unroll
        for (int u = 0; u < C0_PER_THREAD; ++u) {
          const int t = tid + u * NCONS;
          at[u] = -1;
          v[u] = 0.f;
          if ((u + 1) * NCONS <= Y1 * (Y2 / 2) || t < Y1 * (Y2 / 2)) {
            const int a1 = t / (Y2 / 2), h = t - a1 * (Y2 / 2);
            const int j = g1 + a1 - 1;
            const int a2 = 2 * h + (((i + rp + j + g2 - 1) & 1) ^ color0);
            const int k = g2 + a2 - 1;
            at[u] = a1 * Y2 + a2;
            if (F || (in0 && j >= 0 && j < n1 && k >= 0 && k < n2)) {
              const int c = (a1 + 1) * X2 + (a2 + 3);
              v[u] = update(tag, xm[c], xl[c], xh[c], xm[c - X2], xm[c + X2], xm[c - 1],
                            xm[c + 1], bp, dp, a1 * B2 + (a2 + 3), i, j, k);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < C0_PER_THREAD; ++u)
          if (at[u] >= 0) yp[at[u]] = v[u];
      };
      if (full(i))
        run(std::true_type{});
      else
        run(std::false_type{});
    }
    pmg::consumer_sync<NCONS>();

    const int i1 = i - 1;
    if (i1 >= o_lo) {
      // colour 1 of plane i - 1 on the strip: one cell of each aligned
      // pair (k, k + 1), written out with the pair's colour-0 cell
      const float* xm = xs + ((ux - 1) % NX) * XSF;
      const float* yl = ys + ((uy - 2) % NY) * (Y1 * Y2);
      const float* ym = ys + ((uy - 1) % NY) * (Y1 * Y2);
      const float* yh = ys + (uy % NY) * (Y1 * Y2);
      const float* bp = bs + ((ub - 1) % NB) * nbox * BSF;
      const float* dp = bp + (has_b ? BSF : 0);
      float v1[C1_PER_THREAD], v0[C1_PER_THREAD];
      const bool in1 = i1 >= vlo && i1 < vhi;  // else the plane's output is 0
      const auto run = [&](auto tag) {
        constexpr bool F = decltype(tag)::value;
#pragma unroll
        for (int u = 0; u < C1_PER_THREAD; ++u) {
          const int t = tid + u * NCONS;
          const int a1 = t / (T2 / 2), h = t % (T2 / 2);
          const int j = g1 + a1;
          const int odd = ((i1 + rp + j) & 1) == color0;  // colour 1 at k = g2 + 2h + odd
          const int a2 = 2 * h + odd, k = g2 + a2;
          const int c = (a1 + 1) * Y2 + (a2 + 1);
          v0[u] = ym[c + 1 - 2 * odd];
          v1[u] = 0.f;
          if (F || (in1 && j < n1 && k < n2))
            v1[u] = update(tag, xm[(a1 + 2) * X2 + (a2 + 4)], yl[c], yh[c], ym[c - Y2],
                           ym[c + Y2], ym[c - 1], ym[c + 1], bp, dp, (a1 + 1) * B2 + (a2 + 4),
                           i1, j, k);
        }
      };
      if (full(i1))
        run(std::true_type{});
      else
        run(std::false_type{});
#pragma unroll
      for (int u = 0; u < C1_PER_THREAD; ++u) {
        const int t = tid + u * NCONS;
        const int a1 = t / (T2 / 2), h = t % (T2 / 2);
        const int j = g1 + a1, k = g2 + 2 * h;
        if (j >= n1 || k >= n2) continue;
        const int odd = ((i1 + rp + j) & 1) == color0;
        const float lo = odd ? v0[u] : v1[u], hi = odd ? v1[u] : v0[u];
        float* o = out + ((size_t)i1 * n1 + j) * n2 + k;
        if (k + 1 < n2 && (n2 & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(lo, hi);
        } else {
          o[0] = lo;
          if (k + 1 < n2) o[1] = hi;
        }
      }
    }
    rx.release(ux - 1);                       // x plane i - 1 has no reader left
    if (nbox && ub >= 1) rb.release(ub - 1);  // nor b/D plane i - 1
  }
}

// the kernel's shared-memory limit, set once for the largest launch: a
// driver call on every launch is host time that a V(2,2) step, 20 sweeps of
// a few microseconds below 128^3, pays on its critical path
template <bool kStreamD, bool kNoise>
cudaError_t ready() {
  static const cudaError_t e = pmg::allow_smem(sweep_march_kernel<kStreamD, kNoise>, smem_bytes(2));
  return e;
}

template <bool kStreamD>
int launch_mode(const float* x, const float* b, const float* d, float* out, int n0, int n1,
                int n2, int t0, int use_tma, const pmg::StarCoeffs& q, float kappa2,
                float hinv2, float omega, float nscale, unsigned int prefix,
                const unsigned int* prefix_at, int color0, int with_noise, int row_offset, int n0g,
                void* stream) {
  const int nbox = (b != nullptr) + (int)kStreamD;
  const int smem = smem_bytes(nbox);
  // the planes inside the global grid
  const int vlo = row_offset < 0 ? -row_offset : 0;
  const int vhi = n0 < n0g - row_offset ? n0 : n0g - row_offset;
  if (vhi <= vlo) return (int)cudaErrorInvalidValue;
  const size_t skip = (size_t)vlo * n1 * n2;
  CUtensorMap mx, mb, md;
  if (use_tma) {
    if (!pmg::encode_planes(&mx, x + skip, vhi - vlo, n1, n2, X1, X2) ||
        !pmg::encode_planes(&mb, b ? b + skip : nullptr, vhi - vlo, n1, n2, B1, B2) ||
        !pmg::encode_planes(&md, kStreamD ? d + skip : nullptr, vhi - vlo, n1, n2, B1, B2))
      return (int)cudaErrorInvalidValue;
  } else {
    pmg::encode_planes(&mx, nullptr, 0, 0, 0, 0, 0);
    mb = md = mx;
  }
  auto kernel = with_noise ? sweep_march_kernel<kStreamD, true>
                           : sweep_march_kernel<kStreamD, false>;
  const cudaError_t e = with_noise ? ready<kStreamD, true>() : ready<kStreamD, false>();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n2 + T2 - 1) / T2, (n1 + T1 - 1) / T1, (n0 + t0 - 1) / t0);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(x, b, d, out, n0, n1, n2, t0, use_tma, q,
                                                   kappa2, hinv2, omega, nscale,
                                                   (uint32_t)prefix, prefix_at, color0, row_offset,
                                                   n0g, vlo, vhi, mx, mb, md);
  return (int)cudaGetLastError();
}

int launch(const float* x, const float* b, const float* d, float* out, int n0, int n1,
           int n2, int t0, int use_tma, const pmg::StarCoeffs& q, float kappa2, float hinv2,
           float omega, float nscale, unsigned int prefix, const unsigned int* prefix_at,
           int color0, int with_noise, int row_offset, int n0g, void* stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || t0 <= 0 || n0g <= 0) return (int)cudaErrorInvalidValue;
  if (d)
    return launch_mode<true>(x, b, d, out, n0, n1, n2, t0, use_tma, q, kappa2, hinv2, omega,
                             nscale, prefix, prefix_at, color0, with_noise, row_offset, n0g,
                             stream);
  return launch_mode<false>(x, b, d, out, n0, n1, n2, t0, use_tma, q, kappa2, hinv2, omega,
                            nscale, prefix, prefix_at, color0, with_noise, row_offset, n0g,
                            stream);
}

}  // namespace

extern "C" {

// (axis-0 halo, T1, T2), so the loader can check them
void pmg_sweep_march_tile(int* out) {
  out[0] = HALO;
  out[1] = T1;
  out[2] = T2;
}

// (blocks an SM, SMs, dynamic shared bytes) of a launch with b given or
// not and D streamed or not
void pmg_sweep_march_occupancy(int with_b, int stream_d, int* out) {
  const int nbox = (with_b != 0) + (stream_d != 0);
  if (stream_d)
    pmg::occupancy(sweep_march_kernel<true, true>, NT, smem_bytes(nbox), out);
  else
    pmg::occupancy(sweep_march_kernel<false, true>, NT, smem_bytes(nbox), out);
}

// #9: FD only (d must be nullptr)
int pmg_sweep_march_staged(const float* x, const float* b, const float* d, float* out, int n0,
                           int n1, int n2, int t0, int use_tma, float c0lo, float c0hi,
                           float c1lo, float c1hi, float c2lo, float c2hi, float kappa2,
                           float hinv2, float omega, float nscale, unsigned int prefix,
                           const unsigned int* prefix_at, int color0, int with_noise,
                           int row_offset, int n0g, void* stream) {
  if (d) return (int)cudaErrorInvalidValue;
  const pmg::StarCoeffs q{c0lo, c0hi, c1lo, c1hi, c2lo, c2hi};
  return launch(x, b, nullptr, out, n0, n1, n2, t0, use_tma, q, kappa2, hinv2, omega, nscale,
                prefix, prefix_at, color0, with_noise, row_offset, n0g, stream);
}

// #8: d == nullptr: FD mode (D from kappa2, hinv2), else D is read from d
int pmg_sweep_march_windowed(const float* x, const float* b, const float* d, float* out,
                             int n0, int n1, int n2, int t0, int use_tma, float c0lo,
                             float c0hi, float c1lo, float c1hi, float c2lo, float c2hi,
                             float kappa2, float hinv2, float omega, float nscale,
                             unsigned int prefix, const unsigned int* prefix_at, int color0,
                             int with_noise, int row_offset, int n0g, void* stream) {
  const pmg::StarCoeffs q{c0lo, c0hi, c1lo, c1hi, c2lo, c2hi};
  return launch(x, b, d, out, n0, n1, n2, t0, use_tma, q, kappa2, hinv2, omega, nscale,
                prefix, prefix_at, color0, with_noise, row_offset, n0g, stream);
}

// #7: the full sweep below the plane limit, FD (d must be nullptr)
int pmg_sweep_march_fd(const float* x, const float* b, const float* d, float* out, int n0,
                       int n1, int n2, int t0, int use_tma, float c0lo, float c0hi,
                       float c1lo, float c1hi, float c2lo, float c2hi, float kappa2,
                       float hinv2, float omega, float nscale, unsigned int prefix,
                       const unsigned int* prefix_at, int color0, int with_noise, int row_offset,
                       int n0g, void* stream) {
  if (d) return (int)cudaErrorInvalidValue;
  const pmg::StarCoeffs q{c0lo, c0hi, c1lo, c1hi, c2lo, c2hi};
  return launch(x, b, nullptr, out, n0, n1, n2, t0, use_tma, q, kappa2, hinv2, omega, nscale,
                prefix, prefix_at, color0, with_noise, row_offset, n0g, stream);
}

// #6: the full sweep below the plane limit, D streamed (d is required)
int pmg_sweep_march_diag(const float* x, const float* b, const float* d, float* out, int n0,
                         int n1, int n2, int t0, int use_tma, float c0lo, float c0hi,
                         float c1lo, float c1hi, float c2lo, float c2hi, float kappa2,
                         float hinv2, float omega, float nscale, unsigned int prefix,
                         const unsigned int* prefix_at, int color0, int with_noise,
                         int row_offset, int n0g, void* stream) {
  if (!d) return (int)cudaErrorInvalidValue;
  const pmg::StarCoeffs q{c0lo, c0hi, c1lo, c1hi, c2lo, c2hi};
  return launch(x, b, d, out, n0, n1, n2, t0, use_tma, q, kappa2, hinv2, omega, nscale,
                prefix, prefix_at, color0, with_noise, row_offset, n0g, stream);
}

}  // extern "C"
