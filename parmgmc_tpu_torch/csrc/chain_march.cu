// MGMC down-phase of one level by plane marching, one launch.
//
// Replaces four Pallas kernels of parmgmc_tpu/kernels/mg_sweep.py with one
// body, each with its own entry mode, wrapper and launch counter:
//
//   fused_chain_down_fd          (#1)  the chain's level 0 up to the plane
//                                      limit (the 256^3 main path);
//   fused_chain_down_2d_staged   (#5)  the chain's level 0 past it
//                                      (deferred chain);
//   fused_chain_down_2d          (#4)  the same function (sample_chain);
//   fused_zero_gibbs_restrict_fd (#3)  no x stream: the level's cycle from
//                                      zero.
//
// A work item is a (T1, T2) column strip over a segment of t0 planes of
// axis 0 (t0 even, so an aggregate's two planes stay in one segment), one
// block each, recomputing a 3-plane axis-0 halo on each side.  #5, #4 and
// #3 take the long segments of kernels/_march.py's plan (up to 96 planes,
// for 768^3); #1 those of mg_sweep.chain_fd_plan, whose shorter segments
// fill the card at 256^3.
//
// For the chain state x = x_in + P z (x_in == nullptr: x = 0; z optional,
// compact (N0/2, N1/2, N2/2), P the 2x2x2 aggregate prolongation) it
// computes
//
//   r    = b - A x                                (b == nullptr: b = 0)
//   r~   = r + nscale * sqrt(D) * eta             (counter-hash noise)
//   y    = one red/black SOR sweep from zero on r~
//   xpy  = x + y
//   rc   = 2x2x2 aggregate sum of (r - A y)       (N0/2, N1/2, N2/2)
//
// plus optional partial sums of xpy (xsum) and of z (zsum), one slot per
// work item, each summed in a fixed order.  Every grid point is computed
// by the same instructions in every mode and plan, so #1, #4 and #5 agree
// bit for bit and #3(b) equals #5(x = 0, b).
//
// The array may be a block of a larger grid (a halo-extended shard of
// parmgmc_tpu_torch/parallel/fused.py): array plane i is global row g =
// row_offset + i of n0g rows (row_offset = 0, n0g = n0 for a whole grid;
// both even, so rc's plane pairs are the global aggregates).  The
// parity, the FD link count and the noise counter follow g.  Planes
// outside the global grid (the first and last shards' outer halos, vlo
// and vhi below) are outside the grid: x and b are streamed as zeros
// there (the tensor maps and copies start at plane vlo), no cell of
// theirs is computed, and their xpy and rc are 0; so no cell reads a
// neighbour across a global end.  No z with such planes.  For a whole
// grid nothing changes: the same instructions run on the same values.
//
// What bounds it on an H100: device memory by the count, instruction
// issue in fact.  At 768^3 the chain (#5, b = None, z) reads x (1.81 GB)
// and z (0.23 GB) and writes xpy and rc (2.04 GB): 1.22 ms at 3.35 TB/s.
// Each cell costs 79 float operations (0.53 ms at 67 TFLOP/s) plus the
// noise hash's integer work, two mix rounds of ~10 integer operations
// each (noise.cuh), at half the float rate (~0.3 ms); counted in issued
// instructions (the draw ~70, A x and A y, the colour-1 update, the
// bookkeeping; 1.2 draws a strip cell for the halo) it is ~3 ms at the
// SMs' 4 warp-instructions a clock.  At 256^3 (#1) the same counts give a
// byte bound of 0.045 ms and ~0.11 ms of issue; a segment of t0 planes
// draws r~ on t0 + 4 of them, so the short segments that fill the card
// there cost more draws a cell.
//
// Design (csrc/march.cuh).  Loads issued by the computing threads stall
// their phase, and whole-axis strips (576 at 768^3) leave a partial last
// wave of block slots.  So one producer warp streams x
// (38 x 40 boxes, strip + 3), z (20 x 24 boxes) and b (36 x 40, strip +
// 2) into rings of shared-memory stages (7 x, 3 z, 5 b planes) with TMA,
// or with cp.async where a row stride is not a multiple of 16 B; each
// stage completes on an mbarrier.  4,608 work items at 768^3 fill 3
// blocks an SM in 11.6 waves.  Eight consumer warps run at step s:
// (2) r~ of plane s - 1 on the strip + 1 and the colour-0 cells of the
// ring around it, colour-0 phase applied, into a ring of 5 planes: a warp
// a row and a lane a column of the strip's own columns (no division, no
// bank conflict), the side columns and the ring in the batch that the
// warps with one row fewer have free, 5 cells a thread whose draws the
// compiler interleaves; barrier; (3) the colour-1 phase of plane s - 2 in
// place on the strip + 1, colour-1 cells only (it reads only colour-0
// neighbours, which it does not write), and x + P z of plane s + 1 added
// in place into its x stage, 4 cells a float4; barrier; (4) xpy and A y
// of plane s - 3 on the strip, a lane a column of two row pairs, r - A y
// restricted once both planes of an aggregate are done (the even
// plane's value kept in registers, the aggregate's column pair added
// with a shuffle, in the order AggregateTransfer.restrict adds).  The two
// barriers are the two true dependencies (colour 1 needs colour-0 values,
// A y needs y, from other threads); the rings are deep enough that no
// other barrier guards a slot.  z is read once, into its stage: zsum is
// taken there.  The x stream and the noise are template flags, a block
// inside the grid skips the link counts and bound tests, and the draw's
// square root has no branch (noise.cuh), so the batches have none.  The
// in-plane halo is recomputed by the neighbouring strips; the axis-0 halo
// costs 6 x planes a segment (6 % at 96 planes).  D, omega / D and nscale
// sqrt(D) come from 7-entry tables (one per link count) instead of a
// division and a square root a cell.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "march.cuh"
#include "noise.cuh"

namespace {

constexpr int HALO = 3;                   // axis-0 halo planes of a segment
constexpr int T1 = 32, T2 = 32;           // strip; kernels.TILES["chain_march"]
// TMA boxes start on a 16-B column (k % 4 == 0): x on the strip + 3 rows
// at (g1-3, g2-4), b on the strip + 2 rows at (g1-2, g2-4), both 40
// columns wide; z at (g1/2-2, g2/2-4), 24 wide
constexpr int X1 = T1 + 6, X2 = T2 + 8;
constexpr int B1 = T1 + 4, B2 = T2 + 8;
constexpr int Z1 = T1 / 2 + 4, Z2 = T2 / 2 + 8;
constexpr int R1 = T1 + 4, R2 = T2 + 4;  // r~ / y ring, strip + 2, at (g1-2, g2-2)
constexpr int XSF = pmg::stage_floats(X1, X2), ZSF = pmg::stage_floats(Z1, Z2);
constexpr int BSF = pmg::stage_floats(B1, B2), VSF = R1 * R2;
// x planes s - 4 .. s + 1 in use at step s and one in flight; r~/y
// planes s - 5 .. s - 1 (step s + 1 writes the slot of s - 5 after the
// first barrier of step s + 1, which follows its last reader); b planes
// s - 3 .. s - 1 and two in flight; z planes of x s - 4 .. s + 1
constexpr int NX = 7, NV = 5, NB = 5, NZ = 3;
constexpr int NCONS = (T1 / 2) * (T2 / 2);  // one thread per aggregate column
constexpr int NT = NCONS + 32;              // 8 consumer warps, 1 producer
// cells of r~ a step: the strip + 1 and the ring's colour-0 cells, as
// CORE_ROWS rows of the strip's T2 columns (a warp a row, a lane a column)
// and EXTRA_CELLS more; a consumer thread takes R_PER_THREAD of them.  Of
// the colour-1 phase: the strip + 1's colour-1 cells
constexpr int NWARPS = NCONS / 32;
constexpr int CORE_ROWS = R1 - 2;
constexpr int EXTRA_CELLS = 2 * (R1 - 2) + R1 + R2 - 2;
constexpr int R_PER_THREAD = (CORE_ROWS + NWARPS - 1) / NWARPS;
static_assert(T2 == 32, "a lane a column of the strip");
static_assert((NWARPS - CORE_ROWS % NWARPS) * 32 >= EXTRA_CELLS &&
                  CORE_ROWS % NWARPS != 0 && CORE_ROWS / NWARPS + 1 == R_PER_THREAD,
              "the extra cells fill the last batch of the warps with one row fewer");
constexpr int Y_PER_THREAD = ((R1 - 2) * ((R2 - 2) / 2) + NCONS - 1) / NCONS;

int smem_bytes(bool has_x, bool has_b, bool has_z) {
  return (NX * XSF * has_x + NZ * ZSF * has_z + NB * BSF * has_b + NV * VSF) *
         (int)sizeof(float);
}

struct Coeffs {
  float c0lo, c0hi, c1lo, c1hi, c2lo, c2hi;
};

// in-grid link count of a cell of global row g of n0g: D = kappa2 + hinv2
// * links takes one of 7 values, so D, omega / D and nscale * sqrt(D) come
// from per-block tables
__device__ __forceinline__ int links_at(int g, int j, int k, int n0g, int n1, int n2) {
  return (g >= 1) + (g <= n0g - 2) + (j >= 1) + (j <= n1 - 2) + (k >= 1) + (k <= n2 - 2);
}

// off-diagonal star sum at in-plane cell c of plane ring entries lo (i-1),
// mid (i), hi (i+1) with row stride s1; cells outside the grid hold 0
__device__ __forceinline__ float neigh(const float* lo, const float* mid, const float* hi,
                                       int c, int s1, const Coeffs& q) {
  return q.c0lo * lo[c] + q.c0hi * hi[c] + q.c1lo * mid[c - s1] + q.c1hi * mid[c + s1] +
         q.c2lo * mid[c - 1] + q.c2hi * mid[c + 1];
}

// deterministic sum over the consumer threads (fixed shuffle tree, then
// warp 0); the result is valid in thread 0
__device__ __forceinline__ float consumer_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  pmg::consumer_sync<NCONS>();
  float s = 0.f;
  if (warp == 0) {
    s = lane < NCONS / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  pmg::consumer_sync<NCONS>();
  return s;
}

// kX: an x stream (else x = 0: #3); kNoise: the noise draw.  Both are
// template flags so the per-cell batches compile without branches
template <bool kX, bool kNoise>
__global__ void __launch_bounds__(NT, 3)
    chain_march_kernel(const float* __restrict__ x, const float* __restrict__ b,
                       const float* __restrict__ z, float* __restrict__ xpy,
                       float* __restrict__ rc, float* __restrict__ xsum,
                       float* __restrict__ zsum, int n0, int n1, int n2, int t0, int use_tma,
                       Coeffs q, float kappa2, float hinv2, float omega, float nscale,
                       uint32_t prefix_arg, const uint32_t* __restrict__ prefix_at,
                       int color0, int row_offset, int n0g, int vlo, int vhi,
                       const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mb,
                       const __grid_constant__ CUtensorMap mz) {
  extern __shared__ __align__(128) float smem[];
  __shared__ pmg::Ring<NX> rx;
  __shared__ pmg::Ring<NB> rb;
  __shared__ pmg::Ring<NZ> rz;
  __shared__ float red[NCONS / 32];
  // per link count: D, omega / D, nscale * sqrt(D) (csrc/chain_down.cu's
  // per-cell float operations, evaluated once per link count)
  __shared__ float dtab[7], wtab[7], ntab[7];
  constexpr bool has_x = kX;
  const bool has_b = b != nullptr, has_z = z != nullptr;
  float* xs = smem;                         // NX planes of (X1, X2)
  float* zs = xs + NX * XSF * has_x;        // NZ planes of (Z1, Z2)
  float* bs = zs + NZ * ZSF * has_z;        // NB planes of (B1, B2)
  float* vs = bs + NB * BSF * has_b;        // NV planes of (R1, R2)
  // the noise key: read from device memory when given (a replayed graph's
  // step), else the launch argument
  const uint32_t prefix = prefix_at ? __ldg(prefix_at) : prefix_arg;
  const int tid = threadIdx.x;
  if (tid < 7) {
    const float d = kappa2 + hinv2 * (float)tid;
    dtab[tid] = d;
    wtab[tid] = omega / d;
    ntab[tid] = nscale * sqrtf(d);
  }
  const int g1 = blockIdx.y * T1, g2 = blockIdx.x * T2;
  const int o_lo = blockIdx.z * t0, o_hi = min(o_lo + t0, n0);
  const int first = o_lo - HALO, last = o_hi + HALO - 1;  // x planes streamed
  const int bfirst = o_lo - 2;                            // b planes o_lo - 2 .. o_hi + 1
  const int m0 = n0 >> 1, m1 = n1 >> 1, m2 = n2 >> 1;
  // planes vlo .. vhi - 1 lie inside the global grid; x and b loads start there
  const size_t skip = (size_t)vlo * n1 * n2;
  const int nin = vhi - vlo;
  if (tid == 0) {
    rx.init(use_tma ? 1 : 32, NCONS / 32);
    rb.init(use_tma ? 1 : 32, NCONS / 32);
    rz.init(use_tma ? 1 : 32, NCONS / 32);
    pmg::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // producer warp, in plane order: x plane p, the z plane it first
    // needs, and b plane p
    const int lane = tid - NCONS;
    for (int p = first; p <= last; ++p) {
      if (has_x) {
        const int ux = p - first;
        rx.wait_empty(ux);
        float* dst = xs + (ux % NX) * XSF;
        uint64_t* bar = &rx.full[ux % NX];
        if (use_tma) {
          if (lane == 0) {
            pmg::mbar_expect_tx(bar, X1 * X2 * 4);
            pmg::tma_load_3d(dst, &mx, bar, g2 - 4, g1 - 3, p - vlo);
          }
        } else {
          pmg::cpasync_box(dst, x + skip, X1, X2, g2 - 4, g1 - 3, p - vlo, nin, n1, n2, lane);
          pmg::cpasync_arrive(bar);
        }
        if (has_z && (p == first || (p & 1) == 0)) {
          const int uz = (p >> 1) - (first >> 1);
          rz.wait_empty(uz);
          float* zdst = zs + (uz % NZ) * ZSF;
          uint64_t* zbar = &rz.full[uz % NZ];
          if (use_tma) {
            if (lane == 0) {
              pmg::mbar_expect_tx(zbar, Z1 * Z2 * 4);
              pmg::tma_load_3d(zdst, &mz, zbar, (g2 >> 1) - 4, (g1 >> 1) - 2, p >> 1);
            }
          } else {
            pmg::cpasync_box(zdst, z, Z1, Z2, (g2 >> 1) - 4, (g1 >> 1) - 2, p >> 1, m0, m1, m2,
                             lane);
            pmg::cpasync_arrive(zbar);
          }
        }
      }
      if (has_b && p >= bfirst && p <= o_hi + 1) {
        const int ub = p - bfirst;
        rb.wait_empty(ub);
        float* dst = bs + (ub % NB) * BSF;
        uint64_t* bar = &rb.full[ub % NB];
        if (use_tma) {
          if (lane == 0) {
            pmg::mbar_expect_tx(bar, B1 * B2 * 4);
            pmg::tma_load_3d(dst, &mb, bar, g2 - 4, g1 - 2, p - vlo);
          }
        } else {
          pmg::cpasync_box(dst, b + skip, B1, B2, g2 - 4, g1 - 2, p - vlo, nin, n1, n2, lane);
          pmg::cpasync_arrive(bar);
        }
      }
    }
    if (!use_tma) pmg::cpasync_wait_all();
    return;
  }

  __builtin_assume(tid < NCONS);
  const int lane = tid & 31, warp = tid >> 5;
  // zsum: one aggregate column a thread
  const int cj = tid / (T2 / 2), ck = tid % (T2 / 2);
  const bool owner = g1 + 2 * cj < n1 && g2 + 2 * ck < n2;  // even extents: whole aggregate
  // every row and column the block computes on (the strip + 2) is inside
  // the grid and has both in-plane links
  const bool inner = g1 >= 3 && g1 + T1 + 3 <= n1 && g2 >= 3 && g2 + T2 + 3 <= n2;
  // plane i of an inner block takes the 6-link path: two axis-0 links in
  // the global grid (so inside it) and inside the array
  const auto full = [&](int i) {
    return inner && i >= vlo && i < vhi && row_offset + i >= 1 && row_offset + i <= n0g - 2;
  };
  const int rp = row_offset & 1;  // parity of the global row of plane 0
  float reven[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // phase 4: r of the even plane
  float xacc = 0.f, zacc = 0.f;
  auto xplane = [&](int p) { return xs + ((p - first) % NX) * XSF; };
  auto vplane = [&](int i) { return vs + ((i - bfirst) % NV) * VSF; };
  auto bplane = [&](int i) { return bs + ((i - bfirst) % NB) * BSF; };

  // x + P z of plane p in place in its stage (zero outside the grid, as
  // both boxes are); zsum over the segment's own z planes
  auto prep = [&](int p) {
    rx.wait_full(p - first);
    if (!has_z) return;
    const int uz = (p >> 1) - (first >> 1);
    rz.wait_full(uz);
    float* xp = xplane(p);
    const float* zp = zs + (uz % NZ) * ZSF;
    const int zj = (g1 >> 1) - 2;
    // 4 x cells (16 B) share 2 z cells: the box starts on a 4-column
    // boundary, z's on a 2-column one (column g2/2 - 4 holds k = g2 - 8)
    for (int t = tid; t < X1 * (X2 / 4); t += NCONS) {
      const int a1 = t / (X2 / 4), q4 = t % (X2 / 4);
      float4* xv = reinterpret_cast<float4*>(xp + a1 * X2) + q4;
      const float2 zv =
          *reinterpret_cast<const float2*>(zp + (((g1 - 3 + a1) >> 1) - zj) * Z2 + 2 + 2 * q4);
      float4 w = *xv;
      w.x += zv.x;
      w.y += zv.x;
      w.z += zv.y;
      w.w += zv.y;
      *xv = w;
    }
    if (owner && (p & 1) == 0 && p >= o_lo && p < o_hi) zacc += zp[(cj + 2) * Z2 + (ck + 4)];
    if ((p & 1) || p == last) rz.release(uz);
  };
  if (has_x) {
    for (int p = first; p < o_lo; ++p) prep(p);
    pmg::consumer_sync<NCONS>();
  }

  for (int s = o_lo - 1; s <= o_hi + 2; ++s) {
    // 2. r~ = (b - A x) + noise of plane s - 1 on the strip + 2; the
    //    colour-0 phase from zero in place
    {
      const int i = s - 1;
      const float* xl = has_x ? xplane(i - 1) : nullptr;
      const float* xm = has_x ? xplane(i) : nullptr;
      const float* xh = has_x ? xplane(i + 1) : nullptr;
      if (has_x) rx.wait_full(s - first);
      if (has_b) rb.wait_full(i - bfirst);
      const float* bp = has_b ? bplane(i) : nullptr;
      float* vp = vplane(i);
      const bool in0 = i >= vlo && i < vhi;
      // the strip + 1, and the colour-0 cells of the ring around it (its
      // colour-1 cells have no reader); v computed for all first, then
      // stored, so the batch's noise draws overlap
      // F: every cell the step touches is inside the grid with 6 links
      const auto run = [&](auto tag) {
        constexpr bool F = decltype(tag)::value;
        const float d6 = dtab[6], n6 = ntab[6], w6 = wtab[6];  // F: every cell's
        float v[R_PER_THREAD];
        int at[R_PER_THREAD];
#pragma unroll
        for (int u = 0; u < R_PER_THREAD; ++u) {
          at[u] = -1;
          v[u] = 0.f;
          int a1, a2;
          if (u < CORE_ROWS / NWARPS || warp < CORE_ROWS % NWARPS) {
            // the strip's own columns on the strip + 1 rows: warp = row,
            // lane = column
            a1 = 1 + warp + NWARPS * u;
            a2 = 2 + lane;
          } else {
            // the rest, one cell a lane of the remaining warps: the strip +
            // 1's two side columns, then the ring's colour-0 cells
            const int e = (warp - CORE_ROWS % NWARPS) * 32 + lane;
            if (e >= EXTRA_CELLS) continue;
            if (e < 2 * (R1 - 2)) {
              a2 = e < R1 - 2 ? 1 : R2 - 2;
              a1 = 1 + e % (R1 - 2);
            } else if (e < 2 * (R1 - 2) + R2) {  // rows 0 and R1 - 1
              const int r = e - 2 * (R1 - 2);
              a1 = r < R2 / 2 ? 0 : R1 - 1;
              a2 = 2 * (r % (R2 / 2)) + ((color0 ^ (i + rp + g1 + g2 + a1)) & 1);
            } else {                             // columns 0 and R2 - 1
              const int r = e - 2 * (R1 - 2) - R2;
              a2 = r < (R1 - 2) / 2 ? 0 : R2 - 1;
              a1 = 1 + 2 * (r % ((R1 - 2) / 2)) + ((1 ^ color0 ^ (i + rp + g1 + g2 + a2)) & 1);
            }
          }
          const int j = g1 + a1 - 2, k = g2 + a2 - 2;
          at[u] = a1 * R2 + a2;
          if (F || (in0 && j >= 0 && j < n1 && k >= 0 && k < n2)) {
            const int g = row_offset + i;
            const uint32_t id = ((uint32_t)g * n1 + j) * n2 + k;  // the noise counter
            const int l = F ? 6 : links_at(g, j, k, n0g, n1, n2);
            float ax = 0.f;
            if (has_x) {
              const int c = (a1 + 1) * X2 + (a2 + 2);
              ax = (F ? d6 : dtab[l]) * xm[c] + neigh(xl, xm, xh, c, X2, q);
            }
            float r = (has_b ? bp[a1 * B2 + (a2 + 2)] : 0.f) - ax;
            if (kNoise) r = r + (F ? n6 : ntab[l]) * pmg::eta<true>(prefix, id);
            if (((i + rp + j + k) & 1) == color0) r = (F ? w6 : wtab[l]) * r;
            v[u] = r;
          }
        }
#pragma unroll
        for (int u = 0; u < R_PER_THREAD; ++u)
          if (at[u] >= 0) vp[at[u]] = v[u];
      };
      if (full(i))
        run(std::true_type{});
      else
        run(std::false_type{});
    }
    pmg::consumer_sync<NCONS>();

    // 3. colour-1 phase of plane s - 2 in place on the strip + 1 (it reads
    //    only colour-0 neighbours); then x + P z of plane s + 1
    {
      const int i = s - 2;  // planes o_lo - 1 .. o_hi
      if (i >= o_lo - 1 && i >= vlo && i < vhi) {
        const float* vl = vplane(i - 1);
        float* vm = vplane(i);
        const float* vh = vplane(i + 1);
        // colour-1 cells only: 17 a row of the strip + 1
        const auto run = [&](auto tag) {
          constexpr bool F = decltype(tag)::value;
          const float w6 = wtab[6];
          float v[Y_PER_THREAD];
          int at[Y_PER_THREAD];
#pragma unroll
          for (int u = 0; u < Y_PER_THREAD; ++u) {
            const int t = tid + u * NCONS;
            at[u] = -1;
            if (t >= (R1 - 2) * ((R2 - 2) / 2)) continue;
            const int a1 = 1 + t / ((R2 - 2) / 2);
            const int a2 =
                1 + 2 * (t % ((R2 - 2) / 2)) + ((color0 ^ (i + rp + g1 + g2 + a1)) & 1);
            const int j = g1 + a1 - 2, k = g2 + a2 - 2;
            if (F || (j >= 0 && j < n1 && k >= 0 && k < n2)) {
              const int c = a1 * R2 + a2, g = row_offset + i;
              at[u] = c;
              v[u] = (F ? w6 : wtab[links_at(g, j, k, n0g, n1, n2)]) *
                     (vm[c] - neigh(vl, vm, vh, c, R2, q));
            }
          }
#pragma unroll
          for (int u = 0; u < Y_PER_THREAD; ++u)
            if (at[u] >= 0) vm[at[u]] = v[u];
        };
        if (full(i))
          run(std::true_type{});
        else
          run(std::false_type{});
      }
      if (has_x && s + 1 <= last) prep(s + 1);
    }
    pmg::consumer_sync<NCONS>();

    // 4. outputs of plane s - 3 on the strip: xpy, and r - A y restricted
    //    once both planes of the aggregate are done.  A warp takes two
    //    row pairs of the strip, a lane one column (neighbouring lanes on
    //    neighbouring banks); the lane pair of an aggregate adds its two
    //    column sums with a shuffle
    const int i = s - 3;
    if (i >= o_lo && i < o_hi) {
      const float* xl = has_x ? xplane(i - 1) : nullptr;
      const float* xm = has_x ? xplane(i) : nullptr;
      const float* xh = has_x ? xplane(i + 1) : nullptr;
      const float* yl = vplane(i - 1);
      const float* ym = vplane(i);
      const float* yh = vplane(i + 1);
      const float* bp = has_b ? bplane(i) : nullptr;
      const int k = g2 + lane;
      float r[2][2], o[2][2];  // [row pair][row of the pair]
      const bool in4 = i >= vlo && i < vhi;  // else the plane's outputs are 0
      const auto run = [&](auto tag) {
        constexpr bool F = decltype(tag)::value;
        const float d6 = dtab[6];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            if (!F && !in4) {
              r[u][dj] = o[u][dj] = 0.f;
              continue;
            }
            const int a1 = 2 * (warp + NWARPS * u) + dj, j = g1 + a1, g = row_offset + i;
            const int cy = (a1 + 2) * R2 + (lane + 2);
            const float d = F ? d6 : dtab[links_at(g, j, k, n0g, n1, n2)];
            float xv = 0.f, ax = 0.f;
            if (has_x) {
              const int cx = (a1 + 3) * X2 + (lane + 4);
              xv = xm[cx];
              ax = d * xv + neigh(xl, xm, xh, cx, X2, q);
            }
            const float yv = ym[cy];
            const float ay = d * yv + neigh(yl, ym, yh, cy, R2, q);
            r[u][dj] = ((has_b ? bp[(a1 + 2) * B2 + (lane + 4)] : 0.f) - ax) - ay;
            o[u][dj] = xv + yv;
          }
      };
      if (full(i))
        run(std::true_type{});
      else
        run(std::false_type{});
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jp = g1 + 2 * (warp + NWARPS * u);
        const bool valid = jp < n1 && (k & ~1) < n2;  // even extents: whole aggregates
        if (valid) {
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) xpy[((size_t)i * n1 + (jp + dj)) * n2 + k] = o[u][dj];
          xacc += o[u][0] + o[u][1];
        }
        if ((i & 1) == 0) {
          reven[u][0] = r[u][0];
          reven[u][1] = r[u][1];
        } else {
          // axis-0 pairs, then axis 1, then axis 2 (AggregateTransfer.restrict)
          const float col = (reven[u][0] + r[u][0]) + (reven[u][1] + r[u][1]);
          const float other = __shfl_xor_sync(0xffffffffu, col, 1);
          if (valid && (lane & 1) == 0)
            rc[((size_t)(i >> 1) * m1 + (jp >> 1)) * m2 + (k >> 1)] = col + other;
        }
      }
    }
    // x plane s - 4 and b plane s - 3 have no reader left
    if (has_x && s - 4 >= first) rx.release(s - 4 - first);
    if (has_b && s - 3 >= bfirst) rb.release(s - 3 - bfirst);
  }
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (xsum) {
    const float s = consumer_sum(xacc, red);
    if (tid == 0) xsum[blk] = s;
  }
  if (zsum) {
    const float s = consumer_sum(zacc, red);
    if (tid == 0) zsum[blk] = s;
  }
}

// t0 = planes a work item (even); use_tma: stream through TMA (else
// cp.async); x == nullptr is the from-zero level (#3); prefix_at, when not
// nullptr, holds the noise key in device memory in place of prefix
int launch(const float* x, const float* b, const float* z, float* xpy, float* rc,
           float* xsum, float* zsum, int n0, int n1, int n2, int t0, int use_tma,
           float c0lo, float c0hi, float c1lo, float c1hi, float c2lo, float c2hi,
           float kappa2, float hinv2, float omega, float nscale, unsigned int prefix,
           const unsigned int* prefix_at, int color0, int with_noise, int row_offset, int n0g,
           void* stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || (n0 | n1 | n2) & 1 || t0 <= 0 || (t0 & 1) ||
      (z && !x) || n0g <= 0 || ((row_offset | n0g) & 1))
    return (int)cudaErrorInvalidValue;
  // the planes inside the global grid (even bounds: whole aggregates)
  const int vlo = row_offset < 0 ? -row_offset : 0;
  const int vhi = n0 < n0g - row_offset ? n0 : n0g - row_offset;
  if (vhi <= vlo || (z && (vlo != 0 || vhi != n0))) return (int)cudaErrorInvalidValue;
  const size_t skip = (size_t)vlo * n1 * n2;
  CUtensorMap mx, mb, mz;
  if (use_tma) {
    if (!pmg::encode_planes(&mx, x ? x + skip : nullptr, vhi - vlo, n1, n2, X1, X2) ||
        !pmg::encode_planes(&mb, b ? b + skip : nullptr, vhi - vlo, n1, n2, B1, B2) ||
        !pmg::encode_planes(&mz, z, n0 / 2, n1 / 2, n2 / 2, Z1, Z2))
      return (int)cudaErrorInvalidValue;
  } else {
    pmg::encode_planes(&mx, nullptr, 0, 0, 0, 0, 0);
    mb = mz = mx;
  }
  const int smem = smem_bytes(x != nullptr, b != nullptr, z != nullptr);
  auto kernel = x ? (with_noise ? chain_march_kernel<true, true>
                                : chain_march_kernel<true, false>)
                  : (with_noise ? chain_march_kernel<false, true>
                                : chain_march_kernel<false, false>);
  const cudaError_t e = pmg::allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n2 + T2 - 1) / T2, (n1 + T1 - 1) / T1, (n0 + t0 - 1) / t0);
  const Coeffs q{c0lo, c0hi, c1lo, c1hi, c2lo, c2hi};
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(x, b, z, xpy, rc, xsum, zsum, n0, n1, n2, t0,
                                                   use_tma, q, kappa2, hinv2, omega, nscale,
                                                   (uint32_t)prefix, prefix_at, color0, row_offset,
                                                   n0g, vlo, vhi, mx, mb, mz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (axis-0 halo, T1, T2), so the loader can check them
void pmg_chain_march_tile(int* out) {
  out[0] = HALO;
  out[1] = T1;
  out[2] = T2;
}

// (blocks an SM, SMs, dynamic shared bytes) of a launch with the given
// streams
void pmg_chain_march_occupancy(int with_x, int with_b, int with_z, int* out) {
  if (with_x)
    pmg::occupancy(chain_march_kernel<true, true>, NT, smem_bytes(true, with_b, with_z), out);
  else
    pmg::occupancy(chain_march_kernel<false, true>, NT, smem_bytes(false, with_b, with_z), out);
}

#define PMG_CHAIN_ARGS                                                                     \
  const float *x, const float *b, const float *z, float *xpy, float *rc, float *xsum,      \
      float *zsum, int n0, int n1, int n2, int t0, int use_tma, float c0lo, float c0hi,    \
      float c1lo, float c1hi, float c2lo, float c2hi, float kappa2, float hinv2,           \
      float omega, float nscale, unsigned int prefix, const unsigned int *prefix_at,       \
      int color0, int with_noise, int row_offset, int n0g, void *stream
#define PMG_CHAIN_PASS                                                                   \
  x, b, z, xpy, rc, xsum, zsum, n0, n1, n2, t0, use_tma, c0lo, c0hi, c1lo, c1hi, c2lo, c2hi, \
      kappa2, hinv2, omega, nscale, prefix, prefix_at, color0, with_noise, row_offset, n0g, stream

// #5, #4, #3
int pmg_chain_march(PMG_CHAIN_ARGS) { return launch(PMG_CHAIN_PASS); }

// #1: the chain's level 0 up to the plane limit (x required), in the
// geometry of mg_sweep.chain_fd_plan
int pmg_chain_march_fd(PMG_CHAIN_ARGS) {
  return x ? launch(PMG_CHAIN_PASS) : (int)cudaErrorInvalidValue;
}

#undef PMG_CHAIN_PASS
#undef PMG_CHAIN_ARGS

}  // extern "C"
