// Every smoothed level of the MGMC tail down-phase, ONE cooperative launch.
//
// Replaces the Pallas kernel parmgmc_tpu/kernels/mg_tail.py
// fused_tail_down (body _kernel_tail, math in _tail_levels), which runs
// every tail level in one launch out of TPU VMEM.  For each link-count FD
// level li (off-diagonals -hinv2) with RHS b (level 0: the caller's;
// level li + 1: level li's rc):
//
//   b~  = b + nscale * sqrt(D) * eta       (eta keyed like _eta_hash)
//   y   = one red/black SOR sweep from zero on b~
//   rc  = 2x2x2 aggregate sum of (b - A y)  (the next level's RHS)
//
// in the tail's own arithmetic form: A y = D y + (-hinv2) * (the sum of the
// six neighbours), as _tail_levels writes it.
//
// What bounds it on an H100: at the 256^3 hierarchy's 128^3 entry level it
// reads b (8 MB) and writes y (8 MB) and rc (1 MB): ~5 us of device memory
// time; the levels' fields (~29 MB with the phase-1 scratch) stay in the
// 50 MB L2.  Each cell costs one noise draw, ~100 issued instructions
// (noise.cuh): ~7 us at 128^3 at the SMs' issue rate.  The smaller levels
// are bound by latency: a grid barrier and one tile's loads a level.
//
// Design.  A level marched plane by plane (the chain body, csrc/
// chain_march.cu) recomputes a halo of 4 planes of draws a segment, ~2
// draws a cell at 128^3 in segments that fill the card, and runs each
// small level as a few serial plane steps; and three grid-wide phases a
// level (noise, colour 1, restriction) wait on two grid barriers and
// many L2 round trips a level.  Here the grid of blocks works on one
// level at a time in two phases, one grid barrier apart:
//
//   1. b~ and the colour-0 update from zero, v = omega / D * b~ on
//      colour-0 cells and v = b~ on colour-1 cells, into a scratch field v
//      (a warp 64 cells of a row, a lane a pair, two rows a warp in flight);
//   2. a block a tile of 8 x 16 x 32 cells at a time: v on the tile + 2
//      into shared memory (cp.async, every copy in flight at once); the
//      colour-1 update on the tile + 1 there, y = omega / D * (b~ - A_off y),
//      which reads only colour-0 values, final since phase 1; then a
//      thread an aggregate: y of its 8 cells out, r = b - A y summed into
//      rc, and phase 1 of the next level at that coarse cell (its phase 1
//      reads nothing but its own cell).
//
// So no draw is recomputed (the tiles' halo costs loads, not draws), L
// levels take L grid barriers, and phase 1 of level li + 1 runs inside
// phase 2 of level li.  v is separate from y: a tile's halo reads b~ of
// colour-1 cells that a neighbouring tile finishes.  D, omega / D and
// nscale sqrt(D) come from 7-entry tables a level (one per link count),
// all in shared memory from the start.  Values another block wrote are
// read through L2 (ld.global.cg): the SMs' L1 is not coherent within a
// launch (the tile copies go through L1, which holds no line of a level's
// v before its tile phase: every earlier access to it was a store).  The
// grid is as large as the card keeps resident (at most
// MAX_BLOCKS_PER_SM blocks an SM) and no larger than the largest phase
// needs (kernels/mg_tail.py, tail_blocks).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;                 // threads a block
constexpr int NW = NT / 32;             // warps a block
// one block an SM: the draws and the tile phase want ~100 registers a
// thread, which two 512-thread blocks (64 each) would spill
constexpr int MAX_BLOCKS_PER_SM = 1;
constexpr int MAX_LEVELS = 10;          // levels a launch takes (2^(3 * 10) points)

struct Level {
  const float* b;
  float* v;  // phase 1's field
  float* y;
  float* rc;
  int n0, n1, n2;
  float kappa2, hinv2, omega, nscale;
  uint32_t prefix;
};

struct TailArgs {
  Level lv[MAX_LEVELS];
  // each level's noise key in device memory (a replayed graph's step), in
  // place of the levels' own prefix; nullptr: those
  const uint32_t* prefix_at;
  int nlev, color0;
  int b_aligned;  // the first level's b (the caller's) is 8-B aligned
};

__device__ __forceinline__ int links_at(int i, int j, int k, int n0, int n1, int n2) {
  return (i >= 1) + (i <= n0 - 2) + (j >= 1) + (j <= n1 - 2) + (k >= 1) + (k <= n2 - 2);
}

// the pair of cells (i, j, k0), (i, j, k0 + 1) of field p (k0 even, so a
// pair never straddles the grid's edge), through L2; zeros outside the
// grid or for a lane with no pair (on false).  aligned: p is 8-B aligned,
// one 8-B load
__device__ __forceinline__ float2 pair_at(const float* p, const Level& L, int i, int j, int k0,
                                          bool on, bool aligned) {
  if (!on || i < 0 || i >= L.n0 || j < 0 || j >= L.n1) return make_float2(0.f, 0.f);
  const float* q = p + ((size_t)i * L.n1 + j) * L.n2 + k0;
  return aligned ? __ldcg(reinterpret_cast<const float2*>(q)) : make_float2(__ldcg(q), __ldcg(q + 1));
}

// phase 1: the warps of the grid walk items of 64 cells of a row, a lane a
// pair of cells, U1 items an iteration with their loads issued together
// (and their draws interleaved)
constexpr int U1 = 2;
__device__ __forceinline__ int warp_id() { return blockIdx.x * NW + (threadIdx.x >> 5); }

// item w of phase 1 over rows of `chunks` chunks: (row, the lane's first
// column, on: the lane has a pair)
struct Slot {
  int i, j, k0;
  bool on;
};
__device__ __forceinline__ Slot slot(const Level& L, int w, int items, int chunks, int width) {
  const int lane = threadIdx.x & 31;
  if (w >= items) return Slot{0, 0, 0, false};
  const int row = w / chunks, k0 = (w - row * chunks) * width + 2 * lane;
  const int i = row / L.n1;
  return Slot{i, row - i * L.n1, k0, k0 < L.n2};
}

// a level's tables, per link count: D, omega / D, nscale * sqrt(D); and
// its noise key
struct Tables {
  float d[7], w[7], n[7];
  uint32_t prefix;
};

// phase 1 at cell (i, j, k) of L (flat index id) with RHS value r
template <bool kNoise>
__device__ __forceinline__ float noisy_colour0(const Level& L, const Tables& t, int color0,
                                               int i, int j, int k, size_t id, float r) {
  const int l = links_at(i, j, k, L.n0, L.n1, L.n2);
  if (kNoise) r = r + t.n[l] * pmg::eta<true>(t.prefix, (uint32_t)id);
  return ((i + j + k) & 1) == color0 ? t.w[l] * r : r;
}

// 1. b~ and the colour-0 update from zero (the first level; b_aligned: its
//    b is 8-B aligned)
template <bool kNoise>
__device__ __forceinline__ void phase_noise(const Level& L, const Tables& t, int color0,
                                            bool b_aligned) {
  const int chunks = (L.n2 + 63) >> 6, items = L.n0 * L.n1 * chunks, stride = gridDim.x * NW;
  for (int w = warp_id(); w < items; w += U1 * stride) {
    Slot c[U1];
    float2 b[U1];
#pragma unroll
    for (int u = 0; u < U1; ++u) {
      c[u] = slot(L, w + u * stride, items, chunks, 64);
      b[u] = pair_at(L.b, L, c[u].i, c[u].j, c[u].k0, c[u].on, b_aligned);
    }
#pragma unroll
    for (int u = 0; u < U1; ++u) {
      if (!c[u].on) continue;
      const size_t id = ((size_t)c[u].i * L.n1 + c[u].j) * L.n2 + c[u].k0;
      const float v0 = noisy_colour0<kNoise>(L, t, color0, c[u].i, c[u].j, c[u].k0, id, b[u].x);
      const float v1 =
          noisy_colour0<kNoise>(L, t, color0, c[u].i, c[u].j, c[u].k0 + 1, id + 1, b[u].y);
      *reinterpret_cast<float2*>(L.v + id) = make_float2(v0, v1);
    }
  }
}

// 2. per tile of T0 x T1 x T2 cells (aggregate-aligned): the phase-1
//    field v on the tile + 2 into shared memory (zero outside the grid);
//    the colour-1 update on the tile + 1 there, y = omega / D * (b~ -
//    A_off y), which reads only colour-0 neighbours, final since phase 1;
//    then a thread an aggregate: y of its 8 cells out, r = b - A y summed
//    into rc (axis-0 pairs, then axis 1, then axis 2, the _tail_levels
//    order), and with a next level N, phase 1 of N at the aggregate's
//    coarse cell
constexpr int T0 = 8, T1 = 16, T2 = 32;  // 512 aggregates: a thread each
constexpr int S0 = T0 + 4, S1 = T1 + 4, S2 = T2 + 4;
constexpr int STAGE = S0 * S1 * S2;
constexpr int LOADS = (STAGE + NT - 1) / NT;
constexpr int C1 = (S0 - 2) * (S1 - 2) * ((S2 - 2) / 2);  // pairs of the tile + 1
constexpr int C1_PER_THREAD = (C1 + NT - 1) / NT;
static_assert((T0 / 2) * (T1 / 2) * (T2 / 2) == NT, "a thread an aggregate");

template <bool kNoise>
__device__ __forceinline__ void phase_tiles(const Level& L, const Tables& t, const Level* N,
                                            const Tables* tn, int color0, bool b_aligned,
                                            float* vs) {
  const int tid = threadIdx.x;
  const int q0 = (L.n0 + T0 - 1) / T0, q1 = (L.n1 + T1 - 1) / T1, q2 = (L.n2 + T2 - 1) / T2;
  const float mh = -L.hinv2;
  // the thread's aggregate
  const int ck = tid % (T2 / 2), cj = (tid / (T2 / 2)) % (T1 / 2), ci = tid / ((T2 / 2) * (T1 / 2));
  for (int tile = blockIdx.x; tile < q0 * q1 * q2; tile += gridDim.x) {
    const int g0 = (tile / (q1 * q2)) * T0, g1 = ((tile / q2) % q1) * T1, g2 = (tile % q2) * T2;
    const int i0 = g0 + 2 * ci, j0 = g1 + 2 * cj, k0 = g2 + 2 * ck;
    const bool on = i0 < L.n0 && j0 < L.n1 && k0 < L.n2;  // even extents: whole aggregates
    // v on the tile + 2 straight into shared memory (cp.async, zero outside
    // the grid: no register holds a copy), and b of the aggregate, all in
    // flight at once
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = tid + u * NT;
      if (e >= STAGE) break;
      const int a2 = e % S2, a1 = (e / S2) % S1, a0 = e / (S2 * S1);
      const int i = g0 + a0 - 2, j = g1 + a1 - 2, k = g2 + a2 - 2;
      const bool in = i >= 0 && i < L.n0 && j >= 0 && j < L.n1 && k >= 0 && k < L.n2;
      const float* src = in ? L.v + ((size_t)i * L.n1 + j) * L.n2 + k : L.v;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(vs + e)),
                   "l"(src), "r"(in ? 4 : 0)
                   : "memory");
    }
    float2 b[2][2];
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) b[di][dj] = pair_at(L.b, L, i0 + di, j0 + dj, k0, on, b_aligned);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    // the colour-1 cell of each pair of the tile + 1 (rows of 34 cells from
    // column g2 - 1: 17 pairs), in place
#pragma unroll 2
    for (int u = 0; u < C1_PER_THREAD; ++u) {
      const int e = tid + u * NT;
      const int p = e % ((S2 - 2) / 2), a1 = 1 + (e / ((S2 - 2) / 2)) % (S1 - 2);
      const int a0 = 1 + e / (((S2 - 2) / 2) * (S1 - 2));
      const int i = g0 + a0 - 2, j = g1 + a1 - 2;
      const int a2 = 1 + 2 * p + ((color0 ^ 1 ^ (i + j + g2 - 1)) & 1);
      const int k = g2 + a2 - 2;
      if (e >= C1 || i < 0 || i >= L.n0 || j < 0 || j >= L.n1 || k < 0 || k >= L.n2) continue;
      const int c = (a0 * S1 + a1) * S2 + a2;
      const float sum = vs[c - S1 * S2] + vs[c + S1 * S2] + vs[c - S2] + vs[c + S2] + vs[c - 1] +
                        vs[c + 1];
      vs[c] = t.w[links_at(i, j, k, L.n0, L.n1, L.n2)] * (vs[c] - mh * sum);
    }
    __syncthreads();
    if (on) {
      // the axis-0 pairs r(0, dj, dk) + r(1, dj, dk), a row pair dj at a
      // time (its rows' y written out as they go), then axis 1, then axis 2
      float p0 = 0.f, p1 = 0.f, rc = 0.f;
#pragma unroll 1
      for (int dj = 0; dj < 2; ++dj) {
        float r[2][2];
#pragma unroll
        for (int di = 0; di < 2; ++di) {
          float yv[2];
#pragma unroll
          for (int dk = 0; dk < 2; ++dk) {
            const int i = i0 + di, j = j0 + dj, k = k0 + dk;
            const int c = ((2 * ci + di + 2) * S1 + (2 * cj + dj + 2)) * S2 + (2 * ck + dk + 2);
            const float sum = vs[c - S1 * S2] + vs[c + S1 * S2] + vs[c - S2] + vs[c + S2] +
                              vs[c - 1] + vs[c + 1];
            yv[dk] = vs[c];
            const float2 bp = dj ? b[di][1] : b[di][0];
            const float bv = dk ? bp.y : bp.x;
            r[di][dk] = bv - (t.d[links_at(i, j, k, L.n0, L.n1, L.n2)] * yv[dk] + mh * sum);
          }
          *reinterpret_cast<float2*>(L.y + ((size_t)(i0 + di) * L.n1 + (j0 + dj)) * L.n2 + k0) =
              make_float2(yv[0], yv[1]);
        }
        if (dj == 0) {
          p0 = r[0][0] + r[1][0];
          p1 = r[0][1] + r[1][1];
        } else {
          rc = (p0 + (r[0][0] + r[1][0])) + (p1 + (r[0][1] + r[1][1]));
        }
      }
      const int m1 = L.n1 >> 1, m2 = L.n2 >> 1, ai = i0 >> 1, aj = j0 >> 1, ak = k0 >> 1;
      const size_t ac = ((size_t)ai * m1 + aj) * m2 + ak;
      L.rc[ac] = rc;
      if (N) N->v[ac] = noisy_colour0<kNoise>(*N, *tn, color0, ai, aj, ak, ac, rc);
    }
    __syncthreads();  // the stage's readers are done before the next tile
  }
}

template <bool kNoise>
__global__ void __launch_bounds__(NT, MAX_BLOCKS_PER_SM)
    tail_grid_kernel(const __grid_constant__ TailArgs a) {
  __shared__ Tables tab[MAX_LEVELS];
  __shared__ __align__(16) float vs[STAGE];  // the tile phase's stage
  if (threadIdx.x < 7 * a.nlev) {
    const int li = threadIdx.x / 7, l = threadIdx.x % 7;
    const Level& L = a.lv[li];
    const float d = L.kappa2 + L.hinv2 * (float)l;
    tab[li].d[l] = d;
    tab[li].w[l] = L.omega / d;
    tab[li].n[l] = L.nscale * sqrtf(d);
    if (l == 0) tab[li].prefix = a.prefix_at ? __ldg(a.prefix_at + li) : L.prefix;
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  phase_noise<kNoise>(a.lv[0], tab[0], a.color0, a.b_aligned);
  for (int li = 0; li < a.nlev; ++li) {
    const bool next = li + 1 < a.nlev;
    grid.sync();  // level li's v is whole
    phase_tiles<kNoise>(a.lv[li], tab[li], next ? &a.lv[li + 1] : nullptr,
                        next ? &tab[li + 1] : nullptr, a.color0, li > 0 || a.b_aligned, vs);
  }
}

template <bool kNoise>
int launch(const TailArgs& a, int need, void* stream) {
  auto kernel = tail_grid_kernel<kNoise>;
  // as many blocks as the card keeps resident, worked out once
  static int most = -1;
  if (most < 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
    if (err != cudaSuccess) return (int)err;
    most = (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM) * sms;
  }
  // a grid that cannot be co-resident is refused
  // (cudaErrorCooperativeLaunchTooLarge), not worked around
  if (most < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const unsigned blocks = (unsigned)(need < most ? need : most);
  void* args[] = {const_cast<TailArgs*>(&a)};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(NT), args, 0,
                                          (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// (blocks an SM, SMs, dynamic shared bytes) of the launch, for the report
void pmg_tail_grid_occupancy(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tail_grid_kernel<true>, NT, 0);
  out[0] = per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM;
  out[1] = sms;
  out[2] = 0;
}

// nlev smoothed levels in one cooperative launch.  shapes: (nlev + 1) x 3
// extents (each level halves the last; the smoothed ones even); params:
// (omega, kappa2, hinv2, nscale) a level; prefixes: each level's noise key,
// or, when prefix_at is not nullptr, the nlev keys in device memory there;
// out holds, at float offsets off[3 li .. 3 li + 2] (each even), the
// scratch v, y and rc of level li; level li + 1 reads rc of level li.
// need: the blocks the largest phase has work for (mg_tail.tail_blocks)
int pmg_tail_grid(const float* b, float* out, const int* shapes, const float* params,
                  const unsigned int* prefixes, const unsigned int* prefix_at,
                  const long long* off, int nlev, int need, int color0, int with_noise,
                  void* stream) {
  if (nlev < 1 || nlev > MAX_LEVELS || need < 1) return (int)cudaErrorInvalidValue;
  TailArgs a;
  a.prefix_at = prefix_at;
  a.nlev = nlev;
  a.color0 = color0;
  a.b_aligned = ((uintptr_t)b & 7) == 0;
  for (int li = 0; li < nlev; ++li) {
    const int n0 = shapes[3 * li], n1 = shapes[3 * li + 1], n2 = shapes[3 * li + 2];
    if (n0 <= 0 || n1 <= 0 || n2 <= 0 || (n0 | n1 | n2) & 1 ||
        shapes[3 * li + 3] != n0 / 2 || shapes[3 * li + 4] != n1 / 2 ||
        shapes[3 * li + 5] != n2 / 2)
      return (int)cudaErrorInvalidValue;
    a.lv[li] = Level{li ? out + off[3 * li - 1] : b,
                     out + off[3 * li],
                     out + off[3 * li + 1],
                     out + off[3 * li + 2],
                     n0, n1, n2,
                     params[4 * li + 1], params[4 * li + 2], params[4 * li], params[4 * li + 3],
                     (uint32_t)prefixes[li]};
  }
  return with_noise ? launch<true>(a, need, stream) : launch<false>(a, need, stream);
}

}  // extern "C"
