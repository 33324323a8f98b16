// One coloured vertex-star patch-Gibbs sweep x -> x' of the squared
// link-count FD operator A = F^2, F = kappa2 + hinv2 * links, with the
// patch systems rebuilt in closed form.
//
// Replaces two Pallas kernels with one kernel body and two launches:
//   parmgmc_tpu/kernels/patch_sweep.py fused_patch_sweep_sqfd (body
//     _kernel, closed form _group_slab): the whole sweep with the state
//     resident on chip -> pmg_patch_sweep, ONE cooperative launch that
//     meets at a grid barrier between phases (the state stays in L2, the
//     GPU's counterpart of the TPU's VMEM);
//   parmgmc_tpu/kernels/patch_sweep.py fused_patch_sweep_sqfd_streamed
//     (body _kernel_streamed): the state in device memory ->
//     pmg_patch_sweep_streamed, one launch per phase, all enqueued by one
//     C call.
// Both copy x into out and update out in place; the math is
// kernels/patch_sweep.py's (its docstring gives the closed form of A_SS).
// A third entry, pmg_patch_sweep_colourwise, runs the 125 colours one
// launch each with every read in device memory: a check of the schedule
// below, on no sampler path.  All three run the same update_patch on the
// same values and draws, so they agree bit for bit.
//
// The patch centred at (c0, c1, c2) is of colour (a0, a1, a2) = c mod 5;
// the sweep runs the colours in the order 25 a0 + 5 a1 + a2.  A patch
// writes within L1 distance 1 of its centre and reads within 3, so two
// patches interact only if their centres are at most 4 apart.  Centres
// with the same a0 (a1) are a multiple of 5 apart on axis 0 (1): within
// distance 4 they lie on the same (i, j) line of axis 2.  So the colour
// order factorises (kernels/patch_sweep.py, patch_schedule): 25 phases
// (a0, a1) in turn; in a phase the lines (a0 + 5p, a1 + 5q) are
// independent, and on each line the colours a2 = 0 .. 4 run in turn.  Any
// order that keeps phases in turn and a line's colours in turn updates
// every patch from the same values as the colour order does.
//
// What bounds it on an H100: operations.  A patch costs ~900 float32
// operations (FLOPS_PATCH in chip_smoke.py) and every point is a centre
// once per sweep, so 256^3 needs ~1.5e10 operations (0.23 ms at 67
// TFLOP/s) against 134 MB moved (0.04 ms at 3.35 TB/s).  Counted in
// issued instructions (the Cholesky's divisions and square roots, the 7
// draws of ~70 each) a patch is ~1,500, ~0.9 ms at 256^3.
//
// Design.  The first version ran 125 colour passes over the state (8 GB
// of device-memory reads at 256^3, beyond the 50 MB L2), each patch
// making 63 scattered loads.  Here a block takes a line of a phase: it
// stages the line's 25 neighbour lines (|di| + |dj| <= 3, the rows a patch
// on it reads) in shared memory, zero outside the grid, with the b rows of
// its members' 5 lines, by 16-B cp.async; runs the line's five colours in
// turn, a thread a centre, reading and writing the staged rows, with a
// block barrier between colours; and writes the members' 5 lines back.
// A phase reads each row of x about once and writes a fifth of them: 25
// passes a sweep instead of 125, and the five colours of a line share
// one staging.  What is left is the patch itself, one thread's
// straight-line code: its Cholesky divides once a row and multiplies by
// the reciprocal elsewhere (the 42 divisions' chain was its longest), the
// draws' square roots have no branch, and the kernel is held to 128
// registers so that 8 blocks of 64 threads share an SM at 256^3.  A block
// of several lines, to fill the lanes a 52-centre colour leaves idle,
// measured no faster (time_main_path.py, patch-plans drive).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int M = 5;  // colour base: stencil radius 2 + 3
constexpr int NCOLOR = M * M * M;
constexpr int NPHASE = M * M;
constexpr int K = 7;  // members: centre, -e0, +e0, -e1, +e1, -e2, +e2
constexpr int NT_COLOUR = 128;  // threads a block of the colourwise check
constexpr int MAX_NT = 256;     // threads a block of the phase kernel, at most
// staged rows: the 25 lines (di, dj) with |di| + |dj| <= 3 around a line,
// by di, then dj (widths 1, 3, 5, 7, 5, 3, 1); each row holds the line's
// n2 cells between PAD zero columns on each side (a patch reads 3; 4 keep
// the cells 16-B aligned where n2 % 4 == 0)
constexpr int NLINE = 25;
constexpr int PAD = 4;
// b rows: the members' lines (0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)
constexpr int NBLINE = 5;

struct Prefixes {
  uint32_t p[K];  // hash prefix of member j's draws (PATCH_DOMAIN + j)
};

__host__ __device__ constexpr int member_off(int j, int ax) {
  return j == 0 ? 0 : ((j - 1) / 2 == ax ? ((j - 1) % 2 ? 1 : -1) : 0);
}

__host__ __device__ constexpr int iabs(int v) { return v < 0 ? -v : v; }

// the staged row of line offset (di, dj), |di| + |dj| <= 3
__host__ __device__ constexpr int line_slot(int di, int dj) {
  return (di <= 0 ? (di + 3) * (di + 3) : NLINE - (4 - di) * (4 - di)) + dj + 3 - iabs(di);
}

// the b row of a member's line (o0, o1)
__host__ __device__ constexpr int bline_slot(int o0, int o1) {
  return o0 == -1 ? 1 : o0 == 1 ? 2 : o1 == -1 ? 3 : o1 == 1 ? 4 : 0;
}

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

// x and b around the patch centred at (c0, c1, c2), in device memory.
// Reads of x use __ldcg (L2, coherent): after a launch boundary or grid
// barrier a block must see other blocks' writes.
struct DeviceView {
  float* xs;
  const float* bp;  // nullptr: b = 0
  int n0, n1, n2, c0, c1, c2;
  __device__ __forceinline__ float x(int di, int dj, int dk) const {
    const int i = c0 + di, j = c1 + dj, k = c2 + dk;
    return inside(i, j, k, n0, n1, n2) ? __ldcg(xs + ((size_t)i * n1 + j) * n2 + k) : 0.f;
  }
  __device__ __forceinline__ float b(int, int, int, bool in, size_t id) const {
    return (bp && in) ? __ldg(bp + id) : 0.f;
  }
  __device__ __forceinline__ void put(int, int, int, size_t id, float v) const { xs[id] = v; }
};

// the same from a line's staged rows in shared memory: xr and br point at
// the centre's column of the line's first x row and first b row
struct StagedView {
  float* xr;
  const float* br;  // nullptr: b = 0
  int s;            // row stride
  __device__ __forceinline__ float x(int di, int dj, int dk) const {
    return xr[line_slot(di, dj) * s + dk];
  }
  __device__ __forceinline__ float b(int o0, int o1, int o2, bool in, size_t) const {
    return (br && in) ? br[bline_slot(o0, o1) * s + o2] : 0.f;
  }
  __device__ __forceinline__ void put(int o0, int o1, int o2, size_t, float v) const {
    xr[line_slot(o0, o1) * s + o2] = v;
  }
};

// resample the patch centred at (c0, c1, c2) in place.  The view reads x
// at an offset from the centre (zero outside the grid) and b at a member
// (zero outside the grid or without b), and writes a member; both views
// give the same values to the same float operations
template <class V>
__device__ __forceinline__ void update_patch(const V& view, int n0, int n1, int n2, int c0,
                                             int c1, int c2, float k2, float h2,
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
        xv[u][v][w] = view.x(u - 3, v - 3, w - 3);
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
    rm[m] = view.b(o0, o1, o2, in[m], id[m]) - ffx;
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

  // 6. Cholesky A_SS = L L^T (row by row, in place in A's lower triangle),
  //    with the reciprocal of each diagonal entry: one division a row, a
  //    multiplication for every other (the divisions' chain was the patch's
  //    longest)
  float inv[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int t = 0; t < j; ++t) s = s - A[i][t] * A[j][t];
      if (i == j) {
        A[i][i] = sqrtf(s);
        inv[i] = 1.f / A[i][i];
      } else {
        A[i][j] = s * inv[j];
      }
    }

  // 7. z = L^{-1} rhs; x_S = L^{-T} (z + eta)
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = z[i];
#pragma unroll
    for (int j = 0; j < i; ++j) s = s - A[i][j] * z[j];
    z[i] = s * inv[i];
  }
  const uint32_t p = (uint32_t)(((size_t)c0 * n1 + c1) * n2 + c2);
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float s = z[i] + (with_noise ? pmg::eta<true>(pre.p[i], p) : 0.f);
#pragma unroll
    for (int j = i + 1; j < K; ++j) s = s - A[j][i] * z[j];
    z[i] = s * inv[i];
  }
#pragma unroll
  for (int m = 0; m < K; ++m)
    if (in[m]) view.put(member_off(m, 0), member_off(m, 1), member_off(m, 2), id[m], z[m]);
}

// -- the factorised schedule ---------------------------------------------------

// (di, dj) of staged row r: the 25 x rows in line_slot's order, then the 5
// b rows in bline_slot's
__constant__ int8_t kRowDi[NLINE + NBLINE] = {-3, -2, -2, -2, -1, -1, -1, -1, -1, 0,
                                              0,  0,  0,  0,  0,  0,  1,  1,  1,  1,
                                              1,  2,  2,  2,  3,  0,  -1, 1,  0,  0};
__constant__ int8_t kRowDj[NLINE + NBLINE] = {0,  -1, 0,  1, -2, -1, 0, 1, 2,  -3,
                                              -2, -1, 0,  1, 2,  3,  -2, -1, 0, 1,
                                              2,  -1, 0,  1, 0,  0,  0,  0, -1, 1};

// 16 B from device memory (L2 only) into shared memory; zeros where !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// one phase (a0, a1): a line a block, staged, its five colours in turn,
// its members' lines written back.  Blocks stride over the lines; line
// number l is (a0 + 5p, a1 + 5q) with l = p * (lines of a1) + q.  Every
// index below is worked out once a line or a row: a warp's scalar chains
// of divisions cost more than its loads
__device__ void run_phase(float* xs, const float* __restrict__ b, int n0, int n1, int n2,
                          float k2, float h2, const Prefixes& pre, int with_noise, int a0,
                          int a1, int aligned, float* sm) {
  const int nq = centres(n1, a1);
  const int nlines = centres(n0, a0) * nq;
  const int s = n2 + 2 * PAD;
  const int nrows = NLINE + (b ? NBLINE : 0);
  float* xsm = sm;
  float* bsm = sm + NLINE * s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  // the PAD zero columns of every row; nothing writes them later
  for (int r = warp; r < nrows; r += nw)
    if (lane < 2 * PAD) sm[r * s + (lane < PAD ? lane : n2 + lane)] = 0.f;
  for (int l = blockIdx.x; l < nlines; l += gridDim.x) {
    const int p = l / nq;
    const int c0 = a0 + M * p, c1 = a1 + M * (l - p * nq);
    // 1. stage the line's 25 x rows and its members' 5 b rows, a warp a
    //    row: with 16-B cp.async (L2 only, so coherent after a grid
    //    barrier), every copy of the block in flight at once; or, where a
    //    row is not 16-B aligned, with __ldcg
    for (int r = warp; r < nrows; r += nw) {
      const int i = c0 + kRowDi[r], j = c1 + kRowDj[r];
      const bool in = (unsigned)i < (unsigned)n0 && (unsigned)j < (unsigned)n1;
      const float* src = r < NLINE ? xs : b;
      const float* row = in ? src + ((size_t)i * n1 + j) * n2 : src;
      float* dst = sm + r * s + PAD;
      if (aligned) {
        for (int c = 4 * lane; c < n2; c += 128) cp_async16(dst + c, row + (in ? c : 0), in);
      } else {
        for (int c = lane; c < n2; c += 32) dst[c] = in ? __ldcg(row + c) : 0.f;
      }
    }
    if (aligned) cp_async_wait_all();
    __syncthreads();
    // 2. the line's colours a2 = 0 .. 4 in turn, a thread a centre
    for (int a2 = 0; a2 < M; ++a2) {
      for (int c2 = a2 + M * threadIdx.x; c2 < n2; c2 += M * blockDim.x) {
        const StagedView v{xsm + PAD + c2, b ? bsm + PAD + c2 : nullptr, s};
        update_patch(v, n0, n1, n2, c0, c1, c2, k2, h2, pre, with_noise);
      }
      __syncthreads();
    }
    // 3. write the members' lines back, a warp a row
    for (int r = warp; r < NBLINE; r += nw) {
      const int di = kRowDi[NLINE + r], dj = kRowDj[NLINE + r];
      const int i = c0 + di, j = c1 + dj;
      if ((unsigned)i >= (unsigned)n0 || (unsigned)j >= (unsigned)n1) continue;
      const float* src = xsm + line_slot(di, dj) * s + PAD;
      float* row = xs + ((size_t)i * n1 + j) * n2;
      for (int k = lane; k < n2; k += 32) row[k] = src[k];
    }
    __syncthreads();
  }
}

// phases [ph_begin, ph_end) in turn; a grid barrier between two phases
// (only the cooperative launch spans more than one).  Held to 128
// registers: 8 blocks of 64 threads an SM at 256^3, where 147 gave 6
__global__ void __launch_bounds__(MAX_NT, 2)
    patch_phase_kernel(float* xs, const float* __restrict__ b, int n0, int n1, int n2,
                       float k2, float h2, Prefixes pre, int with_noise, int ph_begin,
                       int ph_end, int aligned) {
  extern __shared__ __align__(16) float sm[];
  for (int ph = ph_begin; ph < ph_end; ++ph) {
    if (ph > ph_begin) cg::this_grid().sync();
    run_phase(xs, b, n0, n1, n2, k2, h2, pre, with_noise, ph / M, ph % M, aligned, sm);
  }
}

// the colourwise check: colour c = 25 a0 + 5 a1 + a2, a thread a centre
__global__ void __launch_bounds__(NT_COLOUR)
    patch_colour_kernel(float* xs, const float* __restrict__ b, int n0, int n1, int n2,
                        float k2, float h2, Prefixes pre, int with_noise, int c) {
  const int a0 = c / (M * M), a1 = (c / M) % M, a2 = c % M;
  const int m1 = centres(n1, a1), m2 = centres(n2, a2);
  const long long nc = (long long)centres(n0, a0) * m1 * m2;
  const long long t = (long long)blockIdx.x * NT_COLOUR + threadIdx.x;
  if (t >= nc) return;
  const int k = (int)(t % m2);
  const long long r = t / m2;
  const int j = (int)(r % m1), i = (int)(r / m1);
  const int c0 = a0 + M * i, c1 = a1 + M * j, c2 = a2 + M * k;
  const DeviceView v{xs, b, n0, n1, n2, c0, c1, c2};
  update_patch(v, n0, n1, n2, c0, c1, c2, k2, h2, pre, with_noise);
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

// lines of phase ph
int phase_lines(int ph, int n0, int n1) { return centres(n0, ph / M) * centres(n1, ph % M); }

// threads a block: the largest colour's centres on a line, in warps
int phase_threads(int n2) {
  const int t = (centres(n2, 0) + 31) / 32 * 32;
  return t < MAX_NT ? t : MAX_NT;
}

int phase_smem(int n2, bool with_b) {
  return (NLINE + (with_b ? NBLINE : 0)) * (n2 + 2 * PAD) * (int)sizeof(float);
}

// can the staging copy 16 B at a time: rows of a multiple of 4 cells, 16-B
// aligned tensors
int rows_aligned(const float* out, const float* b, int n2) {
  return n2 % 4 == 0 && (uintptr_t)out % 16 == 0 && (uintptr_t)b % 16 == 0;
}

// copy x to out and let the phase kernel take smem dynamic bytes
cudaError_t prepare(const float* x, float* out, int n0, int n1, int n2, int smem,
                    cudaStream_t s) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0) return cudaErrorInvalidValue;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > most) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(patch_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  return cudaMemcpyAsync(out, x, sizeof(float) * (size_t)n0 * n1 * n2,
                         cudaMemcpyDeviceToDevice, s);
}

}  // namespace

extern "C" {

// #11: copy x to out, then one launch per phase (a0, a1) on the caller's
// stream, a block a line
int pmg_patch_sweep_streamed(const float* x, const float* b, float* out, int n0, int n1,
                             int n2, float kappa2, float hinv2,
                             const unsigned int* prefixes, int with_noise, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = phase_smem(n2, b != nullptr);
  cudaError_t err = prepare(x, out, n0, n1, n2, smem, s);
  if (err != cudaSuccess) return (int)err;
  const Prefixes pre = load_prefixes(prefixes);
  const int nt = phase_threads(n2), aligned = rows_aligned(out, b, n2);
  for (int ph = 0; ph < NPHASE; ++ph) {
    const int lines = phase_lines(ph, n0, n1);
    if (lines == 0) continue;
    patch_phase_kernel<<<lines, nt, smem, s>>>(out, b, n0, n1, n2, kappa2, hinv2, pre,
                                                with_noise, ph, ph + 1, aligned);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// #10: copy x to out, then one cooperative launch for all 25 phases.
// The grid is as large as the card keeps resident at once (occupancy x
// SMs) and no larger than the largest phase needs; a grid that cannot be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
int pmg_patch_sweep(const float* x, const float* b, float* out, int n0, int n1, int n2,
                    float kappa2, float hinv2, const unsigned int* prefixes, int with_noise,
                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = phase_smem(n2, b != nullptr);
  cudaError_t err = prepare(x, out, n0, n1, n2, smem, s);
  if (err != cudaSuccess) return (int)err;
  const int nt = phase_threads(n2);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, patch_phase_kernel, nt,
                                                           smem)) != cudaSuccess)
    return (int)err;
  long long need = 1;
  for (int ph = 0; ph < NPHASE; ++ph)
    if (phase_lines(ph, n0, n1) > need) need = phase_lines(ph, n0, n1);
  const long long most = (long long)per_sm * sms;
  if (most < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const unsigned blocks = (unsigned)(need < most ? need : most);

  float* xs = out;
  Prefixes pre = load_prefixes(prefixes);
  int ph_begin = 0, ph_end = NPHASE, aligned = rows_aligned(out, b, n2);
  void* args[] = {&xs,  &b,          &n0,       &n1,     &n2,     &kappa2,
                  &hinv2, &pre, &with_noise, &ph_begin, &ph_end, &aligned};
  return (int)cudaLaunchCooperativeKernel((const void*)patch_phase_kernel, dim3(blocks),
                                          dim3(nt), args, smem, s);
}

// the check: copy x to out, then the 125 colours in turn, one launch each,
// every read in device memory.  No sampler path calls it
int pmg_patch_sweep_colourwise(const float* x, const float* b, float* out, int n0, int n1,
                               int n2, float kappa2, float hinv2,
                               const unsigned int* prefixes, int with_noise, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(out, x, sizeof(float) * (size_t)n0 * n1 * n2,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const Prefixes pre = load_prefixes(prefixes);
  for (int c = 0; c < NCOLOR; ++c) {
    const long long nc = colour_centres(c, n0, n1, n2);
    if (nc == 0) continue;
    patch_colour_kernel<<<(unsigned)((nc + NT_COLOUR - 1) / NT_COLOUR), NT_COLOUR, 0, s>>>(
        out, b, n0, n1, n2, kappa2, hinv2, pre, with_noise, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
