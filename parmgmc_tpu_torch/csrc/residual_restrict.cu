// The residual r = b - A x of a 3D radius-1 stencil, fused with the
// full-weighting restriction that follows it in a multigrid cycle: one
// launch a call, in two forms,
//
//   restrict:  out = R (b - A x)   (coarse, ceil(n/2) an axis)
//   alone:     out = b - A x       (fine)
//
// with b == nullptr read as zero.  A holds offsets o_1 .. o_m in
// {-1, 0, 1}^3 (m <= 26), each coefficient a scalar or a grid field, and
// the diagonal D as a field or, for a link-count FD operator, as
// kappa2 + hinv2 * (in-grid neighbours), rebuilt in registers.  R is the
// exact transpose of the vertex-style linear interpolation
// (operators/stencil.py: _restrict_1d), axis 0, then 1, then 2; per axis,
// with h(j) = 0.5 f[j] inside the grid and 0 outside,
//
//   y[i] = (f[2i] + h(2i + 1)) + h(2i - 1)    (+ h(2i + 1) once more at the
//                                              last i of an even extent)
//
// which is the even and the odd branch of _restrict_1d in one.
//
// Replaces no TPU kernel: the JAX package leaves the residuals and the
// transfers of its general cycle to XLA.  In the port each was a dozen
// to sixty host-dispatched torch ops (a pad, a product and a sum a
// stencil offset, a movedim, slices and two cats an axis of the
// restriction), 3.6 ms of device time a step of the linear-Galerkin
// V(2,2) at 256^3.
//
// Bit for bit its plain twin (kernels/residual_restrict.py, the
// expression it replaces): every product and sum rounded on its own
// (__fmul_rn, __fadd_rn: nothing contracted into an FMA), the offsets
// summed in their order from 0 + c_1 x_1, then D x + y, then b - (D x + y),
// and the restriction's sums in _restrict_1d's order.
//
// What bounds it on an H100: bytes.  A call reads x, b, D and each
// coefficient field once and writes its output once: 134 MB for the
// 256^3 FD residual alone, 143 MB for its restriction, 177 MB at 128^3
// with the 18 fields of the GMRF's Galerkin level; some 60 float
// operations a fine point are far below the card's 20 a byte.
//
// Design.  A block owns T1 x T2 coarse points of axes 1 and 2 over a
// segment of coarse planes and marches along axis 0.  x arrives a fine
// plane at a time, with a one-point halo in axes 1 and 2, into a ring of
// three shared-memory planes, loaded into registers one plane ahead while
// the current plane is computed.  The residual of a fine plane lands in a
// second ring of three planes (restrict) or in device memory (alone).  On
// the plane that completes coarse plane I (fine 2I + 1, or the last) each
// thread folds axis 0 at its fine points into the slot of fine plane
// 2I - 1; after a barrier each thread folds axes 1 and 2 for one coarse
// point and writes it.  A block recomputes the residuals of one fine row
// and one fine column beyond its own (the odd fine points its neighbours
// share) and of one fine plane before its segment.  The plan gives each
// block the fewest planes that keep the grid within one wave.
//
// Three variants.  The 7-point star with scalar coefficients in
// star_offsets order (level 0) has its offsets in the code and takes b and
// D one plane ahead in registers.  Any other stencil computes a point at
// a time, every coefficient of the point loaded before the first product
// (a scalar from a small array in device memory, so that no loaded value
// meets a select); the stencil of all 26 offsets (the Galerkin levels)
// runs that loop at its constant length.  What that bought, in
// microseconds for a 256^3 V(2,2) step's six calls on an NVIDIA H100 80GB
// HBM3 at 700 W (256^3 alone, 256^3, 128^3, 64^3, 32^3, 16^3): tile sizes
// and indices computed at run time, each field loaded right before its
// product: 208, 420, 287, 67, 43, 30; constant tiles and the star variant:
// 97, 147, 167, 44, 41, 33; the loop over the offset count guarded by
// it (every load of a point waiting on the one before): 68, 97, 165, 38,
// 38, 31; the constant-length loop: 67, 97, 91, 18, 17, 15.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads a block
constexpr int MAX_OFF = 26;  // offsets of a radius-1 3D stencil
constexpr int T1 = 8, T2 = 32;  // coarse points of a block in axes 1 and 2

// a block's box of fine residuals (restrict: fine 2 J0 - 1 .. 2 (J0 + T1) - 1,
// the odd points its lower neighbour shares; alone: its own 2 T1 x 2 T2)
// and of x (the box and a one-point halo)
template <bool RESTRICT>
struct Box {
  static constexpr int H = RESTRICT ? 1 : 0;
  static constexpr int R1 = 2 * T1 + H, R2 = 2 * T2 + H;
  static constexpr int X1 = R1 + 2, X2 = R2 + 2;
  static constexpr int RN = R1 * R2, XN = X1 * X2;
  static constexpr int XREG = (XN + NT - 1) / NT, RREG = (RN + NT - 1) / NT;
};

struct Args {
  const float* x;
  const float* b;               // nullptr: b = 0
  float* out;
  // what offset m reads at point g: field[m][g] where fld[m], else
  // field[m][0], its scalar in device memory (so that every load of a
  // point is issued before the first is used, with no select between a
  // loaded value and a scalar); scal[m] the scalars again, for the star
  const float* field[MAX_OFF];
  int8_t fld[MAX_OFF];
  float scal[MAX_OFF];
  int8_t d0[MAX_OFF], d1[MAX_OFF], d2[MAX_OFF];
  int noff;
  const float* diag;            // nullptr: kappa2 + hinv2 * links
  float kappa2, hinv2;
  int n0, n1, n2;               // fine grid
  int c0, c1, c2;               // coarse grid, ceil(n / 2) an axis
  int seg;                      // coarse planes of a block (launch's plan)
};

__device__ __forceinline__ int slot3(int p) { return (p + 3) % 3; }

// one axis of the restriction at coarse i: f[2i] = c, f[2i + 1] = nx,
// f[2i - 1] = pv, each neighbour counted where it is inside the grid
__device__ __forceinline__ float fold(float c, float nx, bool in_nx, float pv, bool in_pv,
                                      bool last_even) {
  const float hn = in_nx ? __fmul_rn(0.5f, nx) : 0.f;
  const float hp = in_pv ? __fmul_rn(0.5f, pv) : 0.f;
  float y = __fadd_rn(__fadd_rn(c, hn), hp);
  if (last_even) y = __fadd_rn(y, hn);
  return y;
}

// the stencils a launch is specialised for: any offsets; all 26 of them
// (the Galerkin levels: a loop of constant length, which the compiler
// schedules with every load of a point in flight at once, where a loop
// guarded by the offset count was 1.8-2.1x slower on the H100); the 7-point
// star with scalar coefficients in star_offsets order (level 0)
enum Kind { kAny = 0, kAll26 = 1, kStar = 2 };

// blocks an SM that a variant's launch bounds hold (the star keeps to 64
// registers a thread, the others to 85)
constexpr int blocks_per_sm(int kind) { return kind == kStar ? 4 : 3; }

template <bool RESTRICT, int KIND>
__global__ void __launch_bounds__(NT, blocks_per_sm(KIND)) residual_restrict_kernel(const Args a) {
  using B = Box<RESTRICT>;
  __shared__ float xs[3][B::XN];
  __shared__ float rs[RESTRICT ? 3 : 1][RESTRICT ? B::RN : 1];
  // the ring index of each offset's neighbour, for each of the three
  // rotations of the x ring (q % 3); made from the parameters with static
  // indices (a dynamic one would copy the parameters to local memory)
  __shared__ int soff[3][MAX_OFF];
  const int tid = threadIdx.x;
  constexpr bool STAR = KIND == kStar;
  if (!STAR && tid == 0) {
#pragma unroll
    for (int m = 0; m < MAX_OFF; ++m)
#pragma unroll
      for (int rot = 0; rot < 3; ++rot)
        soff[rot][m] = (rot + a.d0[m] + 3) % 3 * B::XN + a.d1[m] * B::X2 + a.d2[m];
  }
  const int tiles2 = (a.c2 + T2 - 1) / T2;
  const int J0 = blockIdx.x / tiles2 * T1, K0 = blockIdx.x % tiles2 * T2;
  const int I0 = blockIdx.y * a.seg, I1 = min(I0 + a.seg, a.c0);
  const int o1 = 2 * J0 - B::H, o2 = 2 * K0 - B::H;  // fine row and column of box index 0
  const int q_lo = RESTRICT ? max(2 * I0 - 1, 0) : 2 * I0;
  const int q_hi = RESTRICT ? min(2 * I1 - 1, a.n0 - 1) : min(2 * I1, a.n0) - 1;
  const size_t plane = (size_t)a.n1 * a.n2;

  // where this thread's x values and fine points lie, the same on every
  // plane: the offset in a plane (-1 outside the grid) and, for a point,
  // its x index with its in-grid links of axes 1 and 2 above bit 16
  int xoff[B::XREG], poff[B::RREG], pxi[B::RREG];
#pragma unroll
  for (int u = 0; u < B::XREG; ++u) {
    const int t = tid + u * NT;
    const int j = o1 - 1 + t / B::X2, k = o2 - 1 + t % B::X2;
    xoff[u] = t < B::XN && (unsigned)j < (unsigned)a.n1 && (unsigned)k < (unsigned)a.n2
                  ? j * a.n2 + k
                  : -1;
  }
#pragma unroll
  for (int u = 0; u < B::RREG; ++u) {
    const int t = tid + u * NT;
    const int jl = t / B::R2, kl = t % B::R2, j = o1 + jl, k = o2 + kl;
    poff[u] = t < B::RN && (unsigned)j < (unsigned)a.n1 && (unsigned)k < (unsigned)a.n2
                  ? j * a.n2 + k
                  : -1;
    pxi[u] = ((jl + 1) * B::X2 + kl + 1) |
             (((j >= 1) + (j <= a.n1 - 2) + (k >= 1) + (k <= a.n2 - 2)) << 16);
  }

  // x of fine plane p into registers, then into its ring slot
  float xpre[B::XREG];
  auto fetch = [&](int p) {
    const bool in = (unsigned)p < (unsigned)a.n0;
#pragma unroll
    for (int u = 0; u < B::XREG; ++u)
      xpre[u] = in && xoff[u] >= 0 ? __ldg(a.x + p * plane + xoff[u]) : 0.f;
  };
  auto stash = [&](int p) {
#pragma unroll
    for (int u = 0; u < B::XREG; ++u) {
      const int t = tid + u * NT;
      if (t < B::XN) xs[slot3(p)][t] = xpre[u];
    }
  };
  // b and D of fine plane p at this thread's points, into registers
  float bpre[B::RREG], dpre[B::RREG];
  auto fetch_bd = [&](int p) {
#pragma unroll
    for (int u = 0; u < B::RREG; ++u) {
      const bool in = p <= q_hi && poff[u] >= 0;
      bpre[u] = in && a.b ? __ldg(a.b + p * plane + poff[u]) : 0.f;
      dpre[u] = in && a.diag ? __ldg(a.diag + p * plane + poff[u]) : 0.f;
    }
  };

  fetch(q_lo - 1);
  stash(q_lo - 1);
  fetch(q_lo);
  stash(q_lo);
  fetch(q_lo + 1);
  if (STAR) fetch_bd(q_lo);
  for (int q = q_lo; q <= q_hi; ++q) {
    stash(q + 1);
    __syncthreads();
    float bcur[B::RREG], dcur[B::RREG];
#pragma unroll
    for (int u = 0; u < B::RREG; ++u) {
      bcur[u] = bpre[u];
      dcur[u] = dpre[u];
    }
    if (q + 1 <= q_hi) {  // in flight while plane q is computed
      fetch(q + 2);
      if (STAR) fetch_bd(q + 1);
    }

    // the plane that completes coarse plane I = q >> 1: fine 2I + 1, or the last
    const bool completes = RESTRICT && ((q & 1) || q == a.n0 - 1) && q >= 2 * I0;
    const int I = q >> 1;
    const bool in_m0 = I > 0, in_p0 = 2 * I + 1 < a.n0, last0 = !(a.n0 & 1) && I == a.c0 - 1;
    const float* xall = &xs[0][0];
    const int* so = soff[q % 3];
    const float* xm = xs[slot3(q - 1)];
    const float* xc = xs[slot3(q)];
    const float* xp = xs[slot3(q + 1)];
    const int l0 = (q >= 1) + (q <= a.n0 - 2);
    // a fine point's residual r at box index t (plane offset off): into the
    // ring (restrict) or device memory, and on a completing plane its fold
    // along axis 0 into fine plane 2I - 1's slot
    auto put = [&](int t, int off, float r) {
      if (!RESTRICT) {
        a.out[q * plane + off] = r;
        return;
      }
      rs[slot3(q)][t] = r;
      if (completes) {
        float* am = rs[slot3(2 * I - 1)];
        am[t] = q & 1 ? fold(rs[slot3(q - 1)][t], r, true, am[t], in_m0, last0)
                      : fold(r, 0.f, false, am[t], in_m0, false);
      }
    };
    if (STAR) {  // (-e0, +e0, -e1, +e1, -e2, +e2), b and D from the prefetch
#pragma unroll
      for (int u = 0; u < B::RREG; ++u) {
        if (poff[u] < 0) continue;
        const int xi = pxi[u] & 0xffff;
        float y = 0.f;
        y = __fadd_rn(y, __fmul_rn(a.scal[0], xm[xi]));
        y = __fadd_rn(y, __fmul_rn(a.scal[1], xp[xi]));
        y = __fadd_rn(y, __fmul_rn(a.scal[2], xc[xi - B::X2]));
        y = __fadd_rn(y, __fmul_rn(a.scal[3], xc[xi + B::X2]));
        y = __fadd_rn(y, __fmul_rn(a.scal[4], xc[xi - 1]));
        y = __fadd_rn(y, __fmul_rn(a.scal[5], xc[xi + 1]));
        const float d = a.diag ? dcur[u]
                               : __fadd_rn(a.kappa2, __fmul_rn(a.hinv2, (float)(l0 + (pxi[u] >> 16))));
        put(tid + u * NT, poff[u], __fsub_rn(bcur[u], __fadd_rn(__fmul_rn(d, xc[xi]), y)));
      }
    } else {  // a point at a time (a loop kept small for the instruction cache),
              // each load of the point issued before its first product
#pragma unroll 1
      for (int t = tid; t < B::RN; t += NT) {
        const int jl = t / B::R2, kl = t % B::R2, j = o1 + jl, k = o2 + kl;
        if ((unsigned)j >= (unsigned)a.n1 || (unsigned)k >= (unsigned)a.n2) continue;
        const int off = j * a.n2 + k, xi = (jl + 1) * B::X2 + kl + 1;
        const size_t g = q * plane + off;
        const float bv = a.b ? __ldg(a.b + g) : 0.f;
        const float dv = a.diag ? __ldg(a.diag + g) : 0.f;
        float cf[MAX_OFF];
#pragma unroll
        for (int m = 0; m < MAX_OFF; ++m) cf[m] = __ldg(a.field[m] + (a.fld[m] ? g : 0));
        float y = 0.f;
#pragma unroll
        for (int m = 0; m < MAX_OFF; ++m)
          if (KIND == kAll26 || m < a.noff) y = __fadd_rn(y, __fmul_rn(cf[m], xall[so[m] + xi]));
        const int links = l0 + (j >= 1) + (j <= a.n1 - 2) + (k >= 1) + (k <= a.n2 - 2);
        const float d = a.diag ? dv : __fadd_rn(a.kappa2, __fmul_rn(a.hinv2, (float)links));
        put(t, off, __fsub_rn(bv, __fadd_rn(__fmul_rn(d, xc[xi]), y)));
      }
    }
    __syncthreads();

    if (completes) {  // axes 1 and 2: one coarse point a thread
      const float* av = rs[slot3(2 * I - 1)];
      const int Jl = tid / T2, Kl = tid % T2, J = J0 + Jl, K = K0 + Kl;
      if (J < a.c1 && K < a.c2) {
        float bk[3];
#pragma unroll
        for (int dk = 0; dk < 3; ++dk) {
          const int k = 2 * K - 1 + dk, at = 2 * Jl * B::R2 + 2 * Kl + dk;
          bk[dk] = (unsigned)k < (unsigned)a.n2
                       ? fold(av[at + B::R2], av[at + 2 * B::R2], 2 * J + 1 < a.n1, av[at], J > 0,
                              !(a.n1 & 1) && J == a.c1 - 1)
                       : 0.f;
        }
        a.out[((size_t)I * a.c1 + J) * a.c2 + K] =
            fold(bk[1], bk[2], 2 * K + 1 < a.n2, bk[0], K > 0, !(a.n2 & 1) && K == a.c2 - 1);
      }
    }
  }
}

// A block's coarse planes: the fewest that keep the grid within one wave
// of the variant's blocks on the card's SMs (at 256^3 on the H100 one wave
// was as fast as two or more, and shorter segments recompute more halo
// planes).
template <bool RESTRICT, int KIND>
cudaError_t launch(Args& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.c1 + T1 - 1) / T1) * ((a.c2 + T2 - 1) / T2);
  const int fit = blocks_per_sm(KIND) * sms / tiles;
  const int nseg = fit < 1 ? 1 : fit < a.c0 ? fit : a.c0;
  a.seg = (a.c0 + nseg - 1) / nseg;
  const dim3 grid(tiles, (a.c0 + a.seg - 1) / a.seg);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  residual_restrict_kernel<RESTRICT, KIND><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = R (b - A x) (restrict != 0; out coarse) or b - A x (out fine), in
// one launch on stream.  offs: noff x 3 offsets in {-1, 0, 1}; fields: the
// coefficient field of each offset (natural layout, the grid's shape) or
// nullptr for its scalar in scal; scal_at: MAX_OFF floats in device memory,
// scal[m] at m < noff (read by any stencil but the star); diag: D, or
// nullptr for kappa2 + hinv2 * links; b: nullptr for zero.
int pmg_residual_restrict(const float* x, const float* b, float* out, const float* const* fields,
                          const float* scal, const float* scal_at, const int* offs, int noff,
                          const float* diag, float kappa2, float hinv2, int n0, int n1, int n2,
                          int restrict_, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || noff < 0 || noff > MAX_OFF || x == out ||
      (b != nullptr && b == out) || (long long)n0 * n1 * n2 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.b = b;
  a.out = out;
  a.noff = noff;
  // the 7-point star with scalars in star_offsets order takes its own variant
  static const int star[6][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0}, {0, 1, 0}, {0, 0, -1}, {0, 0, 1}};
  bool is_star = noff == 6;
  for (int m = 0; m < noff; ++m) {
    for (int ax = 0; ax < 3; ++ax) {
      if (offs[3 * m + ax] < -1 || offs[3 * m + ax] > 1) return (int)cudaErrorInvalidValue;
      if (is_star && offs[3 * m + ax] != star[m][ax]) is_star = false;
    }
    a.d0[m] = (int8_t)offs[3 * m];
    a.d1[m] = (int8_t)offs[3 * m + 1];
    a.d2[m] = (int8_t)offs[3 * m + 2];
    a.field[m] = fields[m] ? fields[m] : scal_at + m;
    a.fld[m] = fields[m] != nullptr;
    a.scal[m] = scal[m];
    if (fields[m]) is_star = false;
  }
  for (int m = noff; m < MAX_OFF; ++m) a.field[m] = scal_at + m;
  if (!is_star && scal_at == nullptr) return (int)cudaErrorInvalidValue;
  a.diag = diag;
  a.kappa2 = kappa2;
  a.hinv2 = hinv2;
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.c0 = (n0 + 1) / 2;
  a.c1 = (n1 + 1) / 2;
  a.c2 = (n2 + 1) / 2;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const int kind = is_star ? kStar : noff == MAX_OFF ? kAll26 : kAny;
  if (restrict_)
    err = kind == kStar    ? launch<true, kStar>(a, s)
          : kind == kAll26 ? launch<true, kAll26>(a, s)
                           : launch<true, kAny>(a, s);
  else
    err = kind == kStar    ? launch<false, kStar>(a, s)
          : kind == kAll26 ? launch<false, kAll26>(a, s)
                           : launch<false, kAny>(a, s);
  return (int)err;
}

}  // extern "C"
