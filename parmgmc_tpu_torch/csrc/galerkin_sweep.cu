// One stochastic SOR (Gibbs) sweep of a 3D radius-1 stencil with
// coefficient fields: the colour sweep of the linear-Galerkin levels.
//
// Replaces no TPU kernel: the JAX package leaves the sweep of its 27-point
// Galerkin levels (parmgmc_tpu/samplers/sor.py, sor_sweep with the 2^3
// parity colouring) to XLA.  In the port that sweep was 8 colours x 26
// terms of host-dispatched torch ops a half-sweep, with its noise drawn
// from a torch.Generator on the host.  For an operator with offsets
// o_1 .. o_m in {-1, 0, 1}^3 (m <= 26), each coefficient a scalar or a
// grid field, the diagonal D, the sweep's omega and one launch's noise key,
// a call maps x to x':
//
//   b~ = b + nfac sqrt(D) eta      (nfac = sqrt((2 - omega)/omega); eta keyed
//                                   by (prefix, flat index), noise.cuh)
//   for colour c in order (c = 4 (i % 2) + 2 (j % 2) + k % 2; backward: reversed):
//     x_r <- (1 - omega) x_r + (1 / D_r) omega (b~_r - sum_m a_m,r x_{r + o_m})
//
// bit for bit its plain twin (kernels/galerkin_sweep.py, the sublattice
// sweep of samplers/sor.py on b~): every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: nothing contracted into an FMA), the terms
// are summed in the order of the offsets, the draw's polynomial likewise
// (eta_rn), and 1 / D is torch's reciprocal, then times omega.
//
// What bounds it on an H100: bytes.  A half-sweep reads each grid-shaped
// coefficient field, D and b once, reads x once and writes it once: at 128^3
// with the 18 fields of the GMRF's Galerkin levels 185 MB, 55 us at 3.35
// TB/s; ~85 float operations a point are far below the card's 20 a byte.
//
// Design.  The wrapper packs the fields and D colour-major once a sampler
// (colour c's points in a block of their own, row-major in the sublattice),
// so the threads of a colour read them coalesced; x and b keep the natural
// layout, and a point's 26 neighbour reads mostly hit L1 and L2 (x is 8 MB
// at 128^3).  A call is one launch a colour, 8 in sweep order.  The first
// colour's launch runs a thread a 2^3 cell (its colour-c point updated, the
// other seven copied from x into the output), so a call is out of place
// with no pass of its own and every thread of every launch updates one
// point.  The update is a loop of constant length over 26 offsets that
// issues every load of a point (26 neighbours, 26 coefficients, D and b)
// before the first product.  Each coefficient is read through its own
// pointer: its field at the colour-major index, or its scalar in a small
// array in device memory at one fixed index, so no select ever takes a
// loaded value; a neighbour is guarded only by a mask of the grid faces the
// point lies on against the faces its offset crosses, and its flat offset
// comes from the parameters.  A stencil of fewer offsets is padded to 26
// with terms of coefficient 0.0 (the scalar array's tail) on the point
// itself: each adds +-0 to the sum, which leaves its value as it was.  128
// threads a block, 8 blocks an SM: 64 registers, 0 bytes of spills
// (ptxas -v, sm_90a).
//
// Microseconds a call in a CUDA graph of 20 calls (b, noise; NVIDIA H100
// 80GB HBM3, 700 W) at 128^3, 64^3, 32^3, 16^3 of the 256^3 hierarchy: a
// loop guarded by the offset count, each load of a point right before its
// product and so waiting on the one before (256 threads, 4 blocks an SM,
// 24 registers) 151, 55, 50, 49; the constant-length loop with the in-grid
// test from the offsets' three components 155, 39, 32, 32; with the face
// mask and flat offsets 118, 27, 21, 22; with the first launch a thread a
// cell 103, 24, 21, 22; at 128 threads and 8 blocks an SM 98.46, 23.31,
// 19.64, 18.60.  Tried and left out: the neighbours through the read-only
// cache (no change), division by a multiply and a shift (2 % slower at
// 128^3), 256 threads at 3 or 4 blocks an SM and 64 threads at 16 (0-6 %
// slower).  Measured with the guarded loop, at 128^3 in a graph: one
// cooperative launch with a grid barrier between colours 266 us against
// 247, unbounded registers 470 us, and every load of a point hoisted before
// the sums, with the selects between scalars and loaded fields kept, at 212
// registers 834 us.
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace {

constexpr int MAX_OFF = 26;   // offsets of a radius-1 3D stencil
constexpr int COLOURS = 8;
constexpr int NT = 128;       // threads a block
constexpr int BLOCKS_PER_SM = 8;  // what the launch bounds hold: at most 64 registers a thread

struct Args {
  const float* x;       // the call's input: the first colour reads it
  float* out;           // the output, swept in place after the first colour
  const float* b;       // nullptr: b = 0
  const float* diag;    // D, colour-major
  int n0, n1, n2;
  // what offset m reads at colour-major index cm: coef[m][cm] where fld[m]
  // (its field), else coef[m][0] (its scalar in device memory); its
  // neighbour at flat index id + flat[m], inside the grid unless the point
  // lies on a face that offset m crosses (cross[m], face bits).  Offsets
  // past the stencil's read a scalar 0.0 at flat offset 0 and cross no face
  const float* coef[MAX_OFF];
  int8_t fld[MAX_OFF];
  int flat[MAX_OFF];
  uint8_t cross[MAX_OFF];
  float omega, omc, nfac;  // omega, 1 - omega and sqrt((2 - omega)/omega), as float32
  uint32_t prefix;
  const uint32_t* prefix_at;  // the key in device memory (a replayed step), or nullptr
  int with_noise;
  int order[COLOURS];   // colours in sweep order
  int base[COLOURS];    // colour-major start of each colour
};

// sin(2 pi x) on [-1/4, 1/4], noise.cuh's polynomial rounded term by term
__device__ __forceinline__ float sin2pi_rn(float x) {
  const float x2 = __fmul_rn(x, x);
  float p = -1.509464264e+01f;
  p = __fadd_rn(__fmul_rn(p, x2), 4.205869293e+01f);
  p = __fadd_rn(__fmul_rn(p, x2), -7.670585632e+01f);
  p = __fadd_rn(__fmul_rn(p, x2), 8.160524750e+01f);
  p = __fadd_rn(__fmul_rn(p, x2), -4.134170151e+01f);
  p = __fadd_rn(__fmul_rn(p, x2), 6.283185482e+00f);
  return __fmul_rn(p, x);
}

// pmg::eta with each operation rounded on its own, as the twin's torch ops
// round them (kernels/_noise.py eta_hash)
__device__ __forceinline__ float eta_rn(uint32_t prefix, uint32_t idx) {
  const uint32_t h1 = pmg::mix(prefix, idx);
  const uint32_t h2 = pmg::mix(h1, 0x63D83595u);
  const float u1 = __fadd_rn(__fmul_rn((float)(h1 >> 9), 1.0f / 8388608.0f), 1e-7f);
  const float u2 = __fmul_rn((float)(h2 >> 9), 1.0f / 8388608.0f);
  const float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(u1)));
  const float t = __fsub_rn(u2, floorf(__fadd_rn(u2, 0.5f)));
  return __fmul_rn(r, sin2pi_rn(__fsub_rn(0.25f, fabsf(t))));
}

// the new value of point (i, j, k) (flat index id, colour-major index cm),
// its neighbours read from src
__device__ __forceinline__ float update(const Args& a, const float* src, int i, int j, int k,
                                        int id, int cm, float here, uint32_t prefix) {
  // the in-grid test comes from (i, j, k) and the parameters alone, and the
  // indices into the parameters are static (a dynamic one would copy them
  // to local memory)
  const int faces = (i == 0) | (i == a.n0 - 1) << 1 | (j == 0) << 2 | (j == a.n1 - 1) << 3 |
                    (k == 0) << 4 | (k == a.n2 - 1) << 5;
  float nb[MAX_OFF], cf[MAX_OFF];
#pragma unroll
  for (int m = 0; m < MAX_OFF; ++m) {
    nb[m] = faces & a.cross[m] ? 0.f : src[id + a.flat[m]];
    cf[m] = __ldg(a.coef[m] + (a.fld[m] ? cm : 0));
  }
  const float d = __ldg(a.diag + cm);
  float bv = a.b ? __ldg(a.b + id) : 0.f;
  float y = __fmul_rn(cf[0], nb[0]);
#pragma unroll
  for (int m = 1; m < MAX_OFF; ++m) y = __fadd_rn(y, __fmul_rn(cf[m], nb[m]));
  if (a.with_noise)
    bv = __fadd_rn(bv, __fmul_rn(__fmul_rn(a.nfac, __fsqrt_rn(d)), eta_rn(prefix, (uint32_t)id)));
  const float inv = __fmul_rn(__frcp_rn(d), a.omega);
  return __fadd_rn(__fmul_rn(a.omc, here), __fmul_rn(inv, __fsub_rn(bv, y)));
}

// colour order[ph], a thread a point of it.  The first colour's launch
// also copies x into the output, a thread a 2^3 cell (the points of colour
// 0 and the seven after it in each axis), so that every thread of every
// launch updates one point
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) galerkin_sweep_kernel(const Args a, int ph) {
  const uint32_t prefix = a.prefix_at ? __ldg(a.prefix_at) : a.prefix;
  const int t = blockIdx.x * NT + threadIdx.x;
  const int c = a.order[ph];
  const int p0 = c >> 2 & 1, p1 = c >> 1 & 1, p2 = c & 1;
  const int c1 = (a.n1 - p1 + 1) >> 1, c2 = (a.n2 - p2 + 1) >> 1;
  if (ph == 0) {  // colour c's point of cell t from x, the others copied
    const int e1 = (a.n1 + 1) >> 1, e2 = (a.n2 + 1) >> 1;
    if (t >= ((a.n0 + 1) >> 1) * e1 * e2) return;
    const int K = t % e2, r = t / e2;
    const int J = r % e1, I = r / e1;
#pragma unroll
    for (int q = 0; q < COLOURS; ++q) {
      const int i = 2 * I + (q >> 2 & 1), j = 2 * J + (q >> 1 & 1), k = 2 * K + (q & 1);
      if (q == c || i >= a.n0 || j >= a.n1 || k >= a.n2) continue;
      const int id = (i * a.n1 + j) * a.n2 + k;
      a.out[id] = __ldg(a.x + id);
    }
    const int i = 2 * I + p0, j = 2 * J + p1, k = 2 * K + p2;
    if (i >= a.n0 || j >= a.n1 || k >= a.n2) return;
    const int id = (i * a.n1 + j) * a.n2 + k;
    a.out[id] = update(a, a.x, i, j, k, id, a.base[c] + (I * c1 + J) * c2 + K, __ldg(a.x + id),
                       prefix);
    return;
  }
  if (t >= ((a.n0 - p0 + 1) >> 1) * c1 * c2) return;
  const int k = 2 * (t % c2) + p2, r = t / c2;
  const int j = 2 * (r % c1) + p1, i = 2 * (r / c1) + p0;
  const int id = (i * a.n1 + j) * a.n2 + k;
  a.out[id] = update(a, a.out, i, j, k, id, a.base[c] + t, a.out[id], prefix);
}

int colour_points(const Args& a, int c) {
  return ((a.n0 - (c >> 2 & 1) + 1) >> 1) * ((a.n1 - (c >> 1 & 1) + 1) >> 1) *
         ((a.n2 - (c & 1) + 1) >> 1);
}

}  // namespace

extern "C" {

// One sweep of the stencil (offs: noff x 3 offsets in {-1, 0, 1}; slots:
// the field of each offset in fields, or -1 for its scalar) from x into out
// (not x), one launch a colour.  fields and diag are colour-major (colours
// 0 .. 7, each its sublattice row-major); x, b (nullptr: zero) and out are
// natural.  scal_at: MAX_OFF floats in device memory, offset m's scalar at
// each m whose slot is -1 and 0.0 at every m from noff on.  prefix_at: the
// noise key in device memory, or nullptr for prefix.  backward: the colours
// in reverse
int pmg_galerkin_sweep(const float* x, float* out, const float* b, const float* fields,
                       const float* diag, int n0, int n1, int n2, int noff, const int* offs,
                       const int* slots, const float* scal_at, float omega, float omc, float nfac,
                       unsigned int prefix, const unsigned int* prefix_at, int backward,
                       int with_noise, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || noff < 1 || noff > MAX_OFF || x == out || scal_at == nullptr ||
      (long long)n0 * n1 * n2 >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const size_t npts = (size_t)n0 * n1 * n2;
  Args a = {};
  a.x = x;
  a.out = out;
  a.b = b;
  a.diag = diag;
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  for (int m = 0; m < MAX_OFF; ++m) {
    a.coef[m] = scal_at + m;
    if (m >= noff) continue;
    const int* o = offs + 3 * m;
    for (int ax = 0; ax < 3; ++ax)
      if (o[ax] < -1 || o[ax] > 1) return (int)cudaErrorInvalidValue;
    if (slots[m] >= 0) a.coef[m] = fields + (size_t)slots[m] * npts;
    a.fld[m] = slots[m] >= 0;
    a.flat[m] = (o[0] * n1 + o[1]) * n2 + o[2];
    a.cross[m] = (o[0] < 0) | (o[0] > 0) << 1 | (o[1] < 0) << 2 | (o[1] > 0) << 3 | (o[2] < 0) << 4 |
                 (o[2] > 0) << 5;
  }
  a.omega = omega;
  a.omc = omc;
  a.nfac = nfac;
  a.prefix = (uint32_t)prefix;
  a.prefix_at = prefix_at;
  a.with_noise = with_noise;
  int at = 0;
  for (int c = 0; c < COLOURS; ++c) {
    a.order[c] = backward ? COLOURS - 1 - c : c;
    a.base[c] = at;
    at += colour_points(a, c);
  }
  for (int ph = 0; ph < COLOURS; ++ph) {
    // the first colour's launch runs a thread a cell: as many as colour 0 has points
    const int n = colour_points(a, ph > 0 ? a.order[ph] : 0);
    galerkin_sweep_kernel<<<n > 0 ? (n + NT - 1) / NT : 1, NT, 0, (cudaStream_t)stream>>>(a, ph);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
