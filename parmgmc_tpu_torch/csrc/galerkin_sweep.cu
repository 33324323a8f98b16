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
// at 128^3).  The first colour's launch runs a thread a point of the grid
// and also copies every other point of x into the output, so a call is out
// of place with no pass of its own.  A call is one launch a colour, 8 in
// sweep order.  Registers are held to 64 a thread (4 blocks an SM), so more
// warps keep more loads in flight.  Measured at 128^3 in a CUDA graph of 20
// calls (NVIDIA H100 80GB HBM3, 700 W): 247 us a call, against 266 us for
// one cooperative launch with a grid barrier between colours, 470 us with
// unbounded registers and 834 us with every load of a point hoisted before
// the sums (212 registers).  At 64^3 .. 16^3 a call takes 54 .. 64 us
// whatever the variant: 8 colours in sequence, each bound by its latency.
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace {

constexpr int NT = 256;       // threads a block
constexpr int MAX_OFF = 26;   // offsets of a radius-1 3D stencil
constexpr int COLOURS = 8;

struct Args {
  const float* x;       // the call's input: the first colour reads it
  float* out;           // the output, swept in place after the first colour
  const float* b;       // nullptr: b = 0
  const float* fields;  // the grid-shaped coefficients, colour-major, one after another
  const float* diag;    // D, colour-major
  int npts;             // below 2^30
  int n0, n1, n2;
  int noff;
  int8_t d0[MAX_OFF], d1[MAX_OFF], d2[MAX_OFF];
  int slot[MAX_OFF];    // the field of offset m, or -1: the scalar scal[m]
  float scal[MAX_OFF];
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
  const int plane = a.n1 * a.n2;
  float y = 0.f;
#pragma unroll
  for (int m = 0; m < MAX_OFF; ++m) {
    if (m >= a.noff) break;
    const int ii = i + a.d0[m], jj = j + a.d1[m], kk = k + a.d2[m];
    const bool in = (unsigned)ii < (unsigned)a.n0 && (unsigned)jj < (unsigned)a.n1 &&
                    (unsigned)kk < (unsigned)a.n2;
    const float nb = in ? src[id + a.d0[m] * plane + a.d1[m] * a.n2 + a.d2[m]] : 0.f;
    const float c = a.slot[m] < 0 ? a.scal[m] : __ldg(a.fields + (size_t)a.slot[m] * a.npts + cm);
    const float t = __fmul_rn(c, nb);
    y = m == 0 ? t : __fadd_rn(y, t);
  }
  const float d = __ldg(a.diag + cm);
  float bv = a.b ? __ldg(a.b + id) : 0.f;
  if (a.with_noise)
    bv = __fadd_rn(bv, __fmul_rn(__fmul_rn(a.nfac, __fsqrt_rn(d)), eta_rn(prefix, (uint32_t)id)));
  const float inv = __fmul_rn(__frcp_rn(d), a.omega);
  return __fadd_rn(__fmul_rn(a.omc, here), __fmul_rn(inv, __fsub_rn(bv, y)));
}

// colour order[ph], a thread a point of it; the first colour's launch a
// thread a point of the grid, the other colours' values copied
__global__ void __launch_bounds__(NT, 4) galerkin_sweep_kernel(const Args a, int ph) {
  const uint32_t prefix = a.prefix_at ? __ldg(a.prefix_at) : a.prefix;
  const int t = blockIdx.x * NT + threadIdx.x;
  const int c = a.order[ph];
  const int p0 = c >> 2 & 1, p1 = c >> 1 & 1, p2 = c & 1;
  const int c1 = (a.n1 - p1 + 1) >> 1, c2 = (a.n2 - p2 + 1) >> 1;
  if (ph == 0) {  // colour c from x
    if (t >= a.npts) return;
    const int k = t % a.n2, r = t / a.n2;
    const int j = r % a.n1, i = r / a.n1;
    const float xv = __ldg(a.x + t);
    float v = xv;
    if (((i & 1) << 2 | (j & 1) << 1 | (k & 1)) == c) {
      const int cm = a.base[c] + ((i >> 1) * c1 + (j >> 1)) * c2 + (k >> 1);
      v = update(a, a.x, i, j, k, t, cm, xv, prefix);
    }
    a.out[t] = v;
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
// the field of each offset in fields, or -1 for its scalar in scal) from x
// into out (not x), one launch a colour.  fields and diag are colour-major
// (colours 0 .. 7, each its sublattice row-major); x, b (nullptr: zero) and
// out are natural.  prefix_at: the noise key in device memory, or nullptr
// for prefix.  backward: the colours in reverse
int pmg_galerkin_sweep(const float* x, float* out, const float* b, const float* fields,
                       const float* diag, int n0, int n1, int n2, int noff, const int* offs,
                       const int* slots, const float* scal, float omega, float omc, float nfac,
                       unsigned int prefix, const unsigned int* prefix_at, int backward,
                       int with_noise, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || noff < 1 || noff > MAX_OFF || x == out ||
      (long long)n0 * n1 * n2 >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.out = out;
  a.b = b;
  a.fields = fields;
  a.diag = diag;
  a.npts = n0 * n1 * n2;
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.noff = noff;
  for (int m = 0; m < noff; ++m) {
    for (int ax = 0; ax < 3; ++ax)
      if (offs[3 * m + ax] < -1 || offs[3 * m + ax] > 1) return (int)cudaErrorInvalidValue;
    a.d0[m] = (int8_t)offs[3 * m];
    a.d1[m] = (int8_t)offs[3 * m + 1];
    a.d2[m] = (int8_t)offs[3 * m + 2];
    a.slot[m] = slots[m];
    a.scal[m] = scal[m];
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
    const int n = ph == 0 ? a.npts : colour_points(a, a.order[ph]);
    galerkin_sweep_kernel<<<n > 0 ? (n + NT - 1) / NT : 1, NT, 0, (cudaStream_t)stream>>>(a, ph);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
