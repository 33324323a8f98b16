// The prolong-add of the linear-Galerkin cycle, out = y + P z, in one
// launch a call: y and out the fine 3D grid (n0, n1, n2), z the coarse
// grid, ceil(n / 2) an axis, and P the vertex-style trilinear
// interpolation of operators/stencil.py (prolong).  out may be y itself:
// each output point reads y only at its own index.
//
// Bit for bit its plain twin (kernels/prolong_add.py, the expression it
// replaces, y + prolong(z)): the interpolation runs along axis 0, then
// axis 1 on those values, then axis 2, as _prolong_1d's three passes do;
// per axis an even fine node 2I takes c[I], an interior odd node
// 0.5 (c[I] + c[I + 1]), the last odd node of an even extent
// 0.5 c[I] + 0.5 c[I]; then y + p.  Every product and sum is rounded on
// its own (__fmul_rn, __fadd_rn: nothing contracted into an FMA).
//
// Replaces no TPU kernel: the JAX package leaves the transfers of its
// general cycle to XLA.  In the port the prolong-add was three passes of
// _prolong_1d (a movedim, a half-sum, a cat and a stack an axis) and an
// add, every temporary through device memory: about 0.6 ms of device time
// a step of the linear-Galerkin V(2,2) at 256^3, a twelfth of its bound.
//
// What bounds it on an H100: bytes.  A call reads y and z once and writes
// out once: 142.6 MB at 256^3 (42.6 us at 3.35 TB/s), 163.0 MB over a
// 256^3 step's five calls (48.65 us); some eight float operations a fine
// point are far below the card's 20 a byte.
//
// Design.  A thread owns four consecutive fine points of axis 2: one
// 16-byte load of y and one 16-byte store of out, neighbouring threads on
// neighbouring addresses.  It reads the <= 2 x 2 x 3 coarse values those
// points need through the read-only path (__ldg); z is an eighth of y
// (8.4 MB at 128^3, inside the 50 MB L2), so device memory sees it about
// once, and no interpolated temporary is written anywhere.  A fine last
// extent that is not a multiple of 4, or a pointer off 16 bytes, takes the
// same arithmetic a point a thread.  Blocks of 256 threads cover (axis-2
// chunks, axis-1 rows) of one axis-0 plane; the block index is decoded
// once, so a thread does no division of its own.  A call is one launch;
// the small levels (64^3 and below) are bound by its latency.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (calls queued behind a
// sleeping kernel), kernel / bound / plain twin, in microseconds: 256^3
// 52.45 / 42.57 (81 %) / 500.4; 128^3 7.20 / 5.32 (74 %) / 105.0; 64^3
// 3.60 / 0.67 / 60.8; 32^3 2.92 / 0.08 / 57.2; 16^3 2.75 / 0.01 / 55.0.
// A 256^3 step's five calls in a CUDA graph: 67.51 against the twin's
// 676.4.  Written into y itself, each call within 0.5 us of the above.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a block

struct Args {
  const float* y;
  const float* z;               // read through __ldg
  float* out;                   // may be y
  int n0, n1, n2;               // fine grid
  int c0, c1, c2;               // coarse grid, ceil(n / 2) an axis
  int w;                        // threads along axis 2 (vector: n2 / 4; scalar: n2)
  int gx, gy;                   // blocks along axis 2 and axis 1
};

// one axis of _prolong_1d at fine node f of an axis with c coarse nodes:
// the coarse nodes it reads (lo, and hi for an interior odd node) and its
// rule
struct Axis {
  int lo, hi;
  bool odd, inner;
};

__device__ __forceinline__ Axis axis_at(int f, int c) {
  Axis a;
  a.lo = f >> 1;
  a.odd = f & 1;
  a.inner = a.lo + 1 < c;
  a.hi = a.odd && a.inner ? a.lo + 1 : a.lo;
  return a;
}

// _prolong_1d's value at a node of that rule from c[lo] = a and c[hi] = b
__device__ __forceinline__ float interp(float a, float b, bool odd, bool inner) {
  if (!odd) return a;
  return inner ? __fmul_rn(0.5f, __fadd_rn(a, b)) : __fadd_rn(__fmul_rn(0.5f, a), __fmul_rn(0.5f, a));
}

__device__ __forceinline__ float zat(const Args& a, int I, int J, int K) {
  return __ldg(a.z + ((size_t)I * a.c1 + J) * a.c2 + K);
}

// (axis-2 thread, j, i) of this thread, or false past the grid
__device__ __forceinline__ bool place(const Args& a, int& t, int& j, int& i) {
  const unsigned bx = blockIdx.x % a.gx, rest = blockIdx.x / a.gx;
  const unsigned by = rest % a.gy;
  i = (int)(rest / a.gy);
  t = (int)(bx * blockDim.x + threadIdx.x);
  j = (int)(by * blockDim.y + threadIdx.y);
  return t < a.w && j < a.n1;
}

// four fine points 4t .. 4t + 3 of row (i, j); n2 % 4 == 0, y and out on
// 16 bytes
__global__ void __launch_bounds__(NT) prolong_add_kernel_vec4(const Args a) {
  int t, j, i;
  if (!place(a, t, j, i)) return;
  const Axis x0 = axis_at(i, a.c0), x1 = axis_at(j, a.c1);
  // coarse nodes of axis 2: 2t, 2t + 1 and, inside the grid, 2t + 2
  const int K0 = 2 * t, K1 = K0 + 1;
  const bool k_inner = K1 + 1 < a.c2;
  const int K2 = k_inner ? K1 + 1 : K1;
  const int Ks[3] = {K0, K1, K2};
  float zv[2][2][3];  // (axis 0 lo/hi, axis 1 lo/hi, K)
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    zv[0][0][kk] = zat(a, x0.lo, x1.lo, Ks[kk]);
    zv[0][1][kk] = zat(a, x0.lo, x1.hi, Ks[kk]);
    zv[1][0][kk] = zat(a, x0.hi, x1.lo, Ks[kk]);
    zv[1][1][kk] = zat(a, x0.hi, x1.hi, Ks[kk]);
  }
  const size_t at = ((size_t)i * a.n1 + j) * a.n2 + 4 * (size_t)t;
  const float4 yv = *reinterpret_cast<const float4*>(a.y + at);
  float t1[3];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    const float lo = interp(zv[0][0][kk], zv[1][0][kk], x0.odd, x0.inner);
    const float hi = interp(zv[0][1][kk], zv[1][1][kk], x0.odd, x0.inner);
    t1[kk] = interp(lo, hi, x1.odd, x1.inner);
  }
  float4 o;
  o.x = __fadd_rn(yv.x, t1[0]);
  o.y = __fadd_rn(yv.y, interp(t1[0], t1[1], true, true));
  o.z = __fadd_rn(yv.z, t1[1]);
  o.w = __fadd_rn(yv.w, interp(t1[1], t1[2], true, k_inner));
  *reinterpret_cast<float4*>(a.out + at) = o;
}

// one fine point a thread (any n2, any alignment)
__global__ void __launch_bounds__(NT) prolong_add_kernel_scalar(const Args a) {
  int k, j, i;
  if (!place(a, k, j, i)) return;
  const Axis x0 = axis_at(i, a.c0), x1 = axis_at(j, a.c1), x2 = axis_at(k, a.c2);
  float zv[2][2][2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        zv[ii][jj][kk] = zat(a, ii ? x0.hi : x0.lo, jj ? x1.hi : x1.lo, kk ? x2.hi : x2.lo);
  const size_t at = ((size_t)i * a.n1 + j) * a.n2 + k;
  const float yv = a.y[at];
  float t1[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float lo = interp(zv[0][0][kk], zv[1][0][kk], x0.odd, x0.inner);
    const float hi = interp(zv[0][1][kk], zv[1][1][kk], x0.odd, x0.inner);
    t1[kk] = interp(lo, hi, x1.odd, x1.inner);
  }
  a.out[at] = __fadd_rn(yv, interp(t1[0], t1[1], x2.odd, x2.inner));
}

}  // namespace

extern "C" {

// out = y + P z in one launch on stream: y and out (n0, n1, n2), z
// (ceil(n0 / 2), ceil(n1 / 2), ceil(n2 / 2)), all float32 and contiguous;
// out may be y, never z.
int pmg_prolong_add(const float* y, const float* z, float* out, int n0, int n1, int n2,
                    void* stream) {
  if (y == nullptr || z == nullptr || out == nullptr || n0 < 1 || n1 < 1 || n2 < 1 ||
      (long long)n0 * n1 * n2 >= (1LL << 31) || (const float*)out == z)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.y = y;
  a.z = z;
  a.out = out;
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.c0 = (n0 + 1) / 2;
  a.c1 = (n1 + 1) / 2;
  a.c2 = (n2 + 1) / 2;
  const bool vec = n2 % 4 == 0 && ((uintptr_t)y % 16) == 0 && ((uintptr_t)out % 16) == 0;
  a.w = vec ? n2 / 4 : n2;
  // a warp along axis 2 (two where a row holds more than 32 threads' work)
  const int bx = a.w > 32 ? 64 : 32, by = NT / bx;
  a.gx = (a.w + bx - 1) / bx;
  a.gy = (n1 + by - 1) / by;
  const long long blocks = (long long)a.gx * a.gy * n0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    prolong_add_kernel_vec4<<<(unsigned)blocks, dim3(bx, by), 0, s>>>(a);
  else
    prolong_add_kernel_scalar<<<(unsigned)blocks, dim3(bx, by), 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
