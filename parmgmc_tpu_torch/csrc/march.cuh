// Asynchronous plane rings shared by the plane-marching kernels,
// csrc/sweep_march.cu and csrc/chain_march.cu.
//
// A marching block holds a few planes of each streamed field in a ring of
// shared-memory stages.  One producer warp fills the stages ahead of the
// consumer warps; each stage has a "full" mbarrier (the producer's copy
// has landed) and an "empty" one (every consumer warp is done with it).
// Two producers fill a stage with the same box of a plane, zero outside
// the grid:
//
//   TMA       one cp.async.bulk.tensor of a (1, rows, cols) box from a 3D
//             CUtensorMap; the hardware zero-fills the part of the box
//             outside the tensor.  It needs a row stride that is a
//             multiple of 16 B (n2 % 4 == 0) and a 16-B aligned base.
//   cp.async  the producer warp copies the box 4 B a lane with zero fill
//             outside the grid; every lane's copies arrive on the stage's
//             full barrier (cp.async.mbarrier.arrive.noinc).  Any shape.
//
// The host encodes the tensor maps per launch with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links against
// the CUDA runtime alone.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace pmg {

// -- device side ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier has completed the phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the (1, rows, cols) box of plane c2 at (c1, c0) into dst
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// cp.async: the same box, 4 B a lane, zero outside the (n0, n1, n2) grid
__device__ __forceinline__ void cpasync_box(float* dst, const float* src, int rows, int cols,
                                            int c0, int c1, int c2, int n0, int n1, int n2,
                                            int lane) {
  const bool in0 = c2 >= 0 && c2 < n0;
  for (int t = lane; t < rows * cols; t += 32) {
    const int r = t / cols, c = t - r * cols;
    const int j = c1 + r, k = c0 + c;
    const bool in = in0 && j >= 0 && j < n1 && k >= 0 && k < n2;
    const float* g = in ? src + ((size_t)c2 * n1 + j) * n2 + k : src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst + t)),
                 "l"(g), "r"(in ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cpasync_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cpasync_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// barrier among the consumer warps only (the producer warp runs ahead)
template <int NCONS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NCONS) : "memory");
}

// one ring of planes: stage slot and phase parity of the u-th plane the
// block streams (u = 0, 1, ...)
template <int N>
struct Ring {
  uint64_t full[N];
  uint64_t empty[N];
  __device__ __forceinline__ void init(uint32_t fill_arrivals, uint32_t consumer_warps) {
    for (int q = 0; q < N; ++q) {
      mbar_init(&full[q], fill_arrivals);
      mbar_init(&empty[q], consumer_warps);
    }
  }
  // consumer: wait for plane u
  __device__ __forceinline__ void wait_full(int u) { mbar_wait(&full[u % N], (u / N) & 1); }
  // consumer warp (lane 0 after __syncwarp): done with plane u
  __device__ __forceinline__ void release(int u) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[u % N]);
  }
  // producer: wait until the slot of plane u is free (its previous plane
  // u - N released)
  __device__ __forceinline__ void wait_empty(int u) {
    if (u >= N) mbar_wait(&empty[u % N], ((u / N) - 1) & 1);
  }
};

// -- host side -------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a float32 (n0, n1, n2) tensor seen in (1, rows, cols) boxes; zero
// outside it.  Returns false where TMA cannot take it.
static inline bool encode_planes(CUtensorMap* map, const float* base, int n0, int n1, int n2,
                                 int rows, int cols) {
  memset(map, 0, sizeof(*map));
  if (!base) return true;
  if (((uintptr_t)base & 15) || (n2 * sizeof(float)) % 16 || (cols * sizeof(float)) % 16)
    return false;
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return false;
  const cuuint64_t dim[3] = {(cuuint64_t)n2, (cuuint64_t)n1, (cuuint64_t)n0};
  const cuuint64_t stride[2] = {(cuuint64_t)n2 * sizeof(float),
                                (cuuint64_t)n1 * n2 * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)base, dim, stride, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// floats of a stage of rows x cols, rounded up to 128 B (TMA's
// shared-memory alignment)
constexpr int stage_floats(int rows, int cols) { return (rows * cols + 31) / 32 * 32; }

// let a launch of kernel take smem dynamic bytes (the limit is raised,
// never lowered), with the SM's unified memory split in favour of shared
// memory (a block slot is worth more than L1 here)
template <typename K>
static inline cudaError_t allow_smem(K kernel, int smem) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess || a.maxDynamicSharedSizeBytes >= smem) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// (blocks an SM, SMs, dynamic shared bytes) of a launch, for the report
template <typename K>
static inline void occupancy(K kernel, int threads, int smem, int* out) {
  int dev = 0, sms = 0, blocks = 0;
  allow_smem(kernel, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = blocks;
  out[1] = sms;
  out[2] = smem;
}

}  // namespace pmg
