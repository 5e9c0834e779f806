// Shared helpers for the port's Hopper kernels (plain C launch interface,
// loaded with ctypes by ops/cuda_lib.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace de {

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Round an f32 to the nearest bf16 (ties to even), kept as f32: the
// TPU kernels' ``.astype(jnp.bfloat16)`` between two f32 steps.
__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline unsigned smem_addr(const bf16* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory at the address ``a`` (row
// addresses from the lanes)
__device__ inline void ldmatrix_x4_addr(unsigned (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same, transposed, at the shared-memory address ``a``
__device__ inline void ldmatrix_x4_trans(unsigned (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Before a launch of ``kernel`` with ``smem`` bytes of dynamic shared
// memory: raise its limit and ask its resident blocks per SM and the SMs,
// once per device; ``slots`` is the caller's own static cache (one
// launcher, one kernel and one ``smem`` each), 0 where not asked yet: a
// launcher runs once per layer call, and the queries are host time.
template <typename Kernel>
inline cudaError_t launch_shape(Kernel kernel, int threads, size_t smem,
                                int (&slots)[16][2], int* per_sm,
                                int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && slots[dev][0] > 0) {
    *per_sm = slots[dev][0];
    *n_sm = slots[dev][1];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && *per_sm > 0) {
    slots[dev][0] = *per_sm;
    slots[dev][1] = *n_sm;
  }
  return cudaSuccess;
}

}  // namespace de
