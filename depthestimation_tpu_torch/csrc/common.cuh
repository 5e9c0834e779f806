// Shared helpers for the port's Hopper kernels (plain C launch interface,
// loaded with ctypes by ops/cuda_lib.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

// four 8x8 b16 matrices from shared memory (row addresses from the lanes)
__device__ inline void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same at the shared-memory address ``a``
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

// d += A (16x16, row) . B (16x8, col), bf16 in, f32 accumulate
__device__ inline void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                 unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// resident blocks of ``kernel`` per SM at this launch shape, and the SMs
template <typename Kernel>
inline cudaError_t blocks_per_sm(Kernel kernel, int threads, size_t smem,
                                 int* per_sm, int* n_sm) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace de
