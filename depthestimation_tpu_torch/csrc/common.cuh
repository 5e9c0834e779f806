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

}  // namespace de
