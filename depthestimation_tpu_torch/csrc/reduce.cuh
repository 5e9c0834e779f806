// Fixed-order reductions of per-block partial sums, shared by the kernels
// that write such partials (no atomics, so results repeat run to run).
#pragma once

#include "common.cuh"

namespace de {

// out[f] = sum over blocks of partials[f, :, :] (two sums per channel,
// interleaved), in a fixed order; one block per channel. ``static``: each
// source that includes this header gets its own copy.
static __global__ void __launch_bounds__(256)
stats_reduce_kernel(const float* __restrict__ partials,
                    float* __restrict__ out, int nblk) {
  __shared__ float red[2][8];
  const int f = blockIdx.x;
  const float* pf = partials + (size_t)f * nblk * 2;
  float s = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
    s += pf[2 * i];
    s2 += pf[2 * i + 1];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f, t2 = 0.0f;
    for (int i = 0; i < (int)(blockDim.x / 32); ++i) {
      t += red[0][i];
      t2 += red[1][i];
    }
    out[2 * f] = t;
    out[2 * f + 1] = t2;
  }
}

// dw[e] = sum over blocks of partials[block][e], blocks in order.
static __global__ void __launch_bounds__(256)
dw_reduce_kernel(const float* __restrict__ partials, float* __restrict__ dw,
                 int nblk, int elems) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  float v = 0.0f;
  for (int i = 0; i < nblk; ++i) v += partials[(size_t)i * elems + e];
  dw[e] = v;
}

}  // namespace de
