// Velocity-constrained DP of the light-curtain planner, for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX runs the planner's DP as one lax.scan per
// field under vmap (depthestimation_tpu/lc/planner.py), which XLA compiles
// into one loop on the device. The port's plain version
// (lc/planner.py:_dp_solve) is a host loop of PyTorch ops: three launches a
// camera column forward and a gather a column back, about 3,070 launches a
// solve of 768 columns. This kernel is the whole solve in one launch.
//
// For each field m (one block each) over the (column c, range r) graph:
//
//   best_0[r]  = f[r, 0]
//   top_c[r]   = max_rp  best_{c-1}[rp] + pen_c[rp, r]     (pen 0 or -1e30)
//   ptr_c[r]   = the first rp that attains it
//   best_c[r]  = f[r, c] + top_c[r]
//
// then r_{C-1} = the first argmax of best_{C-1}, r_{c-1} = ptr_c[r_c], and
// out[m, c] = xz[c, r_c]. f is the field with NaN as 0 and +-inf as
// +-FLT_MAX (torch.nan_to_num). Every score is the f32 sum the plain
// version forms, the penalty added and never skipped, and ties go to the
// lower index, so the path is the plain version's to the bit.
//
// What bounds it on the H100: neither bytes nor operations, but the chain
// of 767 dependent columns. Per column a block does R^2 compare-adds
// (16,384 at R = 128) and reads one column of the field; the field is
// 18.9 MB for 48 fields, the feasibility bits 1.5 MB, both L2-resident
// after the first block. The design keeps the chain on chip: best[] is
// double-buffered in shared memory (one __syncthreads a column), the
// back-pointers stay in shared memory (uint8 for R <= 256: 767 x 128 B =
// 98 KB a field) unless they do not fit, and the backtrack runs in the
// block that made them. S lanes share a node r (S a power of two, R * S
// about 512 threads), lane q scanning rp = q, q + S, q + 2S, ... so the
// lanes of a warp read consecutive words of best[] (no bank conflict);
// the S partial maxima meet in a butterfly of shuffles that keeps the
// lower index on equal scores. The feasibility is the planner's penalty
// packed once into bits in that lane order (ops/planner_dp_kernel.py:
// pack_feasible), and each lane prefetches the next column's word and
// field value while it scans.
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace de {

constexpr int kDpMaxThreads = 1024;
constexpr float kDpNeg = -1e30f;   // lc/planner.py NEG, rounded to f32

__device__ __forceinline__ float nan_to_num(float v) {
  return isnan(v) ? 0.0f : fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
}

// (v, i) replaces (bv, bi): a higher score, or the same at a lower index
__device__ __forceinline__ bool dp_beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// One block a field. field [M, R, C] f32; bits [C-1, W, R, S] (bit b of
// word w for lane q of node r: rp = (w * 32 + b) * S + q is a feasible
// predecessor); xz [C, R] (x, z); points [M, C] (x, z); idx [M, C];
// bp_global: [M, C-1, R] back-pointers, or null to keep them in shared
// memory after best[2][R].
template <typename P>
__global__ void __launch_bounds__(kDpMaxThreads)
planner_dp_kernel(const float* __restrict__ field,
                  const uint32_t* __restrict__ bits,
                  const float2* __restrict__ xz, float2* __restrict__ points,
                  long long* __restrict__ idx, P* bp_global, int R, int C,
                  int S, int W) {
  extern __shared__ __align__(16) unsigned char dp_smem[];
  float* best = reinterpret_cast<float*>(dp_smem);               // [2][R]
  P* bp = bp_global ? bp_global + (size_t)blockIdx.x * (C - 1) * R
                    : reinterpret_cast<P*>(best + 2 * R);        // [C-1][R]
  const float* f = field + (size_t)blockIdx.x * R * C;
  const int lane = threadIdx.x & 31;
  const int q = lane & (S - 1);
  const int r = (threadIdx.x >> 5) * (32 / S) + lane / S;
  const bool writer = r < R && q == 0;
  // this lane's predecessors: rp = q + j * S for j < nj
  const int nj = (r < R && q < R) ? (R - q + S - 1) / S : 0;
  const size_t col_words = (size_t)W * R * S;
  const size_t word_stride = (size_t)R * S;
  const uint32_t* my_bits = bits + (size_t)r * S + q;   // read if nj > 0
  const float* my_row = f + (size_t)r * C;               // read if writer

  for (int k = threadIdx.x; k < R; k += blockDim.x)
    best[k] = nan_to_num(__ldg(f + (size_t)k * C));
  float fv = writer ? nan_to_num(__ldg(my_row + 1)) : 0.0f;
  uint32_t word0 = nj > 0 ? __ldg(my_bits) : 0u;
  __syncthreads();

  for (int c = 1; c < C; ++c) {
    const float* cur = best + ((c - 1) & 1) * R;
    float* nxt = best + (c & 1) * R;
    const uint32_t* cb = my_bits + (size_t)(c - 1) * col_words;
    float fv_next = 0.0f;
    uint32_t word_next = 0u;
    if (c + 1 < C) {
      if (writer) fv_next = nan_to_num(__ldg(my_row + c + 1));
      if (nj > 0) word_next = __ldg(cb + col_words);
    }
    float v = -INFINITY;
    int ix = INT_MAX;
    if (nj > 0) {
      uint32_t w = word0;
      v = cur[q] + ((w & 1u) ? 0.0f : kDpNeg);
      ix = q;
      int j = 1;
      for (int wi = 0; wi < W; ++wi) {
        if (wi > 0) w = __ldg(cb + wi * word_stride);
        const int jend = min(nj, (wi + 1) * 32);
#pragma unroll 8
        for (; j < jend; ++j) {
          const int rp = q + j * S;
          const float s = cur[rp] + (((w >> (j & 31)) & 1u) ? 0.0f : kDpNeg);
          if (s > v) {
            v = s;
            ix = rp;
          }
        }
      }
    }
    for (int o = S >> 1; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, ix, o);
      if (dp_beats(v2, i2, v, ix)) {
        v = v2;
        ix = i2;
      }
    }
    if (writer) {
      nxt[r] = fv + v;
      bp[(size_t)(c - 1) * R + r] = (P)ix;
    }
    fv = fv_next;
    word0 = word_next;
    __syncthreads();
  }

  if (threadIdx.x >= 32) return;
  const float* fin = best + ((C - 1) & 1) * R;
  float v = -INFINITY;
  int ix = INT_MAX;
  if (lane < R) {
    v = fin[lane];
    ix = lane;
  }
  for (int k = lane + 32; k < R; k += 32)
    if (fin[k] > v) {
      v = fin[k];
      ix = k;
    }
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, ix, o);
    if (dp_beats(v2, i2, v, ix)) {
      v = v2;
      ix = i2;
    }
  }
  if (lane != 0) return;
  float2* out = points + (size_t)blockIdx.x * C;
  long long* io = idx + (size_t)blockIdx.x * C;
  int rc = ix;
  for (int c = C - 1; c > 0; --c) {
    out[c] = xz[(size_t)c * R + rc];
    io[c] = rc;
    rc = bp[(size_t)(c - 1) * R + rc];
  }
  out[0] = xz[rc];
  io[0] = rc;
}

template <typename P>
static cudaError_t dp_launch(const void* field, const void* bits,
                             const void* xz, void* points, void* idx,
                             void* scratch, int M, int R, int C, int S,
                             cudaStream_t stream) {
  const int W = ((R + S - 1) / S + 31) / 32;
  const int threads = (R * S + 31) / 32 * 32;
  if (threads > kDpMaxThreads) return cudaErrorInvalidValue;
  size_t smem = 2 * (size_t)R * sizeof(float);
  if (!scratch) smem += (size_t)(C - 1) * R * sizeof(P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        planner_dp_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  planner_dp_kernel<P><<<M, threads, smem, stream>>>(
      (const float*)field, (const uint32_t*)bits, (const float2*)xz,
      (float2*)points, (long long*)idx, (P*)scratch, R, C, S, W);
  return cudaGetLastError();
}

}  // namespace de

// field [M, R, C] f32, bits [C-1, W, R, S] (W = ceil(ceil(R / S) / 32)),
// xz [C, R, 2] f32 -> points [M, C, 2] f32, idx [M, C] int64; all
// contiguous. S a power of two up to 32 with R * S <= 1024 (rounded up to
// a warp); 1 <= R <= 1024, C >= 2, M >= 1. scratch: null to keep the
// back-pointers in shared memory (8 R + (C-1) R bytes for R <= 256, twice
// that above, must fit the block's limit), else [M, C-1, R] of uint8 (R <=
// 256) or uint16. One launch on ``stream``.
extern "C" int planner_dp_fwd(const void* field, const void* bits,
                              const void* xz, void* points, void* idx,
                              void* scratch, int M, int R, int C, int S,
                              void* stream) {
  if (M < 1 || R < 1 || R > 1024 || C < 2 || S < 1 || S > 32 ||
      (S & (S - 1)))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return R <= 256 ? de::dp_launch<uint8_t>(field, bits, xz, points, idx,
                                           scratch, M, R, C, S, s)
                  : de::dp_launch<uint16_t>(field, bits, xz, points, idx,
                                            scratch, M, R, C, S, s);
}
