// Depth-tap combine of the flat Conv3d, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel depthestimation_tpu/ops/combine_pallas.py: _kernel
// (launched by _call_local), which serves tap_combine and, with the roles
// of the taps swapped, its VJP. The flat Conv3d computes the three depth
// taps of a 3x3x3 conv with one 2D conv whose output channels stack the
// taps, t [N = B*D, 3F, H*W] (PyTorch's contiguous NCHW), and combines
//
//   y[n, f, p] = t[n-1, f, p] [n%D > 0] + t[n, F+f, p]
//                + t[n+1, 2F+f, p] [n%D < D-1]
//
// summed left to right in f32 and rounded once to t's type (the Pallas
// body's three dots with preferred_element_type = f32). The backward is
//
//   dt[n, f]      = g[n+1, f] [n%D < D-1]
//   dt[n, F+f]    = g[n, f]
//   dt[n, 2F+f]   = g[n-1, f] [n%D > 0]
//
// The TPU body picks the taps with one-hot [3F, F] matmuls over a (B, H)
// grid of whole depth columns, because slicing the lane axis needs a Mosaic
// relayout. Nothing of that carries over: in this layout row n of y is one
// contiguous run of F*H*W elements, and each of its three sources is one
// contiguous run of the same length inside rows n-1, n and n+1 of t. The
// kernel is a three-input streaming add (the backward a three-segment copy
// with zero fill).
//
// What bounds it on the H100: bytes. No multiply, 2 adds per output, against
// (3F + F) * N * H*W elements moved. The design moves each byte once: 16-byte
// loads and stores, neighbouring threads on neighbouring addresses, a block
// per (row, chunk of the run), the depth edges by a predicate that is
// uniform over the block (no divergence, the edge tap is never read). Runs
// whose length is not a multiple of the vector width, or tensors that are
// not 16-byte aligned, take the scalar kernel. Every N and every F >= 1
// runs, the 1-channel classifier included.
#include <stdint.h>

#include "common.cuh"

namespace de {

constexpr int kCombThreads = 256;
constexpr int kCombUnroll = 4;   // vectors (or scalars) per thread

template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
};

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline void from_f32(float v, float* o) { *o = v; }
__device__ inline void from_f32(float v, bf16* o) { *o = __float2bfloat16(v); }

// Row n of y from its three runs. ``len``: F*H*W elements; ``chunks``:
// blocks per row. kVec: 16-byte accesses (len % (16 / sizeof(T)) == 0 and
// aligned bases), else one element per access.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kCombThreads)
tap_combine_fwd_kernel(const T* __restrict__ t, T* __restrict__ y,
                       long long len, int depth, int chunks) {
  const long long n = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int d = (int)(n % depth);
  const bool has_dn = d > 0, has_up = d < depth - 1;
  const T* t1 = t + (n * 3 + 1) * len;
  const T* t0 = t + (n - 1) * 3 * len;           // read only if has_dn
  const T* t2 = t + ((n + 1) * 3 + 2) * len;     // read only if has_up
  T* yo = y + n * len;
  constexpr int kN = kVec ? Vec16<T>::kN : 1;
  const long long units = len / kN;
  long long u = (long long)chunk * kCombThreads * kCombUnroll + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kCombUnroll; ++k, u += kCombThreads) {
    if (u >= units) return;
    if (kVec) {
      uint4 a = make_uint4(0, 0, 0, 0), c = make_uint4(0, 0, 0, 0);
      const uint4 b = reinterpret_cast<const uint4*>(t1)[u];
      if (has_dn) a = reinterpret_cast<const uint4*>(t0)[u];
      if (has_up) c = reinterpret_cast<const uint4*>(t2)[u];
      uint4 o;
      const T* av = reinterpret_cast<const T*>(&a);
      const T* bv = reinterpret_cast<const T*>(&b);
      const T* cv = reinterpret_cast<const T*>(&c);
      T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int i = 0; i < kN; ++i)
        from_f32((to_f32(av[i]) + to_f32(bv[i])) + to_f32(cv[i]), ov + i);
      reinterpret_cast<uint4*>(yo)[u] = o;
    } else {
      const float a = has_dn ? to_f32(t0[u]) : 0.0f;
      const float c = has_up ? to_f32(t2[u]) : 0.0f;
      from_f32((a + to_f32(t1[u])) + c, yo + u);
    }
  }
}

// Segment s (0, 1, 2) of row n of dt: a copy of g[n+1], g[n] or g[n-1], or
// zeros across a depth edge. blockIdx.x = (n * 3 + s) * chunks + chunk.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kCombThreads)
tap_combine_bwd_kernel(const T* __restrict__ g, T* __restrict__ dt,
                       long long len, int depth, int chunks) {
  const long long seg = blockIdx.x / chunks;     // n * 3 + s
  const int chunk = blockIdx.x % chunks;
  const long long n = seg / 3;
  const int s = (int)(seg % 3);
  const int d = (int)(n % depth);
  const bool live = s == 1 || (s == 0 ? d < depth - 1 : d > 0);
  const T* src = g + (n + 1 - s) * len;          // read only if live
  T* dst = dt + seg * len;
  constexpr int kN = kVec ? Vec16<T>::kN : 1;
  const long long units = len / kN;
  long long u = (long long)chunk * kCombThreads * kCombUnroll + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kCombUnroll; ++k, u += kCombThreads) {
    if (u >= units) return;
    if (kVec) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (live) v = reinterpret_cast<const uint4*>(src)[u];
      reinterpret_cast<uint4*>(dst)[u] = v;
    } else {
      float v = live ? to_f32(src[u]) : 0.0f;
      from_f32(v, dst + u);
    }
  }
}

template <typename T>
static cudaError_t launch(bool fwd, const void* in, void* out, int N, int F,
                          int P, int depth, cudaStream_t s) {
  const long long len = (long long)F * P;
  const bool vec = len % Vec16<T>::kN == 0 &&
                   (reinterpret_cast<uintptr_t>(in) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  const long long units = vec ? len / Vec16<T>::kN : len;
  const long long per_block = (long long)kCombThreads * kCombUnroll;
  const long long chunks = (units + per_block - 1) / per_block;
  const long long blocks = (long long)N * (fwd ? 1 : 3) * chunks;
  if (chunks > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const T* i = (const T*)in;
  T* o = (T*)out;
  const unsigned grid = (unsigned)blocks;
  const int ch = (int)chunks;
  if (fwd) {
    if (vec)
      tap_combine_fwd_kernel<T, true><<<grid, kCombThreads, 0, s>>>(
          i, o, len, depth, ch);
    else
      tap_combine_fwd_kernel<T, false><<<grid, kCombThreads, 0, s>>>(
          i, o, len, depth, ch);
  } else {
    if (vec)
      tap_combine_bwd_kernel<T, true><<<grid, kCombThreads, 0, s>>>(
          i, o, len, depth, ch);
    else
      tap_combine_bwd_kernel<T, false><<<grid, kCombThreads, 0, s>>>(
          i, o, len, depth, ch);
  }
  return cudaGetLastError();
}

static cudaError_t dispatch(bool fwd, const void* in, void* out, int N, int F,
                            int P, int depth, int is_bf16, void* stream) {
  if (N < 1 || F < 1 || P < 1 || depth < 1 || N % depth)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<bf16>(fwd, in, out, N, F, P, depth, s)
                 : launch<float>(fwd, in, out, N, F, P, depth, s);
}

}  // namespace de

// t [N, 3F, P] -> y [N, F, P], both contiguous, bf16 (is_bf16 = 1) or f32
// (0); N a multiple of ``depth``. One launch on ``stream``.
extern "C" int tap_combine_fwd(const void* t, void* y, int N, int F, int P,
                               int depth, int is_bf16, void* stream) {
  return de::dispatch(true, t, y, N, F, P, depth, is_bf16, stream);
}

// g [N, F, P] -> dt [N, 3F, P], the cotangent of tap_combine_fwd's input.
extern "C" int tap_combine_bwd(const void* g, void* dt, int N, int F, int P,
                               int depth, int is_bf16, void* stream) {
  return de::dispatch(false, g, dt, N, F, P, depth, is_bf16, stream);
}
