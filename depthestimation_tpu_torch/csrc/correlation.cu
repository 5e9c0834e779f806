// Cost-volume correlation, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel depthestimation_tpu/ops/correlation.py:
// _corr_kernel (launched by _correlation_pallas_fwd), and, for the
// backward, the VJP that JAX takes of the XLA form of the same function
// (correlation_pallas's _bwd). Over x1, x2 [B, C, H, W] f32 (PyTorch's
// contiguous NCHW) and a search range md (K = (2 md + 1)^2 displacements,
// 81 at md = 4):
//
//   out[b, k, y, x] = (sum_c x1[b, c, y, x] * x2[b, c, y + i - md, x + j - md]) / C
//
// with k = i (2 md + 1) + j and x2 zero outside the image (JAX pads it with
// jnp.pad). The backward, with g the cotangent of out:
//
//   dx1[c, y, x]   = sum_k g[k, y, x] / C * x2[c, y + i - md, x + j - md]
//   dx2[c, y', x'] = sum_k g[k, y' - i + md, x' - j + md] / C
//                          * x1[c, y' - i + md, x' - j + md]
//
// out-of-range terms zero. The sums over k run in k order, as the plain
// version's (ops/correlation.py).
//
// What bounds it on the H100: bytes. The forward reads x1 and x2 once and
// writes K / (2 C) times as much as it reads (K = 81, C = 32 to 192), at
// 2 K FLOPs (f32 FMAs on the CUDA cores; no tensor core takes them) per
// input element pair: 0.4 to 2.5 FLOP/byte, far below the card's balance.
// The TPU kernel keeps a row strip of x1 and its padded x2 in VMEM and
// writes the K planes from shifted static slices; here a block owns a tile
// of output pixels of one item and stages chunks of channels of the x1 tile
// and of the x2 tile with its md halo (zeros outside the image) in shared
// memory, so each input element is read from device memory about once.
// Each thread owns one output pixel and keeps its K sums in registers (K is
// a template constant), and writes the K planes with neighbouring threads
// on neighbouring addresses.
//
// The backward is one kernel with both outputs, a gather with no atomics:
// each thread owns one pixel, keeps its K cotangents g[k, y, x] / C in
// registers for dx1, and for dx2 reads g at the K shifted pixels (through
// the read-only cache) against the staged x1 halo. Blocks, chunks and
// orders are fixed, so the results repeat run to run.

#include "common.cuh"

namespace {

constexpr int kTH = 8, kTW = 32;       // output tile, rows x cols
constexpr int kThreads = kTH * kTW;    // one pixel per thread
constexpr int kCC = 8;                 // channels staged per chunk

template <int MD>
struct Geo {
  static constexpr int kD = 2 * MD + 1;
  static constexpr int kK = kD * kD;
  static constexpr int kHH = kTH + 2 * MD, kHW = kTW + 2 * MD;
  static constexpr int kHalo = kHH * kHW;
};

// Stage channels [c0, c0 + kCC) of ``src``'s halo tile (origin (ty0 - MD,
// tx0 - MD)), zeros outside the image and past C.
template <int MD>
__device__ inline void stage_halo(float* dst, const float* __restrict__ src,
                                  int c0, int C, int H, int W, int ty0,
                                  int tx0) {
  using G = Geo<MD>;
  for (int i = threadIdx.x; i < kCC * G::kHalo; i += kThreads) {
    const int cl = i / G::kHalo, hp = i - cl * G::kHalo;
    const int hy = hp / G::kHW, hx = hp - hy * G::kHW;
    const int gy = ty0 + hy - MD, gx = tx0 + hx - MD, c = c0 + cl;
    float v = 0.0f;
    if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = src[((size_t)c * H + gy) * W + gx];
    dst[i] = v;
  }
}

template <int MD>
__global__ void __launch_bounds__(kThreads)
correlation_fwd_kernel(const float* __restrict__ x1,
                       const float* __restrict__ x2, float* __restrict__ out,
                       int C, int H, int W, int tiles_x) {
  using G = Geo<MD>;
  __shared__ float s1[kCC][kTH * kTW];
  __shared__ float s2[kCC * G::kHalo];
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int ly = threadIdx.x / kTW, lx = threadIdx.x % kTW;
  const int y = ty0 + ly, x = tx0 + lx;
  const size_t plane = (size_t)H * W;
  const float* x1b = x1 + (size_t)b * C * plane;
  const float* x2b = x2 + (size_t)b * C * plane;

  float acc[G::kK];
#pragma unroll
  for (int k = 0; k < G::kK; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    __syncthreads();                    // the last chunk's reads are done
    for (int i = threadIdx.x; i < kCC * kTH * kTW; i += kThreads) {
      const int cl = i / (kTH * kTW), p = i - cl * (kTH * kTW);
      const int gy = ty0 + p / kTW, gx = tx0 + p % kTW, c = c0 + cl;
      s1[cl][p] = (c < C && gy < H && gx < W)
                      ? x1b[((size_t)c * H + gy) * W + gx] : 0.0f;
    }
    stage_halo<MD>(s2, x2b, c0, C, H, W, ty0, tx0);
    __syncthreads();
#pragma unroll 1
    for (int cl = 0; cl < kCC; ++cl) {
      const float v1 = s1[cl][threadIdx.x];
      const float* r = s2 + cl * G::kHalo + ly * G::kHW + lx;
#pragma unroll
      for (int i = 0; i < G::kD; ++i)
#pragma unroll
        for (int j = 0; j < G::kD; ++j)
          acc[i * G::kD + j] = fmaf(v1, r[i * G::kHW + j], acc[i * G::kD + j]);
    }
  }
  if (y >= H || x >= W) return;
  const float cf = (float)C;
  float* o = out + (size_t)b * G::kK * plane + (size_t)y * W + x;
#pragma unroll
  for (int k = 0; k < G::kK; ++k) o[k * plane] = acc[k] / cf;
}

template <int MD>
__global__ void __launch_bounds__(kThreads)
correlation_bwd_kernel(const float* __restrict__ x1,
                       const float* __restrict__ x2,
                       const float* __restrict__ g, float* __restrict__ dx1,
                       float* __restrict__ dx2, int C, int H, int W,
                       int tiles_x) {
  using G = Geo<MD>;
  __shared__ float s1h[kCC * G::kHalo];   // x1 around the tile (for dx2)
  __shared__ float s2h[kCC * G::kHalo];   // x2 around the tile (for dx1)
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int ly = threadIdx.x / kTW, lx = threadIdx.x % kTW;
  const int y = ty0 + ly, x = tx0 + lx;
  const bool live = y < H && x < W;
  const size_t plane = (size_t)H * W;
  const float* gb = g + (size_t)b * G::kK * plane;
  const float cf = (float)C;

  // this pixel's cotangents, / C as the plain version's g / C
  float gk[G::kK];
#pragma unroll
  for (int k = 0; k < G::kK; ++k)
    gk[k] = live ? gb[k * plane + (size_t)y * W + x] / cf : 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    __syncthreads();
    stage_halo<MD>(s1h, x1 + (size_t)b * C * plane, c0, C, H, W, ty0, tx0);
    stage_halo<MD>(s2h, x2 + (size_t)b * C * plane, c0, C, H, W, ty0, tx0);
    __syncthreads();

    // dx2 at (y, x) for the chunk's channels: the K shifted cotangents
    // against x1 at the same shifted pixels (halo index ly + 2md - i)
    float a2[kCC];
#pragma unroll
    for (int cl = 0; cl < kCC; ++cl) a2[cl] = 0.0f;
#pragma unroll 1
    for (int i = 0; i < G::kD; ++i) {
      const int py = y - i + MD;
#pragma unroll
      for (int j = 0; j < G::kD; ++j) {
        const int px = x - j + MD;
        float gv = 0.0f;
        if (live && py >= 0 && py < H && px >= 0 && px < W)
          gv = __ldg(gb + (size_t)(i * G::kD + j) * plane +
                     (size_t)py * W + px) / cf;
        const int hp = (ly + 2 * MD - i) * G::kHW + (lx + 2 * MD - j);
#pragma unroll
        for (int cl = 0; cl < kCC; ++cl)
          a2[cl] = fmaf(gv, s1h[cl * G::kHalo + hp], a2[cl]);
      }
    }

    // dx1 at (y, x): this pixel's cotangents against the shifted x2
#pragma unroll 1
    for (int cl = 0; cl < kCC; ++cl) {
      const int c = c0 + cl;
      const float* r = s2h + cl * G::kHalo + ly * G::kHW + lx;
      float a1 = 0.0f;
#pragma unroll
      for (int i = 0; i < G::kD; ++i)
#pragma unroll
        for (int j = 0; j < G::kD; ++j)
          a1 = fmaf(gk[i * G::kD + j], r[i * G::kHW + j], a1);
      if (live && c < C) {
        const size_t at = (((size_t)b * C + c) * H + y) * W + x;
        dx1[at] = a1;
        dx2[at] = a2[cl];
      }
    }
  }
}

template <int MD>
cudaError_t launch(bool fwd, const float* x1, const float* x2, const float* g,
                   float* o1, float* o2, int B, int C, int H, int W,
                   cudaStream_t s) {
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles = ((H + kTH - 1) / kTH) * tiles_x;
  dim3 grid(tiles, B);
  if (fwd)
    correlation_fwd_kernel<MD><<<grid, kThreads, 0, s>>>(x1, x2, o1, C, H, W,
                                                         tiles_x);
  else
    correlation_bwd_kernel<MD><<<grid, kThreads, 0, s>>>(x1, x2, g, o1, o2,
                                                         C, H, W, tiles_x);
  return cudaGetLastError();
}

cudaError_t dispatch(bool fwd, const void* x1, const void* x2, const void* g,
                     void* o1, void* o2, int B, int C, int H, int W, int md,
                     void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || B > 65535)
    return cudaErrorInvalidValue;
  const float* a = (const float*)x1;
  const float* b = (const float*)x2;
  const float* gg = (const float*)g;
  float* p = (float*)o1;
  float* q = (float*)o2;
  cudaStream_t s = (cudaStream_t)stream;
  switch (md) {
    case 1: return launch<1>(fwd, a, b, gg, p, q, B, C, H, W, s);
    case 2: return launch<2>(fwd, a, b, gg, p, q, B, C, H, W, s);
    case 3: return launch<3>(fwd, a, b, gg, p, q, B, C, H, W, s);
    case 4: return launch<4>(fwd, a, b, gg, p, q, B, C, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x1, x2 [B, C, H, W] f32 -> out [B, (2 md + 1)^2, H, W] f32, contiguous;
// md in 1..4. One launch on ``stream``.
extern "C" int correlation_fwd(const void* x1, const void* x2, void* out,
                               int B, int C, int H, int W, int md,
                               void* stream) {
  return dispatch(true, x1, x2, nullptr, out, nullptr, B, C, H, W, md,
                  stream);
}

// The cotangents dx1, dx2 [B, C, H, W] of correlation_fwd's inputs for the
// output cotangent g [B, (2 md + 1)^2, H, W]; all f32 and contiguous. One
// launch on ``stream``.
extern "C" int correlation_bwd(const void* x1, const void* x2, const void* g,
                               void* dx1, void* dx2, int B, int C, int H,
                               int W, int md, void* stream) {
  return dispatch(false, x1, x2, g, dx1, dx2, B, C, H, W, md, stream);
}
