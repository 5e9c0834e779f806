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
// out-of-range terms zero.
//
// What bounds it on the H100: bytes. The forward reads x1 and x2 once and
// writes K / (2 C) times as much as it reads (K = 81, C = 32 to 192), at
// 2 K operations (f32 FMAs on the CUDA cores; no tensor core takes them)
// per input element pair: 0.4 to 2.5 operations a byte, far below the
// card's balance. The TPU kernel keeps a row strip of x1 and its padded x2
// in VMEM and writes the K planes from shifted static slices. Here:
//
// Forward (corr_fwd_kernel): a block owns an 8x32-pixel tile of one item
// and a group of channels; the group's channels arrive 8 at a time by
// cp.async, two chunks ahead of the one that computes (x1's tile and x2's
// tile with its md halo, zero outside the image). A thread owns 4
// neighbouring pixels of a row and 3 displacement rows (27 displacements):
// per channel one float4 of x1 and, per displacement row, 3 float4 of x2's
// window feed 36 FMAs. Where the tiles are few (the coarse pyramid levels)
// the channels split across blocks: each group writes its partial sums and
// a second pass adds the groups in a fixed order and divides by C, so the
// card fills at every level with no atomics.
//
// Backward (corr_bwd_kernel): one kernel with both cotangents, a gather. A
// block owns an 8x32-pixel tile of one item and a group of 8 or 32
// channels: its dx1 and dx2 are its own (per channel), so the split costs
// nothing. It keeps x1's and x2's md halos of its channels in shared memory
// and walks the 2 md + 1 displacement rows, staging each row's 2 md + 1
// cotangent planes twice, by cp.async two rows ahead: at the tile (for dx1)
// and shifted by each plane's own displacement (for dx2), so that a
// thread's 4 pixels read each plane as one aligned float4 in both. g is
// read from device memory once per block, not once per channel chunk. A
// thread owns 4 pixels of a row and 2 or 8 channels, and per
// displacement row loads the 9 float4 of g once for all its channels.
// Blocks, chunks and orders are fixed, so the results repeat run to run.

#include "common.cuh"
#include "conv_bwd.cuh"

namespace {

constexpr int kTH = 8, kTW = 32;       // tile: 8 rows x 32 columns
constexpr int kQuads = kTH * kTW / 4;  // 64 pixel quads
constexpr int kCC = 8;                 // forward: channels a chunk
constexpr int kStages = 3;             // one computes, two in flight

template <int MD>
struct Geo {
  static constexpr int kD = 2 * MD + 1;
  static constexpr int kK = kD * kD;
  static constexpr int kNW = (4 + 2 * MD + 3) / 4;   // float4 of a window
  static constexpr int kXW = 28 + 4 * kNW;           // halo row (col tx0-MD)
  static constexpr int kHH = kTH + 2 * MD;           // halo rows
  static constexpr int kHalo = kHH * kXW;
  static constexpr int kIG = (kD + 2) / 3;           // displacement-row
                                                     // groups of 3
};

// the 4 floats at image columns px0 .. px0 + 3 of ``row`` (null outside
// the image rows) into dst (16-byte aligned) by cp.async, zeros outside
// [0, W) stored directly
__device__ inline void copy4(float* dst, const float* row, int px0, int W) {
  if (row == nullptr || px0 + 3 < 0 || px0 >= W) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else if (px0 >= 0 && px0 + 3 < W && de::aligned16(row + px0)) {
    de::cp_async16(dst, row + px0, true);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (px0 + e >= 0 && px0 + e < W)
        de::cp_async4(dst + e, row + px0 + e, true);
      else
        dst[e] = 0.0f;
    }
  }
}

// channels c_lo .. c_lo + n - 1 of ``src`` ([C, H, W], one item) around
// the tile: rows ty0 - MD .. , columns tx0 - MD .. in rows of kXW, one
// channel after another (zero outside the image and past C)
template <int MD>
__device__ inline void stage_halo(float* dst, const float* __restrict__ src,
                                  int c_lo, int n, int C, int H, int W,
                                  int ty0, int tx0) {
  using G = Geo<MD>;
  constexpr int kQ = G::kXW / 4;
  for (int j = threadIdx.x; j < n * G::kHH * kQ; j += blockDim.x) {
    const int cy = j / kQ, qx = j - cy * kQ;
    const int cl = cy / G::kHH, yy = cy - cl * G::kHH;
    const int c = c_lo + cl, py = ty0 + yy - MD;
    const float* row = c < C && py >= 0 && py < H
                           ? src + ((size_t)c * H + py) * W : nullptr;
    copy4(dst + cy * G::kXW + 4 * qx, row, tx0 - MD + 4 * qx, W);
  }
}

// out (one group: / C) or partials[group] [B, K, H, W] of the block's
// tile (blockIdx.x), channel group (blockIdx.y) and item (blockIdx.z)
template <int MD>
__global__ void __launch_bounds__(kQuads * Geo<MD>::kIG)
corr_fwd_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                float* __restrict__ out, int B, int C, int H, int W, int cg,
                int tiles_x) {
  using G = Geo<MD>;
  constexpr int kX1 = kTH * kTW;
  constexpr int kStage = kCC * (kX1 + G::kHalo);
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.z, grp = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int quad = threadIdx.x % kQuads, ig = threadIdx.x / kQuads;
  const int r = quad / 8, q = quad % 8;
  const int c_lo = grp * cg, c_hi = min(C, c_lo + cg);
  const int nch = (c_hi - c_lo + kCC - 1) / kCC;
  const size_t plane = (size_t)H * W;
  const float* x1b = x1 + (size_t)b * C * plane;
  const float* x2b = x2 + (size_t)b * C * plane;

  auto stage = [&](int u) {
    if (u < nch) {
      float* s1 = sm + (u % kStages) * kStage;
      const int c0 = c_lo + u * kCC, n = min(kCC, c_hi - c0);
      for (int j = threadIdx.x; j < kCC * kTH * 8; j += blockDim.x) {
        const int cy = j / 8, qx = j - cy * 8;
        const int cl = cy / kTH, yy = cy - cl * kTH, py = ty0 + yy;
        const float* row = cl < n && py < H
                               ? x1b + ((size_t)(c0 + cl) * H + py) * W
                               : nullptr;
        copy4(s1 + cy * kTW + 4 * qx, row, tx0 + 4 * qx, W);
      }
      stage_halo<MD>(s1 + kCC * kX1, x2b, c0, kCC, c_hi, H, W, ty0, tx0);
    }
    de::cp_async_commit();
  };
  stage(0);
  stage(1);

  float acc[3][G::kD][4];
#pragma unroll
  for (int ii = 0; ii < 3; ++ii)
#pragma unroll
    for (int j = 0; j < G::kD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ii][j][e] = 0.0f;

  for (int u = 0; u < nch; ++u) {
    de::cp_async_wait<1>();
    __syncthreads();
    stage(u + 2);
    const float* s1 = sm + (u % kStages) * kStage;
    const float* s2 = s1 + kCC * kX1;
#pragma unroll 1
    for (int cl = 0; cl < kCC; ++cl) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(s1 + cl * kX1 + r * kTW + 4 * q);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) {
        const int i = 3 * ig + ii;
        if (i >= G::kD) break;
        const float* row = s2 + cl * G::kHalo + (r + i) * G::kXW + 4 * q;
        float v[4 * G::kNW];
#pragma unroll
        for (int k = 0; k < G::kNW; ++k) {
          const float4 t = *reinterpret_cast<const float4*>(row + 4 * k);
          v[4 * k] = t.x;
          v[4 * k + 1] = t.y;
          v[4 * k + 2] = t.z;
          v[4 * k + 3] = t.w;
        }
#pragma unroll
        for (int j = 0; j < G::kD; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[ii][j][e] = fmaf(a[e], v[e + j], acc[ii][j][e]);
      }
    }
  }

  const int y = ty0 + r, x = tx0 + 4 * q;
  if (y >= H || x >= W) return;
  const bool whole = gridDim.y == 1;
  const float cf = (float)C;
  float* o = out + ((size_t)(whole ? 0 : grp) * B + b) * G::kK * plane +
             (size_t)y * W + x;
  const bool vec = x + 3 < W && W % 4 == 0 && de::aligned16(out);
#pragma unroll
  for (int ii = 0; ii < 3; ++ii) {
    const int i = 3 * ig + ii;
    if (i >= G::kD) break;
#pragma unroll
    for (int j = 0; j < G::kD; ++j) {
      float vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vv[e] = whole ? acc[ii][j][e] / cf : acc[ii][j][e];
      float* dst = o + (size_t)(i * G::kD + j) * plane;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(vv[0], vv[1], vv[2],
                                                      vv[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (x + e < W) dst[e] = vv[e];
      }
    }
  }
}

// out[i] = (sum over groups g in order of partials[g][i]) / C
__global__ void __launch_bounds__(256)
corr_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                   int groups, size_t n, int C) {
  const float cf = (float)C;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = 0.0f;
    for (int g = 0; g < groups; ++g) v += partials[(size_t)g * n + i];
    out[i] = v / cf;
  }
}

// dx1, dx2 of the block's (tile, group of 4 CT channels, item): thread
// (channel lane cl = tid / 64, quad) owns channels c_lo + cl * CT ..
template <int MD, int CT>
__global__ void __launch_bounds__(256)
corr_bwd_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                const float* __restrict__ g, float* __restrict__ dx1,
                float* __restrict__ dx2, int C, int H, int W,
                int tiles_x) {
  using G = Geo<MD>;
  constexpr int CG = 4 * CT;
  constexpr int kP = kTH * kTW;                  // a plane's tile
  constexpr int kGStage = 2 * G::kD * kP;        // [2][kD planes][8][32]
  extern __shared__ __align__(16) float sm[];
  float* h1 = sm;                                // x1's halo [CG][kHalo]
  float* h2 = h1 + CG * G::kHalo;                // x2's halo
  float* sg = h2 + CG * G::kHalo;                // [kStages][kGStage]
  const int b = blockIdx.z, c_lo = blockIdx.y * CG;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int quad = threadIdx.x % kQuads, cl = threadIdx.x / kQuads;
  const int r = quad / 8, q = quad % 8;
  const size_t plane = (size_t)H * W;
  const float* gb = g + (size_t)b * G::kK * plane;

  // displacement row i's planes: version 0 at the tile, version 1 shifted
  // by (-(i - MD), -(j - MD)), plane j
  auto stage = [&](int i) {
    if (i < G::kD) {
      float* dst = sg + (i % kStages) * kGStage;
      for (int jb = threadIdx.x; jb < 2 * G::kD * kTH * 8; jb += blockDim.x) {
        const int qx = jb % 8, rest = jb / 8;
        const int yy = rest % kTH, vj = rest / kTH;
        const int ver = vj / G::kD, j = vj - ver * G::kD;
        const int dy = ver ? MD - i : 0, dx = ver ? MD - j : 0;
        const int py = ty0 + yy + dy;
        const float* row = py >= 0 && py < H
                               ? gb + (size_t)(i * G::kD + j) * plane +
                                     (size_t)py * W
                               : nullptr;
        copy4(dst + (vj * kTH + yy) * kTW + 4 * qx, row, tx0 + 4 * qx + dx,
              W);
      }
    }
    de::cp_async_commit();
  };
  stage_halo<MD>(h1, x1 + (size_t)b * C * plane, c_lo, CG, C, H, W, ty0,
                 tx0);
  stage_halo<MD>(h2, x2 + (size_t)b * C * plane, c_lo, CG, C, H, W, ty0,
                 tx0);
  stage(0);                         // the halos and row 0: one group
  stage(1);

  float a1[CT][4], a2[CT][4];
#pragma unroll
  for (int t = 0; t < CT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) a1[t][e] = a2[t][e] = 0.0f;

#pragma unroll 1
  for (int i = 0; i < G::kD; ++i) {
    de::cp_async_wait<1>();
    __syncthreads();
    stage(i + 2);
    const float* gi = sg + (i % kStages) * kGStage;
    // dx1: g at the tile against x2's window of displacement row i
    {
      float gq[G::kD][4];
#pragma unroll
      for (int j = 0; j < G::kD; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(
            gi + (j * kTH + r) * kTW + 4 * q);
        gq[j][0] = t.x;
        gq[j][1] = t.y;
        gq[j][2] = t.z;
        gq[j][3] = t.w;
      }
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const float* row =
            h2 + (cl * CT + t) * G::kHalo + (r + i) * G::kXW + 4 * q;
        float v[4 * G::kNW];
#pragma unroll
        for (int k = 0; k < G::kNW; ++k) {
          const float4 z = *reinterpret_cast<const float4*>(row + 4 * k);
          v[4 * k] = z.x;
          v[4 * k + 1] = z.y;
          v[4 * k + 2] = z.z;
          v[4 * k + 3] = z.w;
        }
#pragma unroll
        for (int j = 0; j < G::kD; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a1[t][e] = fmaf(gq[j][e], v[e + j], a1[t][e]);
      }
    }
    // dx2: g at the shifted pixels against x1 there (halo row r + 2MD - i,
    // column 4q + e - j + 2MD)
    {
      float gs[G::kD][4];
#pragma unroll
      for (int j = 0; j < G::kD; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(
            gi + ((G::kD + j) * kTH + r) * kTW + 4 * q);
        gs[j][0] = t.x;
        gs[j][1] = t.y;
        gs[j][2] = t.z;
        gs[j][3] = t.w;
      }
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const float* row = h1 + (cl * CT + t) * G::kHalo +
                           (r + 2 * MD - i) * G::kXW + 4 * q;
        float v[4 * G::kNW];
#pragma unroll
        for (int k = 0; k < G::kNW; ++k) {
          const float4 z = *reinterpret_cast<const float4*>(row + 4 * k);
          v[4 * k] = z.x;
          v[4 * k + 1] = z.y;
          v[4 * k + 2] = z.z;
          v[4 * k + 3] = z.w;
        }
#pragma unroll
        for (int j = 0; j < G::kD; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a2[t][e] = fmaf(gs[j][e], v[e - j + 2 * MD], a2[t][e]);
      }
    }
  }

  const int y = ty0 + r, x = tx0 + 4 * q;
  if (y >= H || x >= W) return;
  const float cf = (float)C;
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    const int c = c_lo + cl * CT + t;
    if (c >= C) break;
    const size_t at = (((size_t)b * C + c) * H + y) * W + x;
    float* d1 = dx1 + at;
    float* d2 = dx2 + at;
    if (x + 3 < W && W % 4 == 0 && de::aligned16(dx1) && de::aligned16(dx2)) {
      *reinterpret_cast<float4*>(d1) =
          make_float4(a1[t][0] / cf, a1[t][1] / cf, a1[t][2] / cf,
                      a1[t][3] / cf);
      *reinterpret_cast<float4*>(d2) =
          make_float4(a2[t][0] / cf, a2[t][1] / cf, a2[t][2] / cf,
                      a2[t][3] / cf);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x + e < W) {
          d1[e] = a1[t][e] / cf;
          d2[e] = a2[t][e] / cf;
        }
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int MD>
cudaError_t launch_fwd(const float* x1, const float* x2, float* out,
                       float* partials, int B, int C, int H, int W, int cg,
                       cudaStream_t s) {
  using G = Geo<MD>;
  const size_t smem =
      sizeof(float) * kStages * kCC * (kTH * kTW + G::kHalo);
  cudaError_t err = cudaFuncSetAttribute(
      corr_fwd_kernel<MD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = ceil_div(W, kTW);
  const int tiles = ceil_div(H, kTH) * tiles_x;
  const int groups = ceil_div(C, cg);
  corr_fwd_kernel<MD><<<dim3(tiles, groups, B), kQuads * G::kIG, smem, s>>>(
      x1, x2, groups == 1 ? out : partials, B, C, H, W, cg, tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  const size_t n = (size_t)B * G::kK * H * W;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  corr_reduce_kernel<<<blocks, 256, 0, s>>>(partials, out, groups, n, C);
  return cudaGetLastError();
}

template <int MD, int CT>
cudaError_t launch_bwd(const float* x1, const float* x2, const float* g,
                       float* dx1, float* dx2, int B, int C, int H, int W,
                       cudaStream_t s) {
  using G = Geo<MD>;
  const size_t smem = sizeof(float) * (2 * 4 * CT * G::kHalo +
                                       kStages * 2 * G::kD * kTH * kTW);
  cudaError_t err = cudaFuncSetAttribute(
      corr_bwd_kernel<MD, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = ceil_div(W, kTW);
  const int tiles = ceil_div(H, kTH) * tiles_x;
  corr_bwd_kernel<MD, CT><<<dim3(tiles, ceil_div(C, 4 * CT), B), 256, smem,
                            s>>>(x1, x2, g, dx1, dx2, C, H, W, tiles_x);
  return cudaGetLastError();
}

template <int MD>
cudaError_t dispatch_md(bool fwd, const float* a, const float* b,
                        const float* gg, float* p, float* q, float* part,
                        int B, int C, int H, int W, int cg, cudaStream_t s) {
  if (fwd) return launch_fwd<MD>(a, b, p, part, B, C, H, W, cg, s);
  switch (cg) {
    case 8: return launch_bwd<MD, 2>(a, b, gg, p, q, B, C, H, W, s);
    case 32:   // not at md 1: ptxas spills that instantiation
      if constexpr (MD > 1)
        return launch_bwd<MD, 8>(a, b, gg, p, q, B, C, H, W, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(bool fwd, const void* x1, const void* x2, const void* g,
                     void* o1, void* o2, void* part, int B, int C, int H,
                     int W, int md, int cg, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || B > 65535 || cg < 1 ||
      (fwd && cg % kCC) || ceil_div(C, cg) > 65535)
    return cudaErrorInvalidValue;
  const float* a = (const float*)x1;
  const float* b = (const float*)x2;
  const float* gg = (const float*)g;
  float* p = (float*)o1;
  float* q = (float*)o2;
  float* pt = (float*)part;
  cudaStream_t s = (cudaStream_t)stream;
  switch (md) {
    case 1: return dispatch_md<1>(fwd, a, b, gg, p, q, pt, B, C, H, W, cg, s);
    case 2: return dispatch_md<2>(fwd, a, b, gg, p, q, pt, B, C, H, W, cg, s);
    case 3: return dispatch_md<3>(fwd, a, b, gg, p, q, pt, B, C, H, W, cg, s);
    case 4: return dispatch_md<4>(fwd, a, b, gg, p, q, pt, B, C, H, W, cg, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x1, x2 [B, C, H, W] f32 -> out [B, (2 md + 1)^2, H, W] f32, contiguous;
// md in 1..4; blocks of ``cg`` channels (a multiple of 8). Where cg < C,
// partials [ceil(C / cg), B, (2 md + 1)^2, H, W] f32 is scratch and a
// second launch adds the groups in order; else one launch. On ``stream``.
extern "C" int correlation_fwd(const void* x1, const void* x2, void* out,
                               void* partials, int B, int C, int H, int W,
                               int md, int cg, void* stream) {
  return dispatch(true, x1, x2, nullptr, out, nullptr, partials, B, C, H, W,
                  md, cg, stream);
}

// The cotangents dx1, dx2 [B, C, H, W] of correlation_fwd's inputs for the
// output cotangent g [B, (2 md + 1)^2, H, W]; all f32 and contiguous;
// blocks of ``cg`` channels (8, or 32 where md > 1). One launch on
// ``stream``.
extern "C" int correlation_bwd(const void* x1, const void* x2, const void* g,
                               void* dx1, void* dx2, int B, int C, int H,
                               int W, int md, int cg, void* stream) {
  return dispatch(false, x1, x2, g, dx1, dx2, nullptr, B, C, H, W, md, cg,
                  stream);
}
