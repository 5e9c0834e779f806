// Flat 3x3x3 Conv3d, forward (which also gives the data gradient) and
// weight gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels depthestimation_tpu/ops/conv3d_pallas.py:
// _fwd_kernel (launched by _fwd_call) and _dw_kernel (launched by
// _dw_call), the two kernels of conv3d_flat_pallas and its custom VJP. Over
// the depth-major flat volume x [N = B*D, C, H, W] (PyTorch's contiguous
// NCHW) and the Conv3d weight W5 [F, C, 3, 3, 3], stride 1, zero padding:
//
//   t_k(m) = T(W_k (*) x(m))        3x3 conv with depth tap k, f32 sums
//                                   rounded to x's type T (the TPU body's
//                                   taps_s holds x.dtype)
//   y(n)   = T((t_1(n) + t_0(n-1) [n%D > 0]) + t_2(n+1) [n%D < D-1])
//
// the combine summed in f32 in that order and rounded once
// (conv3d_pallas.py:92-104). The data gradient is this forward over dy
// with the weight flipped in all three axes and its I/O swapped
// (conv3d_pallas.py:227-239); the kernels read W5 so by index, so no
// flipped copy exists. The weight gradient is
//
//   dW[kd*F + f, c*9 + s] = sum_n sum_p g_kd(n)[f, p] x(n)[c, p + shift_s]
//
// with g_0(n) = dy(n+1) [n%D < D-1], g_1(n) = dy(n), g_2(n) = dy(n-1)
// [n%D > 0] (conv3d_pallas.py:144-170), summed in f32.
//
// What bounds it on the H100: 2 * 27 * C * F operations per output pixel
// against 2 (C + F) bytes of bf16 (4 (C + F) of f32) moved: at C = F = 32,
// about 860 operations a byte in bf16, so the tensor cores bound it (0.176
// ms at Base3D's [512, 32, 64, 96] shape), and in f32 (no TF32: the op's
// f32 contract) the CUDA cores' 67 TFLOP/s (2.6 ms).
//
// bf16: the forward and the data gradient are conv_ring.cuh's ring kernel
// in its conv3d mode (wgmma, M = 64 pixels, N = the three taps stacked, K
// = 9 Cp in chunks of at most 32 channels; the depth ring in the
// accumulators, so each input row is staged once per block; output
// channels in groups of 32; B built from W5 by index, flipped for dx). The
// weight gradient is conv_bwd.cuh's conv_dw_kernel with three taps: M = 9
// Cp (a group of at most 64 channels), N = 3F (a group of at most 32
// channels, padded to 16), K = every pixel of every row, u = x channels
// fastest (conv_dw_input_kernel without the normalize) and G = dy's taps
// read straight from dy; its fixed-order reduce writes [3F, C, 3, 3],
// which is the op's [kd*F + f, c*9 + s].
//
// f32: register-tiled implicit GEMMs on the CUDA cores.
// - Forward (conv3d_f32_fwd_kernel): M = pixels, N = the three taps of 32
//   output channels, K = 9 C. A block owns an 8x32-pixel tile of one item's
//   depth segment and walks its input rows in order, the depth ring in
//   registers (each input row staged once per block for the three output
//   rows it feeds); a unit (one input row, 8 input channels: its halo, and
//   where C > 32 the weights of those channels) arrives by cp.async two
//   units ahead; for C <= 32 the block's weights stay in shared memory,
//   loaded once. A thread owns 4 neighbouring pixels x 4 output channels x
//   3 taps: per (channel, kh) one float4 + float2 of x and nine float4
//   broadcasts of the weights feed 144 FMAs.
// - Weight gradient (conv3d_f32_dw_kernel): M = 3F, N = 9C, K = pixels. A
//   block owns the (32 output channels x 3 taps) x (32 input channels x 9
//   shifts) tile and walks (row, 2x32-pixel tile) units in a grid-stride
//   loop, three in shared memory (dy's three rows for the taps, x's halo);
//   a thread owns 2 channels f x 3 taps x 2 channels c x 9 shifts and per
//   4 pixels loads 6 float4 of dy and 6 x windows for 432 FMAs. The sums go
//   to partials once; a second pass adds them in a fixed order.
// No atomics anywhere, so every result repeats bit for bit.

#include <algorithm>

#include "common.cuh"
#include "conv_bwd.cuh"
#include "conv_ring.cuh"
#include "reduce.cuh"

using de::bf16;

namespace {

// -------------------------------------------------------- f32 forward

constexpr int kFThreads = 512;
constexpr int kFTH = 8, kFTW = 32;         // output tile
constexpr int kFCC = 8;                    // input channels a unit
constexpr int kFXW = 36;                   // halo row: cols tx0-1 .. tx0+34
constexpr int kFXC = (kFTH + 2) * kFXW;    // halo floats a channel
constexpr int kFWC = 27 * 32;              // weights a channel: [9][3][32]
constexpr int kFResC = 32;                 // input channels whose weights
                                           // stay in shared memory
constexpr int kFStages = 3;                // one computes, two in flight

// the f32 forward's shared memory: the stages (x's halo of 8 channels, and
// unless RES the weights of those channels) and, with RES, the weights of
// all C <= 32 input channels
template <bool RES>
constexpr size_t f32_smem() {
  return sizeof(float) * (kFStages * kFCC * (kFXC + (RES ? 0 : kFWC)) +
                          (RES ? kFResC * kFWC : 0));
}

// y [N, F, h*w] from x [N, C, h*w] and W5 (f32); blockIdx = (pixel tile,
// item * nseg + segment, group of 32 output channels)
template <bool RES>
__global__ void __launch_bounds__(kFThreads, 1)
conv3d_f32_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ w5,
                      float* __restrict__ y, int C, int F, int depth, int h,
                      int w, int d1w, int flip, int seg, int nseg,
                      int tiles_x) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int kStage = kFCC * (kFXC + (RES ? 0 : kFWC));
  float* const swres = fsm + kFStages * kStage;   // RES: [C][9][3][32]
  const int HW = h * w;
  const int ty0 = (blockIdx.x / tiles_x) * kFTH;
  const int tx0 = (blockIdx.x % tiles_x) * kFTW;
  const int item = blockIdx.y / nseg;
  const int d0 = (blockIdx.y % nseg) * seg;
  const int d1 = min(d0 + seg, depth);
  const int o0 = blockIdx.z * 32;
  const int quad = threadIdx.x & 63, fg = threadIdx.x >> 6;
  const int r = quad >> 3, q = quad & 7;     // tile row, pixel quad
  const int fl = fg * 4;                     // output channels o0 + fl ..
  const int m_begin = d0 > 0 ? d0 - 1 : 0;
  const int m_end = d1 < depth ? d1 : depth - 1;
  const int nch = (C + kFCC - 1) / kFCC;
  const int units = (m_end - m_begin + 1) * nch;
  const float* xi = x + (size_t)item * depth * C * HW;

  // the weights of input channels k0 .. k0 + n_c - 1 into dst [n_c][9][3]
  // [32]: W5 read by index (flipped for the data gradient), zero past F
  // and C
  auto weights = [&](float* dst, int k0, int n_c) {
    for (int i = threadIdx.x; i < n_c * kFWC; i += kFThreads) {
      const int ol = i & 31, rest = i >> 5;
      const int t = rest % 3, cs = rest / 3, s = cs % 9, cl = cs / 9;
      const int o = o0 + ol, k = k0 + cl, ts = t * 9 + s;
      const bool ok = o < F && k < C;
      const size_t src = flip ? ((size_t)k * d1w + o) * 27 + 26 - ts
                              : ((size_t)o * d1w + k) * 27 + ts;
      de::cp_async4(dst + i, ok ? w5 + src : w5, ok);
    }
  };
  auto stage = [&](int u) {
    if (u < units) {
      float* sx = fsm + (u % kFStages) * kStage;
      const int rr = u / nch, k0 = (u - rr * nch) * kFCC;
      const float* xr = xi + (size_t)(m_begin + rr) * C * HW;
      for (int i = threadIdx.x; i < kFCC * (kFTH + 2) * 34; i += kFThreads) {
        const int cl = i / ((kFTH + 2) * 34), rem = i - cl * (kFTH + 2) * 34;
        const int yy = rem / 34, xx = rem - yy * 34;
        const int c = k0 + cl, py = ty0 + yy - 1, px = tx0 + xx - 1;
        const bool ok = c < C && py >= 0 && py < h && px >= 0 && px < w;
        de::cp_async4(sx + cl * kFXC + yy * kFXW + xx,
                      ok ? xr + (size_t)c * HW + (size_t)py * w + px : x,
                      ok);
      }
      if (!RES) weights(sx + kFCC * kFXC, k0, kFCC);
    }
    de::cp_async_commit();
  };
  if (RES) weights(swres, 0, nch * kFCC);   // with unit 0's group
  stage(0);
  stage(1);

  float part[4][4], t0p[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[f][e] = t0p[f][e] = 0.0f;

  const bool fast_y = w % 4 == 0 && de::aligned16(y);
  auto emit = [&](int row, const float (&v)[4][4]) {
    const int py = ty0 + r, px = tx0 + 4 * q;
    if (py >= h || px >= w) return;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int o = o0 + fl + f;
      if (o >= F) continue;
      float* dst = y + ((size_t)(item * depth + row) * F + o) * HW +
                   (size_t)py * w + px;
      if (fast_y && px + 3 < w) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(v[f][0], v[f][1], v[f][2], v[f][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (px + e < w) dst[e] = v[f][e];
      }
    }
  };

  int u = 0;
  for (int m = m_begin; m <= m_end; ++m) {
    float acc[3][4][4];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][f][e] = 0.0f;
    for (int cc = 0; cc < nch; ++cc, ++u) {
      de::cp_async_wait<1>();        // this thread's copies of unit u landed
      __syncthreads();               // everyone's; unit u - 1 is computed,
                                     // so its buffer takes unit u + 2
      stage(u + 2);
      const float* sx = fsm + (u % kFStages) * kStage;
      const float* sw = RES ? swres + cc * kFCC * kFWC : sx + kFCC * kFXC;
#pragma unroll 2
      for (int cl = 0; cl < kFCC; ++cl) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float* xp = sx + cl * kFXC + (r + kh) * kFXW + 4 * q;
          const float4 a4 = *reinterpret_cast<const float4*>(xp);
          const float2 a2 = *reinterpret_cast<const float2*>(xp + 4);
          const float xv[6] = {a4.x, a4.y, a4.z, a4.w, a2.x, a2.y};
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              const float4 wv = *reinterpret_cast<const float4*>(
                  sw + ((cl * 9 + kh * 3 + kw) * 3 + t) * 32 + fl);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float xe = xv[e + kw];
                acc[t][0][e] = fmaf(xe, wv.x, acc[t][0][e]);
                acc[t][1][e] = fmaf(xe, wv.y, acc[t][1][e]);
                acc[t][2][e] = fmaf(xe, wv.z, acc[t][2][e]);
                acc[t][3][e] = fmaf(xe, wv.w, acc[t][3][e]);
              }
            }
        }
      }
    }
    // the ring in f32: y(m-1) = part(m-1) + t2(m), part(m) = t1(m) +
    // t0(m-1) [m > 0]
    const bool out = m - 1 >= d0 && m - 1 < d1;
    const bool in = m >= d0 && m < d1;
    float yv[4][4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yv[f][e] = part[f][e] + acc[2][f][e];
        if (in) part[f][e] = m > 0 ? acc[1][f][e] + t0p[f][e] : acc[1][f][e];
        t0p[f][e] = acc[0][f][e];
      }
    if (out) emit(m - 1, yv);
  }
  if (d1 == depth) emit(depth - 1, part);   // the top row: no upper tap
}

// ---------------------------------------------------------- f32 weight grad

constexpr int kDThreads = 256;
constexpr int kDTH = 2, kDTW = 32;         // pixels of one work unit
constexpr int kDXW = 36;                   // x halo row: cols tx0-1 ..
constexpr int kDXS = 148;                  // x halo channel stride (odd x4)
constexpr int kDG = 3 * 32 * kDTH * kDTW;  // dy's three rows, 32 channels
constexpr int kDStage = 32 * kDXS + kDG;
constexpr int kDStages = 3;

// partials[blockIdx.x, kd*F + f, c*9 + s] for the block's f group
// (blockIdx.y) and c group (blockIdx.z): its share of the sums over work
// units blockIdx.x, + gridDim.x, ...
__global__ void __launch_bounds__(kDThreads, 1)
conv3d_f32_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ partials, int N, int C, int F,
                     int depth, int h, int w, int tiles_x, int tiles) {
  extern __shared__ __align__(16) float dsm[];
  const int HW = h * w;
  const int f0 = blockIdx.y * 32, c0 = blockIdx.z * 32;
  const int fi = threadIdx.x >> 4, ci = threadIdx.x & 15;
  const int units = N * tiles;
  auto stage = [&](int j) {
    const int unit = blockIdx.x + j * gridDim.x;
    if (unit < units) {
      float* sx = dsm + (j % kDStages) * kDStage;
      float* sg = sx + 32 * kDXS;
      const int n = unit / tiles, tile = unit - n * tiles;
      const int ty0 = (tile / tiles_x) * kDTH, tx0 = (tile % tiles_x) * kDTW;
      const int d = n % depth;
      const float* xr = x + (size_t)n * C * HW;
      for (int i = threadIdx.x; i < 32 * (kDTH + 2) * 34; i += kDThreads) {
        const int cl = i / ((kDTH + 2) * 34), rem = i - cl * (kDTH + 2) * 34;
        const int yy = rem / 34, xx = rem - yy * 34;
        const int c = c0 + cl, py = ty0 + yy - 1, px = tx0 + xx - 1;
        const bool ok = c < C && py >= 0 && py < h && px >= 0 && px < w;
        de::cp_async4(sx + cl * kDXS + yy * kDXW + xx,
                      ok ? xr + (size_t)c * HW + (size_t)py * w + px : x,
                      ok);
      }
      for (int i = threadIdx.x; i < kDG; i += kDThreads) {
        const int xx = i & 31, yy = (i >> 5) & 1, fl = (i >> 6) & 31;
        const int t = i >> 11, f = f0 + fl;
        const int py = ty0 + yy, px = tx0 + xx;
        const bool ok = f < F && py < h && px < w &&
                        (t == 1 || (t == 0 ? d < depth - 1 : d > 0));
        de::cp_async4(sg + i,
                      ok ? dy + ((size_t)(n + 1 - t) * F + f) * HW +
                               (size_t)py * w + px
                         : dy,
                      ok);
      }
    }
    de::cp_async_commit();
  };
  stage(0);
  stage(1);

  float acc[2][9][2][3];             // [c][shift][f][tap]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int s = 0; s < 9; ++s)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int t = 0; t < 3; ++t) acc[a][s][b][t] = 0.0f;

  for (int j = 0; blockIdx.x + j * gridDim.x < units; ++j) {
    de::cp_async_wait<1>();
    __syncthreads();
    stage(j + 2);
    const float* sx = dsm + (j % kDStages) * kDStage;
    const float* sg = sx + 32 * kDXS;
#pragma unroll 1
    for (int r = 0; r < kDTH; ++r) {
#pragma unroll 1
      for (int qq = 0; qq < 8; ++qq) {
        float gv[2][3][4];
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const float4 g4 = *reinterpret_cast<const float4*>(
                sg + ((t * 32 + fi + 16 * b) * kDTH + r) * kDTW + 4 * qq);
            gv[b][t][0] = g4.x;
            gv[b][t][1] = g4.y;
            gv[b][t][2] = g4.z;
            gv[b][t][3] = g4.w;
          }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            const float* xp =
                sx + (ci + 16 * a) * kDXS + (r + kh) * kDXW + 4 * qq;
            const float4 a4 = *reinterpret_cast<const float4*>(xp);
            const float2 a2 = *reinterpret_cast<const float2*>(xp + 4);
            const float xv[6] = {a4.x, a4.y, a4.z, a4.w, a2.x, a2.y};
#pragma unroll
            for (int kw = 0; kw < 3; ++kw)
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                  for (int t = 0; t < 3; ++t)
                    acc[a][kh * 3 + kw][b][t] = fmaf(
                        xv[e + kw], gv[b][t][e], acc[a][kh * 3 + kw][b][t]);
          }
      }
    }
  }

  float* out = partials + (size_t)blockIdx.x * 27 * F * C;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int c = c0 + ci + 16 * a;
    if (c >= C) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int f = f0 + fi + 16 * b;
      if (f >= F) continue;
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int s = 0; s < 9; ++s)
          out[((size_t)t * F + f) * 9 * C + c * 9 + s] = acc[a][s][b][t];
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

cudaError_t blocks_per_sm(const void* kernel, int threads, size_t smem,
                          int* per_sm, int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

// the bf16 forward: the ring kernel's conv3d mode at (NG, S)
template <int NG, int S>
cudaError_t launch_bf16_fwd(const bf16* x, const void* w5, bf16* y, int N,
                            int C, int F, int depth, int h, int w, int w_f32,
                            int flip, cudaStream_t s) {
  using namespace de::ring;
  auto kernel = ring_kernel<NG, S, true>;
  constexpr int Cp = NG * 16;
  const int nch = ceil_div(C, Cp);
  // all chunks' B resident where the block still fits
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const bool resident = smem_bytes<NG, S>(nch, false) <= (size_t)max_smem;
  const size_t smem = smem_bytes<NG, S>(resident ? nch : 1, false);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, n_sm = 0;
  err = blocks_per_sm((const void*)kernel, kThreads, smem, &per_sm, &n_sm);
  if (err != cudaSuccess) return err;
  const int tiles_x = ceil_div(w, kTW);
  const int tiles = ceil_div(h, kTH) * tiles_x;
  const int groups = ceil_div(F, S);
  const int seg = forward_segment(N / depth, depth, tiles * groups,
                                  per_sm * n_sm);
  const int nseg = ceil_div(depth, seg);
  const Args p{x, w5, nullptr, nullptr, y, nullptr, C, F, depth, h, w, 0,
               seg, nseg, tiles_x, w_f32, flip, flip ? F : C,
               (int)resident};
  kernel<<<dim3(tiles, (N / depth) * nseg, groups), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool RES>
cudaError_t launch_f32_fwd(const float* x, const float* w5, float* y, int N,
                           int C, int F, int depth, int h, int w, int flip,
                           cudaStream_t s) {
  constexpr size_t smem = f32_smem<RES>();
  auto kernel = conv3d_f32_fwd_kernel<RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, n_sm = 0;
  err = blocks_per_sm((const void*)kernel, kFThreads, smem, &per_sm, &n_sm);
  if (err != cudaSuccess) return err;
  const int tiles_x = ceil_div(w, kFTW);
  const int tiles = ceil_div(h, kFTH) * tiles_x;
  const int groups = ceil_div(F, 32);
  const int seg = de::ring::forward_segment(N / depth, depth, tiles * groups,
                                            per_sm * n_sm);
  const int nseg = ceil_div(depth, seg);
  kernel<<<dim3(tiles, (N / depth) * nseg, groups), kFThreads, smem, s>>>(
      x, w5, y, C, F, depth, h, w, flip ? F : C, flip, seg, nseg, tiles_x);
  return cudaGetLastError();
}

// the bf16 weight gradient: u = x channels fastest, then per (group of 32
// output channels, group of 64 input channels) conv_dw_kernel and its
// reduce into the group's rows and channels of dw
cudaError_t launch_bf16_dw(const bf16* x, const bf16* dy, float* dw,
                           float* partials, bf16* u, int N, int C, int F,
                           int depth, int h, int w, int n_sm,
                           cudaStream_t s) {
  const int Cp = de::round16(C), HW = h * w;
  cudaError_t err = de::launch_conv_dw_input(x, nullptr, nullptr, u, N, C, Cp,
                                             HW, de::kActNone, s);
  if (err != cudaSuccess) return err;
  const int units = N * ceil_div(h, de::kDwTH) * ceil_div(w, de::kDwTW);
  for (int f0 = 0; f0 < F; f0 += 32) {
    const int fg = std::min(32, F - f0), np = de::round16(3 * fg);
    for (int c0 = 0; c0 < C; c0 += 64) {
      const int cg = std::min(64, C - c0), cpg = de::round16(cg);
      // dw_split (ops/conv_gemm.py): the 64-row tiles of M over at most
      // three warpgroups a block and nsplit blocks
      const int mt = ceil_div(9 * cpg, 64);
      const int nsplit = ceil_div(mt, std::min(mt, de::kDwMaxWgs));
      const int wgs = ceil_div(mt, nsplit);
      const int blocks = std::max(1, std::min(units, n_sm / nsplit));
      const de::DwArgs p{dy + (size_t)f0 * HW, u + c0, N, cg, cpg, fg, 3,
                         depth, h, w, F, Cp};
      const de::DwOut o{F, C, f0, c0};
#define DE_DW(n)                                                              \
  de::launch_conv_dw<n>(p, partials, dw, blocks, nsplit, wgs, s, o)
      err = [&]() -> cudaError_t {
        if (np == 96) return DE_DW(96);
        DE_SWITCH16(np, DE_DW)
      }();
#undef DE_DW
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

cudaError_t launch_f32_dw(const float* x, const float* dy, float* dw,
                          float* partials, int N, int C, int F, int depth,
                          int h, int w, int n_sm, cudaStream_t s) {
  const size_t smem = sizeof(float) * kDStages * kDStage;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_f32_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = ceil_div(w, kDTW);
  const int tiles = ceil_div(h, kDTH) * tiles_x;
  const int groups = ceil_div(F, 32) * ceil_div(C, 32);
  const int slices = std::max(1, std::min(N * tiles, n_sm / groups));
  conv3d_f32_dw_kernel<<<dim3(slices, ceil_div(F, 32), ceil_div(C, 32)),
                         kDThreads, smem, s>>>(x, dy, partials, N, C, F,
                                               depth, h, w, tiles_x, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int elems = 27 * F * C;
  de::dw_reduce_kernel<<<ceil_div(elems, 256), 256, 0, s>>>(partials, dw,
                                                            slices, elems);
  return cudaGetLastError();
}

bool bad_shape(int N, int C, int F, int depth, int h, int w) {
  return N < 1 || C < 1 || F < 1 || depth < 1 || h < 1 || w < 1 ||
         N % depth || N > 65535 || (long)F * C * 27 >= (1L << 24);
}

}  // namespace

// The forward: x [N, C, h*w] -> y [N, F, h*w], both bf16 (is_bf16 = 1) or
// both f32 (0), contiguous, N a multiple of ``depth``; W5 the contiguous
// Conv3d weight [F, C, 3, 3, 3], f32 (w_f32 = 1) or bf16 (0; f32 x takes
// an f32 weight only), rounded to x's type in the kernel. With ``flip`` the
// data gradient: x is dy [N, C, h*w], y is dx [N, F, h*w], and W5 is the
// forward's weight [C, F, 3, 3, 3], read flipped and transposed. One launch
// on ``stream``.
extern "C" int conv3d_flat_fwd(const void* x, const void* w5, void* y, int N,
                               int C, int F, int depth, int h, int w,
                               int is_bf16, int w_f32, int flip,
                               void* stream) {
  if (bad_shape(N, C, F, depth, h, w) || (!is_bf16 && !w_f32))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    return (C <= kFResC ? launch_f32_fwd<true> : launch_f32_fwd<false>)(
        (const float*)x, (const float*)w5, (float*)y, N, C, F, depth, h, w,
        flip, s);
  return de::ring::with_shape(C, F, [&](auto ng, auto st) {
    return launch_bf16_fwd<decltype(ng)::value, decltype(st)::value>(
        (const bf16*)x, w5, (bf16*)y, N, C, F, depth, h, w, w_f32, flip, s);
  });
}

// The weight gradient of conv3d_flat_fwd: x [N, C, h*w] and dy [N, F, h*w]
// (both bf16 or both f32, contiguous) -> dw [3F, C, 3, 3] f32 (row kd*F +
// f, the op's [kd*F + f, c*9 + kh*3 + kw]). Scratch: bf16: u [N, h*w,
// round16(C)] bf16 and partials of n_sm * 9 * round16(min(C, 64)) *
// round16(3 min(F, 32)) f32; f32: partials of max(1, n_sm / (ceil(F/32)
// ceil(C/32))) * 27 F C f32 (u unused). bf16: 1 + 2 launches per group of
// (32 output, 64 input) channels; f32: two launches; all on ``stream``.
extern "C" int conv3d_flat_dw(const void* x, const void* dy, void* dw_out,
                              void* partials, void* u, int N, int C, int F,
                              int depth, int h, int w, int n_sm, int is_bf16,
                              void* stream) {
  if (bad_shape(N, C, F, depth, h, w) || n_sm < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_bf16_dw((const bf16*)x, (const bf16*)dy, (float*)dw_out,
                          (float*)partials, (bf16*)u, N, C, F, depth, h, w,
                          n_sm, s);
  return launch_f32_dw((const float*)x, (const float*)dy, (float*)dw_out,
                       (float*)partials, N, C, F, depth, h, w, n_sm, s);
}
