// Flat 3x3x3 Conv3d, forward (which also gives the data gradient) and
// weight gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels depthestimation_tpu/ops/conv3d_pallas.py:
// _fwd_kernel (launched by _fwd_call) and _dw_kernel (launched by
// _dw_call), the two kernels of conv3d_flat_pallas and its custom VJP. Over
// the depth-major flat volume x [N = B*D, C, H, W] (PyTorch's contiguous
// NCHW) and the Conv3d weight [F, C, 3, 3, 3], stride 1, zero padding:
//
//   t_k(m) = T(W_k (*) x(m))        3x3 conv with depth tap k, f32 sums
//                                   rounded to x's type T (the TPU body's
//                                   taps_s holds x.dtype)
//   y(n)   = T((t_1(n) + t_0(n-1) [n%D > 0]) + t_2(n+1) [n%D < D-1])
//
// the combine summed in f32 in that order and rounded once
// (conv3d_pallas.py:92-104). The data gradient is this forward over dy
// with the weight flipped in all three axes and its I/O swapped
// (conv3d_pallas.py:227-239). The weight gradient is
//
//   dW[kd*F + f, c*9 + s] = sum_n sum_p g_kd(n)[f, p] x(n)[c, p + shift_s]
//
// with g_0(n) = dy(n+1) [n%D < D-1], g_1(n) = dy(n), g_2(n) = dy(n-1)
// [n%D > 0] (conv3d_pallas.py:144-170), summed in f32.
//
// What bounds it on the H100: at C = F = 32 the conv does 2 * 27 * C * F
// FLOPs per output pixel against 2 (C + F) bytes of bf16 moved: about 860
// FLOP/byte, so the card's tensor cores bound it (0.176 ms at Base3D's
// [512, 32, 64, 96] shape). These kernels are the simple first version:
// f32 FMAs on the CUDA cores for both types (bf16 is widened on load), so
// they run at a fraction of that bound; tensor-core (mma / wgmma) versions
// are later work. The TPU kernel's im2col by nine masked rolls and its
// delayed-write ring over a sequential grid do not carry over. Forward: a
// block owns a tile of 8x32 output pixels of one row n and 16 output
// channels; for each tap it stages chunks of 16 input channels of row
// n - 1 + k with a one-pixel halo (zeros outside the image) and the tap's
// weights in shared memory; each thread owns one pixel and its 16 channel
// sums, rounds each tap to T and adds the taps in the TPU kernel's order.
// Weight gradient: a GEMM of M = 3F rows by 9C columns over every pixel of
// every row; a block owns a 96x288 output tile (a 6x18 register tile per
// thread, its smem offsets computed once, outside the pixel loop) and walks
// work units (one row, one 4x32 pixel tile) in a grid-stride loop, keeps
// its sums in registers, and writes them once as a partial; a second pass
// adds the partials in a fixed order (no atomics, so the gradient repeats
// run to run).

#include "common.cuh"
#include "reduce.cuh"

using de::bf16;
using de::dw_reduce_kernel;

namespace {

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline float round_to(float v, const float*) { return v; }
__device__ inline float round_to(float v, const bf16*) {
  return de::round_bf16(v);
}
__device__ inline void store(float v, float* o) { *o = v; }
__device__ inline void store(float v, bf16* o) { *o = __float2bfloat16(v); }

// -------------------------------------------------------------- forward

constexpr int kTH = 8, kTW = 32;           // output pixel tile
constexpr int kThreads = kTH * kTW;
constexpr int kHW = kTW + 2, kHH = kTH + 2;
constexpr int kFB = 16;                    // output channels per block
constexpr int kCC = 16;                    // input channels per chunk

// y [N, F, H*W] from x [N, C, H*W] and wk [3, C, 9, F] (tap, input
// channel, kh*3 + kw, output channel), all of type T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wk,
                  T* __restrict__ y, int C, int F, int depth, int h, int w,
                  int tiles_x) {
  __shared__ float sx[kCC * kHH * kHW];
  __shared__ __align__(16) float sw[kCC * 9 * kFB];
  const int n = blockIdx.y;
  const int f0 = blockIdx.z * kFB;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int ly = threadIdx.x / kTW, lx = threadIdx.x % kTW;
  const int d = n % depth;
  const size_t HW = (size_t)h * w;

  float out[kFB];
  bool first = true;
  // the taps in the order the TPU kernel adds them: t_1, t_0, t_2
  for (int q = 0; q < 3; ++q) {
    const int k = q == 0 ? 1 : q == 1 ? 0 : 2;
    if ((k == 0 && d == 0) || (k == 2 && d == depth - 1)) continue;
    const T* xm = x + (size_t)(n - 1 + k) * C * HW;
    float acc[kFB];
#pragma unroll
    for (int i = 0; i < kFB; ++i) acc[i] = 0.0f;
    for (int c0 = 0; c0 < C; c0 += kCC) {
      __syncthreads();                   // the last chunk's reads are done
      for (int i = threadIdx.x; i < kCC * kHH * kHW; i += kThreads) {
        const int cl = i / (kHH * kHW), hp = i - cl * (kHH * kHW);
        const int hy = hp / kHW, hx = hp - hy * kHW;
        const int gy = ty0 + hy - 1, gx = tx0 + hx - 1, c = c0 + cl;
        float v = 0.0f;
        if (c < C && gy >= 0 && gy < h && gx >= 0 && gx < w)
          v = to_f32(xm[(size_t)c * HW + (size_t)gy * w + gx]);
        sx[i] = v;
      }
      for (int i = threadIdx.x; i < kCC * 9 * kFB; i += kThreads) {
        const int fl = i % kFB, cs = i / kFB;    // cs = cl * 9 + s
        const int cl = cs / 9, s = cs - cl * 9;
        const int c = c0 + cl, f = f0 + fl;
        sw[i] = (c < C && f < F)
                    ? to_f32(wk[(((size_t)k * C + c) * 9 + s) * F + f])
                    : 0.0f;
      }
      __syncthreads();
#pragma unroll 2
      for (int cl = 0; cl < kCC; ++cl) {
#pragma unroll
        for (int s = 0; s < 9; ++s) {
          const float xv =
              sx[cl * (kHH * kHW) + (ly + s / 3) * kHW + lx + s % 3];
          const float4* wv =
              reinterpret_cast<const float4*>(sw + (cl * 9 + s) * kFB);
#pragma unroll
          for (int v = 0; v < kFB / 4; ++v) {
            const float4 q4 = wv[v];
            acc[4 * v] = fmaf(xv, q4.x, acc[4 * v]);
            acc[4 * v + 1] = fmaf(xv, q4.y, acc[4 * v + 1]);
            acc[4 * v + 2] = fmaf(xv, q4.z, acc[4 * v + 2]);
            acc[4 * v + 3] = fmaf(xv, q4.w, acc[4 * v + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kFB; ++i) {
      const float t = round_to(acc[i], x);
      out[i] = first ? t : out[i] + t;
    }
    first = false;
  }
  const int gy = ty0 + ly, gx = tx0 + lx;
  if (gy >= h || gx >= w) return;
  T* yo = y + (size_t)n * F * HW + (size_t)gy * w + gx;
#pragma unroll
  for (int i = 0; i < kFB; ++i)
    if (f0 + i < F) store(out[i], yo + (size_t)(f0 + i) * HW);
}

// -------------------------------------------------------- weight gradient

constexpr int kDwThreads = 256;            // a 16 x 16 grid of threads
constexpr int kTM = 6, kTN = 18;           // register tile per thread
constexpr int kBM = 16 * kTM, kBN = 16 * kTN;   // 96 x 288 block tile
constexpr int kUH = 4, kUW = 32;           // pixels of one work unit
constexpr int kUP = kUH * kUW;
constexpr int kAS = kBM + 1;               // sA row stride (no conflicts)
constexpr int kXH = kUH + 2, kXW = kUW + 2;
constexpr int kXC = kBN / 9;               // input channels per block tile

// partials[blockIdx.x, m, c*9 + s] for the block's (m, n) tile: its share
// of the sums over work units blockIdx.x, + gridDim.x, ...
template <typename T>
__global__ void __launch_bounds__(kDwThreads, 1)
conv3d_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 float* __restrict__ partials, int N, int C, int F, int depth,
                 int h, int w, int tiles_x, int tiles) {
  extern __shared__ __align__(16) float dsm[];
  float* sA = dsm;                          // [kUP][kAS]: g_taps by pixel
  float* sX = dsm + kUP * kAS;              // [kXC][kXH][kXW]: x halo
  const int M = 3 * F, NN = 9 * C;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.z * kBN;
  const int c_lo = n0 / 9;                  // n0 is a multiple of 9
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  const size_t HW = (size_t)h * w;

  // this thread's columns: their halo offsets, computed once
  int xoff[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int nn = min(n0 + tn * kTN + j, NN - 1);
    const int c = nn / 9 - c_lo, s = nn % 9;
    xoff[j] = c * (kXH * kXW) + (s / 3) * kXW + s % 3;
  }
  const int arow = tm * kTM;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  const int units = N * tiles;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row = u / tiles, tile = u - row * tiles;
    const int ty0 = (tile / tiles_x) * kUH, tx0 = (tile % tiles_x) * kUW;
    const int dd = row % depth;
    __syncthreads();                        // the last unit's reads are done
    for (int i = threadIdx.x; i < kBM * kUP; i += kDwThreads) {
      const int ml = i / kUP, p = i - ml * kUP;
      const int m = m0 + ml;
      float v = 0.0f;
      if (m < M) {
        const int kd = m / F, f = m - kd * F;
        const bool ok = kd == 1 || (kd == 0 ? dd < depth - 1 : dd > 0);
        const int gy = ty0 + p / kUW, gx = tx0 + p % kUW;
        if (ok && gy < h && gx < w)
          v = to_f32(dy[((size_t)(row + 1 - kd) * F + f) * HW +
                        (size_t)gy * w + gx]);
      }
      sA[p * kAS + ml] = v;
    }
    const T* xr = x + (size_t)row * C * HW;
    for (int i = threadIdx.x; i < kXC * kXH * kXW; i += kDwThreads) {
      const int cl = i / (kXH * kXW), hp = i - cl * (kXH * kXW);
      const int hy = hp / kXW, hx = hp - hy * kXW;
      const int gy = ty0 + hy - 1, gx = tx0 + hx - 1, c = c_lo + cl;
      float v = 0.0f;
      if (c < C && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = to_f32(xr[(size_t)c * HW + (size_t)gy * w + gx]);
      sX[i] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int r = 0; r < kUH; ++r) {
#pragma unroll 2
      for (int col = 0; col < kUW; ++col) {
        const float* ap = sA + (r * kUW + col) * kAS + arow;
        const float* xp = sX + r * kXW + col;
        float a[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = ap[i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const float b = xp[xoff[j]];
#pragma unroll
          for (int i = 0; i < kTM; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
        }
      }
    }
  }

  float* out = partials + (size_t)blockIdx.x * M * NN;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + arow + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int nn = n0 + tn * kTN + j;
      if (nn < NN) out[(size_t)m * NN + nn] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t fwd(const void* x, const void* wk, void* y, int N, int C, int F,
                int depth, int h, int w, cudaStream_t s) {
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles = ((h + kTH - 1) / kTH) * tiles_x;
  dim3 grid(tiles, N, (F + kFB - 1) / kFB);
  conv3d_fwd_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const T*)wk, (T*)y, C, F, depth, h, w, tiles_x);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw(const void* x, const void* dy, void* out, void* partials,
               int N, int C, int F, int depth, int h, int w, int slices,
               cudaStream_t s) {
  const int tiles_x = (w + kUW - 1) / kUW;
  const int tiles = ((h + kUH - 1) / kUH) * tiles_x;
  const size_t smem = sizeof(float) * ((size_t)kUP * kAS +
                                       (size_t)kXC * kXH * kXW);
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(slices, (3 * F + kBM - 1) / kBM, (9 * C + kBN - 1) / kBN);
  conv3d_dw_kernel<T><<<grid, kDwThreads, smem, s>>>(
      (const T*)x, (const T*)dy, (float*)partials, N, C, F, depth, h, w,
      tiles_x, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int elems = 3 * F * 9 * C;
  dw_reduce_kernel<<<(elems + 255) / 256, 256, 0, s>>>(
      (const float*)partials, (float*)out, slices, elems);
  return cudaGetLastError();
}

bool bad_shape(int N, int C, int F, int depth, int h, int w) {
  return N < 1 || C < 1 || F < 1 || depth < 1 || h < 1 || w < 1 ||
         N % depth || N > 65535 || (F + kFB - 1) / kFB > 65535;
}

}  // namespace

// x [N, C, h*w] and wk [3, C, 9, F] -> y [N, F, h*w], all bf16 (is_bf16 =
// 1) or all f32 (0), contiguous; N a multiple of ``depth``. One launch on
// ``stream``. With dy for x and the flipped, I/O-swapped weight it gives
// the data gradient.
extern "C" int conv3d_flat_fwd(const void* x, const void* wk, void* y, int N,
                               int C, int F, int depth, int h, int w,
                               int is_bf16, void* stream) {
  if (bad_shape(N, C, F, depth, h, w)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? fwd<bf16>(x, wk, y, N, C, F, depth, h, w, s)
                 : fwd<float>(x, wk, y, N, C, F, depth, h, w, s);
}

// The weight gradient of conv3d_flat_fwd: x [N, C, h*w] and dy [N, F, h*w]
// (both bf16 or both f32) -> dw [3F, 9C] f32 (row kd*F + f, column c*9 +
// kh*3 + kw), through partials [slices, 3F, 9C] f32 scratch. Two launches
// on ``stream``.
extern "C" int conv3d_flat_dw(const void* x, const void* dy, void* dw_out,
                              void* partials, int N, int C, int F, int depth,
                              int h, int w, int slices, int is_bf16,
                              void* stream) {
  if (bad_shape(N, C, F, depth, h, w) || slices < 1 ||
      (3 * F + kBM - 1) / kBM > 65535 || (9 * C + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dw<bf16>(x, dy, dw_out, partials, N, C, F, depth, h, w,
                            slices, s)
                 : dw<float>(x, dy, dw_out, partials, N, C, F, depth, h, w,
                             slices, s);
}
