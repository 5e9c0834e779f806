// Fused 2D ConvBN layer, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels depthestimation_tpu/ops/convbn2d_pallas.py:
// _fwd_kernel (launched by _fwd_call) and _bwd_kernel (launched by
// _bwd_call) with the seam weight gradient _xla_seam_dw, the two halves of
// the custom VJP of convbn2d_block. One stride-1 3x3 'same' conv layer of
// the encoder's fused ConvBN chain (and of the decoder's refine tail) over
// x [N, C, H*W] (PyTorch's contiguous NCHW):
//
//   u     = bf16(act(x * a + b))          normalize on load, f32, act in
//                                         {none, relu, leaky 0.01}
//   y     = bf16(W (*) u)                 3x3 conv, zero padding of u
//   stats = (sum y, sum y^2) per output channel, f32, of the bf16 y
//
// with the TPU kernel's rounding points (convbn2d_pallas.py:142-198). The
// TPU kernel walks row strips with seam rings because its tiles are lane
// rows; here a block owns an 8x16-pixel tile of one image and reads the
// one-pixel halo of neighbouring rows directly, so there are no seams.
//
// What bounds it on the H100: at the encoder's widths (C = F = 32, 64) the
// conv does 2 * 9C * F FLOPs per pixel against 2 (C + F) bytes, 72 to 144
// FLOP/byte, under the card's bf16 balance point (about 295), so HBM
// bounds the ideal kernel (about 15 us per half-resolution launch at
// B = 8); a simple kernel is bound by its own instructions: building the
// normalized operand and feeding the tensor cores from shared memory.
//
// What the design does about it: the implicit GEMM of csrc/convcomb.cu
// without its depth ring. A block keeps the whole [F, 9C] weight matrix in
// shared memory (loaded once) and walks image tiles in a grid-stride loop;
// for each tile it normalizes the 10x18-pixel halo into shared memory,
// channels fastest, and each warp computes every output channel of 32
// pixels with mma.sync m16n8k16, ldmatrix reading the B fragments straight
// from the shifted halo pixels. The BN sums stay in registers across the
// block's tiles and go to a partials buffer that a second kernel reduces
// in a fixed order (deterministic stats). C and F up to 80 (five 16-row
// tiles): the weights take at most 116 KB, two blocks per SM at C = F = 64.
//
// Backward (convbn2d_bwd), with ge = bf16(gy + s0 + 2 y s1) folding the
// statistics' cotangent (s0, s1) into gy, written once by a fold pass
// (conv_bwd.cuh) and read by both gradients:
//   du  = the transposed 3x3 conv of ge          products summed in f32
//   dv  = du masked by act' on the f32 pre-activation v = x a + b
//   dx  = bf16(dv a),  da = sum dv x,  db = sum dv
//   dW  = sum over pixels of ge (x) im2col(u)    f32, u rebuilt from x
// Bound: at 64x96, C = F = 64, N = 16 the two GEMMs are 14.5 GFLOP, 0.015
// ms on the tensor cores, against 0.015 ms for the bytes of x, y, gy and
// dx: a kernel at the card's balance point, so both the products and the
// operand building have to be cheap. Design (see the backward section):
// both GEMMs on wgmma (wgmma.cuh), the shifted operand in registers from a
// halo tile, the regular one in shared memory; each kernel reads W in the
// module's own [F, C, 3, 3] layout and dW's second pass writes it, so the
// wrapper packs nothing. The TPU's seam dW (_xla_seam_dw, f32 u and ge)
// has no counterpart: the halo carries the neighbouring rows, with bf16
// operands everywhere. Partial sums per block, added in a fixed order: no
// atomics, so the gradients repeat bit for bit.

#include <algorithm>

#include "common.cuh"
#include "reduce.cuh"
#include "conv_bwd.cuh"
#include "wgmma.cuh"

using de::bf16;
using de::ldmatrix_x4;
using de::mma_16816;
using de::stats_reduce_kernel;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 8, kTW = 16;           // output tile: 8 rows x 16 cols
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;  // 180 halo pixels
constexpr int kNT = 4;                     // n8 pixel tiles per warp
constexpr int kMaxMT = 5;                  // m16 row tiles: C, F <= 80

using de::act_bwd;
using de::act_fwd;
using de::affine;
using de::kActLeaky;
using de::kActNone;

// The forward layer. x [N, C, HW] with the layer's (a, b) and act, wk
// [MT*16, 9*Cp] (index s*Cp + c, s = kh*3 + kw); y [N, F, HW],
// ``partials`` [F, gridDim.x, 2] = per-block (sum y, sum y^2).
template <int MT>
__global__ void __launch_bounds__(kThreads)
convbn2d_kernel(const bf16* __restrict__ in, const float* __restrict__ ka,
                const float* __restrict__ kb, const bf16* __restrict__ wk,
                bf16* __restrict__ out, float* __restrict__ partials, int K,
                int Kp, int M, int h, int w, int act, int tiles_x, int units) {
  constexpr int Mp = MT * 16;
  const int HW = h * w;
  const int tiles = ((h + kTH - 1) / kTH) * tiles_x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ws = 9 * Kp + 8, us = Kp + 8;  // row strides: +16 B, no conflicts

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);                 // [Mp, ws]
  bf16* sU = sW + Mp * ws;                                   // [kHalo, us]
  float* sRed = reinterpret_cast<float*>(sU + kHalo * us);   // [warp, Mp, 2]

  const int k8 = 9 * Kp / 8;
  for (int i = threadIdx.x; i < Mp * k8; i += kThreads) {
    const int r = i / k8, c8 = i - r * k8;
    *reinterpret_cast<uint4*>(sW + r * ws + c8 * 8) =
        *reinterpret_cast<const uint4*>(wk + (size_t)r * 9 * Kp + c8 * 8);
  }
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < kHalo * us; i += kThreads) sU[i] = zero;

  // warp w owns tile rows 2w, 2w+1: n8 tiles t = 4w + j (row t/2, columns
  // (t%2)*8 .. +7). ldmatrix B (x4 = two n8 tiles x two 8-channel halves):
  // lane -> matrix lane/8 -> tile 4w + 2p + (lane/8)/2, half (lane/8)%2
  int hb[kNT / 2];
#pragma unroll
  for (int p = 0; p < kNT / 2; ++p) {
    const int t = 4 * warp + 2 * p + ((lane >> 3) >> 1);
    hb[p] = ((t >> 1) + 1) * kHaloW + (t & 1) * 8 + (lane & 7) + 1;
  }
  const int chalf = ((lane >> 3) & 1) * 8;
  // A (x4 = rows 0-7 / 8-15 x k 0-7 / 8-15 of a 16x16 tile)
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
  // this lane's accumulator elements: rows g and g+8, pixels q2, q2+1
  const int g = lane >> 2, q2 = (lane & 3) * 2;

  float st[MT][2][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) st[mt][hh][0] = st[mt][hh][1] = 0.0f;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n = unit / tiles, tile = unit - n * tiles;
    const int ty0 = (tile / tiles_x) * kTH, tx0 = (tile % tiles_x) * kTW;
    const size_t in0 = (size_t)n * K * HW;
    __syncthreads();                 // the last tile's products are done
    for (int i = threadIdx.x; i < K * kHalo; i += kThreads) {
      const int c = i / kHalo, hp = i - c * kHalo;
      const int yy = hp / kHaloW, xx = hp - yy * kHaloW;
      const int gy = ty0 + yy - 1, gx = tx0 + xx - 1;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const size_t at = in0 + (size_t)c * HW + gy * w + gx;
        v = act_fwd(affine(__bfloat162float(in[at]), ka[c], kb[c]), act);
      }
      sU[hp * us + c] = __float2bfloat16(v);
    }
    __syncthreads();

    float acc[MT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
    for (int s = 0; s < 9; ++s) {
      const int off = (s / 3 - 1) * kHaloW + (s % 3 - 1);
      for (int cg = 0; cg < Kp; cg += 16) {
        unsigned bfr[kNT / 2][4];
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p)
          ldmatrix_x4(bfr[p], sU + (hb[p] + off) * us + cg + chalf);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned afr[4];
          ldmatrix_x4(afr, sW + (mt * 16 + arow) * ws + s * Kp + cg + acol);
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            mma_16816(acc[mt][j], afr, bfr[j / 2][(j & 1) * 2],
                      bfr[j / 2][(j & 1) * 2 + 1]);
        }
      }
    }

    // y to global bf16, and the channel sums
    const size_t out0 = (size_t)n * M * HW;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int t = 4 * warp + j;
      const int gy = ty0 + (t >> 1);
      const int gx = tx0 + (t & 1) * 8 + q2;
      if (gy >= h) continue;
      const bool ok0 = gx < w, ok1 = gx + 1 < w;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = mt * 16 + g + 8 * hh;
          if (m >= M) continue;
          const size_t at = out0 + (size_t)m * HW + gy * w + gx;
          // stats of the bf16 y
          const float v0 = de::round_bf16(acc[mt][j][2 * hh]);
          const float v1 = de::round_bf16(acc[mt][j][2 * hh + 1]);
          const float s0 = v0, s1 = v1, q0 = v0 * v0, q1 = v1 * v1;
          bf16* dst = out + at;
          if (ok1 && !(w & 1)) {    // even w: the pair is 4-byte aligned
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (ok0) dst[0] = __float2bfloat16(v0);
            if (ok1) dst[1] = __float2bfloat16(v1);
          }
          if (ok0) {
            st[mt][hh][0] += s0;
            st[mt][hh][1] += q0;
          }
          if (ok1) {
            st[mt][hh][0] += s1;
            st[mt][hh][1] += q1;
          }
        }
    }
  }

  // channel sums: the 4 lanes of a row, then the warps
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float v = st[mt][hh][k];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        st[mt][hh][k] = v;
      }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mt * 16 + g + 8 * hh;
        sRed[(warp * Mp + m) * 2] = st[mt][hh][0];
        sRed[(warp * Mp + m) * 2 + 1] = st[mt][hh][1];
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * M; i += kThreads) {
    const int m = i / 2, k = i % 2;
    float v = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) v += sRed[(wi * Mp + m) * 2 + k];
    partials[((size_t)m * gridDim.x + blockIdx.x) * 2 + k] = v;
  }
}

template <int MT>
cudaError_t launch_fwd(const bf16* x, const float* a, const float* b,
                       const bf16* wk, bf16* y, float* partials, float* sums,
                       int N, int C, int Cp, int F, int h, int w, int act,
                       cudaStream_t s) {
  const size_t smem = sizeof(bf16) * ((size_t)MT * 16 * (9 * Cp + 8) +
                                      (size_t)kHalo * (Cp + 8)) +
                      sizeof(float) * kWarps * MT * 16 * 2;
  auto kernel = convbn2d_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, n_sm = 0;
  err = de::blocks_per_sm(kernel, kThreads, smem, &per_sm, &n_sm);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int units = N * ((h + kTH - 1) / kTH) * tiles_x;
  const int nblk = std::min(units, std::max(per_sm, 1) * n_sm);
  kernel<<<nblk, kThreads, smem, s>>>(x, a, b, wk, y, partials, C, Cp, F, h,
                                       w, act, tiles_x, units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<F, 256, 0, s>>>(partials, sums, nblk);
  return cudaGetLastError();
}

bool bad_dims(int C, int Cp, int F, int Fp, int act) {
  return C < 1 || F < 1 || Cp % 16 || Cp < C || Cp > kMaxMT * 16 ||
         Fp % 16 || Fp < F || Fp > kMaxMT * 16 || act < kActNone ||
         act > kActLeaky;
}

// ---------------------------------------------------------------- backward
//
// Both gradients are GEMMs on the tensor cores through wgmma (wgmma.cuh),
// with the operand that needs the 3x3 shift in registers (ldmatrix from a
// halo tile: a shifted window of a 2-D tile is no core matrix) and the
// regular one in shared memory:
//   dx: M = 64 output pixels (one tile row of 16 per warp), N = Cp,
//       K = 9 Fp; A = im2col(ge) from the ge halo, B = the flipped,
//       transposed weights [9 Fp, Cp] (B[s*Fp + f][c] = W[f, c, 8 - s]),
//       read from W's own [F, C, 3, 3] layout into shared memory once per
//       block;
//   dW: conv_bwd.cuh's conv_dw_kernel with one tap (M = 9 Cp, N = Fp).

// Data gradient. ``NC`` = Cp, the wgmma N; ``NG`` = Fp / 16, the 16-channel
// groups of K per shift (both constants, so that every register operand
// of the products is known to the compiler). A block (one warpgroup) walks
// 8x16-pixel tiles in a grid-stride loop: it stages the tile's ge halo
// (10x18 pixels, Fp channels fastest) in shared memory, then per 3x3
// shift s loads the A fragments of both 4-row halves (warp w: tile rows w
// and w + 4) and issues their products; the shifts alternate two register
// sets, so the loads of shift s + 1 overlap the products of shift s. The
// epilogue masks du by act' on the f32 pre-activation of the layer's input
// x, writes dx = bf16(dv a) and adds (sum dv x, sum dv) per channel into
// the warp's own shared-memory row (a fixed order); ``partials`` [C,
// gridDim.x, 2] gets the block's sums.
template <int NC, int NG>
__global__ void __launch_bounds__(kThreads)
convbn2d_dx_kernel(const bf16* __restrict__ ge,
                   const bf16* __restrict__ wt, const bf16* __restrict__ x,
                   const float* __restrict__ a, const float* __restrict__ b,
                   bf16* __restrict__ dx, float* __restrict__ partials, int C,
                   int F, int h, int w, int act, int tiles_x, int units) {
  const int HW = h * w;
  const int tiles = ((h + kTH - 1) / kTH) * tiles_x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int Fp = NG * 16;
  const int K = 9 * Fp, us = Fp + 8;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem);                  // [K, NC]
  bf16* sU = sB + K * NC;                                     // [kHalo, us]
  float* sRed = reinterpret_cast<float*>(sU + kHalo * us);    // [4][NC][2]

  const uint4 z4 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < (K * NC + kHalo * us) / 8; i += kThreads)
    reinterpret_cast<uint4*>(sB)[i] = z4;
  for (int i = threadIdx.x; i < kWarps * NC * 2; i += kThreads) sRed[i] = 0;
  __syncthreads();
  // W [F, C, 3, 3] -> B[(8 - r) * Fp + f][c]
  const float inv_c9 = 1.0f / (C * 9);
  de::for_each_bf16(wt, F * C * 9, [&](int i, unsigned short v) {
    const int f = de::div_small(i, C * 9, inv_c9), rem = i - f * C * 9;
    const int c = rem / 9, r = rem - c * 9;
    sB[de::kmajor_off((8 - r) * Fp + f, c, NC)] = __ushort_as_bfloat16(v);
  });
  de::fence_proxy_async();

  // ldmatrix rows: pixel p of the warp's tile row, channel half ch
  const int p = (lane & 7) + ((lane >> 3) & 1) * 8, ch = (lane >> 4) * 8;
  unsigned ab[2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
    ab[t] = de::smem_addr(sU + ((warp + 4 * t) * kHaloW + p) * us + ch);
  const int g = lane >> 2, q2 = (lane & 3) * 2;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n = unit / tiles, tile = unit - n * tiles;
    const int ty0 = (tile / tiles_x) * kTH, tx0 = (tile % tiles_x) * kTW;
    const size_t g0 = (size_t)n * F * HW;
    __syncthreads();                 // the last tile's loads are done
    de::stage_halo<kTH>(sU, us, F, h, w, HW, ty0, tx0, ge + g0);
    __syncthreads();

    float acc[2][NC / 2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < NC / 2; ++e) acc[t][e] = 0.0f;
    unsigned af[2][2][NG][4];        // [register set][tile half][group]
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int set = s & 1;
      const unsigned off =
          (unsigned)(((s / 3) * kHaloW + s % 3) * us * sizeof(bf16));
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int cg = 0; cg < NG; ++cg)
          de::ldmatrix_x4_addr(af[set][t][cg], ab[t] + off + cg * 32);
      de::wg_fence();
#pragma unroll
      for (int cg = 0; cg < NG; ++cg) {
        const uint64_t desc = de::kmajor_desc(sB, s * NG + cg, NC);
#pragma unroll
        for (int t = 0; t < 2; ++t)
          de::Wgmma<NC>::mma(acc[t], af[set][t][cg], desc);
      }
      de::wg_commit();
      de::wg_wait<1>();              // the other register set is free
    }
    de::wg_wait<0>();

    // epilogue: element e of n8 group j is pixel g (+8 for e >= 2) of the
    // warp's tile row, channel 8j + q2 (+1 for odd e)
    const size_t x0 = (size_t)n * C * HW;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int c = 8 * j + q2 + e1;
        const float ac = c < C ? a[c] : 0.0f, bc = c < C ? b[c] : 0.0f;
        float sx = 0.0f, sd = 0.0f;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int py = ty0 + warp + 4 * t, px = tx0 + g + 8 * hh;
            if (c >= C || py >= h || px >= w) continue;
            const size_t at = x0 + (size_t)c * HW + py * w + px;
            const float xv = __bfloat162float(x[at]);
            const float dv =
                act_bwd(acc[t][4 * j + 2 * hh + e1], affine(xv, ac, bc), act);
            dx[at] = __float2bfloat16(dv * ac);
            sx += dv * xv;
            sd += dv;
          }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sx += __shfl_xor_sync(0xffffffffu, sx, o);
          sd += __shfl_xor_sync(0xffffffffu, sd, o);
        }
        if (g == 0) {
          sRed[(warp * NC + c) * 2] += sx;
          sRed[(warp * NC + c) * 2 + 1] += sd;
        }
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    const int c = i / 2, k = i % 2;
    float v = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) v += sRed[(wi * NC + c) * 2 + k];
    partials[((size_t)c * gridDim.x + blockIdx.x) * 2 + k] = v;
  }
}

template <int NC, int NG>
cudaError_t launch_dx(const bf16* ge, const bf16* wt, const bf16* x,
                      const float* a, const float* b, bf16* dx,
                      float* partials, float* dab, int cap, int N, int C,
                      int F, int h, int w, int act, cudaStream_t s) {
  const size_t smem = sizeof(bf16) * ((size_t)9 * NG * 16 * NC +
                                      (size_t)kHalo * (NG * 16 + 8)) +
                      sizeof(float) * kWarps * NC * 2;
  auto kernel = convbn2d_dx_kernel<NC, NG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, n_sm = 0;
  err = de::blocks_per_sm(kernel, kThreads, smem, &per_sm, &n_sm);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int units = N * ((h + kTH - 1) / kTH) * tiles_x;
  const int nblk = std::min({units, std::max(per_sm, 1) * n_sm, cap});
  kernel<<<nblk, kThreads, smem, s>>>(ge, wt, x, a, b, dx, partials, C, F, h,
                                       w, act, tiles_x, units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<C, 256, 0, s>>>(partials, dab, nblk);
  return cudaGetLastError();
}

// the data gradient at Cp = NC, Fp chosen at run time
template <int NC>
cudaError_t dispatch_dx(int Fp, const bf16* ge, const bf16* wt, const bf16* x,
                        const float* a, const float* b, bf16* dx,
                        float* partials, float* dab, int cap, int N, int C,
                        int F, int h, int w, int act, cudaStream_t s) {
#define DE_DX(fp)                                                            \
  launch_dx<NC, fp / 16>(ge, wt, x, a, b, dx, partials, dab, cap, N, C, F,   \
                         h, w, act, s)
  DE_SWITCH16(Fp, DE_DX)
#undef DE_DX
}

}  // namespace

// The forward: x [N, C, h*w] bf16; wk [Fp, 9*Cp] bf16 packed weights (K
// index s*Cp + c, s = kh*3 + kw, zero padded); a, b [C] f32; act 0 none,
// 1 relu, 2 leaky; y [N, F, h*w] bf16; stats [F, 2] f32; partials [F, cap,
// 2] f32 scratch with cap >= N * ceil(h/8) * ceil(w/16). All contiguous.
// C, F <= 80.
extern "C" int convbn2d_fwd(const void* x, const void* wk, const void* a,
                            const void* b, void* y, void* stats,
                            void* partials, int N, int C, int Cp, int F,
                            int Fp, int h, int w, int act, void* stream) {
  if (bad_dims(C, Cp, F, Fp, act) || N < 1 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
#define DE_FWD(fp)                                                           \
  launch_fwd<fp / 16>((const bf16*)x, (const float*)a, (const float*)b,      \
                      (const bf16*)wk, (bf16*)y, (float*)partials,           \
                      (float*)stats, N, C, Cp, F, h, w, act,                 \
                      (cudaStream_t)stream)
  DE_SWITCH16(Fp, DE_FWD)
#undef DE_FWD
}

// The backward of convbn2d_fwd (convbn2d_pallas.py:_bwd_kernel and
// _xla_seam_dw), in six launches on ``stream``: the fold of the
// statistics' cotangent into ge [N, F, hw] (scratch, bf16); the data
// gradient (convbn2d_dx_kernel) into dx and per-block (da, db) sums in
// ab_partials [C, cap, 2], which stats_reduce_kernel adds into dab [C, 2];
// the normalized input, channels fastest, into u [N, hw, Cp] (scratch,
// bf16); the weight gradient (conv_bwd.cuh's conv_dw_kernel with one tap)
// on (dw_blocks, nsplit) blocks of 128 * wgs threads (nsplit * wgs >=
// ceil(9 Cp / 64)) into dw_partials [dw_blocks, 9 Cp, Fp], which its
// second pass adds into dw [F, C, 3, 3]. x [N, C, hw], y, gy [N, F, hw],
// w [F, C, 3, 3] bf16; a, b [C], gstats [F, 2] f32; dx [N, C, hw] bf16.
// All contiguous. C, F <= 80.
extern "C" int convbn2d_bwd(const void* x, const void* w, const void* a,
                            const void* b, const void* y, const void* gy,
                            const void* gstats, void* ge, void* u, void* dx,
                            void* dab, void* ab_partials, void* dw,
                            void* dw_partials, int N, int C, int F, int h,
                            int wd, int act,
                            int cap, int dw_blocks, int nsplit, int wgs,
                            void* stream) {
  const int Cp = de::round16(C), Fp = de::round16(F);
  if (bad_dims(C, Cp, F, Fp, act) || N < 1 || h < 1 || wd < 1 || cap < 1 ||
      dw_blocks < 1 || nsplit < 1 || wgs < 1 || wgs > de::kDwMaxWgs ||
      nsplit * wgs * 64 < 9 * Cp)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      de::launch_ge_fold((const bf16*)gy, (const bf16*)y,
                         (const float*)gstats, (bf16*)ge, N, F, h * wd, s);
  if (err != cudaSuccess) return err;
#define DE_DX(nc)                                                            \
  dispatch_dx<nc>(Fp, (const bf16*)ge, (const bf16*)w, (const bf16*)x,       \
                  (const float*)a, (const float*)b, (bf16*)dx,               \
                  (float*)ab_partials, (float*)dab, cap, N, C, F, h, wd,     \
                  act, s)
  err = [&]() -> cudaError_t { DE_SWITCH16(Cp, DE_DX) }();
#undef DE_DX
  if (err != cudaSuccess) return err;
  err = de::launch_conv_dw_input((const bf16*)x, (const float*)a,
                                 (const float*)b, (bf16*)u, N, C, Cp, h * wd,
                                 act, s);
  if (err != cudaSuccess) return err;
  const de::DwArgs p{(const bf16*)ge, (const bf16*)u, N, C, Cp, F, 1, 1, h,
                     wd};
#define DE_DW(np)                                                            \
  de::launch_conv_dw<np>(p, (float*)dw_partials, (float*)dw, dw_blocks,      \
                         nsplit, wgs, s)
  DE_SWITCH16(Fp, DE_DW)
#undef DE_DW
}
