// Fused Base3D conv block, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels depthestimation_tpu/ops/convcomb_pallas.py:
// _fwd_kernel (launched by _fwd_call) and _bwd_kernel (launched by
// _bwd_call), the two halves of the custom VJP of convbn_block. One layer of
// the Base3D stack over the depth-major flat volume x [N = B*D, C, H*W]
// (PyTorch's contiguous NCHW of [B*D, C, H, W]):
//
//   u       = bf16(relu?(x * a + b))             normalize on load, in f32
//   t_k(m)  = bf16(W_k (*) u(m))                 3x3 conv, tap k = 0, 1, 2
//   y(n)    = bf16(bf16(t_1(n) + t_0(n-1)[n%D>0]) + t_2(n+1)[n%D<D-1])
//   stats   = (sum y, sum y^2) per output channel, f32, over all rows/pixels
//
// with the TPU kernel's rounding points (convcomb_pallas.py:85-93, 113-132)
// and zero padding of u at the image border (_shift_hw).
//
// What bounds it on the H100: tensor-core work of 2 * 3F * 9C * H*W FLOPs
// per row (the bf16 products), against the bytes of x and y: about 290
// FLOP/byte at C = F = 32, near the card's bf16 balance point, so neither
// HBM nor the tensor cores bound a simple kernel; its own instruction
// overhead does: building the conv's input operand (gather, normalize,
// round) and feeding the tensor cores.
//
// What the design does about it: a block owns a 4x16-pixel image tile of
// one item's depth segment of up to ``seg`` output rows and streams the
// input rows the segment needs (one halo row each side) in depth order,
// the TPU kernel's ring on a short segment. Each input row is normalized
// once into a 6x18-pixel halo tile in shared memory, channels fastest;
// the conv is an implicit GEMM on it: for each 3x3 shift and 16-channel
// group, ldmatrix reads the mma.sync m16n8k16 B fragments straight from
// the shifted halo pixels, and the three taps' weights [3F, 9C] sit in
// shared memory for the whole block. The depth combine runs on the f32
// accumulator fragments in registers (the running part(m) and the
// previous row's t0), so the [N, 3F, H*W] tap tensor never exists and
// each (tap, row) product is computed once. Per-block channel sums go to
// a partials buffer that a second small kernel reduces, so the stats are
// deterministic. TMA and wgmma are later work.
//
// Backward (convcomb_bwd). With ge = bf16(gy + s0 + 2 y s1) folding the
// statistics' cotangent (s0, s1) into the output cotangent gy, the taps'
// cotangents are g_0(n) = ge(n+1) [n%D < D-1], g_1(n) = ge(n) and
// g_2(n) = ge(n-1) [n%D > 0] (the forward's taps swapped), and
//   du(n) = sum_t (transposed 3x3 conv of g_t(n) with tap t's weights)
//   dv    = du [v > 0] on the f32 pre-activation v = x a + b (with ReLU)
//   dx    = bf16(dv a),  da = sum dv x,  db = sum dv
//   dW    = sum over rows and pixels of g_taps(n) u9(n)^T
// with u9 rebuilt from the saved bf16 x (convcomb_pallas.py:178-256).
// du(n) = P_1(n) + P_2(n-1) [n%D>0] + P_0(n+1) [n%D<D-1], P_t(m) being
// tap t's transposed conv of ge(m): the forward's ring with the taps in
// reverse order. Bound: at C = F = 32, N = 512, 64x96 the two GEMMs are
// 348 GFLOP, 0.352 ms on the tensor cores, above the bytes of x, y, gy and
// dx. Both run on wgmma (wgmma.cuh), the operand that needs the 3x3 shift
// in registers (ldmatrix from the halo tile), the regular one in shared
// memory:
//   dx: convcomb_dx_kernel, the forward's ring over a depth segment with
//       M = 64 pixels, N = Cp, K = 9 Fp for each of the three taps (B =
//       the taps' flipped, transposed weights, read from wm's own layout
//       once per block), the ring summed in f32;
//   dW: conv_bwd.cuh's conv_dw_kernel with three taps, M = 9 Cp (row
//       s*Cp + c), N = 3F padded to 16 (the stacked taps, masked at the
//       depth edges), K = every pixel of every row, 128 pixels between
//       barriers; its second pass writes wm's [3F, C, 3, 3].
// ge is written once by a fold pass (conv_bwd.cuh), which measured
// cheaper than folding it on load: the weight gradient reads each ge row
// three times and both gradients stage it.
// Partial sums per block, added in a fixed order: no atomics, so the
// gradients repeat bit for bit.

#include <algorithm>

#include "common.cuh"
#include "conv_bwd.cuh"
#include "reduce.cuh"
#include "wgmma.cuh"

using de::bf16;
using de::ldmatrix_x4;
using de::mma_16816;
using de::stats_reduce_kernel;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 4, kTW = 16;           // output tile: 4 rows x 16 cols
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;  // 108 halo pixels
constexpr int kNT = 4;                     // n8 pixel tiles per warp (max)
constexpr int kMaxF = 32;                  // two 16-channel row tiles

// The forward layer (x -> y, stats): the ring over the segment's input
// rows, each normalized once into the halo tile.
__global__ void __launch_bounds__(kThreads)
convcomb_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                const float* __restrict__ a, const float* __restrict__ b,
                bf16* __restrict__ y,
                float* __restrict__ partials, int C, int Cp, int F, int Fp,
                int depth, int h, int w, int relu, int seg, int nseg,
                int tiles_x) {
  const int HW = h * w;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int item = blockIdx.y / nseg;
  const int d0 = (blockIdx.y % nseg) * seg;
  const int d1 = min(d0 + seg, depth);
  const int nblk = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Kp = 9 * Cp;
  const int ws = Kp + 8, us = Cp + 8;      // row strides: +16 B, no conflicts

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);                  // [3 * Fp, ws]
  bf16* sU = sW + 3 * Fp * ws;                                // [kHalo, us]
  float* sRed = reinterpret_cast<float*>(sU + kHalo * us);    // [warp,16,2]

  // the three taps' weights, K index s*Cp + c (s = kh*3 + kw), once
  const int k8 = Kp / 8;
  for (int i = threadIdx.x; i < 3 * Fp * k8; i += kThreads) {
    const int r = i / k8, c8 = i - r * k8;
    *reinterpret_cast<uint4*>(sW + r * ws + c8 * 8) =
        *reinterpret_cast<const uint4*>(wk + (size_t)r * Kp + c8 * 8);
  }
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < kHalo * us; i += kThreads) sU[i] = zero;

  // warp tiling: all three taps of one 16-channel row tile ft and nt n8
  // pixel tiles (n8 tile t = image row t/2 of the tile, columns
  // (t%2)*8 .. +7)
  const bool two_ft = Fp == 32;
  const int ft = two_ft ? warp >> 1 : 0;
  const int nt = two_ft ? 4 : 2;
  const int n0 = two_ft ? (warp & 1) * 4 : warp * 2;
  // ldmatrix row addresses. B (x4 = two n8 tiles x two 8-channel halves):
  // lane -> matrix lane/8 -> tile n0 + 2p + (lane/8)/2, half (lane/8)%2
  int hb[kNT / 2];
#pragma unroll
  for (int p = 0; p < kNT / 2; ++p) {
    const int t = n0 + 2 * p + ((lane >> 3) >> 1);
    hb[p] = ((t >> 1) + 1) * kHaloW + (t & 1) * 8 + (lane & 7) + 1;
  }
  const int chalf = ((lane >> 3) & 1) * 8;
  // A (x4 = rows 0-7 / 8-15 x k 0-7 / 8-15 of a 16x16 tile)
  const int arow = ft * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
  // this lane's accumulator elements: rows g and g+8, pixels q2, q2+1
  const int g = lane >> 2, q2 = (lane & 3) * 2;

  float part[kNT][4], t0p[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = t0p[j][e] = 0.0f;
  float st[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [row half][sum, sumsq]

  // row r's y from this lane's fragments -> global bf16, and the channel
  // sums
  auto emit = [&](int r, const float (&v)[kNT][4]) {
    const size_t row = (size_t)item * depth + r;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nt) continue;
      const int t = n0 + j;
      const int gy = ty0 + (t >> 1);
      const int gx = tx0 + (t & 1) * 8 + q2;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int f = ft * 16 + g + 8 * hh;
        if (f >= F || gy >= h) continue;
        const size_t at = (row * F + f) * HW + (size_t)gy * w + gx;
        const bool ok0 = gx < w, ok1 = gx + 1 < w;
        const float v0 = v[j][2 * hh], v1 = v[j][2 * hh + 1];
        const float s0 = v0, s1 = v1, q0 = v0 * v0, q1 = v1 * v1;
        bf16* dst = y + at;
        if (ok1 && !(w & 1)) {      // even w: the pair is 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (ok0) dst[0] = __float2bfloat16(v0);
          if (ok1) dst[1] = __float2bfloat16(v1);
        }
        if (ok0) {
          st[hh][0] += s0;
          st[hh][1] += q0;
        }
        if (ok1) {
          st[hh][0] += s1;
          st[hh][1] += q1;
        }
      }
    }
  };

  const int m_begin = d0 > 0 ? d0 - 1 : 0;
  const int m_end = d1 < depth ? d1 : depth - 1;
  for (int m = m_begin; m <= m_end; ++m) {
    const bf16* xm = x + ((size_t)item * depth + m) * C * HW;
    __syncthreads();                 // the last products are done with sU
    for (int i = threadIdx.x; i < C * kHalo; i += kThreads) {
      const int c = i / kHalo, hp = i - c * kHalo;
      const int yy = hp / kHaloW, xx = hp - yy * kHaloW;
      const int gy = ty0 + yy - 1, gx = tx0 + xx - 1;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        v = __bfloat162float(xm[(size_t)c * HW + gy * w + gx]) * a[c] + b[c];
        if (relu) v = fmaxf(v, 0.0f);
      }
      sU[hp * us + c] = __float2bfloat16(v);
    }
    __syncthreads();

    float acc[3][kNT][4];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.0f;
    for (int s = 0; s < 9; ++s) {
      const int off = (s / 3 - 1) * kHaloW + (s % 3 - 1);
      for (int cg = 0; cg < Cp; cg += 16) {
        unsigned bfr[kNT / 2][4];
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p)
          if (2 * p < nt)
            ldmatrix_x4(bfr[p], sU + (hb[p] + off) * us + cg + chalf);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          unsigned afr[4];
          ldmatrix_x4(afr, sW + (t * Fp + arow) * ws + s * Cp + cg + acol);
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            if (j < nt)
              mma_16816(acc[t][j], afr, bfr[j / 2][(j & 1) * 2],
                        bfr[j / 2][(j & 1) * 2 + 1]);
        }
      }
    }

    // the TPU kernel's ring, in its rounding order (all three taps share
    // the accumulator layout, so the combine is elementwise):
    //   y(m-1)  = bf16(part(m-1) + bf16(t2(m)))
    //   part(m) = bf16(bf16(t1(m)) + bf16(t0(m-1)))   [t0 term iff m > 0]
    auto rnd = [](float v) { return de::round_bf16(v); };
    const bool out = m - 1 >= d0 && m - 1 < d1;
    const bool in = m >= d0 && m < d1;
    float yv[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yv[j][e] = rnd(part[j][e] + rnd(acc[2][j][e]));
        if (in) {
          const float t1 = rnd(acc[1][j][e]);
          part[j][e] = m > 0 ? rnd(t1 + t0p[j][e]) : t1;
        }
        t0p[j][e] = rnd(acc[0][j][e]);
      }
    if (out) emit(m - 1, yv);
  }
  if (d1 == depth) emit(depth - 1, part);   // the top row: no upper tap

  // channel sums: the 4 lanes of a row, then the warps of a row tile
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float v = st[hh][k];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      st[hh][k] = v;
    }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sRed[(warp * 16 + g + 8 * hh) * 2] = st[hh][0];
      sRed[(warp * 16 + g + 8 * hh) * 2 + 1] = st[hh][1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * F; i += kThreads) {
    const int f = i / 2, k = i % 2;
    float v = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi)
      if ((two_ft ? wi >> 1 : 0) == f / 16)
        v += sRed[(wi * 16 + f % 16) * 2 + k];
    partials[((size_t)f * nblk + bid) * 2 + k] = v;
  }
}

// Data gradient. ``NC`` = Cp, the wgmma N; ``NG`` = Fp / 16 (both
// constants, so that every register operand of the products is known to
// the compiler). The forward's ring over a
// depth segment, one warpgroup a block: per input row m the block stages
// ge(m)'s 6x18-pixel halo in shared memory (Fp channels fastest), then
// per 3x3 shift s loads the A fragments (warp w: tile row w, 16 pixels)
// and issues the three taps' products into acc[q] (slot q = tap 2 - q, B
// = the taps' flipped, transposed weights [9 Fp, Cp], read from wm's
// [3F, C, 3, 3] once per block); the shifts alternate two register sets,
// so the loads of shift s + 1 overlap the products of shift s. The ring
// sums the taps in f32, and the epilogue writes dx = bf16(dv a) with
// dv = du [v > 0] on the f32 pre-activation of x, and per-block (sum dv x,
// sum dv) into ``partials`` [C, nblk, 2].
template <int NC, int NG>
__global__ void __launch_bounds__(kThreads)
convcomb_dx_kernel(const bf16* __restrict__ ge,
                   const bf16* __restrict__ wm, const bf16* __restrict__ x,
                   const float* __restrict__ a, const float* __restrict__ b,
                   bf16* __restrict__ dx, float* __restrict__ partials,
                   int C, int F, int depth, int h, int w, int relu, int seg,
                   int nseg, int tiles_x) {
  constexpr int Fp = NG * 16;
  const int HW = h * w;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int item = blockIdx.y / nseg;
  const int d0 = (blockIdx.y % nseg) * seg;
  const int d1 = min(d0 + seg, depth);
  const int nblk = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = 9 * Fp, us = Fp + 8;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem);                  // [3][K, NC]
  bf16* sU = sB + 3 * K * NC;                                 // [kHalo, us]
  float* sRed = reinterpret_cast<float*>(sU + kHalo * us);    // [4][NC][2]

  const uint4 z4 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < (3 * K * NC + kHalo * us) / 8; i += kThreads)
    reinterpret_cast<uint4*>(sB)[i] = z4;
  __syncthreads();
  // wm [3F, C, 3, 3], row t*F + f -> slot 2 - t, B[(8 - r) * Fp + f][c]
  const float inv_c9 = 1.0f / (C * 9), inv_f = 1.0f / F;
  de::for_each_bf16(wm, 3 * F * C * 9, [&](int i, unsigned short v) {
    const int tf = de::div_small(i, C * 9, inv_c9), rem = i - tf * C * 9;
    const int c = rem / 9, r = rem - c * 9;
    const int t = de::div_small(tf, F, inv_f), f = tf - t * F;
    sB[(2 - t) * K * NC + de::kmajor_off((8 - r) * Fp + f, c, NC)] =
        __ushort_as_bfloat16(v);
  });
  de::fence_proxy_async();

  // ldmatrix rows: pixel p of the warp's tile row, channel half ch
  const int p = (lane & 7) + ((lane >> 3) & 1) * 8, ch = (lane >> 4) * 8;
  const unsigned ab = de::smem_addr(sU + (warp * kHaloW + p) * us + ch);
  const int g = lane >> 2, q2 = (lane & 3) * 2;

  float part[NC / 2], t0p[NC / 2], st[NC / 8][2][2];
#pragma unroll
  for (int e = 0; e < NC / 2; ++e) part[e] = t0p[e] = 0.0f;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) st[j][e][0] = st[j][e][1] = 0.0f;

  // row r's du -> dx, and the (da, db) sums; element e of n8 group j is
  // pixel g (+8 for e >= 2) of the warp's tile row, channel 8j + q2 (+1
  // for odd e)
  auto emit = [&](int r, const float (&v)[NC / 2]) {
    const size_t row = (size_t)item * depth + r;
    const int py = ty0 + warp;
    if (py >= h) return;
    float xv[NC / 8][4];             // the loads first, in flight together
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + q2 + (e & 1), px = tx0 + g + (e >> 1) * 8;
        xv[j][e] = c < C && px < w
                       ? __bfloat162float(x[(row * C + c) * HW + py * w + px])
                       : 0.0f;
      }
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + q2 + (e & 1), px = tx0 + g + (e >> 1) * 8;
        if (c >= C || px >= w) continue;
        // the mask on the f32 pre-activation, unfused as in the TPU kernel
        // and the plain version
        const float dv = relu && !(de::affine(xv[j][e], a[c], b[c]) > 0.0f)
                             ? 0.0f
                             : v[4 * j + e];
        dx[(row * C + c) * HW + py * w + px] = __float2bfloat16(dv * a[c]);
        st[j][e & 1][0] += dv * xv[j][e];
        st[j][e & 1][1] += dv;
      }
  };

  const int m_begin = d0 > 0 ? d0 - 1 : 0;
  const int m_end = d1 < depth ? d1 : depth - 1;
  for (int m = m_begin; m <= m_end; ++m) {
    const size_t g0 = ((size_t)item * depth + m) * F * HW;
    __syncthreads();                 // the last row's loads are done
    de::stage_halo<kTH>(sU, us, F, h, w, HW, ty0, tx0, ge + g0);
    __syncthreads();

    float acc[3][NC / 2];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < NC / 2; ++e) acc[q][e] = 0.0f;
    unsigned af[2][NG][4];           // [register set][group]
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int set = s & 1;
      const unsigned off =
          ab + (unsigned)(((s / 3) * kHaloW + s % 3) * us * sizeof(bf16));
#pragma unroll
      for (int cg = 0; cg < NG; ++cg)
        de::ldmatrix_x4_addr(af[set][cg], off + cg * 32);
      de::wg_fence();
#pragma unroll
      for (int cg = 0; cg < NG; ++cg) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          de::Wgmma<NC>::mma(acc[q], af[set][cg],
                             de::kmajor_desc(sB + q * K * NC, s * NG + cg,
                                             NC));
      }
      de::wg_commit();
      de::wg_wait<1>();              // the other register set is free
    }
    de::wg_wait<0>();

    // the ring in f32: du(m-1) = part(m-1) + P_0(m), part(m) = P_1(m) +
    // P_2(m-1) [m > 0]; acc[q] = P_{2-q}(m)
    const bool out = m - 1 >= d0 && m - 1 < d1;
    const bool in = m >= d0 && m < d1;
    float du[NC / 2];
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) {
      du[e] = part[e] + acc[2][e];
      if (in) part[e] = m > 0 ? acc[1][e] + t0p[e] : acc[1][e];
      t0p[e] = acc[0][e];
    }
    if (out) emit(m - 1, du);
  }
  if (d1 == depth) emit(depth - 1, part);   // the top row: no upper tap

  // (da, db): the 8 lanes of a channel, then the warps in order
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float v = st[j][e][k];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (g == 0) sRed[(warp * NC + 8 * j + q2 + e) * 2 + k] = v;
      }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    const int c = i / 2, k = i % 2;
    float v = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) v += sRed[(wi * NC + c) * 2 + k];
    partials[((size_t)c * nblk + bid) * 2 + k] = v;
  }
}

template <int NC, int NG>
cudaError_t launch_dx(const bf16* ge, const bf16* wm, const bf16* x,
                      const float* a, const float* b, bf16* dx,
                      float* partials, float* dab, int N, int C, int F,
                      int depth, int h, int w, int relu, int seg,
                      cudaStream_t s) {
  const size_t smem = sizeof(bf16) * ((size_t)3 * 9 * NG * 16 * NC +
                                      (size_t)kHalo * (NG * 16 + 8)) +
                      sizeof(float) * kWarps * NC * 2;
  cudaError_t err = cudaFuncSetAttribute(
      convcomb_dx_kernel<NC, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles = ((h + kTH - 1) / kTH) * tiles_x;
  const int nseg = (depth + seg - 1) / seg;
  dim3 grid(tiles, (N / depth) * nseg);
  convcomb_dx_kernel<NC, NG><<<grid, kThreads, smem, s>>>(
      ge, wm, x, a, b, dx, partials, C, F, depth, h, w, relu, seg, nseg,
      tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<C, 256, 0, s>>>(partials, dab, grid.x * grid.y);
  return cudaGetLastError();
}

}  // namespace

// x [N, C, h*w] bf16; wk [3, Fp, 9*Cp] bf16 packed taps (K index s*Cp + c,
// s = kh*3 + kw, zero padded); a, b [C] f32; y [N, F, h*w] bf16; stats
// [F, 2] f32; partials [F, ceil(h/4) * ceil(w/16) * (N / depth) *
// ceil(depth / seg), 2] f32 scratch. All contiguous. ``seg``: output rows
// per block.
extern "C" int convcomb_fwd(const void* x, const void* wk, const void* a,
                            const void* b, void* y, void* stats,
                            void* partials, int N, int C, int Cp, int F,
                            int Fp, int depth, int h, int w, int relu,
                            int seg, void* stream) {
  if (F > kMaxF || (Fp != 16 && Fp != 32) || Fp < F || Cp % 16 ||
      Cp < C || N % depth || seg < 1)
    return cudaErrorInvalidValue;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles = ((h + kTH - 1) / kTH) * tiles_x;
  const int nseg = (depth + seg - 1) / seg;
  const size_t smem = sizeof(bf16) * ((size_t)3 * Fp * (9 * Cp + 8) +
                                      (size_t)kHalo * (Cp + 8)) +
                      sizeof(float) * kWarps * 16 * 2;
  cudaError_t err = cudaFuncSetAttribute(
      convcomb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(tiles, (N / depth) * nseg);
  convcomb_kernel<<<grid, kThreads, smem, s>>>(
      (const bf16*)x, (const bf16*)wk, (const float*)a, (const float*)b,
      (bf16*)y, (float*)partials, C, Cp, F, Fp, depth, h, w, relu,
      seg, nseg, tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<F, 256, 0, s>>>((const float*)partials,
                                         (float*)stats, grid.x * grid.y);
  return cudaGetLastError();
}

// The backward of convcomb_fwd (convcomb_pallas.py:_bwd_kernel), in six
// launches on ``stream``: the fold of the statistics' cotangent into ge
// [N, F, hw] (scratch, bf16); the data gradient (convcomb_dx_kernel, the
// grid of the forward's ring with ``seg`` rows a block) into dx and
// per-block (da, db) sums in ab_partials [C, nblk, 2], which
// stats_reduce_kernel adds into dab [C, 2]; the normalized input, channels
// fastest, into u [N, hw, Cp] (scratch, bf16); the weight gradient
// (conv_bwd.cuh's conv_dw_kernel with three taps) on (dw_blocks, nsplit)
// blocks of 128 * wgs threads (nsplit * wgs >= ceil(9 Cp / 64)) into
// dw_partials [dw_blocks, 9 Cp, round16(3F)], which its second pass adds
// into dw [3F, C, 3, 3]. x [N, C, hw], y, gy [N, F, hw], wm [3F, C, 3, 3]
// bf16; a, b [C], gstats [F, 2] f32; dx [N, C, hw] bf16. All contiguous.
// C, F <= 32.
extern "C" int convcomb_bwd(const void* x, const void* wm, const void* a,
                            const void* b, const void* y, const void* gy,
                            const void* gstats, void* ge, void* u, void* dx,
                            void* dab, void* ab_partials, void* dw,
                            void* dw_partials, int N, int C, int F, int depth,
                            int h, int w,
                            int relu, int seg, int dw_blocks, int nsplit,
                            int wgs, void* stream) {
  const int Cp = de::round16(C), Fp = de::round16(F), Np = de::round16(3 * F);
  if (C < 1 || F < 1 || C > kMaxF || F > kMaxF || N < 1 || N % depth ||
      h < 1 || w < 1 || seg < 1 || dw_blocks < 1 || nsplit < 1 || wgs < 1 ||
      wgs > de::kDwMaxWgs || nsplit * wgs * 64 < 9 * Cp)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      de::launch_ge_fold((const bf16*)gy, (const bf16*)y,
                         (const float*)gstats, (bf16*)ge, N, F, h * w, s);
  if (err != cudaSuccess) return err;
  const bf16* ge_ = (const bf16*)ge;
  auto dx_at = [&](auto kernel_launch) {
    return kernel_launch(ge_, (const bf16*)wm, (const bf16*)x,
                         (const float*)a, (const float*)b, (bf16*)dx,
                         (float*)ab_partials, (float*)dab, N, C, F, depth, h,
                         w, relu, seg, s);
  };
  err = Cp == 16 ? (Fp == 16 ? dx_at(launch_dx<16, 1>)
                             : dx_at(launch_dx<16, 2>))
                 : (Fp == 16 ? dx_at(launch_dx<32, 1>)
                             : dx_at(launch_dx<32, 2>));
  if (err != cudaSuccess) return err;
  err = de::launch_conv_dw_input((const bf16*)x, (const float*)a,
                                 (const float*)b, (bf16*)u, N, C, Cp, h * w,
                                 relu ? de::kActRelu : de::kActNone, s);
  if (err != cudaSuccess) return err;
  const de::DwArgs p{ge_, (const bf16*)u, N, C, Cp, F, 3, depth, h, w};
#define DE_DW(np)                                                            \
  de::launch_conv_dw<np>(p, (float*)dw_partials, (float*)dw, dw_blocks,      \
                         nsplit, wgs, s)
  if (Np == 96) return DE_DW(96);
  DE_SWITCH16(Np, DE_DW)
#undef DE_DW
}
