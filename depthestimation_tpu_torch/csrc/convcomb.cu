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
// reverse order. So the data gradient is this file's forward kernel
// instantiated with kBwd: ge in place of x (no normalize), the flipped,
// transposed weights, the ring in f32, and an epilogue that writes dx and
// per-block (da, db) sums. The weight gradient is a GEMM of M = 3F,
// N = 9C over K = B*D*H*W (3.1 M at the flagship B=8): tensor-core work
// of 2 * 3F * 9C per pixel and row against a few bytes per pixel, so it
// is bound by building its operands and feeding mma.sync; one block per
// SM keeps its share of the [3F, 9C] sums in registers across a grid-
// stride walk over (row, tile) units and writes one partial, and a second
// pass adds the partials in a fixed order (no atomics, so the gradients
// are the same from run to run).

#include <algorithm>

#include "common.cuh"
#include "reduce.cuh"

using de::bf16;
using de::dw_reduce_kernel;
using de::ldmatrix_x4;
using de::ldmatrix_x4_trans;
using de::mma_16816;
using de::smem_addr;
using de::stats_reduce_kernel;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 4, kTW = 16;           // output tile: 4 rows x 16 cols
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;  // 108 halo pixels
constexpr int kNT = 4;                     // n8 pixel tiles per warp (max)
constexpr int kMaxF = 32;                  // two 16-channel row tiles

// kBwd = false: the forward layer (x -> y, stats). kBwd = true: its data
// gradient (see convcomb_bwd): x is then the folded cotangent ge [N, C, HW]
// (C = the layer's F), loaded as it is; the three weight slots hold the
// flipped, transposed taps in reverse order; the ring adds in f32 without
// rounding; and the epilogue turns du into dx = bf16(dv * a) with
// dv = du * [v > 0] on the f32 pre-activation v = xo * a + b of the
// layer's input xo, summing (dv * xo, dv) per channel into ``partials``.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads)
convcomb_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                const float* __restrict__ a, const float* __restrict__ b,
                const bf16* __restrict__ xo, bf16* __restrict__ y,
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

  // row r's values (y, or du for kBwd) from this lane's fragments ->
  // global bf16 (y, or dx), and the channel sums
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
        float v0 = v[j][2 * hh], v1 = v[j][2 * hh + 1];
        float s0 = v0, s1 = v1, q0 = v0 * v0, q1 = v1 * v1;
        if constexpr (kBwd) {
          const float x0 = ok0 ? __bfloat162float(xo[at]) : 0.0f;
          const float x1 = ok1 ? __bfloat162float(xo[at + 1]) : 0.0f;
          // the mask on the f32 pre-activation, unfused as in the TPU
          // kernel and the plain version
          if (relu && !(__fadd_rn(__fmul_rn(x0, a[f]), b[f]) > 0.0f))
            v0 = 0.0f;
          if (relu && !(__fadd_rn(__fmul_rn(x1, a[f]), b[f]) > 0.0f))
            v1 = 0.0f;
          s0 = v0 * x0;                      // (da, db) terms
          s1 = v1 * x1;
          q0 = v0;
          q1 = v1;
          v0 *= a[f];                        // dx = dv * a
          v1 *= a[f];
        }
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
        v = __bfloat162float(xm[(size_t)c * HW + gy * w + gx]);
        if constexpr (!kBwd) {
          v = v * a[c] + b[c];
          if (relu) v = fmaxf(v, 0.0f);
        }
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
    // The backward's du ring is the same sum in f32 (no rounding).
    auto rnd = [](float v) { return kBwd ? v : de::round_bf16(v); };
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

// ge = bf16(gy + s0 + 2 * y * s1) with (s0, s1) = gstats[f]: the output
// cotangent with the statistics' cotangent folded in
// (convcomb_pallas.py:201-205).
__global__ void __launch_bounds__(256)
ge_fold_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
               const float* __restrict__ gstats, bf16* __restrict__ ge, int F,
               int HW, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int f = (int)((i / HW) % F);
    const float v = __fadd_rn(__bfloat162float(gy[i]) + gstats[2 * f],
                              2.0f * __bfloat162float(y[i]) * gstats[2 * f + 1]);
    ge[i] = __float2bfloat16(v);
  }
}

constexpr int kDwThreads = 512;
constexpr int kDwWarps = kDwThreads / 32;
constexpr int kDwPairs = 7;     // (m16, n16) output tiles per warp, at most

// Weight gradient, per-block partial sums:
//   dW[t*F + f, s*Cp + c] = sum over rows n and pixels p of
//                           g_t(n)[f, p] * u(n)[c, p + shift_s]
// with the taps g_0(n) = ge(n+1) [n%D < D-1], g_1(n) = ge(n),
// g_2(n) = ge(n-1) [n%D > 0], and u = bf16(relu?(x * a + b)) rebuilt from
// the saved input (convcomb_pallas.py:186-245). A GEMM of M = 3F, N = 9Cp
// over K = every pixel of every row: each block walks work units (one row,
// one 4x16-pixel tile) in a grid-stride loop and keeps its share of the
// [M, N] sums in the warps' accumulator registers across all its units; it
// writes them once to partials[block] and dw_reduce_kernel adds the blocks
// in a fixed order. Operands: the tile's g_taps in shared memory pixel-
// major ([64][Mp]), the normalized halo tile as in the forward; ldmatrix
// .trans reads both as mma.sync fragments, the halo at each 3x3 shift.
__global__ void __launch_bounds__(kDwThreads, 1)
convcomb_dw_kernel(const bf16* __restrict__ ge, const bf16* __restrict__ x,
                   const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ partials, int N, int C, int Cp, int F,
                   int Mp, int depth, int h, int w, int relu, int tiles_x,
                   int tiles) {
  const int HW = h * w;
  const int Np = 9 * Cp;
  const int us = Cp + 8, gs = Mp + 8;   // row strides: +16 B, no conflicts
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc16 = Np / 16;
  const int pairs = (Mp / 16) * nc16;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sU = reinterpret_cast<bf16*>(smem);                  // [kHalo, us]
  bf16* sG = sU + kHalo * us;                                 // [64, gs]
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < kHalo * us + kTH * kTW * gs; i += kDwThreads)
    sU[i] = zero;           // padding channels and rows stay zero

  float acc[kDwPairs][2][4];
#pragma unroll
  for (int q = 0; q < kDwPairs; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.0f;

  // ldmatrix row of this lane (matrix lane/8, row lane%8) for each of the
  // warp's (m16, n16) tiles, at tile row 0 of the unit: A, the tap
  // cotangents, at pixel a_k and m offset a_m; B, the halo at pixel b_k
  // shifted by s = nc*16 / Cp, channel c0 + b_n. Tile row r adds r rows.
  const int mat = lane >> 3, lrow = lane & 7;
  const int a_k = lrow + (mat >> 1) * 8, a_m = (mat & 1) * 8;
  const int b_k = lrow + (mat & 1) * 8, b_n = (mat >> 1) * 8;
  unsigned a_addr[kDwPairs], b_addr[kDwPairs];
#pragma unroll
  for (int q = 0; q < kDwPairs; ++q) {
    const int pr = min(warp + q * kDwWarps, pairs - 1);
    const int mt = pr / nc16, nc = pr - mt * nc16;
    const int s = (nc * 16) / Cp, c0 = nc * 16 - s * Cp;
    a_addr[q] = smem_addr(sG + a_k * gs + mt * 16 + a_m);
    b_addr[q] = smem_addr(sU + ((s / 3) * kHaloW + b_k + s % 3) * us + c0 +
                          b_n);
  }
  const unsigned a_row = kTW * gs * sizeof(bf16);
  const unsigned b_row = kHaloW * us * sizeof(bf16);

  const int units = N * tiles;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row = u / tiles, tile = u - row * tiles;
    const int ty0 = (tile / tiles_x) * kTH, tx0 = (tile % tiles_x) * kTW;
    const int dd = row % depth;
    __syncthreads();                 // the last unit's products are done
    const bf16* xm = x + (size_t)row * C * HW;
    for (int i = threadIdx.x; i < C * kHalo; i += kDwThreads) {
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
    for (int i = threadIdx.x; i < 3 * F * kTH * kTW; i += kDwThreads) {
      const int m = i / (kTH * kTW), p = i - m * (kTH * kTW);
      const int t = m < F ? 0 : m < 2 * F ? 1 : 2, f = m - t * F;
      const int src = row + 1 - t;          // g_t(n) reads ge(n + 1 - t)
      const bool tap_ok = t == 1 || (t == 0 ? dd < depth - 1 : dd > 0);
      const int gy = ty0 + p / kTW, gx = tx0 + p % kTW;
      bf16 v = zero;
      if (tap_ok && gy < h && gx < w)
        v = ge[((size_t)src * F + f) * HW + gy * w + gx];
      sG[p * gs + m] = v;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kTH; ++r) {         // k16 step = tile row r
#pragma unroll
      for (int q = 0; q < kDwPairs; ++q) {
        if (warp + q * kDwWarps >= pairs) continue;
        unsigned af[4], bfr[4];
        ldmatrix_x4_trans(af, a_addr[q] + r * a_row);
        ldmatrix_x4_trans(bfr, b_addr[q] + r * b_row);
        mma_16816(acc[q][0], af, bfr[0], bfr[1]);
        mma_16816(acc[q][1], af, bfr[2], bfr[3]);
      }
    }
  }

  // accumulator element e of n8 tile j: row g (+8 for e >= 2), column
  // q2 (+1 for odd e)
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  float* out = partials + (size_t)blockIdx.x * Mp * Np;
#pragma unroll
  for (int q = 0; q < kDwPairs; ++q) {
    const int pr = warp + q * kDwWarps;
    if (pr >= pairs) continue;
    const int mt = pr / nc16, nc = pr - mt * nc16;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 16 + g + (e >> 1) * 8;
        const int n = nc * 16 + j * 8 + q2 + (e & 1);
        out[(size_t)m * Np + n] = acc[q][j][e];
      }
  }
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
      convcomb_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(tiles, (N / depth) * nseg);
  convcomb_kernel<false><<<grid, kThreads, smem, s>>>(
      (const bf16*)x, (const bf16*)wk, (const float*)a, (const float*)b,
      nullptr, (bf16*)y, (float*)partials, C, Cp, F, Fp, depth, h, w, relu,
      seg, nseg, tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<F, 256, 0, s>>>((const float*)partials,
                                         (float*)stats, grid.x * grid.y);
  return cudaGetLastError();
}

// The backward of convcomb_fwd (convcomb_pallas.py:_bwd_kernel), in four
// launches on ``stream``: the ge fold; the data gradient, convcomb_kernel
// <true> over ge with wkb [3, Cp_out, 9*Fp_in] (slot q = tap 2 - q,
// flipped 3x3, transposed: wkb[q, c, s*Fp_in + f] = wm[(2-q)F + f, c,
// 8 - s]), giving dx and per-block (da, db) sums in ab_partials [C, nblk,
// 2] that stats_reduce_kernel adds into dab [C, 2]; and the weight
// gradient, convcomb_dw_kernel on ``dw_blocks`` blocks into dw_partials
// [dw_blocks, Mp, 9*Cp] and dw_reduce_kernel into dw [Mp, 9*Cp] (row
// t*F + f, column s*Cp + c; rows >= 3F are zero).
// x [N, C, hw], y, gy [N, F, hw] bf16; a, b [C], gstats [F, 2] f32; ge
// [N, F, hw] bf16 scratch; dx [N, C, hw] bf16. All contiguous.
extern "C" int convcomb_bwd(const void* x, const void* wkb, const void* a,
                            const void* b, const void* y, const void* gy,
                            const void* gstats, void* ge, void* dx, void* dab,
                            void* ab_partials, void* dw, void* dw_partials,
                            int N, int C, int Cp, int F, int Fp_in, int Mp,
                            int depth, int h, int w, int relu, int seg,
                            int dw_blocks, void* stream) {
  if (C > kMaxF || Cp % 16 || Cp < C || (Cp != 16 && Cp != 32) ||
      Fp_in % 16 || Fp_in < F || Mp % 16 || Mp < 3 * F ||
      (Mp / 16) * (9 * Cp / 16) > kDwPairs * kDwWarps || N % depth ||
      seg < 1 || dw_blocks < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int HW = h * w;
  const size_t total = (size_t)N * F * HW;
  ge_fold_kernel<<<(int)std::min<size_t>((total + 255) / 256, 65536), 256, 0,
                   s>>>((const bf16*)gy, (const bf16*)y, (const float*)gstats,
                        (bf16*)ge, F, HW, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles = ((h + kTH - 1) / kTH) * tiles_x;
  const int nseg = (depth + seg - 1) / seg;
  const size_t smem = sizeof(bf16) * ((size_t)3 * Cp * (9 * Fp_in + 8) +
                                      (size_t)kHalo * (Fp_in + 8)) +
                      sizeof(float) * kWarps * 16 * 2;
  err = cudaFuncSetAttribute(convcomb_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, (N / depth) * nseg);
  convcomb_kernel<true><<<grid, kThreads, smem, s>>>(
      (const bf16*)ge, (const bf16*)wkb, (const float*)a, (const float*)b,
      (const bf16*)x, (bf16*)dx, (float*)ab_partials, F, Fp_in, C, Cp,
      depth, h, w, relu, seg, nseg, tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<C, 256, 0, s>>>((const float*)ab_partials,
                                         (float*)dab, grid.x * grid.y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dw_smem =
      sizeof(bf16) * ((size_t)kHalo * (Cp + 8) + (size_t)kTH * kTW * (Mp + 8));
  err = cudaFuncSetAttribute(convcomb_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dw_smem);
  if (err != cudaSuccess) return err;
  convcomb_dw_kernel<<<dw_blocks, kDwThreads, dw_smem, s>>>(
      (const bf16*)ge, (const bf16*)x, (const float*)a, (const float*)b,
      (float*)dw_partials, N, C, Cp, F, Mp, depth, h, w, relu, tiles_x,
      tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int elems = Mp * 9 * Cp;
  dw_reduce_kernel<<<(elems + 255) / 256, 256, 0, s>>>(
      (const float*)dw_partials, (float*)dw, dw_blocks, elems);
  return cudaGetLastError();
}
