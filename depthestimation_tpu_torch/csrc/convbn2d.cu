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
// statistics' cotangent (s0, s1) into gy, folded on load wherever ge is
// read (it never exists in device memory):
//   du  = the transposed 3x3 conv of ge          products summed in f32
//   dv  = du masked by act' on the f32 pre-activation v = x a + b
//   dx  = bf16(dv a),  da = sum dv x,  db = sum dv
//   dW  = sum over pixels of ge (x) im2col(u)    f32, u rebuilt from x
// The data gradient is this file's forward kernel instantiated with kBwd:
// ge in place of u, the flipped and transposed weights [C, 9F], and an
// epilogue that writes dx and per-block (da, db) partials. The weight
// gradient is a GEMM of M = F, N = 9C over every pixel: each 512-thread
// block keeps its share of the [F, 9C] sums in registers across a grid-
// stride walk over 4x16-pixel units (the shared-memory addresses of its
// products computed once, outside the unit loop), blockIdx.y splits the
// (m16, n16) output tiles when they are more than one block holds, and a
// second pass adds the blocks' partials in a fixed order (no atomics).
// The TPU's seam dW (_xla_seam_dw, f32 u and ge) has no counterpart: the
// halo carries the neighbouring rows, with bf16 operands everywhere.

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
constexpr int kTH = 8, kTW = 16;           // output tile: 8 rows x 16 cols
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;  // 180 halo pixels
constexpr int kNT = 4;                     // n8 pixel tiles per warp
constexpr int kMaxMT = 5;                  // m16 row tiles: C, F <= 80

constexpr int kActNone = 0, kActRelu = 1, kActLeaky = 2;

__device__ inline float act_fwd(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.0f);
  if (act == kActLeaky) return v >= 0.0f ? v : 0.01f * v;
  return v;
}

// the gradient through act at the f32 pre-activation v (relu: v > 0;
// leaky: slope 1 at v >= 0, as convbn2d_pallas.py:306-311)
__device__ inline float act_bwd(float g, float v, int act) {
  if (act == kActRelu) return v > 0.0f ? g : 0.0f;
  if (act == kActLeaky) return v >= 0.0f ? g : 0.01f * g;
  return g;
}

// v = x * a + b rounded after each step, as the plain version computes it
__device__ inline float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// kBwd = false: the forward layer. ``in`` = x [N, K, HW] (K = C), (ka, kb)
// = the layer's (a, b), wk [MT*16, 9*Kp] (index s*Kp + k, s = kh*3 + kw);
// ``out`` = y [N, M, HW] (M = F), ``partials`` [M, gridDim.x, 2] = per-block
// (sum y, sum y^2).
// kBwd = true: the data gradient. ``in`` = gy, ``in_y`` = y [N, K, HW]
// (K = F), (ka, kb) = (s0, s1), folded on load into ge; wk = the flipped,
// transposed weights [MT*16, 9*Kp] (wk[c, s*Kp + f] = W[f, c, 8 - s]);
// ``out`` = dx [N, M, HW] (M = C) from du and the layer's input ``xo``
// with its (a, b) and act; ``partials`` = per-block (sum dv x, sum dv).
template <int MT, bool kBwd>
__global__ void __launch_bounds__(kThreads)
convbn2d_kernel(const bf16* __restrict__ in, const bf16* __restrict__ in_y,
                const float* __restrict__ ka, const float* __restrict__ kb,
                const bf16* __restrict__ wk, const bf16* __restrict__ xo,
                const float* __restrict__ a, const float* __restrict__ b,
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

  // the epilogue's per-row (a, b) of the layer (kBwd)
  float ra[MT][2], rb[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = mt * 16 + g + 8 * hh;
      ra[mt][hh] = kBwd && m < M ? a[m] : 0.0f;
      rb[mt][hh] = kBwd && m < M ? b[m] : 0.0f;
    }
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
        const float xv = __bfloat162float(in[at]);
        if constexpr (kBwd) {
          v = __fadd_rn(xv + ka[c], 2.0f * __bfloat162float(in_y[at]) * kb[c]);
        } else {
          v = act_fwd(affine(xv, ka[c], kb[c]), act);
        }
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

    // y (or dx) to global bf16, and the channel sums
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
          float v0 = acc[mt][j][2 * hh], v1 = acc[mt][j][2 * hh + 1];
          float s0, s1, q0, q1;
          if constexpr (kBwd) {
            const float x0 = ok0 ? __bfloat162float(xo[at]) : 0.0f;
            const float x1 = ok1 ? __bfloat162float(xo[at + 1]) : 0.0f;
            v0 = act_bwd(v0, affine(x0, ra[mt][hh], rb[mt][hh]), act);
            v1 = act_bwd(v1, affine(x1, ra[mt][hh], rb[mt][hh]), act);
            s0 = v0 * x0;                    // (da, db) terms
            s1 = v1 * x1;
            q0 = v0;
            q1 = v1;
            v0 *= ra[mt][hh];                // dx = dv * a
            v1 *= ra[mt][hh];
          } else {
            v0 = de::round_bf16(v0);         // stats of the bf16 y
            v1 = de::round_bf16(v1);
            s0 = v0;
            s1 = v1;
            q0 = v0 * v0;
            q1 = v1 * v1;
          }
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

constexpr int kDwThreads = 512;
constexpr int kDwWarps = kDwThreads / 32;
constexpr int kDwPairs = 5;     // (m16, n16) output tiles per warp, at most
constexpr int kDH = 4, kDW = 16;             // unit: 4 rows x 16 cols
constexpr int kDHaloW = kDW + 2;
constexpr int kDHalo = (kDH + 2) * kDHaloW;  // 108 halo pixels

// Weight gradient, per-block partial sums:
//   dW[f, s*Cp + c] = sum over images n and pixels p of
//                     ge(n)[f, p] * u(n)[c, p + shift_s]
// with ge = bf16(gy + s0 + 2 y s1) and u = bf16(act(x a + b)) rebuilt on
// load (convbn2d_pallas.py:317-321). A GEMM of M = Fp, N = 9Cp over
// K = every pixel: the (m16, n16) output tiles are split into gridDim.y
// groups of ``per_split``; within a group, warp w takes tiles w, w + 16,
// ...; each block walks (image, 4x16 tile) units in a grid-stride loop,
// keeps its sums in the warps' accumulators and writes them once to
// partials[blockIdx.x]; dw_reduce_kernel adds the blocks in a fixed order.
// Operands: ge pixel-major in shared memory ([64][Mp]), the normalized halo
// channels fastest; ldmatrix .trans reads both as mma.sync fragments, the
// halo at each 3x3 shift.
__global__ void __launch_bounds__(kDwThreads, 1)
convbn2d_dw_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
                   const float* __restrict__ s0, const float* __restrict__ s1,
                   const bf16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ partials,
                   int N, int C, int Cp, int F, int Mp, int h, int w, int act,
                   int tiles_x, int per_split) {
  const int HW = h * w;
  const int Np = 9 * Cp;
  const int tiles = ((h + kDH - 1) / kDH) * tiles_x;
  const int us = Cp + 8, gs = Mp + 8;   // row strides: +16 B, no conflicts
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc16 = Np / 16;
  const int pairs = (Mp / 16) * nc16;
  const int base = blockIdx.y * per_split;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sU = reinterpret_cast<bf16*>(smem);                  // [kDHalo, us]
  bf16* sG = sU + kDHalo * us;                                // [64, gs]
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < kDHalo * us + kDH * kDW * gs; i += kDwThreads)
    sU[i] = zero;           // padding channels and rows stay zero

  // this warp's tiles: q < nq (a prefix of q, since both bounds grow in q)
  int nq = 0;
#pragma unroll
  for (int q = 0; q < kDwPairs; ++q)
    if (warp + q * kDwWarps < per_split && base + warp + q * kDwWarps < pairs)
      nq = q + 1;

  float acc[kDwPairs][2][4];
#pragma unroll
  for (int q = 0; q < kDwPairs; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.0f;

  // ldmatrix row of this lane (matrix lane/8, row lane%8) for each tile,
  // at unit row 0: A, the cotangent, at pixel a_k and m offset a_m; B, the
  // halo at pixel b_k shifted by s = nc*16 / Cp, channel c0 + b_n. Unit row
  // r adds r rows to both.
  const int mat = lane >> 3, lrow = lane & 7;
  const int a_k = lrow + (mat >> 1) * 8, a_m = (mat & 1) * 8;
  const int b_k = lrow + (mat & 1) * 8, b_n = (mat >> 1) * 8;
  unsigned a_addr[kDwPairs], b_addr[kDwPairs];
#pragma unroll
  for (int q = 0; q < kDwPairs; ++q) {
    const int pr = min(base + warp + q * kDwWarps, pairs - 1);
    const int mt = pr / nc16, nc = pr - mt * nc16;
    const int s = (nc * 16) / Cp, c0 = nc * 16 - s * Cp;
    a_addr[q] = smem_addr(sG + a_k * gs + mt * 16 + a_m);
    b_addr[q] = smem_addr(sU + ((s / 3) * kDHaloW + b_k + s % 3) * us + c0 +
                          b_n);
  }
  const unsigned a_row = kDW * gs * sizeof(bf16);
  const unsigned b_row = kDHaloW * us * sizeof(bf16);

  const int units = N * tiles;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n = unit / tiles, tile = unit - n * tiles;
    const int ty0 = (tile / tiles_x) * kDH, tx0 = (tile % tiles_x) * kDW;
    __syncthreads();                 // the last unit's products are done
    const bf16* xn = x + (size_t)n * C * HW;
    for (int i = threadIdx.x; i < C * kDHalo; i += kDwThreads) {
      const int c = i / kDHalo, hp = i - c * kDHalo;
      const int yy = hp / kDHaloW, xx = hp - yy * kDHaloW;
      const int py = ty0 + yy - 1, px = tx0 + xx - 1;
      float v = 0.0f;
      if (py >= 0 && py < h && px >= 0 && px < w)
        v = act_fwd(affine(__bfloat162float(xn[(size_t)c * HW + py * w + px]),
                           a[c], b[c]), act);
      sU[hp * us + c] = __float2bfloat16(v);
    }
    const size_t g0 = (size_t)n * F * HW;
    for (int i = threadIdx.x; i < F * kDH * kDW; i += kDwThreads) {
      const int f = i / (kDH * kDW), p = i - f * (kDH * kDW);
      const int py = ty0 + p / kDW, px = tx0 + p % kDW;
      float v = 0.0f;
      if (py < h && px < w) {
        const size_t at = g0 + (size_t)f * HW + py * w + px;
        v = __fadd_rn(__bfloat162float(gy[at]) + s0[f],
                      2.0f * __bfloat162float(y[at]) * s1[f]);
      }
      sG[p * gs + f] = __float2bfloat16(v);
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kDH; ++r) {         // k16 step = unit row r
#pragma unroll
      for (int q = 0; q < kDwPairs; ++q) {
        if (q >= nq) continue;
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
  float* outp = partials + (size_t)blockIdx.x * Mp * Np;
#pragma unroll
  for (int q = 0; q < kDwPairs; ++q) {
    if (q >= nq) continue;
    const int pr = base + warp + q * kDwWarps;
    const int mt = pr / nc16, nc = pr - mt * nc16;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 16 + g + (e >> 1) * 8;
        const int nn = nc * 16 + j * 8 + q2 + (e & 1);
        outp[(size_t)m * Np + nn] = acc[q][j][e];
      }
  }
}

template <int MT, bool kBwd>
cudaError_t launch_conv(const bf16* in, const bf16* in_y, const float* ka,
                        const float* kb, const bf16* wk, const bf16* xo,
                        const float* a, const float* b, bf16* out,
                        float* partials, float* sums, int N, int K, int Kp,
                        int M, int h, int w, int act, cudaStream_t s) {
  const size_t smem = sizeof(bf16) * ((size_t)MT * 16 * (9 * Kp + 8) +
                                      (size_t)kHalo * (Kp + 8)) +
                      sizeof(float) * kWarps * MT * 16 * 2;
  auto kernel = convbn2d_kernel<MT, kBwd>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int units = N * ((h + kTH - 1) / kTH) * tiles_x;
  const int nblk = std::min(units, std::max(per_sm, 1) * n_sm);
  kernel<<<nblk, kThreads, smem, s>>>(in, in_y, ka, kb, wk, xo, a, b, out,
                                       partials, K, Kp, M, h, w, act,
                                       tiles_x, units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<M, 256, 0, s>>>(partials, sums, nblk);
  return cudaGetLastError();
}

template <bool kBwd>
cudaError_t dispatch_conv(int Mp, const bf16* in, const bf16* in_y,
                          const float* ka, const float* kb, const bf16* wk,
                          const bf16* xo, const float* a, const float* b,
                          bf16* out, float* partials, float* sums, int N,
                          int K, int Kp, int M, int h, int w, int act,
                          cudaStream_t s) {
  switch (Mp / 16) {
#define DE_CASE(mt)                                                          \
  case mt:                                                                   \
    return launch_conv<mt, kBwd>(in, in_y, ka, kb, wk, xo, a, b, out,        \
                                 partials, sums, N, K, Kp, M, h, w, act, s);
    DE_CASE(1)
    DE_CASE(2)
    DE_CASE(3)
    DE_CASE(4)
    DE_CASE(5)
#undef DE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_dims(int C, int Cp, int F, int Fp, int act) {
  return C < 1 || F < 1 || Cp % 16 || Cp < C || Cp > kMaxMT * 16 ||
         Fp % 16 || Fp < F || Fp > kMaxMT * 16 || act < kActNone ||
         act > kActLeaky;
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
  return dispatch_conv<false>(
      Fp, (const bf16*)x, nullptr, (const float*)a, (const float*)b,
      (const bf16*)wk, nullptr, nullptr, nullptr, (bf16*)y, (float*)partials,
      (float*)stats, N, C, Cp, F, h, w, act, (cudaStream_t)stream);
}

// The backward of convbn2d_fwd (convbn2d_pallas.py:_bwd_kernel and
// _xla_seam_dw), in four launches on ``stream``: the data gradient,
// convbn2d_kernel<kBwd> over ge folded from (gy, y, s01) with wkb [Cp,
// 9*Fp] (wkb[c, s*Fp + f] = W[f, c, 8 - s]), giving dx and per-block
// (da, db) sums in ab_partials [C, cap, 2] that stats_reduce_kernel adds
// into dab [C, 2]; and the weight gradient, convbn2d_dw_kernel on
// (dw_blocks, nsplit) blocks into dw_partials [dw_blocks, Fp, 9*Cp] and
// dw_reduce_kernel into dw [Fp, 9*Cp] (column s*Cp + c; padding rows and
// columns are zero). x [N, C, hw], y, gy [N, F, hw] bf16; a, b [C] f32;
// s01 [2, F] f32 (the statistics' cotangent, transposed); dx [N, C, hw]
// bf16. All contiguous.
extern "C" int convbn2d_bwd(const void* x, const void* wkb, const void* a,
                            const void* b, const void* y, const void* gy,
                            const void* s01, void* dx, void* dab,
                            void* ab_partials, void* dw, void* dw_partials,
                            int N, int C, int Cp, int F, int Fp, int h, int w,
                            int act, int dw_blocks, int nsplit,
                            void* stream) {
  const int pairs = (Fp / 16) * (9 * Cp / 16);
  const int per_split = nsplit > 0 ? (pairs + nsplit - 1) / nsplit : 0;
  if (bad_dims(C, Cp, F, Fp, act) || N < 1 || h < 1 || w < 1 ||
      dw_blocks < 1 || nsplit < 1 || per_split > kDwWarps * kDwPairs)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* s0 = (const float*)s01;
  const float* s1 = s0 + F;
  cudaError_t err = dispatch_conv<true>(
      Cp, (const bf16*)gy, (const bf16*)y, s0, s1, (const bf16*)wkb,
      (const bf16*)x, (const float*)a, (const float*)b, (bf16*)dx,
      (float*)ab_partials, (float*)dab, N, F, Fp, C, h, w, act, s);
  if (err != cudaSuccess) return err;

  const size_t dw_smem = sizeof(bf16) * ((size_t)kDHalo * (Cp + 8) +
                                         (size_t)kDH * kDW * (Fp + 8));
  err = cudaFuncSetAttribute(convbn2d_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dw_smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + kDW - 1) / kDW;
  convbn2d_dw_kernel<<<dim3(dw_blocks, nsplit), kDwThreads, dw_smem, s>>>(
      (const bf16*)gy, (const bf16*)y, s0, s1, (const bf16*)x,
      (const float*)a, (const float*)b, (float*)dw_partials, N, C, Cp, F, Fp,
      h, w, act, tiles_x, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int elems = Fp * 9 * Cp;
  dw_reduce_kernel<<<(elems + 255) / 256, 256, 0, s>>>(
      (const float*)dw_partials, (float*)dw, dw_blocks, elems);
  return cudaGetLastError();
}
