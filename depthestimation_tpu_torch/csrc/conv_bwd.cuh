// What the kernels of the fused conv blocks share (convbn2d.cu,
// convcomb.cu): the activations, the two-step staging of a halo tile that
// the forwards and the data gradients read their shifted operand from, the
// cotangent fold, and the weight gradient on wgmma, one kernel for both
// layers.
//
// The weight gradient is the GEMM
//   P[s*Cp + c][col] = sum over rows n and pixels p of
//                      u(n)[c, p + shift_s] * G(n)[col, p]
// of the normalized input u = bf16(act(x a + b)) (x [rows, C, h*w]) and the
// folded cotangent ge = bf16(gy + s0 + 2 y s1) (gy, y [rows, F, h*w]): for
// the 2D layer (taps = 1) G(n) = ge(n), col = f; for Base3D's (taps = 3)
// the three depth taps, col = t*F + f, G(n)[t*F + f] = ge(n + 1 - t)[f]
// with g_0 zero at the last row of an item's depth (n%D == D-1) and g_2 at
// the first. The long side 9 Cp is wgmma's M (a warp owns 16 rows: one
// shift, 16 channels; a warpgroup a 64-row tile), the short side N = NP
// (taps*F padded to 16), K every pixel.
//
// Two passes before it: ge_fold_kernel writes ge once, and
// conv_dw_input_kernel writes u channels fastest ([rows, h*w, Cp], zero
// padded), so that both operands reach shared memory by cp.async alone. A
// block of ``wgs`` warpgroups owns M tiles blockIdx.y * wgs ..; it walks
// (row, 8x16-pixel tile) units in a grid-stride loop over three buffers:
// while the products of one unit run (8 k16 steps, a tile row each), the
// copies of the next two are in flight. A = im2col(u)^T comes from the
// 10x18-pixel u halo by ldmatrix.trans at the warp's shift; B = the G
// tile, K-major for the descriptor (wgmma.cuh). The sums stay in the
// accumulators across the block's units and go to partials[blockIdx.x]
// once; a second pass adds the blocks in a fixed order (no atomics) and
// writes the weight's own layout [taps*F, C, 3, 3].
#pragma once

#include <algorithm>

#include "common.cuh"
#include "wgmma.cuh"

namespace de {

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

// v = x * a + b rounded after each step, as the plain versions compute it
__device__ inline float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// ge before its rounding to bf16, as the plain versions compute it
__device__ inline float fold(float gy, float y, float s0, float s1) {
  return __fadd_rn(gy + s0, 2.0f * y * s1);
}

// ---- staging: global loads of 16 bytes, four in flight per thread
//
// The operands are staged by the block's own threads; what bounds that is
// the latency of each thread's loads, so every loop below issues a batch
// of independent 16-byte loads before it uses any of them.

// element i (0..7) of eight packed bf16, as f32 (i a constant after
// unrolling, so the vector stays in registers)
__device__ inline float bf_at(const uint4& r, int i) {
  const unsigned v = i < 2 ? r.x : i < 4 ? r.y : i < 6 ? r.z : r.w;
  return __uint_as_float((i & 1) ? (v & 0xFFFF0000u) : (v << 16));
}

__device__ inline unsigned short bf_bits(const uint4& r, int i) {
  const unsigned v = i < 2 ? r.x : i < 4 ? r.y : i < 6 ? r.z : r.w;
  return (unsigned short)((i & 1) ? (v >> 16) : (v & 0xFFFFu));
}

__device__ inline void set_bits(uint4& r, int i, unsigned short b) {
  const int sh = (i & 1) * 16;
  const unsigned keep = ~(0xFFFFu << sh), put = (unsigned)b << sh;
  if (i < 2) r.x = (r.x & keep) | put;
  else if (i < 4) r.y = (r.y & keep) | put;
  else if (i < 6) r.z = (r.z & keep) | put;
  else r.w = (r.w & keep) | put;
}

__device__ inline unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// i / d for 0 <= i < 2^24 and d > 0, from a float reciprocal of d and one
// correction: no integer division in a loop over every element
__device__ inline int div_small(int i, int d, float inv_d) {
  int q = (int)((float)i * inv_d);
  if (q * d > i) --q;
  else if ((q + 1) * d <= i) ++q;
  return q;
}

__device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// put(i, bits) for every element i < n of ``src``
template <class Put>
__device__ inline void for_each_bf16(const bf16* __restrict__ src, int n,
                                     Put put) {
  const int n8 = aligned16(src) ? n / 8 : 0;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int j0 = threadIdx.x; j0 < n8; j0 += 4 * blockDim.x) {
    uint4 r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < n8) r[k] = __ldg(src4 + j);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < n8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) put(8 * j + e, bf_bits(r[k], e));
      }
    }
  }
  for (int i = 8 * n8 + threadIdx.x; i < n; i += blockDim.x)
    put(i, __bfloat16_as_ushort(src[i]));
}

// eight pixels px0 .. px0+7 of the row at ``row`` (elements), zero and
// bit clear where they leave [0, w): one 16-byte load where aligned and
// inside, else one load each
__device__ inline uint4 load8(const bf16* __restrict__ p, size_t row,
                              int px0, int w, unsigned& ok) {
  if (px0 >= 0 && px0 + 8 <= w && aligned16(p + row + px0)) {
    ok = 0xFFu;
    return __ldg(reinterpret_cast<const uint4*>(p + row + px0));
  }
  uint4 r = make_uint4(0, 0, 0, 0);
  ok = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (px0 + i >= 0 && px0 + i < w) {
      set_bits(r, i, __bfloat16_as_ushort(p[row + px0 + i]));
      ok |= 1u << i;
    }
  return r;
}

// 16 bytes global -> shared, asynchronous; zero filled when !valid
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(reinterpret_cast<const bf16*>(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 bytes global -> shared, asynchronous, through L1; zero filled when
// !valid
__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(reinterpret_cast<const bf16*>(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// ---- the halo tile of a TH x 16-pixel output tile, in two steps
//
// A halo tile is (TH + 2) x 18 pixels around the tile at (ty0, tx0), zero
// outside the image. The kernels stage it in two steps, so that the copy
// from device memory can be in flight while the block computes:
//
// 1. stage_halo_raw issues asynchronous copies of the raw input into a
//    shared "raw" buffer laid out as the source, one channel row after
//    another: for channel c and halo row yy, kRawW elements at
//    ((c * ROWS + yy) * kRawW): the tile's 16 columns as two 16-byte copies
//    (elements 0-15), then the pixel pairs (tx0 - 2, tx0 - 1) and (tx0 + 16,
//    tx0 + 17) as 4-byte copies (16-17, 18-19). Where w % 8 or the source's
//    alignment rule the copies out, the same elements are loaded one by one.
//    The caller commits the cp.async group and waits for it.
// 2. halo_from_raw writes the halo channels fastest (u[(yy * 18 + xx) *
//    us + c] for c < Cp) through a per-channel transform xf(c, v) of each
//    input value inside the image and channel count (the forward
//    normalizes there; the data gradients copy), zero elsewhere: a thread
//    takes a halo pixel and eight channels at a time and stores them as 16
//    bytes.
constexpr int kRawW = 24;

template <int ROWS>
__device__ inline void stage_halo_raw(bf16* __restrict__ raw, int C, int h,
                                      int w, size_t cs, int ty0, int tx0,
                                      const bf16* __restrict__ src,
                                      bool fast) {
  const int njobs = C * ROWS * 4;
  for (int j = threadIdx.x; j < njobs; j += blockDim.x) {
    const int part = j & 3, cy = j >> 2;
    const int c = cy / ROWS, yy = cy - c * ROWS;
    const int py = ty0 + yy - 1;
    const bool row_in = py >= 0 && py < h;
    const bf16* row = src + (row_in ? c * cs + (size_t)py * w : 0);
    bf16* dst = raw + cy * kRawW;
    if (fast) {
      if (part < 2) {
        const int px0 = tx0 + 8 * part;
        const bool ok = row_in && px0 < w;
        cp_async16(dst + 8 * part, ok ? row + px0 : src, ok);
      } else if (part == 2) {
        const bool ok = row_in && tx0 > 0;
        cp_async4(dst + 16, ok ? row + tx0 - 2 : src, ok);
      } else {
        const bool ok = row_in && tx0 + 16 < w;
        cp_async4(dst + 18, ok ? row + tx0 + 16 : src, ok);
      }
      continue;
    }
    const bf16 zero = __float2bfloat16(0.0f);
    if (part < 2) {
      const int px0 = tx0 + 8 * part;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[8 * part + i] = row_in && px0 + i < w ? row[px0 + i] : zero;
    } else if (part == 2) {
      dst[16] = zero;
      dst[17] = row_in && tx0 > 0 ? row[tx0 - 1] : zero;
    } else {
      dst[18] = row_in && tx0 + 16 < w ? row[tx0 + 16] : zero;
      dst[19] = zero;
    }
  }
}

template <int ROWS, class Xf>
__device__ inline void halo_from_raw(bf16* __restrict__ u, int us, int Cp,
                                     int C, const bf16* __restrict__ raw,
                                     int h, int w, int ty0, int tx0, Xf xf) {
  const unsigned short* rb = reinterpret_cast<const unsigned short*>(raw);
  for (int hp = threadIdx.x; hp < ROWS * 18; hp += blockDim.x) {
    const int yy = hp / 18, xx = hp - yy * 18;
    const int py = ty0 + yy - 1, px = tx0 + xx - 1;
    const bool in = py >= 0 && py < h && px >= 0 && px < w;
    const unsigned short* r =
        rb + yy * kRawW + (xx == 0 ? 17 : xx == 17 ? 18 : xx - 1);
    for (int c0 = 0; c0 < Cp; c0 += 8) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + i;
        v[i] = in && c < C
                   ? xf(c, __uint_as_float((unsigned)r[c * ROWS * kRawW]
                                           << 16))
                   : 0.0f;
      }
      *reinterpret_cast<uint4*>(u + hp * us + c0) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                     pack2(v[4], v[5]), pack2(v[6], v[7]));
    }
  }
}

// the raw buffer's elements for C channels of a ROWS-row halo
template <int ROWS>
__host__ __device__ constexpr int halo_raw_elems(int C) {
  return C * ROWS * kRawW;
}

// ge = bf16(gy + s0 + 2 y s1), (s0, s1) = gstats[f], over [rows, F, HW]:
// the folded cotangent, written once for both gradients (it is read 3 + 3
// times by Base3D's kernels and twice by the 2D layer's), eight elements a
// thread where aligned (HW % 8 == 0 keeps them in one channel)
static __global__ void __launch_bounds__(256)
ge_fold_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
               const float* __restrict__ gstats, bf16* __restrict__ ge,
               int F, int HW, size_t total) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (HW % 8 == 0 && aligned16(gy) && aligned16(y) && aligned16(ge)) {
    for (size_t i = first; i < total / 8; i += stride) {
      const int f = (int)((i * 8 / HW) % F);
      const float s0 = gstats[2 * f], s1 = gstats[2 * f + 1];
      const uint4 g = __ldg(reinterpret_cast<const uint4*>(gy) + i);
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(y) + i);
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = fold(bf_at(g, e), bf_at(v, e), s0, s1);
      reinterpret_cast<uint4*>(ge)[i] =
          make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]),
                     pack2(o[6], o[7]));
    }
    return;
  }
  for (size_t i = first; i < total; i += stride) {
    const int f = (int)((i / HW) % F);
    ge[i] = __float2bfloat16(fold(__bfloat162float(gy[i]),
                                  __bfloat162float(y[i]), gstats[2 * f],
                                  gstats[2 * f + 1]));
  }
}

// the fold in one launch on ``s``
inline cudaError_t launch_ge_fold(const bf16* gy, const bf16* y,
                                  const float* gstats, bf16* ge, int rows,
                                  int F, int HW, cudaStream_t s) {
  const size_t total = (size_t)rows * F * HW;
  const int blocks = (int)std::min<size_t>((total / 8 + 255) / 256 + 1, 8192);
  ge_fold_kernel<<<blocks, 256, 0, s>>>(gy, y, gstats, ge, F, HW, total);
  return cudaGetLastError();
}

constexpr int kDwTH = 8, kDwTW = 16;          // unit: 8 rows x 16 cols
constexpr int kDwPix = kDwTH * kDwTW;         // K per unit: 8 k16 slabs
constexpr int kDwHaloW = kDwTW + 2;
constexpr int kDwHalo = (kDwTH + 2) * kDwHaloW;

struct DwArgs {
  const bf16* ge;        // [rows, gs, h*w], the folded cotangent: channels
                         // 0 .. F-1 from here
  const bf16* u;         // [rows, h*w, ustr], the normalized input:
                         // channels 0 .. Cp-1 from here
  int rows, C, Cp, F, taps, depth, h, w;
  int gs, ustr;          // ge's channels a row, u's a pixel (F, Cp but for
                         // a group of the conv3d op's weight gradient)
};

constexpr int kDwMaxWgs = 3;   // 384 threads: up to 170 registers each
constexpr int kDwStages = 3;   // units in shared memory: one computed, two
                               // in flight

// u[n][p][c] = bf16(act(x[n][c][p] a[c] + b[c])) for c < C, 0 up to Cp
// (x itself where a is null): the weight gradient's normalized input,
// channels fastest. A block transposes 64 pixels of one row and 80
// channels from 80 * blockIdx.z through shared memory, reading 8 pixels of
// a channel and writing 8 channels of a pixel at a time where aligned.
constexpr int kDwInC = 80;
static __global__ void __launch_bounds__(256)
conv_dw_input_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ b, bf16* __restrict__ u,
                     int C, int Cp, int HW, int act) {
  __shared__ __align__(16) bf16 t[64 * (kDwInC + 2)];
  const int c0 = blockIdx.z * kDwInC, cw = min(kDwInC, Cp - c0);
  const int tp = cw + 2;                 // odd word stride: no conflicts
  const int n = blockIdx.y, p0 = blockIdx.x * 64;
  const bf16* xn = x + (size_t)n * C * HW;
  for (int i = threadIdx.x; i < cw * 8; i += blockDim.x) {
    const int cl = i / 8, c = c0 + cl, q0 = (i % 8) * 8;
    uint4 r = make_uint4(0, 0, 0, 0);
    unsigned ok = 0;
    if (c < C) r = load8(xn, (size_t)c * HW, p0 + q0, HW, ok);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      t[(q0 + e) * tp + cl] = __float2bfloat16(
          !((ok >> e) & 1u) ? 0.0f
          : a ? act_fwd(affine(bf_at(r, e), a[c], b[c]), act)
              : bf_at(r, e));
  }
  __syncthreads();
  const int c8 = cw / 8;
  bf16* un = u + ((size_t)n * HW + p0) * Cp + c0;
  for (int i = threadIdx.x; i < 64 * c8; i += blockDim.x) {
    const int q = i / c8, c = (i % c8) * 8;
    if (p0 + q >= HW) continue;
    const unsigned* src = reinterpret_cast<const unsigned*>(t + q * tp + c);
    *reinterpret_cast<uint4*>(un + (size_t)q * Cp + c) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}

template <int NP>
static __global__ void __launch_bounds__(kDwMaxWgs * 128, 1)
conv_dw_kernel(DwArgs p, float* __restrict__ partials, int wgs) {
  const int HW = p.h * p.w;
  const int tiles_x = (p.w + kDwTW - 1) / kDwTW;
  const int tiles = ((p.h + kDwTH - 1) / kDwTH) * tiles_x;
  const int units = p.rows * tiles;
  const int nthr = blockDim.x;
  const int lane = threadIdx.x % 32, wwarp = (threadIdx.x / 32) % 4;
  const int mi = (blockIdx.y * wgs + threadIdx.x / 128) * 4 + wwarp;
  const int M = 9 * p.Cp, cols = p.taps * p.F;
  const bool active = mi * 16 < M;
  const int us = p.Cp + 8;

  // kDwStages buffers, each a G tile [128, NP] and a u halo [halo, us]
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const sB0 = reinterpret_cast<bf16*>(smem);
  bf16* const sU0 = sB0 + kDwStages * kDwPix * NP;
  const int bstride = kDwPix * NP, ustride = kDwHalo * us;

  // one unit's copies, as one cp.async group (committed even when empty,
  // so that the group count stays the unit count): the G tile, a job of 8
  // pixels of one column in one tile row (a core-matrix row of the K-major
  // layout; zero filled at a masked tap or outside the image, one load
  // each where the row is ragged or unaligned), and the u halo, a job of 8
  // channels of one halo pixel (zero filled outside the image). Issuing
  // the copies, not waiting for them, is what this loop spends its time
  // on, so the jobs are numbered to need no division by a run-time value.
  auto stage = [&](int unit, int buf) {
    if (unit < units) {
      const int n = unit / tiles, tile = unit - n * tiles;
      const int ty0 = (tile / tiles_x) * kDwTH;
      const int tx0 = (tile % tiles_x) * kDwTW;
      const bool up = n % p.depth < p.depth - 1, dn = n % p.depth > 0;
      bf16* gb = sB0 + buf * bstride;
      for (int j = threadIdx.x; j < cols * kDwTH * 2; j += nthr) {
        const int rest = j & 15, col = j >> 4;   // rest = tile row, half
        const int t = p.taps == 1 ? 1 : col >= 2 * p.F ? 2 : col >= p.F;
        const int f = col - (p.taps == 1 ? 0 : t * p.F);
        const int py = ty0 + (rest >> 1), px0 = tx0 + 8 * (rest & 1);
        bf16* dst =
            gb + kmajor_off((rest >> 1) * 16 + 8 * (rest & 1), col, NP);
        const bool live = py < p.h && (t == 1 || (t == 0 ? up : dn));
        const bf16* src =
            p.ge + (live ? ((size_t)(n + 1 - t) * p.gs + f) * HW +
                               (size_t)py * p.w + px0
                         : 0);
        if (!live || (px0 + 8 <= p.w && aligned16(src))) {
          cp_async16(dst, src, live);
        } else {
          unsigned ok;
          *reinterpret_cast<uint4*>(dst) = load8(src - px0, 0, px0, p.w, ok);
        }
      }
      bf16* ub = sU0 + buf * ustride;
      const bf16* un = p.u + (size_t)n * HW * p.ustr;
      for (int j = threadIdx.x; j < kDwHalo * (p.Cp / 8); j += nthr) {
        const int hp = j % kDwHalo, ch = (j / kDwHalo) * 8;
        const int yy = hp / kDwHaloW, xx = hp - yy * kDwHaloW;
        const int py = ty0 + yy - 1, px = tx0 + xx - 1;
        const bool in = py >= 0 && py < p.h && px >= 0 && px < p.w;
        cp_async16(ub + hp * us + ch,
                   un + (in ? ((size_t)py * p.w + px) * p.ustr + ch : 0), in);
      }
    }
    cp_async_commit();
  };

  // A = im2col(u)^T at this warp's shift s, channels c0 .. c0+15:
  // ldmatrix.trans of halo pixel (lane%8) + (lane/16)*8 of a tile row at
  // channel half ((lane/8)%2)*8
  const int s = active ? (mi * 16) / p.Cp : 0;
  const int c0 = active ? mi * 16 - s * p.Cp : 0;
  const int pa = (lane & 7) + (lane >> 4) * 8;
  const int ca = c0 + ((lane >> 3) & 1) * 8;
  const unsigned aaddr =
      smem_addr(sU0 + ((s / 3) * kDwHaloW + pa + s % 3) * us + ca);
  const unsigned arow = kDwHaloW * us * sizeof(bf16);

  float acc[NP / 2];
#pragma unroll
  for (int e = 0; e < NP / 2; ++e) acc[e] = 0.0f;

  // the padding channels of the G tiles stay zero: no copy writes them
  for (int i = threadIdx.x; i < kDwStages * kDwPix * NP / 8; i += nthr)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  stage(blockIdx.x, 0);
  stage(blockIdx.x + gridDim.x, 1);
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();
  int buf = 0;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    unsigned af[kDwTH][4];
#pragma unroll
    for (int r = 0; r < kDwTH; ++r) {
      if (active) {
        ldmatrix_x4_trans(af[r], aaddr + (buf * ustride) * sizeof(bf16) +
                                     r * arow);
      } else {
        af[r][0] = af[r][1] = af[r][2] = af[r][3] = 0u;
      }
    }
    wg_fence();
#pragma unroll
    for (int r = 0; r < kDwTH; ++r)
      Wgmma<NP>::mma(acc, af[r], kmajor_desc(sB0 + buf * bstride, r, NP));
    wg_commit();
    stage(unit + 2 * gridDim.x, buf == 0 ? 2 : buf - 1);
    wg_wait<0>();
    cp_async_wait<1>();              // the next unit's copies have landed
    fence_proxy_async();
    __syncthreads();
    buf = buf == kDwStages - 1 ? 0 : buf + 1;
  }

  // element e of n8 group j: row 16 mi + g (+8 for e >= 2), column
  // 8j + q2 (+1 for odd e)
  if (!active) return;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  float* out = partials + (size_t)blockIdx.x * M * NP;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = mi * 16 + g + (e >> 1) * 8;
      out[(size_t)m * NP + 8 * j + q2 + (e & 1)] = acc[4 * j + e];
    }
}

// Where a group's GEMM lands in the weight [taps * Ft, Ct, 3, 3]: its
// columns t*F + f are rows t*Ft + f0 + f, its channels c are c0 + c (the
// whole weight: Ft = F, Ct = C, f0 = c0 = 0)
struct DwOut {
  int Ft, Ct, f0, c0;
};

// dw [taps * Ft, Ct, 3, 3] at the group's rows and channels = sum over
// blocks of partials[block][s*Cp + c][t*F + f], the blocks in a fixed
// order; a thread per GEMM element, so neighbouring threads read
// neighbours
static __global__ void __launch_bounds__(256)
conv_dw_reduce_kernel(const float* __restrict__ partials,
                      float* __restrict__ dw, int nblk, int C, int Cp,
                      int F, int taps, int NP, DwOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int elems = 9 * Cp * NP;
  if (e >= elems) return;
  const int m = e / NP, col = e - m * NP;
  const int s = m / Cp, c = m - s * Cp;
  if (col >= taps * F || c >= C) return;
  const int t = col / F, f = col - t * F;
  float v = 0.0f;
  for (int i = 0; i < nblk; ++i) v += partials[(size_t)i * elems + e];
  dw[((size_t)(t * o.Ft + o.f0 + f) * o.Ct + o.c0 + c) * 9 + s] = v;
}

// The weight gradient in two launches on ``stream`` (after the two passes
// above): conv_dw_kernel on (dw_blocks, nsplit) blocks of 128 * wgs threads
// into dw_partials [dw_blocks, 9 Cp, NP], then conv_dw_reduce_kernel into
// dw (the whole weight, or the group ``o`` of it).
template <int NP>
cudaError_t launch_conv_dw(const DwArgs& p, float* dw_partials, float* dw,
                           int dw_blocks, int nsplit, int wgs,
                           cudaStream_t s, DwOut o = {0, 0, 0, 0}) {
  if (o.Ft == 0) o = {p.F, p.C, 0, 0};
  const size_t smem = sizeof(bf16) * kDwStages *
                      ((size_t)kDwPix * NP + (size_t)kDwHalo * (p.Cp + 8));
  cudaError_t err = cudaFuncSetAttribute(
      conv_dw_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  conv_dw_kernel<NP><<<dim3(dw_blocks, nsplit), 128 * wgs, smem, s>>>(
      p, dw_partials, wgs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int elems = 9 * p.Cp * NP;
  conv_dw_reduce_kernel<<<(elems + 255) / 256, 256, 0, s>>>(
      dw_partials, dw, dw_blocks, p.C, p.Cp, p.F, p.taps, NP, o);
  return cudaGetLastError();
}

// the normalized input for the weight gradient (x itself where a is
// null), one launch on ``s``
inline cudaError_t launch_conv_dw_input(const bf16* x, const float* a,
                                        const float* b, bf16* u, int rows,
                                        int C, int Cp, int HW, int act,
                                        cudaStream_t s) {
  conv_dw_input_kernel<<<dim3((HW + 63) / 64, rows,
                              (Cp + kDwInC - 1) / kDwInC),
                         256, 0, s>>>(x, a, b, u, C, Cp, HW, act);
  return cudaGetLastError();
}

// dispatch on a multiple of 16 up to 80 (a padded channel count)
#define DE_SWITCH16(v, CALL)                                                 \
  switch (v) {                                                               \
    case 16: return CALL(16);                                                \
    case 32: return CALL(32);                                                \
    case 48: return CALL(48);                                                \
    case 64: return CALL(64);                                                \
    case 80: return CALL(80);                                                \
    default: return cudaErrorInvalidValue;                                   \
  }

}  // namespace de
