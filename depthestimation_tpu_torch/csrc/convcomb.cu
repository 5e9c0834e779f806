// Fused Base3D conv block, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel depthestimation_tpu/ops/convcomb_pallas.py:
// _fwd_kernel (launched by _fwd_call, public convbn_block). One layer of
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

#include "common.cuh"

using de::bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 4, kTW = 16;           // output tile: 4 rows x 16 cols
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;  // 108 halo pixels
constexpr int kNT = 4;                     // n8 pixel tiles per warp (max)
constexpr int kMaxF = 32;                  // two 16-channel row tiles

__device__ inline void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += A (16x16, row) . B (16x8, col), bf16 in, f32 accumulate
__device__ inline void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                 unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
convcomb_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                const float* __restrict__ a, const float* __restrict__ b,
                bf16* __restrict__ y, float* __restrict__ partials, int C,
                int Cp, int F, int Fp, int depth, int h, int w, int relu,
                int seg, int nseg, int tiles_x) {
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

  // y(r) from this lane's fragment values -> global bf16, and channel sums
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
        const float v0 = v[j][2 * hh], v1 = v[j][2 * hh + 1];
        bf16* dst = y + (row * F + f) * HW + (size_t)gy * w + gx;
        const bool ok0 = gx < w, ok1 = gx + 1 < w;
        if (ok1 && !(w & 1)) {      // even w: the pair is 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (ok0) dst[0] = __float2bfloat16(v0);
          if (ok1) dst[1] = __float2bfloat16(v1);
        }
        if (ok0) {
          st[hh][0] += v0;
          st[hh][1] += v0 * v0;
        }
        if (ok1) {
          st[hh][0] += v1;
          st[hh][1] += v1 * v1;
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
    const bool out = m - 1 >= d0 && m - 1 < d1;
    const bool in = m >= d0 && m < d1;
    float yv[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yv[j][e] = de::round_bf16(part[j][e] + de::round_bf16(acc[2][j][e]));
        if (in) {
          const float t1 = de::round_bf16(acc[1][j][e]);
          part[j][e] = m > 0 ? de::round_bf16(t1 + t0p[j][e]) : t1;
        }
        t0p[j][e] = de::round_bf16(acc[0][j][e]);
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

// stats[f] = sum over blocks of partials[f, :, :]; one block per channel.
__global__ void __launch_bounds__(256)
stats_reduce_kernel(const float* __restrict__ partials,
                    float* __restrict__ stats, int nblk) {
  __shared__ float red[2][8];
  const int f = blockIdx.x;
  const float* pf = partials + (size_t)f * nblk * 2;
  float s = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
    s += pf[2 * i];
    s2 += pf[2 * i + 1];
  }
  s = de::warp_sum(s);
  s2 = de::warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f, t2 = 0.0f;
    for (int i = 0; i < (int)(blockDim.x / 32); ++i) {
      t += red[0][i];
      t2 += red[1][i];
    }
    stats[2 * f] = t;
    stats[2 * f + 1] = t2;
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
      convcomb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(tiles, (N / depth) * nseg);
  convcomb_kernel<<<grid, kThreads, smem, s>>>(
      (const bf16*)x, (const bf16*)wk, (const float*)a, (const float*)b,
      (bf16*)y, (float*)partials, C, Cp, F, Fp, depth, h, w, relu, seg,
      nseg, tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<F, 256, 0, s>>>((const float*)partials,
                                         (float*)stats, grid.x * grid.y);
  return cudaGetLastError();
}
