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
// without its depth ring, on wgmma (wgmma.cuh). A block keeps the whole
// weight matrix B [9 Cp, Fp] in shared memory (built once from W's own
// [F, C, 3, 3] layout) and walks 8x16-pixel image tiles in a grid-stride
// loop; the raw input of the tile two steps ahead arrives by cp.async
// while the current one computes, and is normalized once into the
// 10x18-pixel halo, channels fastest (conv_bwd.cuh, halo_from_raw). The
// warpgroup's products take M = 64 pixels (two slabs a tile), N = Fp, K =
// 9 Cp, A loaded from the shifted halo by ldmatrix. y leaves through
// shared memory as 16-byte runs; the BN sums stay in registers across the
// block's tiles and go to a partials buffer that a second kernel reduces
// in a fixed order (deterministic stats). C and F up to 80.
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
using de::stats_reduce_kernel;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdThreads = 256;           // the forward: two warpgroups
constexpr int kTH = 8, kTW = 16;           // output tile: 8 rows x 16 cols
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;  // 180 halo pixels
constexpr int kMaxMT = 5;                  // 16-channel groups: C, F <= 80
constexpr int kSYS = kTH * kTW + 8;        // y tile row stride: +16 B

using de::act_bwd;
using de::act_fwd;
using de::affine;
using de::kActLeaky;
using de::kActNone;

// The forward layer. ``NG`` = Cp / 16, the 16-channel groups of K per
// shift; ``NC`` = Fp, the wgmma N (both constants, so that every register
// operand of the products is known to the compiler). x [N, C, HW] with the
// layer's (a, b) and act, wt [F, C, 3, 3] (the module's weight, read once
// per block into B[s*Cp + c][f], K-major in shared memory); y [N, F, HW],
// ``partials`` [F, gridDim.x, 2] = per-block (sum y, sum y^2).
//
// A block (two warpgroups, one 4-row M slab of the tile each) walks
// 8x16-pixel tiles in a grid-stride loop.
// The raw x rows of the tile two steps ahead are copied (cp.async) into
// one of two raw buffers while the current tile computes; the current
// tile's are normalized (halo_from_raw, u = bf16(act(x a + b))) into the
// channels-fastest 10x18-pixel halo; per 3x3 shift s each warp loads the
// A fragments of its tile row (warp w: row w) from the halo, alternating
// two register sets, and its warpgroup issues the products. The
// epilogue rounds y to bf16 and writes it through shared memory (the
// halo's space, [Fp, 128 + 8]) as 16-byte runs of one channel row; the
// thread that stores a run adds it to its channel's sums, which stay in
// registers across the block's tiles: job j = 16 f + 2 * tile row + half,
// so a thread's channels are the same in every tile, and channel f's 16
// jobs are 16 neighbouring lanes, added in a fixed order at the end.
template <int NG, int NC>
__global__ void __launch_bounds__(kFwdThreads, 1)
convbn2d_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                const float* __restrict__ ka, const float* __restrict__ kb,
                bf16* __restrict__ y, float* __restrict__ partials, int C,
                int F, int h, int w, int act, int tiles_x, int units) {
  constexpr int Cp = NG * 16, K = 9 * Cp, us = Cp + 8;
  constexpr int kRows = kTH + 2;
  constexpr int kRaw = de::halo_raw_elems<kRows>(Cp);
  constexpr int kUY = kHalo * us > NC * kSYS ? kHalo * us : NC * kSYS;
  constexpr int kSlots = 16 * NC / kFwdThreads;
  const int HW = h * w;
  const int tiles = ((h + kTH - 1) / kTH) * tiles_x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem);          // [K, NC], K-major
  bf16* sU = sB + K * NC;                             // [kHalo, us] or
  bf16* sY = sU;                                      // [NC, kSYS]
  bf16* sRaw = sU + kUY;                              // [2][kRaw]
  float* sAB = reinterpret_cast<float*>(sRaw + 2 * kRaw);   // a, b [2][Cp]

  const bool fast = w % 8 == 0 && de::aligned16(x);
  const bool fast_y = w % 8 == 0 && de::aligned16(y);
  // unit u's raw copies into buffer ``buf``, one cp.async group (committed
  // even when empty, so that the group count is the unit count)
  auto stage = [&](int unit, int buf) {
    if (unit < units) {
      const int n = unit / tiles, tile = unit - n * tiles;
      de::stage_halo_raw<kRows>(sRaw + buf * kRaw, C, h, w, HW,
                                (tile / tiles_x) * kTH,
                                (tile % tiles_x) * kTW,
                                x + (size_t)n * C * HW, fast);
    }
    de::cp_async_commit();
  };
  stage(blockIdx.x, 0);
  stage(blockIdx.x + gridDim.x, 1);

  const uint4 z4 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < K * NC / 8; i += kFwdThreads)
    reinterpret_cast<uint4*>(sB)[i] = z4;
  for (int i = threadIdx.x; i < 2 * Cp; i += kFwdThreads) {
    const int c = i < Cp ? i : i - Cp;
    sAB[i] = c < C ? (i < Cp ? ka[c] : kb[c]) : 0.0f;
  }
  __syncthreads();
  // W [F, C, 3, 3] -> B[s*Cp + c][f]
  const float inv_c9 = 1.0f / (C * 9);
  de::for_each_bf16(wt, F * C * 9, [&](int i, unsigned short v) {
    const int f = de::div_small(i, C * 9, inv_c9), rem = i - f * C * 9;
    const int c = rem / 9, s = rem - c * 9;
    sB[de::kmajor_off(s * Cp + c, f, NC)] = __ushort_as_bfloat16(v);
  });
  de::fence_proxy_async();
  auto norm = [&](int c, float v) {
    return act_fwd(affine(v, sAB[c], sAB[Cp + c]), act);
  };

  // ldmatrix rows: pixel p of the warp's tile row, channel half ch
  const int p = (lane & 7) + ((lane >> 3) & 1) * 8, ch = (lane >> 4) * 8;
  const unsigned ab = de::smem_addr(sU + (warp * kHaloW + p) * us + ch);
  // accumulator element e of n8 group j: pixel g (+8 for e >= 2) of the
  // warp's tile row, channel 8j + q2 (+1 for odd e)
  const int g = lane >> 2, q2 = (lane & 3) * 2;

  float st[kSlots][2];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) st[k][0] = st[k][1] = 0.0f;

  int buf = 0;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n = unit / tiles, tile = unit - n * tiles;
    const int ty0 = (tile / tiles_x) * kTH, tx0 = (tile % tiles_x) * kTW;
    de::cp_async_wait<1>();          // this thread's copies of the unit
    __syncthreads();                 // everyone's; the last unit is done
                                     // with sU / sY
    de::halo_from_raw<kRows>(sU, us, Cp, C, sRaw + buf * kRaw, h, w, ty0,
                             tx0, norm);
    __syncthreads();                 // the halo is ready; the raw buffer
                                     // is free
    stage(unit + 2 * gridDim.x, buf);
    buf ^= 1;

    float acc[NC / 2];
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) acc[e] = 0.0f;
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
      for (int cg = 0; cg < NG; ++cg)
        de::Wgmma<NC>::mma(acc, af[set][cg],
                           de::kmajor_desc(sB, s * NG + cg, NC));
      de::wg_commit();
      de::wg_wait<1>();              // the other register set is free
    }
    de::wg_wait<0>();
    __syncthreads();                 // every warp is done with the halo

    // y = bf16(acc) -> sY -> global, 16-byte runs of one channel row
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 8 * j + q2 + (e & 1);
        if (f < F)
          sY[f * kSYS + warp * 16 + g + 8 * (e >> 1)] =
              __float2bfloat16(acc[4 * j + e]);
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = threadIdx.x + k * kFwdThreads;
      const int f = j >> 4, rr = (j >> 1) & 7, half = j & 1;
      const int py = ty0 + rr, px0 = tx0 + 8 * half;
      if (f >= F || py >= h || px0 >= w) continue;
      const uint4 val =
          *reinterpret_cast<const uint4*>(sY + f * kSYS + rr * 16 + half * 8);
      bf16* dst = y + ((size_t)n * F + f) * HW + (size_t)py * w + px0;
      if (fast_y) {
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (px0 + i < w)
            dst[i] = __ushort_as_bfloat16(de::bf_bits(val, i));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (px0 + i < w) {
          const float q = de::bf_at(val, i);
          st[k][0] += q;
          st[k][1] += q * q;
        }
    }
  }

  // channel f's 16 jobs: 16 neighbouring lanes, added in a fixed order
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    float s0 = st[k][0], s1 = st[k][1];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    const int j = threadIdx.x + k * kFwdThreads, f = j >> 4;
    if ((j & 15) == 0 && f < F) {
      partials[((size_t)f * gridDim.x + blockIdx.x) * 2] = s0;
      partials[((size_t)f * gridDim.x + blockIdx.x) * 2 + 1] = s1;
    }
  }
}

template <int NG, int NC>
cudaError_t launch_fwd(const bf16* x, const bf16* wt, const float* a,
                       const float* b, bf16* y, float* partials, float* sums,
                       int cap, int N, int C, int F, int h, int w, int act,
                       cudaStream_t s) {
  constexpr int Cp = NG * 16;
  constexpr int kUY =
      kHalo * (Cp + 8) > NC * kSYS ? kHalo * (Cp + 8) : NC * kSYS;
  const size_t smem =
      sizeof(bf16) * ((size_t)9 * Cp * NC + kUY +
                      2 * (size_t)de::halo_raw_elems<kTH + 2>(Cp)) +
      sizeof(float) * 2 * Cp;
  auto kernel = convbn2d_kernel<NG, NC>;
  static int slots[16][2];
  int per_sm = 0, n_sm = 0;
  cudaError_t err =
      de::launch_shape(kernel, kFwdThreads, smem, slots, &per_sm, &n_sm);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int units = N * ((h + kTH - 1) / kTH) * tiles_x;
  const int nblk = std::min({units, std::max(per_sm, 1) * n_sm, cap});
  kernel<<<nblk, kFwdThreads, smem, s>>>(x, wt, a, b, y, partials, C, F, h,
                                         w, act, tiles_x, units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<F, 256, 0, s>>>(partials, sums, nblk);
  return cudaGetLastError();
}

// the forward at Cp = 16 NG, Fp chosen at run time
template <int NG>
cudaError_t dispatch_fwd(int Fp, const bf16* x, const bf16* wt,
                         const float* a, const float* b, bf16* y,
                         float* partials, float* sums, int cap, int N, int C,
                         int F, int h, int w, int act, cudaStream_t s) {
#define DE_FWD(fp)                                                           \
  launch_fwd<NG, fp>(x, wt, a, b, y, partials, sums, cap, N, C, F, h, w,     \
                     act, s)
  DE_SWITCH16(Fp, DE_FWD)
#undef DE_FWD
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

// The channels of ge that one raw copy of the data gradient's halo holds:
// all of them up to Fp = 48; 16 at a time above, so that the raw buffer
// does not cost a block per SM (at C = F = 64: 110 KB, two blocks)
__host__ __device__ constexpr int dx_chunk(int fp) {
  return fp >= 64 ? 16 : fp;
}

// Data gradient. ``NC`` = Cp, the wgmma N; ``NG`` = Fp / 16, the 16-channel
// groups of K per shift (both constants, so that every register operand
// of the products is known to the compiler). A block (one warpgroup) walks
// 8x16-pixel tiles in a grid-stride loop: it stages the tile's ge halo
// (10x18 pixels, Fp channels fastest) in shared memory (conv_bwd.cuh's
// two steps, copy and transpose, dx_chunk channels at a time), then per
// 3x3
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
  constexpr int kChunk = dx_chunk(Fp);
  bf16* sRaw = sU + kHalo * us;            // [kChunk, kTH + 2, kRawW]
  float* sRed = reinterpret_cast<float*>(
      sRaw + de::halo_raw_elems<kTH + 2>(kChunk));            // [4][NC][2]

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

  const bool fast = w % 8 == 0 && de::aligned16(ge);
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n = unit / tiles, tile = unit - n * tiles;
    const int ty0 = (tile / tiles_x) * kTH, tx0 = (tile % tiles_x) * kTW;
    const size_t g0 = (size_t)n * F * HW;
    for (int c0 = 0; c0 < Fp; c0 += kChunk) {
      const int nc = min(kChunk, F - c0);
      if (nc > 0)
        de::stage_halo_raw<kTH + 2>(sRaw, nc, h, w, HW, ty0, tx0,
                                    ge + g0 + (size_t)c0 * HW, fast);
      de::cp_async_commit();
      de::cp_async_wait<0>();
      __syncthreads();               // the copies landed; the last tile's
                                     // products are done with sU
      de::halo_from_raw<kTH + 2>(sU + c0, us, kChunk, nc, sRaw, h, w, ty0,
                                 tx0, [](int, float v) { return v; });
      __syncthreads();
    }

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
  const size_t smem =
      sizeof(bf16) * ((size_t)9 * NG * 16 * NC +
                      (size_t)kHalo * (NG * 16 + 8) +
                      de::halo_raw_elems<kTH + 2>(dx_chunk(NG * 16))) +
      sizeof(float) * kWarps * NC * 2;
  auto kernel = convbn2d_dx_kernel<NC, NG>;
  static int slots[16][2];
  int per_sm = 0, n_sm = 0;
  cudaError_t err =
      de::launch_shape(kernel, kThreads, smem, slots, &per_sm, &n_sm);
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

// The forward: x [N, C, h*w] bf16; w [F, C, 3, 3] bf16 (the module's
// weight, read as it is); a, b [C] f32; act 0 none, 1 relu, 2 leaky; y [N,
// F, h*w] bf16; stats [F, 2] f32; partials [F, cap, 2] f32 scratch with cap
// >= 1 (the kernel takes at most cap blocks). All contiguous. C, F <= 80.
// Two launches on ``stream``: the layer, and the fixed-order reduce of its
// per-block sums into stats.
extern "C" int convbn2d_fwd(const void* x, const void* w, const void* a,
                            const void* b, void* y, void* stats,
                            void* partials, int N, int C, int F, int h,
                            int wd, int act, int cap, void* stream) {
  const int Cp = de::round16(C), Fp = de::round16(F);
  if (bad_dims(C, Cp, F, Fp, act) || N < 1 || h < 1 || wd < 1 || cap < 1)
    return cudaErrorInvalidValue;
#define DE_FWD(cp)                                                           \
  dispatch_fwd<cp / 16>(Fp, (const bf16*)x, (const bf16*)w, (const float*)a, \
                        (const float*)b, (bf16*)y, (float*)partials,         \
                        (float*)stats, cap, N, C, F, h, wd, act,             \
                        (cudaStream_t)stream)
  DE_SWITCH16(Cp, DE_FWD)
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
                     wd, F, Cp};
#define DE_DW(np)                                                            \
  de::launch_conv_dw<np>(p, (float*)dw_partials, (float*)dw, dw_blocks,      \
                         nsplit, wgs, s)
  DE_SWITCH16(Fp, DE_DW)
#undef DE_DW
}
