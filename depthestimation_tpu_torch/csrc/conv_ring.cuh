// The depth-ring conv kernel on wgmma, shared by Base3D's fused layer
// (convcomb.cu, convcomb_fwd) and the flat 3x3x3 conv op in bf16
// (conv3d_flat.cu, conv3d_flat_fwd: the forward and its data gradient).
//
// A block (one warpgroup) owns a 4x16-pixel tile of one item's depth
// segment of up to ``seg`` output rows and walks the input rows m = d0 - 1
// .. d1 in order. The raw rows arrive by cp.async two units ahead of the one
// that computes (a unit: one input row, or in the conv3d mode one K chunk
// of at most Cp input channels of it), each is turned once into a
// channels-fastest 6x18-pixel halo in shared memory (conv_bwd.cuh,
// halo_from_raw: the Base3D mode normalizes there, the conv3d mode copies),
// and per 3x3 shift s the warps load their A fragments (warp w: tile row w,
// 16 pixels) from the halo by ldmatrix, alternating two register sets, and
// issue the product against B = [9 Cp, 3 S] (the three depth taps stacked
// on N, column t*S + f) in shared memory. The ring runs on the f32
// accumulators in registers:
//   y(m-1)  = T(part(m-1) + T(t2(m)))
//   part(m) = T(t1(m)) + T(t0(m-1))   [the t0 term iff m > 0]
// with T the rounding to bf16. Base3D's layer rounds part(m) too
// (convcomb_pallas.py:85-93); the conv3d op does not (its taps are added
// in f32 and rounded once, conv3d_pallas.py:92-104). y(m-1) leaves through
// shared memory as 16-byte runs of one channel row.
//
// The two modes (template flag C3):
// - Base3D (C3 = false): x normalized on load (u = bf16(act(x a + b))),
//   B built from wm [3F, C, 3, 3] once per block, C, F <= 32, and each
//   block's (sum y, sum y^2) per channel into ``partials`` [F, nblk, 2].
// - conv3d (C3 = true): no normalize and no statistics; any C and F. K runs
//   in chunks of Cp input channels (the halo holds one chunk), and the
//   output channels in groups of S = 32 on blockIdx.z. B is read from the
//   op's own weight [F5, C5, 3, 3, 3] (f32 or bf16, rounded to bf16 here):
//   B[s*Cp + k][t*S + o] = W5[o, k, t, s], or with ``flip`` (the data
//   gradient) W5[k, o, 2 - t, 8 - s], flipped and transposed by index. All
//   chunks' B stay in shared memory when they fit (``resident``), else the
//   block rebuilds the chunk's B before its products.
#pragma once

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "conv_bwd.cuh"
#include "wgmma.cuh"

namespace de {
namespace ring {

constexpr int kThreads = 128;
constexpr int kTH = 4, kTW = 16;           // output tile: 4 rows x 16 cols
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;  // 108 halo pixels
constexpr int kSYS = kTH * kTW + 8;        // y tile row stride: +16 B

struct Args {
  const bf16* x;          // [N, C, h*w]
  const void* wt;         // Base3D: wm [3F, C, 3, 3] bf16; conv3d: W5
  const float* a;         // Base3D: the normalize, [C] each
  const float* b;
  bf16* y;                // [N, F, h*w]
  float* partials;        // Base3D: [F, nblk, 2]
  int C, F, depth, h, w, relu, seg, nseg, tiles_x;
  int w_f32, flip, w5_dim1, resident;     // conv3d only
};

// put(i, v) for every element i < n of f32 ``src``, four 16-byte loads in
// flight per thread where aligned
template <class Put>
__device__ inline void for_each_f32(const float* __restrict__ src, int n,
                                    Put put) {
  const int n4 = aligned16(src) ? n / 4 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int j0 = threadIdx.x; j0 < n4; j0 += 4 * blockDim.x) {
    float4 r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < n4) r[k] = __ldg(src4 + j);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < n4) {
        put(4 * j, r[k].x);
        put(4 * j + 1, r[k].y);
        put(4 * j + 2, r[k].z);
        put(4 * j + 3, r[k].w);
      }
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) put(i, src[i]);
}

// the dynamic shared memory of the kernel at (NG, S), with ``nres`` chunks
// of B resident and (Base3D) the normalize's a, b
template <int NG, int S>
__host__ __device__ constexpr size_t smem_bytes(int nres, bool with_ab) {
  return sizeof(bf16) * ((size_t)nres * 9 * NG * 16 * 3 * S +
                         (size_t)kHalo * (NG * 16 + 8) + (size_t)S * kSYS +
                         2 * (size_t)halo_raw_elems<kTH + 2>(NG * 16)) +
         (with_ab ? sizeof(float) * 2 * NG * 16 : 0);
}

// ``NG`` = Cp / 16, the 16-channel groups of K per shift; ``S`` = the tap
// stride (8, 16 or 32 >= the block's output channels): the three taps'
// products are one wgmma with N = 3 S, so that every thread holds all three
// taps of its channels (the ring needs no shuffle) and F = 1 takes N = 24.
template <int NG, int S, bool C3>
static __global__ void __launch_bounds__(kThreads)
ring_kernel(Args p) {
  constexpr int Cp = NG * 16, NP = 3 * S, K = 9 * Cp, us = Cp + 8;
  constexpr int kRows = kTH + 2;
  constexpr int kRaw = halo_raw_elems<kRows>(Cp);
  constexpr int kSlots = (8 * S + kThreads - 1) / kThreads;
  const bf16* __restrict__ x = p.x;
  bf16* __restrict__ y = p.y;
  const int C = p.C, depth = p.depth, h = p.h, w = p.w;
  const int HW = h * w;
  const int ty0 = (blockIdx.x / p.tiles_x) * kTH;
  const int tx0 = (blockIdx.x % p.tiles_x) * kTW;
  const int item = blockIdx.y / p.nseg;
  const int d0 = (blockIdx.y % p.nseg) * p.seg;
  const int d1 = min(d0 + p.seg, depth);
  const int nblk = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the block's output channels: o0 .. o0 + F - 1 of y's Fy
  const int o0 = C3 ? blockIdx.z * S : 0;
  const int Fy = p.F;
  const int F = C3 ? min(S, Fy - o0) : Fy;
  const int nch = C3 ? (C + Cp - 1) / Cp : 1;       // K chunks
  const bool resident = !C3 || p.resident;
  const int nres = C3 && p.resident ? nch : 1;      // chunks of B in smem

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem);          // [nres][K, NP]
  bf16* sU = sB + (size_t)nres * K * NP;              // [kHalo, us]
  bf16* sY = sU + kHalo * us;                         // [S, kSYS]
  bf16* sRaw = sY + S * kSYS;                         // [2][kRaw]
  float* sAB = reinterpret_cast<float*>(sRaw + 2 * kRaw);   // a, b [2][Cp]

  const int m_begin = d0 > 0 ? d0 - 1 : 0;
  const int m_end = d1 < depth ? d1 : depth - 1;
  const int units = (m_end - m_begin + 1) * nch;
  const bf16* xi = x + (size_t)item * depth * C * HW;
  const bool fast = w % 8 == 0 && aligned16(x);
  const bool fast_y = w % 8 == 0 && aligned16(y);
  // unit u's raw copies (input row m_begin + u / nch, chunk u % nch) into
  // buffer ``buf``, one cp.async group (committed even when empty, so that
  // the group count is the unit count)
  auto stage = [&](int u, int buf) {
    if (u < units) {
      if constexpr (C3) {
        const int r = u / nch, cc = u - r * nch;
        stage_halo_raw<kRows>(sRaw + buf * kRaw, min(Cp, C - cc * Cp), h, w,
                              HW, ty0, tx0,
                              xi + ((size_t)(m_begin + r) * C + cc * Cp) * HW,
                              fast);
      } else {
        stage_halo_raw<kRows>(sRaw + buf * kRaw, C, h, w, HW, ty0, tx0,
                              xi + (size_t)(m_begin + u) * C * HW, fast);
      }
    }
    cp_async_commit();
  };
  stage(0, 0);
  stage(1, 1);

  const uint4 z4 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < nres * K * NP / 8; i += kThreads)
    reinterpret_cast<uint4*>(sB)[i] = z4;
  if constexpr (!C3)
    for (int i = threadIdx.x; i < 2 * Cp; i += kThreads) {
      const int c = i < Cp ? i : i - Cp;
      sAB[i] = c < C ? (i < Cp ? p.a[c] : p.b[c]) : 0.0f;
    }
  __syncthreads();
  // W5 -> B of the chunks k_lo / Cp .. (the ones resident; slot 0 when
  // one chunk is): the rows of W5 that hold them, skipping the elements of
  // other output channels or chunks
  auto build_w5 = [&](int k_lo, int k_hi) {
    const int D1 = p.w5_dim1;
    const int lo = p.flip ? k_lo : o0, hi = p.flip ? k_hi : o0 + F;
    const int off = lo * D1 * 27, n = (hi - lo) * D1 * 27;
    const float inv27 = 1.0f / 27, inv_d1 = 1.0f / D1;
    auto put = [&](int i, bf16 v) {
      const int pair = div_small(i, 27, inv27), ts = i - pair * 27;
      const int a_ = lo + div_small(pair, D1, inv_d1);
      const int b_ = pair - (a_ - lo) * D1;
      const int o = p.flip ? b_ : a_, k = p.flip ? a_ : b_;
      if (o < o0 || o >= o0 + F || k < k_lo || k >= k_hi) return;
      const int t0 = ts / 9, s0 = ts - t0 * 9;
      const int t = p.flip ? 2 - t0 : t0, s = p.flip ? 8 - s0 : s0;
      const int slot = (k - k_lo) / Cp, kl = k - k_lo - slot * Cp;
      sB[(size_t)slot * K * NP + kmajor_off(s * Cp + kl, t * S + o - o0, NP)] =
          v;
    };
    if (p.w_f32)
      for_each_f32(reinterpret_cast<const float*>(p.wt) + off, n,
                   [&](int i, float v) { put(i, __float2bfloat16(v)); });
    else
      for_each_bf16(reinterpret_cast<const bf16*>(p.wt) + off, n,
                    [&](int i, unsigned short v) {
                      put(i, __ushort_as_bfloat16(v));
                    });
  };
  if constexpr (!C3) {
    // wm [3F, C, 3, 3]: row t*F + f, column c, shift s -> B[s*Cp + c][t*S + f]
    const float inv_c9 = 1.0f / (C * 9), inv_f = 1.0f / F;
    for_each_bf16(reinterpret_cast<const bf16*>(p.wt), 3 * F * C * 9,
                  [&](int i, unsigned short v) {
                    const int tf = div_small(i, C * 9, inv_c9);
                    const int rem = i - tf * C * 9;
                    const int c = rem / 9, s = rem - c * 9;
                    const int t = div_small(tf, F, inv_f), f = tf - t * F;
                    sB[kmajor_off(s * Cp + c, t * S + f, NP)] =
                        __ushort_as_bfloat16(v);
                  });
  } else if (resident) {
    build_w5(0, C);
  }
  fence_proxy_async();
  const int act = p.relu ? kActRelu : kActNone;
  auto norm = [&](int c, float v) {
    if constexpr (C3)
      return v;
    else
      return act_fwd(affine(v, sAB[c], sAB[Cp + c]), act);
  };

  // ldmatrix rows: pixel p of the warp's tile row, channel half ch
  const int pa = (lane & 7) + ((lane >> 3) & 1) * 8, ch = (lane >> 4) * 8;
  const unsigned ab = smem_addr(sU + (warp * kHaloW + pa) * us + ch);
  // accumulator element e of n8 group j: pixel g (+8 for e >= 2) of the
  // warp's tile row, column 8j + q2 (+1 for odd e)
  const int g = lane >> 2, q2 = (lane & 3) * 2;

  float part[S / 2], t0p[S / 2], st[kSlots][2];
#pragma unroll
  for (int e = 0; e < S / 2; ++e) part[e] = t0p[e] = 0.0f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) st[k][0] = st[k][1] = 0.0f;

  // row r's y (this thread's S/2 values) -> sY -> global as 16-byte runs:
  // job j = 8f + 2 * tile row + half, eight pixels of channel f
  auto emit = [&](int r, const float (&v)[S / 2]) {
#pragma unroll
    for (int jf = 0; jf < S / 8; ++jf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 8 * jf + q2 + (e & 1);
        if (f < F)
          sY[f * kSYS + warp * 16 + g + 8 * (e >> 1)] =
              __float2bfloat16(v[4 * jf + e]);
      }
    __syncthreads();
    const size_t row = (size_t)item * depth + r;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = threadIdx.x + k * kThreads;
      const int f = j >> 3, rr = (j >> 1) & 3, half = j & 1;
      const int py = ty0 + rr, px0 = tx0 + 8 * half;
      if (f >= F || py >= h || px0 >= w) continue;
      const uint4 val =
          *reinterpret_cast<const uint4*>(sY + f * kSYS + rr * 16 + half * 8);
      bf16* dst = y + (row * Fy + o0 + f) * HW + (size_t)py * w + px0;
      if (fast_y) {
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (px0 + i < w) dst[i] = __ushort_as_bfloat16(bf_bits(val, i));
      }
      if constexpr (C3) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (px0 + i < w) {
          const float q = bf_at(val, i);
          st[k][0] += q;
          st[k][1] += q * q;
        }
    }
  };

  int buf = 0, u = 0;
  for (int m = m_begin; m <= m_end; ++m) {
    float acc[NP / 2];
    for (int cc = 0; cc < nch; ++cc) {   // unit u: chunk cc of row m
      cp_async_wait<1>();            // this thread's copies of unit u landed
      __syncthreads();               // everyone's; the last unit is done
                                     // with sU, sY (and a rebuilt sB)
      if constexpr (C3) {
        halo_from_raw<kRows>(sU, us, Cp, min(Cp, C - cc * Cp),
                             sRaw + buf * kRaw, h, w, ty0, tx0, norm);
        if (!resident) {             // this chunk's B
          for (int i = threadIdx.x; i < K * NP / 8; i += kThreads)
            reinterpret_cast<uint4*>(sB)[i] = z4;
          __syncthreads();
          build_w5(cc * Cp, min(C, cc * Cp + Cp));
          fence_proxy_async();
        }
      } else {
        halo_from_raw<kRows>(sU, us, Cp, C, sRaw + buf * kRaw, h, w, ty0,
                             tx0, norm);
      }
      __syncthreads();               // the halo is ready; the raw buffer
                                     // is free
      stage(u + 2, buf);
      buf ^= 1;
      ++u;
      if (cc == 0) {
#pragma unroll
        for (int e = 0; e < NP / 2; ++e) acc[e] = 0.0f;
      }

      const bf16* sBc = sB + (size_t)(C3 && resident ? cc : 0) * K * NP;
      unsigned af[2][NG][4];         // [register set][group]
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const int set = s & 1;
        const unsigned off =
            ab + (unsigned)(((s / 3) * kHaloW + s % 3) * us * sizeof(bf16));
#pragma unroll
        for (int cg = 0; cg < NG; ++cg)
          ldmatrix_x4_addr(af[set][cg], off + cg * 32);
        wg_fence();
#pragma unroll
        for (int cg = 0; cg < NG; ++cg)
          Wgmma<NP>::mma(acc, af[set][cg], kmajor_desc(sBc, s * NG + cg, NP));
        wg_commit();
        wg_wait<1>();                // the other register set is free
      }
      wg_wait<0>();
    }

    const bool out = m - 1 >= d0 && m - 1 < d1;
    const bool in = m >= d0 && m < d1;
    auto rnd = [](float v) { return round_bf16(v); };
    float yv[S / 2];
#pragma unroll
    for (int jf = 0; jf < S / 8; ++jf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jf + e;
        const float t0 = acc[4 * jf + e], t1 = acc[4 * (S / 8 + jf) + e];
        const float t2 = acc[4 * (2 * (S / 8) + jf) + e];
        yv[i] = rnd(part[i] + rnd(t2));
        if (in) {
          const float t1r = rnd(t1);
          const float sum = C3 ? t1r + t0p[i] : rnd(t1r + t0p[i]);
          part[i] = m > 0 ? sum : t1r;
        }
        t0p[i] = rnd(t0);
      }
    if (out) emit(m - 1, yv);
  }
  if (d1 == depth) {                 // the top row: no upper tap
    __syncthreads();                 // the last row's stores read sY
    emit(depth - 1, part);
  }
  if constexpr (C3) return;

  // channel f's eight jobs are eight neighbouring lanes: add them in a
  // fixed order, then the lane of job 8f writes the block's sums
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    float s0 = st[k][0], s1 = st[k][1];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    const int j = threadIdx.x + k * kThreads, f = j >> 3;
    if ((j & 7) == 0 && f < F) {
      p.partials[((size_t)f * nblk + bid) * 2] = s0;
      p.partials[((size_t)f * nblk + bid) * 2 + 1] = s1;
    }
  }
}

// fn(NG, S) as std::integral_constant values for C input channels (a
// chunk of at most 32) and F output channels (a group of at most 32)
template <class Fn>
cudaError_t with_shape(int C, int F, Fn fn) {
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using S8 = std::integral_constant<int, 8>;
  using S16 = std::integral_constant<int, 16>;
  using S32 = std::integral_constant<int, 32>;
  if (C <= 16)
    return F <= 8 ? fn(I1{}, S8{}) : F <= 16 ? fn(I1{}, S16{})
                                              : fn(I1{}, S32{});
  return F <= 8 ? fn(I2{}, S8{}) : F <= 16 ? fn(I2{}, S16{})
                                            : fn(I2{}, S32{});
}

// Output rows per block: the length of (64, 32, 16, 8, 4) that minimizes
// the waves of resident blocks times the rows a block stages,
// ceil(blocks / slots) * (min(seg, depth) + 2), the longest on a tie
// (ops/convcomb_kernel.py:forward_segment, the same model)
inline int forward_segment(int items, int depth, int tiles, int slots) {
  int best = 64;
  long best_cost = -1;
  for (int seg : {64, 32, 16, 8, 4}) {
    const long blocks = (long)tiles * items * ((depth + seg - 1) / seg);
    const long cost =
        ((blocks + slots - 1) / slots) * (std::min(seg, depth) + 2);
    if (best_cost < 0 || cost < best_cost) {
      best = seg;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace ring
}  // namespace de
