// Plane-sweep stage 2, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels depthestimation_tpu/ops/sweep_pallas.py:
// _fwd_kernel (launched by _fwd_call) and _bwd_kernel (launched by
// _bwd_call), the two halves of the custom VJP of sweep_stage2. For source
// view n and depth d, over every feature channel c:
//
//   s1     = bf16(F_c . Rx_d^T)         [H, X]  bf16 x bf16 -> f32, rounded
//   warped = Ry_d . s1                  [Y, X]  f32 accumulation
//   cost  += (warped - f32(ref_c))^2
//   diag   = Ry_d . bf16(Fr[n, d] . Rx_d^T)
//
// with the TPU kernel's rounding points (sweep_pallas.py:65-70, 87, 91-93).
// The backward recomputes the forward and, with g = dcost[n, d],
//
//   dw      = 2 (warped - ref_c) g                f32
//   dfa_c  += bf16(Ry_d^T . bf16(dw)) . Rx_d      summed over d
//   dref_c -= dw                                   over d and the item's views
//   dfr_d   = bf16(Ry_d^T . bf16(ddiag[n, d])) . Rx_d
//
// (sweep_pallas.py:110-148). Rx, Ry come from poses and take no gradient.
//
// The matrices are bilinear bands: on the main path a column of Rx^T and a
// row of Ry hold at most 2 nonzeros, a row of Rx^T and a column of Ry at
// most 3. A dense product does 32x to 64x the work, and its own floor on
// the tensor cores is 4x the bytes bound, so both kernels compute on the
// bands, on the CUDA cores: every output element is a sum of at most
// 3 x 3 exact bf16 x bf16 products in f32 (tensor cores would need dense
// tiles again). What bounds them is then the instructions of those
// gathers and the latency of each block's serial walk over channels or
// depths; the bytes (each plane read once, each output written once) are
// 1/16 (forward) and 1/27 (backward) of the time on the H100.
//
// Band taps (band_taps_kernel, the first launch of either direction). One
// block per (n, d) stages Rx^T and Ry in shared memory and writes, for
// every column of Rx^T (colx), row of Rx^T (roww), row of Ry (rowy) and
// column of Ry (colh), the first nonzero, the extent's length (first to
// last nonzero) and, where it is at most kTaps long, its entries (a Tap,
// 16 bytes), and per (n, d) the longest extent of each kind. Scratch:
// N D (2 W + 2 H) 16 + 4 N D bytes (2.6 MB at N=8, D=64, 64x96).
//
// Forward (sweep_fwd_kernel). A block owns one view n, a group of G depths
// and a strip of kRows output rows; thread (j, x) owns depth d0+j, column
// x and the strip's kRows pixels of that column. It keeps their taps,
// padded to the block's longest extents (NY x NX: 1 x 2 for a sideways
// step, 2 x 2 with a forward part), as shared-memory offsets and weights
// in registers, and their costs across all channels. The feature rows the
// strip needs (the hull of its Ry extents over the group's depths) and the
// strip's ref rows of kChunk channels make one stage of a ring of kStages
// in shared memory, filled by cp.async 16 bytes a copy (each thread's
// copies decoded once where the planes are 16-byte aligned), two stages
// ahead of the one computed: one barrier per kChunk channels. The
// diagonal planes Fr[n, d] of the group's depths follow, kChunk a stage,
// each computed by its depth's threads. G: the largest group of at most 8
// depths whose block holds at most 384 threads.
//
// Backward (sweep_bwd_kernel). The TPU grid accumulates dfa over depths
// and dref over depths and views in output blocks it revisits in order;
// CUDA blocks run in no order, so a block owns its outputs: a strip of
// kRows rows of dfa and dref for one item and a group of Cg channels
// (the largest, at most 8, whose shared memory fits). Thread (q, x) takes
// column x of kCpt channels and keeps their dfa and dref rows in
// registers, written once. The block walks the item's views and depths.
// The view's feature rows and the item's ref rows are staged once, over
// the hull of every depth (the Y hull: the strip and its Ry^T extents; the
// F hull: the Ry extents of the rows each depth needs of it). Per depth
// each thread recomputes warped and dw = 2 (warped - ref) g of its
// columns and ds1 on its strip's rows from its own dw; after the depth's
// one barrier it adds ds1 . Rx of the depth before into dfa. Taps are
// padded to the item's longest extents: 1, 2, 1, 2 for rowy, colx, colh,
// roww on a sideways step, where dw covers the Y hull (the strip itself
// where Ry = I; a row another depth needs may read F rows clamped into
// the F hull, and meets only zero weights); 2, 2, 3, 3 with a forward
// part, where dw covers only the rows depth d needs (on a sideways step
// that bookkeeping cost 10%, at 1 to 2 m forward it saves 9 to 23%,
// PERF.md). Each depth's g rows (two buffers) and taps (three) arrive by
// cp.async one depth ahead. dfr is independent per (n, d): N D more
// blocks of the same launch compute one plane each. No atomics to global
// memory: each output element has one writer and sums in a fixed order,
// so two launches give equal bits.
//
// Dense inputs and steps past the buffers. The contract takes any bf16
// Rx^T and Ry. A block whose extents are longer than a bilinear band's
// (two taps a row of Ry and a column of Rx^T, three for their
// transposes), or whose hull does not fit its buffers, takes a separable
// path: per depth, s1 on the rows it needs into shared memory for as many
// channels as fit, then warped from it, the weights read from the
// matrices themselves. It is correct and slower. At the flagship's 64x96, D=64 (5 m to 40 m) the
// buffers hold a forward step (tz) of -2 m to 2.5 m, a vertical one of
// up to 1 m and a sideways one of any size; a larger step sends some
// strips of the backward to the separable path (ops/sweep_band.py models
// the decision; PERF.md times it).
//
// Limits: W up to 384 (a block's threads span a row).

#include <climits>
#include <cstdint>

#include "common.cuh"

using de::bf16;

namespace {

constexpr int kTaps = 3;      // entries of an extent kept in its Tap
constexpr int kRows = 4;      // rows of a strip
constexpr int kStages = 3;    // forward ring depth
constexpr int kChunk = 4;     // channels a forward ring stage holds
constexpr int kCpt = 2;       // channels a backward thread takes
constexpr int kMaxThreads = 384;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory
constexpr int kTapsThreads = 512;

// One extent of a band matrix's row or column: the first nonzero, the
// length from it to the last nonzero (0: all zero), and the entries where
// the length is at most kTaps (0 past it).
struct __align__(16) Tap {
  short lo, n;
  float w[kTaps];
};

// longest[nd]: the longest extent of colx, rowy, roww and colh, one byte
// each from the lowest (255 for 255 or more)
__device__ inline int longest_of(int packed, int kind) {
  return (packed >> (8 * kind)) & 0xff;
}
constexpr int kColx = 0, kRowy = 1, kRoww = 2, kColh = 3;

__device__ inline float bf(bf16 v) { return __bfloat162float(v); }

// entry k of an extent: from the Tap where it holds it, else from the
// matrix (m at the extent's base, elements ``stride`` apart)
__device__ inline float tap_w(const Tap& t, int k, const bf16* m,
                              int stride) {
  if (t.n <= kTaps) return k == 0 ? t.w[0] : (k == 1 ? t.w[1] : t.w[2]);
  return bf(m[(size_t)(t.lo + k) * stride]);
}

__device__ inline Tap tap_of(float4 v) {
  Tap t;
  const int ln = __float_as_int(v.x);          // lo in the low half
  t.lo = (short)(ln & 0xffff);
  t.n = (short)(ln >> 16);
  t.w[0] = v.y;
  t.w[1] = v.z;
  t.w[2] = v.w;
  return t;
}
__device__ inline Tap load_tap(const Tap* p) {
  return tap_of(__ldg(reinterpret_cast<const float4*>(p)));
}
__device__ inline Tap smem_tap(const Tap* p) {
  return tap_of(*reinterpret_cast<const float4*>(p));
}

// Entry k of a tap padded to K entries: weight 0 past its length.
__device__ inline float pad_w(const Tap& t, int k) {
  return k < t.n ? (k == 0 ? t.w[0] : (k == 1 ? t.w[1] : t.w[2])) : 0.0f;
}
// Index lo + k - base, clamped to [0, rows - 1], so that a padded entry
// reads a finite staged value (its weight is 0).
__device__ inline int pad_i(const Tap& t, int k, int base, int rows) {
  return min(max(t.lo + k - base, 0), rows - 1);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements of T by which a copy of ``src`` is shifted in its 16-byte
// aligned shared buffer, so that source and destination share their
// alignment and the body goes by 16-byte cp.async.
template <typename T>
__device__ inline int phase_of(const T* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) / sizeof(T)) &
               (16 / sizeof(T) - 1));
}

// The whole block copies ``count`` contiguous elements from ``src`` to
// ``dst + phase_of(src)`` (dst 16-byte aligned, with 16 / sizeof(T)
// elements of slack): the ragged head and tail by plain loads, the body
// by cp.async (the caller commits and waits).
template <typename T>
__device__ inline void stage_copy(T* dst, const T* src, int count) {
  constexpr int E = 16 / sizeof(T);
  const int ph = phase_of(src);
  T* d = dst + ph;
  const int head = min(count, (E - ph) & (E - 1));
  const int body = (count - head) / E;
  const int tail = head + body * E;
  for (int i = threadIdx.x; i < head; i += blockDim.x) d[i] = src[i];
  for (int i = threadIdx.x; i < body; i += blockDim.x)
    cp_async16(d + head + i * E, src + head + i * E);
  for (int i = tail + threadIdx.x; i < count; i += blockDim.x) d[i] = src[i];
}

__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ inline int round32(int v) { return (v + 31) & ~31; }

// ------------------------------------------------------------ band taps

// Taps of (n, d) = blockIdx.x: [colx: W][roww: W][rowy: H][colh: H]. With
// ``staged`` the two matrices are first copied to shared memory.
__global__ void __launch_bounds__(kTapsThreads)
band_taps_kernel(const bf16* __restrict__ rxt, const bf16* __restrict__ ry,
                 Tap* __restrict__ taps, int* __restrict__ longest, int H,
                 int W, int staged) {
  const int nd = blockIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_max[4];
  const bf16* mx = rxt + (size_t)nd * W * W;     // [w][x]
  const bf16* my = ry + (size_t)nd * H * H;      // [y][h]
  if (threadIdx.x < 4) s_max[threadIdx.x] = 0;
  if (staged) {
    bf16* sx = reinterpret_cast<bf16*>(smem);
    bf16* sy = sx + round8(W * W + 8);
    stage_copy(sx, mx, W * W);
    stage_copy(sy, my, H * H);
    cp_async_commit();
    cp_async_wait<0>();
    mx = sx + phase_of(mx);
    my = sy + phase_of(my);
  }
  __syncthreads();
  const int T = 2 * W + 2 * H;
  Tap* out = taps + (size_t)nd * T;
  // the Tap of the extent [lo, hi] (lo < 0: empty) of ``len`` entries of
  // ``base``, ``stride`` apart
  auto put = [&](int slot, const bf16* base, int stride, int lo, int hi) {
    Tap t;
    t.lo = (short)(lo < 0 ? 0 : lo);
    t.n = (short)(lo < 0 ? 0 : hi - lo + 1);
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      t.w[k] = (k < t.n && t.n <= kTaps)
                   ? bf(base[(size_t)(t.lo + k) * stride]) : 0.0f;
    out[slot] = t;
    return min((int)t.n, 255);
  };
  int lm[4] = {0, 0, 0, 0};   // this thread's longest extent of each kind
  // columns (colx of Rx^T, colh of Ry): a thread each, neighbouring
  // threads on neighbouring columns
  for (int i = threadIdx.x; i < W + H; i += blockDim.x) {
    const bool isx = i < W;
    const bf16* base = isx ? mx + i : my + (i - W);
    const int len = isx ? W : H, stride = isx ? W : H;
    int lo = -1, hi = -1;
    for (int k0 = 0; k0 < len; k0 += 8) {    // 8 independent loads a step
      unsigned m = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k0 + k < len && bf(base[(size_t)(k0 + k) * stride]) != 0.0f)
          m |= 1u << k;
      if (m) {
        if (lo < 0) lo = k0 + __ffs(m) - 1;
        hi = k0 + 31 - __clz(m);
      }
    }
    const int len_n = put(isx ? i : 2 * W + H + (i - W), base, stride, lo, hi);
    if (isx)
      lm[kColx] = max(lm[kColx], len_n);
    else
      lm[kColh] = max(lm[kColh], len_n);
  }
  // rows (roww of Rx^T, rowy of Ry): a warp each, 32 entries a ballot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < W + H; i += blockDim.x >> 5) {
    const bool isx = i < W;
    const bf16* base = isx ? mx + (size_t)i * W : my + (size_t)(i - W) * H;
    const int len = isx ? W : H;
    int lo = -1, hi = -1;
    for (int k0 = 0; k0 < len; k0 += 32) {
      const int k = k0 + lane;
      const unsigned m =
          __ballot_sync(0xffffffffu, k < len && bf(base[k]) != 0.0f);
      if (m) {
        if (lo < 0) lo = k0 + __ffs(m) - 1;
        hi = k0 + 31 - __clz(m);
      }
    }
    if (lane == 0) {
      const int len_n = put(isx ? W + i : 2 * W + (i - W), base, 1, lo, hi);
      if (isx)
        lm[kRoww] = max(lm[kRoww], len_n);
      else
        lm[kRowy] = max(lm[kRowy], len_n);
    }
  }
  // one shared atomic per warp and kind
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = __reduce_max_sync(0xffffffffu, lm[k]);
    if (lane == 0) atomicMax(&s_max[k], m);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    longest[nd] = s_max[0] | (s_max[1] << 8) | (s_max[2] << 16) |
                  (s_max[3] << 24);
}

// ------------------------------------------------------------ forward

struct FwdPlan {
  int G, XT, threads, capF, stage, smem, blocks;
};

// The band path of a forward block: taps padded to NY x NX.
template <int NY, int NX>
__device__ __forceinline__ void fwd_band(
    unsigned char* smem, const bf16* __restrict__ fa,
    const bf16* __restrict__ ref, const bf16* __restrict__ fr,
    float* __restrict__ cost, float* __restrict__ diag, const Tap& tx,
    const Tap (&ty)[kRows], int n, int b, int d0, int gd, int j, int x,
    bool active, int y0, int rn, int f0, int frows, int capF, int stage,
    int C1, int D, int H, int W, bool aligned) {
  const int HW = H * W;
  const int nd = n * D + d0 + j;
  // padded taps: shared-memory offsets (row * W + column) and weights
  int xo[NX];
  float wx[NX];
  int ro[kRows][NY];
  float wy[kRows][NY];
#pragma unroll
  for (int q = 0; q < NX; ++q) {
    xo[q] = pad_i(tx, q, 0, W);
    wx[q] = pad_w(tx, q);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int k = 0; k < NY; ++k) {
      ro[r][k] = pad_i(ty[r], k, f0, frows) * W;
      wy[r][k] = pad_w(ty[r], k);
    }
  auto warped = [&](const bf16* sf, int r) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NY; ++k) {
      const bf16* row = sf + ro[r][k];
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < NX; ++q) s += bf(row[xo[q]]) * wx[q];
      acc += wy[r][k] * de::round_bf16(s);
    }
    return acc;
  };

  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int fstride = round8(capF * W + 8), rstride = round8(kRows * W + 8);
  const int chunks = (C1 + kChunk - 1) / kChunk;
  const int nst = chunks + (gd + kChunk - 1) / kChunk;   // + diagonals
  auto fsrc = [&](int c) {       // channel c < C1, or diagonal plane C1 + i
    return (c < C1 ? fa + ((size_t)n * C1 + c) * HW
                   : fr + ((size_t)n * D + d0 + (c - C1)) * HW) +
           (size_t)f0 * W;
  };
  auto rsrc = [&](int c) {
    return ref + ((size_t)b * C1 + c) * HW + (size_t)y0 * W;
  };
  // Where every plane and row starts 16-byte aligned, a thread's 16-byte
  // segments of a chunk stage are the same from stage to stage but for the
  // channel: decode them once (channel in the chunk, source and shared
  // offsets in elements).
  constexpr int kSeg = 2;
  const int fseg = frows * W / 8, cseg = fseg + rn * W / 8;
  const bool planned = aligned && kChunk * cseg <= kSeg * (int)blockDim.x;
  int seg_i[kSeg], seg_src[kSeg], seg_dst[kSeg];
  bool seg_ref[kSeg];
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const int sid = threadIdx.x + k * blockDim.x;
    seg_i[k] = planned && sid < kChunk * cseg ? sid / cseg : kChunk;
    const int rem = sid - seg_i[k] * cseg;
    seg_ref[k] = rem >= fseg;
    seg_src[k] = seg_ref[k] ? (rem - fseg) * 8 : rem * 8;
    seg_dst[k] = seg_ref[k] ? kChunk * fstride + seg_i[k] * rstride +
                                  seg_src[k]
                            : seg_i[k] * fstride + seg_src[k];
  }
  auto fetch = [&](int s) {
    bf16* buf = ring + (size_t)(s % kStages) * stage;
    if (s >= chunks) {          // the diagonal planes, kChunk a stage
      const int j0 = (s - chunks) * kChunk;
      for (int i = 0; i < min(kChunk, gd - j0); ++i)
        stage_copy(buf + i * fstride, fsrc(C1 + j0 + i), frows * W);
      return;
    }
    const int c0 = s * kChunk, cn = min(kChunk, C1 - c0);
    if (planned) {
      const bf16* fb = fsrc(c0);
      const bf16* rb = rsrc(c0);
#pragma unroll
      for (int k = 0; k < kSeg; ++k)
        if (seg_i[k] < cn)
          cp_async16(buf + seg_dst[k],
                     (seg_ref[k] ? rb : fb) + (size_t)seg_i[k] * HW +
                         seg_src[k]);
      return;
    }
    for (int i = 0; i < cn; ++i) {
      stage_copy(buf + i * fstride, fsrc(c0 + i), frows * W);
      stage_copy(buf + kChunk * fstride + i * rstride, rsrc(c0 + i), rn * W);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) fetch(s);
    cp_async_commit();
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // stage s is in; s - 1 is read
    if (s + kStages - 1 < nst) fetch(s + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* buf = ring + (size_t)(s % kStages) * stage;
    if (s < chunks) {
      const int c0 = s * kChunk;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (c0 + i < C1) {
          const bf16* sf =
              buf + i * fstride + (aligned ? 0 : phase_of(fsrc(c0 + i)));
          const bf16* sr = buf + kChunk * fstride + i * rstride +
                           (aligned ? 0 : phase_of(rsrc(c0 + i))) + x;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float dv = warped(sf, r) - bf(sr[min(r, rn - 1) * W]);
            acc[r] += dv * dv;
          }
        }
      }
    } else if (j / kChunk == s - chunks) {
      const bf16* sf =
          buf + (j % kChunk) * fstride + (aligned ? 0 : phase_of(fsrc(C1 + j)));
      float* out = diag + (size_t)nd * HW + (size_t)y0 * W + x;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rn) out[r * W] = warped(sf, r);
    }
  }
  cp_async_wait<0>();
  if (active) {
    float* out = cost + (size_t)nd * HW + (size_t)y0 * W + x;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rn) out[r * W] = acc[r];
  }
}

__global__ void __launch_bounds__(kMaxThreads, 2)
sweep_fwd_kernel(const bf16* __restrict__ fa, const bf16* __restrict__ ref,
                 const bf16* __restrict__ fr, const bf16* __restrict__ rxt,
                 const bf16* __restrict__ ry, const Tap* __restrict__ taps,
                 const int* __restrict__ longest, float* __restrict__ cost,
                 float* __restrict__ diag, int V, int C1, int D, int H,
                 int W, int G, int XT, int capF, int stage) {
  const int y0 = blockIdx.x * kRows;
  const int d0 = blockIdx.y * G;
  const int n = blockIdx.z;
  const int HW = H * W, T = 2 * W + 2 * H;
  const int j = threadIdx.x / XT, x = threadIdx.x - j * XT;
  const int d = d0 + j;
  const bool active = x < W && d < D && j < G;
  const int nd = n * D + d;
  const int gd = min(G, D - d0);      // depths of this block
  const int rn = min(kRows, H - y0);  // rows of this strip
  const int b = n / V;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lo, s_hi, s_nx, s_ny;
  if (threadIdx.x == 0) { s_lo = INT_MAX; s_hi = INT_MIN; s_nx = 0; s_ny = 0; }
  __syncthreads();

  Tap tx, ty[kRows];
  if (active) {
    const Tap* t = taps + (size_t)nd * T;
    tx = load_tap(t + x);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rn) {
        ty[r] = load_tap(t + 2 * W + y0 + r);
      } else {
        ty[r].lo = 0; ty[r].n = 0;
      }
      if (x == 0 && ty[r].n > 0) {
        atomicMin(&s_lo, (int)ty[r].lo);
        atomicMax(&s_hi, ty[r].lo + ty[r].n);
      }
    }
    if (x == 0) {
      const int lg = longest[nd];
      atomicMax(&s_nx, longest_of(lg, kColx));
      atomicMax(&s_ny, longest_of(lg, kRowy));
    }
  }
  __syncthreads();
  // an empty hull stages one row anyway (all weights 0)
  const int f0 = s_hi > s_lo ? s_lo : 0;
  const int frows = s_hi > s_lo ? s_hi - s_lo : 1;
  const int nx = s_nx, ny = s_ny;
  // every plane and row 16-byte aligned: the staged copies sit at phase 0
  const bool aligned =
      W % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(fa) | reinterpret_cast<uintptr_t>(ref) |
        reinterpret_cast<uintptr_t>(fr)) & 15) == 0;

  // bilinear bands: Ry rows and Rx^T columns of at most two taps
  if (nx <= 2 && ny <= 2 && frows <= capF) {
    if (ny <= 1)        // a sideways step: Ry = I
      fwd_band<1, 2>(smem, fa, ref, fr, cost, diag, tx, ty, n, b, d0, gd, j,
                     x, active, y0, rn, f0, frows, capF, stage, C1, D, H, W,
                     aligned);
    else
      fwd_band<2, 2>(smem, fa, ref, fr, cost, diag, tx, ty, n, b, d0, gd, j,
                     x, active, y0, rn, f0, frows, capF, stage, C1, D, H, W,
                     aligned);
    return;
  }

  // ---- separable path (dense or wide extents): per channel and depth,
  // s1 on the hull rows into shared memory, then warped from it
  bf16* sS1 = reinterpret_cast<bf16*>(smem);               // [frows, W]
  float* sCost = reinterpret_cast<float*>(smem + round8(H * W) * 2);
  const int nt = blockDim.x;
  const int outs = gd * kRows * W;                         // (j, r, x)
  for (int e = threadIdx.x; e < outs; e += nt) sCost[e] = 0.0f;
  for (int s = 0; s < C1 + gd; ++s) {
    for (int jj = (s < C1 ? 0 : s - C1); jj < (s < C1 ? gd : s - C1 + 1);
         ++jj) {
      const int ndj = n * D + d0 + jj;
      const Tap* t = taps + (size_t)ndj * T;
      const bf16* F = s < C1 ? fa + ((size_t)n * C1 + s) * HW
                             : fr + (size_t)ndj * HW;
      const bf16* mx = rxt + (size_t)ndj * W * W;
      const bf16* my = ry + (size_t)ndj * H * H;
      __syncthreads();                 // the last reads of sS1 are done
      for (int e = threadIdx.x; e < frows * W; e += nt) {
        const int h = f0 + e / W, xx = e % W;
        const Tap c = load_tap(t + xx);
        float acc = 0.0f;
        for (int k = 0; k < c.n; ++k)
          acc += bf(F[(size_t)h * W + c.lo + k]) * tap_w(c, k, mx + xx, W);
        sS1[e] = __float2bfloat16(acc);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < rn * W; e += nt) {
        const int r = e / W, xx = e % W, y = y0 + r;
        const Tap c = load_tap(t + 2 * W + y);
        float acc = 0.0f;
        for (int k = 0; k < c.n; ++k)
          acc += tap_w(c, k, my + (size_t)y * H, 1) *
                 bf(sS1[(c.lo + k - f0) * W + xx]);
        if (s < C1) {
          const float dv =
              acc - bf(ref[((size_t)b * C1 + s) * HW + (size_t)y * W + xx]);
          sCost[(jj * kRows + r) * W + xx] += dv * dv;
        } else {
          diag[(size_t)ndj * HW + (size_t)y * W + xx] = acc;
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < outs; e += nt) {
    const int jj = e / (kRows * W), r = (e / W) % kRows, xx = e % W;
    if (r < rn)
      cost[((size_t)n * D + d0 + jj) * HW + (size_t)(y0 + r) * W + xx] =
          sCost[e];
  }
}

// ------------------------------------------------------------ backward

struct BwdPlan {
  int Cg, XT, QT, threads, capY, capF, smem, main_blocks, blocks;
  // shared-memory offsets in bytes
  // band path: o_f, o_ref, o_g, o_dw, o_ds, o_t; separable path: the
  // accumulators at 0, o_accref, o_sds, and s1 and dw rows from o_s1b to
  // the end (at least two [H, W] planes); dfr blocks: [H, W] bf16 at 0
  int o_f, o_ref, o_g, o_dw, o_ds, o_t, o_accref, o_sds, o_s1b;
  // elements a channel or a buffer
  int f_stride, ref_stride, g_stride, t_stride, ds_stride;
};

// The band path of a backward block: every tap padded, rowy to KY, colx
// to KX, colh to KH and roww to KW entries. dfa and dref leave from
// registers.
template <int KY, int KX, int KH, int KW>
__device__ __forceinline__ void bwd_band(
    unsigned char* smem, const BwdPlan& p, const bf16* __restrict__ fa,
    const bf16* __restrict__ ref, const Tap* __restrict__ taps,
    const float* __restrict__ gcost, float* __restrict__ dfa,
    float* __restrict__ dref, int V, int C1, int D, int H, int W, int b,
    int c0, int cn, int r0, int rn, int y0, int yrows, int f0, int frows,
    int q, int x, bool aligned) {
  const int HW = H * W, T = 2 * W + 2 * H, QT = p.QT;
  const bool xin = x < W;
  bf16* sF = reinterpret_cast<bf16*>(smem + p.o_f);       // [Cg][frows,W]
  bf16* sRef = reinterpret_cast<bf16*>(smem + p.o_ref);   // [Cg][yrows,W]
  float* sG = reinterpret_cast<float*>(smem + p.o_g);     // [2][yrows,W]
  bf16* sDW = reinterpret_cast<bf16*>(smem + p.o_dw);     // [Cg,capY,W]
  bf16* sDS = reinterpret_cast<bf16*>(smem + p.o_ds);     // [2][Cg,R,W]
  // [3][colx, roww: 2W | rowy of the Y hull: capY | colh of the strip]
  Tap* sT = reinterpret_cast<Tap*>(smem + p.o_t);
  // depth d's g rows, to buffer d % 2, and taps, to buffer d % 3
  auto fetch_step = [&](int n, int d) {
    const int nd = n * D + d;
    stage_copy(sG + (d & 1) * p.g_stride,
               gcost + (size_t)nd * HW + (size_t)y0 * W, yrows * W);
    const Tap* t = taps + (size_t)nd * T;
    Tap* dst = sT + (d % 3) * p.t_stride;
    for (int i = threadIdx.x; i < 2 * W + yrows + rn; i += blockDim.x) {
      if (i < 2 * W + yrows)          // colx, roww; then rowy from y0
        cp_async16(dst + i, i < 2 * W ? t + i : t + y0 + i);
      else                            // colh of the strip
        cp_async16(dst + 2 * W + p.capY + (i - 2 * W - yrows),
                   t + 2 * W + H + r0 + (i - 2 * W - yrows));
    }
  };
  // the staged planes' sources (their alignment phases place them)
  auto rsrc = [&](int c) {
    return ref + ((size_t)b * C1 + c0 + c) * HW + (size_t)y0 * W;
  };
  auto fsrc = [&](int n, int c) {
    return fa + ((size_t)n * C1 + c0 + c) * HW + (size_t)f0 * W;
  };
  // Thread (q, x) owns column x of channels q and q + QT of the group (the
  // plan keeps Cg <= kCpt QT): their dw and ds1, which only it reads,
  // and their dref and dfa rows in registers.
  int ch[kCpt];
  bool on[kCpt];
#pragma unroll
  for (int k = 0; k < kCpt; ++k) {
    ch[k] = q + k * QT;
    on[k] = xin && ch[k] < cn;
  }
  float aref[kCpt][kRows], afa[kCpt][kRows];
#pragma unroll
  for (int k = 0; k < kCpt; ++k)
#pragma unroll
    for (int r = 0; r < kRows; ++r) aref[k][r] = afa[k][r] = 0.0f;

  for (int c = 0; c < cn; ++c)
    stage_copy(sRef + c * p.ref_stride, rsrc(c), yrows * W);
  // dfa += ds1 . Rx at depth dd (row w = x of Rx^T), from its buffers
  auto phase_c = [&](int dd) {
    const Tap* st = sT + (dd % 3) * p.t_stride;
    const bf16* ds = sDS + (dd & 1) * p.ds_stride;
    const Tap tw = smem_tap(st + W + min(x, W - 1));
    int wo[KW];
    float ww[KW];
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      wo[i] = pad_i(tw, i, 0, W);
      ww[i] = pad_w(tw, i);
    }
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      if (!on[k]) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bf16* row = ds + (ch[k] * kRows + r) * W;
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < KW; ++i) s += bf(row[wo[i]]) * ww[i];
        afa[k][r] += s;
      }
    }
  };
  // One barrier a depth: the taps rotate through three buffers and the g
  // rows and ds1 through two, so that depth d's dw and ds1 and depth
  // d - 1's dfa share a barrier interval.
  // the thread's channels' staged ref rows, and (per view) feature rows
  const bf16* srk[kCpt];
  const bf16* sfk[kCpt];
#pragma unroll
  for (int k = 0; k < kCpt; ++k)
    srk[k] = sRef + ch[k] * p.ref_stride +
             (aligned || !on[k] ? 0 : phase_of(rsrc(ch[k])));
  for (int v = 0; v < V; ++v) {
    const int n = b * V + v;
    __syncthreads();                  // the last view's reads are done
    for (int c = 0; c < cn; ++c)
      stage_copy(sF + c * p.f_stride, fsrc(n, c), frows * W);
#pragma unroll
    for (int k = 0; k < kCpt; ++k)
      sfk[k] = sF + ch[k] * p.f_stride +
               (aligned || !on[k] ? 0 : phase_of(fsrc(n, ch[k])));
    fetch_step(n, 0);
    cp_async_commit();
    for (int d = 0; d < D; ++d) {
      const int nd = n * D + d;
      cp_async_wait<0>();
      __syncthreads();                // depth d is in; d - 1's ds1 too
      if (d + 1 < D) fetch_step(n, d + 1);
      cp_async_commit();
      const float* sg =
          sG + (d & 1) * p.g_stride +
          (aligned ? 0 : phase_of(gcost + (size_t)nd * HW + (size_t)y0 * W));
      const Tap* st = sT + (d % 3) * p.t_stride;   // this depth's taps
      bf16* sDSd = sDS + (d & 1) * p.ds_stride;
      // dw on the rows below, -dw of the strip's rows into dref; then ds1 =
      // bf16(Ry^T . bf16(dw)) on the strip's rows: the same thread's dw
      const Tap tx = smem_tap(st + min(x, W - 1));
      int xo[KX];
      float wx[KX];
#pragma unroll
      for (int i = 0; i < KX; ++i) {
        xo[i] = pad_i(tx, i, 0, W);
        wx[i] = pad_w(tx, i);
      }
      // dw of hull row yr for the thread's channels into sDW (the strip's
      // own rows r also -dw into dref)
      auto dw_row = [&](int yr, int r) {
        const Tap ty = smem_tap(st + 2 * W + yr);
        int ro[KY];
        float wy[KY];
#pragma unroll
        for (int j = 0; j < KY; ++j) {
          ro[j] = pad_i(ty, j, f0, frows) * W;
          wy[j] = pad_w(ty, j);
        }
        const float g = sg[yr * W + x];
#pragma unroll
        for (int k = 0; k < kCpt; ++k) {
          if (!on[k]) continue;
          const int c = ch[k];
          const bf16* sf = sfk[k];
          float wv = 0.0f;
#pragma unroll
          for (int j = 0; j < KY; ++j) {
            float s = 0.0f;
#pragma unroll
            for (int i = 0; i < KX; ++i) s += bf(sf[ro[j] + xo[i]]) * wx[i];
            wv += wy[j] * de::round_bf16(s);
          }
          const float rv = bf(srk[k][yr * W + x]);
          const float dw = 2.0f * (wv - rv) * g;
          sDW[(c * p.capY + yr) * W + x] = __float2bfloat16(dw);
#pragma unroll
          for (int q2 = 0; q2 < kRows; ++q2)
            if (q2 == r) aref[k][q2] -= dw;
        }
      };
      // the rows of dw, [ya, yb) of the hull: with a forward part (KH > 1)
      // those depth d needs, the strip's and its Ry^T extents at d; else
      // the whole hull (the strip's own rows where Ry = I)
      int ya = 0, yb = yrows;
      if constexpr (KH > 1) {
        ya = r0 - y0;
        yb = ya + rn;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const Tap th = smem_tap(st + 2 * W + p.capY + min(r, rn - 1));
          if (th.n > 0) {
            ya = min(ya, th.lo - y0);
            yb = max(yb, th.lo - y0 + th.n);
          }
        }
      }
      // the strip's own rows, then the rest
      if (xin) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rn) dw_row(r0 - y0 + r, r);
        for (int yr = ya; yr < yb; ++yr) {
          if (yr == r0 - y0) yr += rn;
          if (yr >= yb) break;
          dw_row(yr, -1);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rn) break;
        const Tap th = smem_tap(st + 2 * W + p.capY + r);
        int yo[KH];
        float wh[KH];
#pragma unroll
        for (int i = 0; i < KH; ++i) {
          // a padded entry (weight 0) reads a row computed above
          yo[i] = (pad_i(th, i, y0 + ya, yb - ya) + ya) * W + x;
          wh[i] = pad_w(th, i);
        }
#pragma unroll
        for (int k = 0; k < kCpt; ++k) {
          if (!on[k]) continue;
          const bf16* col = sDW + ch[k] * p.capY * W;
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < KH; ++i) s += wh[i] * bf(col[yo[i]]);
          sDSd[(ch[k] * kRows + r) * W + x] = __float2bfloat16(s);
        }
      }
      // dfa += ds1 . Rx of the depth before: its ds1 is in (barrier above)
      if (d > 0) phase_c(d - 1);
    }
    __syncthreads();                  // ds1 of the view's last depth is in
    phase_c(D - 1);
    // this view's dfa
#pragma unroll
    for (int k = 0; k < kCpt; ++k)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (on[k] && r < rn)
          dfa[((size_t)n * C1 + c0 + ch[k]) * HW + (size_t)(r0 + r) * W + x] =
              afa[k][r];
        afa[k][r] = 0.0f;
      }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < kCpt; ++k)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (on[k] && r < rn)
        dref[((size_t)b * C1 + c0 + ch[k]) * HW + (size_t)(r0 + r) * W + x] =
            aref[k][r];
}

// The rows of F one (view, depth) needs for a strip of the backward: the
// Ry extents of the rows of dw it needs (the strip and its Ry^T
// extents); (lo, hi), hi <= lo where none. Out of line: a prologue's.
__device__ __noinline__ int2 f_extent(const Tap* t, int H, int W, int r0,
                                      int rn) {
  int ya = r0, yb = r0 + rn;
  for (int r = 0; r < rn; ++r) {
    const Tap c = load_tap(t + 2 * W + H + r0 + r);
    if (c.n > 0) {
      ya = min(ya, (int)c.lo);
      yb = max(yb, c.lo + c.n);
    }
  }
  int lo = INT_MAX, hi = INT_MIN;
  for (int y = ya; y < yb; ++y) {
    const Tap c = load_tap(t + 2 * W + y);
    if (c.n > 0) {
      lo = min(lo, (int)c.lo);
      hi = max(hi, c.lo + c.n);
    }
  }
  return make_int2(lo, hi);
}

// The separable path of a backward block (dense or wide extents, or a
// hull past the buffers), out of line: it keeps its registers apart from
// the band path's.
__device__ __noinline__ void bwd_separable(
    const bf16* __restrict__ fa, const bf16* __restrict__ ref,
    const bf16* __restrict__ rxt, const bf16* __restrict__ ry,
    const Tap* __restrict__ taps, const float* __restrict__ gcost,
    float* __restrict__ dfa, float* __restrict__ dref, int V, int C1, int D,
    int H, int W, int b, int c0, int cn, int r0, int rn, int q, int x,
    int QT, int Cg, int o_accref, int o_sds, int o_s1b, int smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W, T = 2 * W + 2 * H;
  const bool xin = x < W;
  // on the rows each depth needs: dw on the strip and its Ry^T extents
  // [ya, yb), s1 on their Ry extents [fa0, fb0), for as many channels at
  // once as fit
  float* sAccFa = reinterpret_cast<float*>(smem);              // [Cg,R,W]
  float* sAccRef = reinterpret_cast<float*>(smem + o_accref);  // [Cg,R,W]
  bf16* sDS = reinterpret_cast<bf16*>(smem + o_sds);           // [Cg,R,W]
  for (int i = threadIdx.x; i < Cg * kRows * W; i += blockDim.x) {
    sAccFa[i] = 0.0f;
    sAccRef[i] = 0.0f;
  }
  bf16* sS1 = reinterpret_cast<bf16*>(smem + o_s1b);           // [cc,ns,W]
  for (int v = 0; v < V; ++v) {
    const int n = b * V + v;
    for (int d = 0; d < D; ++d) {
      const int nd = n * D + d;
      const Tap* t = taps + (size_t)nd * T;
      const bf16* mx = rxt + (size_t)nd * W * W;
      const bf16* my = ry + (size_t)nd * H * H;
      const float* g = gcost + (size_t)nd * HW;
      int ya = r0, yb = r0 + rn;
      for (int r = 0; r < rn; ++r) {
        const Tap th = load_tap(t + 2 * W + H + r0 + r);
        if (th.n > 0) {
          ya = min(ya, (int)th.lo);
          yb = max(yb, th.lo + th.n);
        }
      }
      int fa0 = H, fb0 = 0;
      for (int y = ya; y < yb; ++y) {
        const Tap ty = load_tap(t + 2 * W + y);
        if (ty.n > 0) {
          fa0 = min(fa0, (int)ty.lo);
          fb0 = max(fb0, ty.lo + ty.n);
        }
      }
      // as many channels a pass as their s1 and dw rows fit (at least
      // one: the layout holds two [H, W] planes)
      const int ns = max(fb0 - fa0, 0), ny = yb - ya;
      const int cc = min(cn, ((smem_bytes - o_s1b) / 2) / ((ns + ny) * W));
      bf16* sDWf = sS1 + cc * ns * W;                 // [cc, ny, W]
      const Tap tx = load_tap(t + min(x, W - 1));
      const Tap tw = load_tap(t + W + min(x, W - 1));
      for (int ca = 0; ca < cn; ca += cc) {
        const int ck = min(cc, cn - ca);
        __syncthreads();              // the last pass's reads are done
        if (xin)
          for (int c = 0; c < ck; ++c) {
            const bf16* F = fa + ((size_t)n * C1 + c0 + ca + c) * HW;
            for (int h = fa0 + q; h < fb0; h += QT) {
              float s = 0.0f;
              for (int k = 0; k < tx.n; ++k)
                s += bf(F[(size_t)h * W + tx.lo + k]) *
                     tap_w(tx, k, mx + x, W);
              sS1[(c * ns + h - fa0) * W + x] = __float2bfloat16(s);
            }
          }
        __syncthreads();
        if (xin)
          for (int c = 0; c < ck; ++c) {
            const bf16* R = ref + ((size_t)b * C1 + c0 + ca + c) * HW;
            for (int y = ya + q; y < yb; y += QT) {
              const Tap ty = load_tap(t + 2 * W + y);
              float wv = 0.0f;
              for (int k = 0; k < ty.n; ++k)
                wv += tap_w(ty, k, my + (size_t)y * H, 1) *
                      bf(sS1[(c * ns + ty.lo + k - fa0) * W + x]);
              const float dw = 2.0f * (wv - bf(R[(size_t)y * W + x])) *
                               g[(size_t)y * W + x];
              sDWf[(c * ny + y - ya) * W + x] = __float2bfloat16(dw);
              if (y >= r0 && y < r0 + rn)
                sAccRef[((ca + c) * kRows + y - r0) * W + x] -= dw;
            }
          }
        __syncthreads();
        if (xin)
          for (int r = q; r < rn; r += QT) {
            const Tap th = load_tap(t + 2 * W + H + r0 + r);
            for (int c = 0; c < ck; ++c) {
              float s = 0.0f;
              for (int k = 0; k < th.n; ++k)
                s += tap_w(th, k, my + r0 + r, H) *
                     bf(sDWf[(c * ny + th.lo + k - ya) * W + x]);
              sDS[((ca + c) * kRows + r) * W + x] = __float2bfloat16(s);
            }
          }
        __syncthreads();
        if (xin)
          for (int c = ca; c < ca + ck; ++c)
            for (int r = q; r < rn; r += QT) {
              float s = 0.0f;
              for (int k = 0; k < tw.n; ++k)
                s += bf(sDS[(c * kRows + r) * W + tw.lo + k]) *
                     tap_w(tw, k, mx + (size_t)x * W, 1);
              sAccFa[(c * kRows + r) * W + x] += s;
            }
      }
    }
    if (xin)
      for (int r = q; r < rn; r += QT)
        for (int c = 0; c < cn; ++c) {
          float& a = sAccFa[(c * kRows + r) * W + x];
          dfa[((size_t)n * C1 + c0 + c) * HW + (size_t)(r0 + r) * W + x] =
              a;
          a = 0.0f;
        }
  }
  // dref: every thread's last update is before this barrier
  __syncthreads();
  for (int i = threadIdx.x; i < cn * rn * W; i += blockDim.x) {
    const int c = i / (rn * W), rem = i - c * rn * W;
    const int r = rem / W, xx = rem - r * W;
    dref[((size_t)b * C1 + c0 + c) * HW + (size_t)(r0 + r) * W + xx] =
        sAccRef[(c * kRows + r) * W + xx];
  }
}

__global__ void __launch_bounds__(kMaxThreads, 2)
sweep_bwd_kernel(const bf16* __restrict__ fa, const bf16* __restrict__ ref,
                 const bf16* __restrict__ rxt, const bf16* __restrict__ ry,
                 const Tap* __restrict__ taps,
                 const int* __restrict__ longest,
                 const float* __restrict__ gcost,
                 const float* __restrict__ gdiag, float* __restrict__ dfa,
                 float* __restrict__ dref, float* __restrict__ dfr, int V,
                 int C1, int D, int H, int W, BwdPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ylo, s_yhi, s_flo, s_fhi, s_n[4];
  const int HW = H * W, T = 2 * W + 2 * H;
  const int XT = p.XT, QT = p.QT;
  const int q = threadIdx.x / XT, x = threadIdx.x - q * XT;
  const bool xin = x < W;

  if ((int)blockIdx.x >= p.main_blocks) {
    // ---- dfr of one (n, d): ds2 = bf16(Ry^T . bf16(gd)) on every row,
    // then dfr = ds2 . Rx
    const int nd = blockIdx.x - p.main_blocks;
    const Tap* t = taps + (size_t)nd * T;
    const bf16* mx = rxt + (size_t)nd * W * W;
    const bf16* my = ry + (size_t)nd * H * H;
    const float* g = gdiag + (size_t)nd * HW;
    bf16* sD = reinterpret_cast<bf16*>(smem);                // [H, W]
    if (xin) {
      for (int h = q; h < H; h += QT) {
        const Tap c = load_tap(t + 2 * W + H + h);
        float acc = 0.0f;
        for (int k = 0; k < c.n; ++k)
          acc += tap_w(c, k, my + h, H) *
                 de::round_bf16(g[(size_t)(c.lo + k) * W + x]);
        sD[h * W + x] = __float2bfloat16(acc);
      }
    }
    __syncthreads();
    if (xin) {
      const Tap c = load_tap(t + W + x);          // row w = x of Rx^T
      float* out = dfr + (size_t)nd * HW + x;
      for (int h = q; h < H; h += QT) {
        float acc = 0.0f;
        for (int k = 0; k < c.n; ++k)
          acc += bf(sD[h * W + c.lo + k]) *
                 tap_w(c, k, mx + (size_t)x * W, 1);
        out[(size_t)h * W] = acc;
      }
    }
    return;
  }

  const int strips = (H + kRows - 1) / kRows;
  const int groups = (C1 + p.Cg - 1) / p.Cg;
  const int strip = blockIdx.x % strips;
  const int cgi = (blockIdx.x / strips) % groups;
  const int b = blockIdx.x / (strips * groups);
  const int r0 = strip * kRows, rn = min(kRows, H - r0);
  const int c0 = cgi * p.Cg, cn = min(p.Cg, C1 - c0);

  // the hulls over the item's views and depths: rows of dw (the Y hull:
  // the strip and its Ry^T extents) and rows of F (the F hull: at each
  // depth the Ry extents of the rows of dw that depth needs)
  if (threadIdx.x == 0) {
    s_ylo = r0; s_yhi = r0 + rn; s_flo = INT_MAX; s_fhi = INT_MIN;
    s_n[0] = s_n[1] = s_n[2] = s_n[3] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < V * D * rn; i += blockDim.x) {
    const int vd = i / rn, r = i - vd * rn;
    const int nd = (b * V) * D + vd;          // views of b are contiguous
    const Tap c = load_tap(taps + (size_t)nd * T + 2 * W + H + r0 + r);
    if (c.n > 0) {
      atomicMin(&s_ylo, (int)c.lo);
      atomicMax(&s_yhi, c.lo + c.n);
    }
    if (r == 0) {
      const int lg = longest[nd];
#pragma unroll
      for (int k = 0; k < 4; ++k) atomicMax(&s_n[k], longest_of(lg, k));
    }
  }
  __syncthreads();
  const int y0 = s_ylo, yrows = s_yhi - s_ylo;
  const int ncx = s_n[kColx], nry = s_n[kRowy], nrw = s_n[kRoww],
            nch = s_n[kColh];
  // bilinear bands: Ry rows and Rx^T columns of at most two taps, their
  // transposes of at most three
  const bool bilinear = nry <= 2 && ncx <= 2 && nch <= kTaps && nrw <= kTaps;
  if (bilinear && yrows <= p.capY) {
    for (int vd = threadIdx.x; vd < V * D; vd += blockDim.x) {
      const int2 e =
          f_extent(taps + ((size_t)(b * V) * D + vd) * T, H, W, r0, rn);
      if (e.y > e.x) {
        atomicMin(&s_flo, e.x);
        atomicMax(&s_fhi, e.y);
      }
    }
  }
  __syncthreads();
  // an empty hull stages one row anyway (all weights 0)
  const int f0 = s_fhi > s_flo ? s_flo : 0;
  const int frows = s_fhi > s_flo ? s_fhi - s_flo : 1;

  if (bilinear && yrows <= p.capY && frows <= p.capF) {
    // every plane and row 16-byte aligned: staged copies at phase 0
    const bool aligned =
        W % 8 == 0 &&
        ((reinterpret_cast<uintptr_t>(fa) | reinterpret_cast<uintptr_t>(ref) |
          reinterpret_cast<uintptr_t>(gcost)) & 15) == 0;
    if (nry <= 1 && nch <= 1 && nrw <= 2)   // a sideways step: Ry = I
      bwd_band<1, 2, 1, 2>(smem, p, fa, ref, taps, gcost, dfa, dref, V, C1,
                           D, H, W, b, c0, cn, r0, rn, y0, yrows, f0, frows,
                           q, x, aligned);
    else
      bwd_band<2, 2, 3, 3>(smem, p, fa, ref, taps, gcost, dfa, dref, V, C1,
                           D, H, W, b, c0, cn, r0, rn, y0, yrows, f0, frows,
                           q, x, aligned);
  } else {
    bwd_separable(fa, ref, rxt, ry, taps, gcost, dfa, dref, V, C1, D, H, W,
                  b, c0, cn, r0, rn, q, x, QT, p.Cg, p.o_accref, p.o_sds,
                  p.o_s1b, p.smem);
  }
}

// ------------------------------------------------------------ plans

size_t taps_bytes(int N, int D, int H, int W) {
  return (size_t)N * D * (2 * W + 2 * H) * sizeof(Tap);
}

FwdPlan fwd_plan(int N, int D, int H, int W) {
  FwdPlan p;
  p.XT = round32(W);
  p.capF = H < kRows + 6 ? H : kRows + 6;
  // one ring stage: kChunk channels' hull rows and the strip's ref rows,
  // each with a 16-byte slack for its alignment phase
  p.stage = kChunk * (round8(p.capF * W + 8) + round8(kRows * W + 8));
  const int strips = (H + kRows - 1) / kRows;
  // The grid's threads are N D strips XT whatever the group; a larger
  // group reloads fewer feature rows, and measured no slower at N=1 and
  // N=8 (PERF.md): the largest that fits.
  int G = 8;
  while (G > 1 && G * p.XT > kMaxThreads) G /= 2;
  p.G = G;
  p.threads = G * p.XT;
  const int ring = kStages * p.stage * 2;
  const int sep = round8(H * W) * 2 + G * kRows * W * 4;  // s1, costs
  p.smem = ring > sep ? ring : sep;
  p.blocks = N * ((D + G - 1) / G) * strips;
  return p;
}

// The backward's layout for channel group Cg.
BwdPlan bwd_layout(int N, int V, int C1, int D, int H, int W, int Cg) {
  BwdPlan p;
  p.XT = round32(W);
  p.QT = p.XT >= kMaxThreads ? 1 : kMaxThreads / p.XT;
  p.threads = p.XT * p.QT;
  // rows of dw and of F the band path stages: at 64x96 they hold a
  // forward step of -2 m to 2.5 m with two blocks an SM (PERF.md)
  p.capY = H < kRows + 12 ? H : kRows + 12;
  p.capF = H < kRows + 14 ? H : kRows + 14;
  p.Cg = Cg;
  p.f_stride = round8(p.capF * W + 8);
  p.ref_stride = round8(p.capY * W + 8);
  p.g_stride = (p.capY * W + 4 + 3) & ~3;
  p.t_stride = 2 * W + p.capY + kRows;
  p.o_f = 0;
  p.o_ref = p.o_f + Cg * p.f_stride * 2;
  p.o_g = p.o_ref + Cg * p.ref_stride * 2;
  p.o_dw = p.o_g + 2 * p.g_stride * 4;
  p.ds_stride = round8(Cg * kRows * W);
  p.o_ds = p.o_dw + round8(Cg * p.capY * W) * 2;
  p.o_t = p.o_ds + 2 * p.ds_stride * 2;
  const int band_end = p.o_t + 3 * p.t_stride * (int)sizeof(Tap);
  const int acc = Cg * kRows * W * 4;
  p.o_accref = acc;
  p.o_sds = 2 * acc;
  p.o_s1b = 2 * acc + round8(Cg * kRows * W) * 2;
  const int sep_end = p.o_s1b + 2 * round8(H * W) * 2;
  p.smem = band_end > sep_end ? band_end : sep_end;
  p.main_blocks = (N / V) * ((C1 + Cg - 1) / Cg) * ((H + kRows - 1) / kRows);
  p.blocks = p.main_blocks + N * D;
  return p;
}

// The largest channel group that fits (the fewer blocks, the fewer reloads
// of the taps and g rows; measured better at N=1 and N=8 alike), asked of
// the runtime once per device and (H, W): the launcher runs twice a step.
cudaError_t bwd_plan(int N, int V, int C1, int D, int H, int W,
                     BwdPlan* out, int* per_sm) {
  struct Pick { int dev, H, W, cg, per_sm; };
  static Pick picks[32];
  static int n_picks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_picks; ++i)
    if (picks[i].dev == dev && picks[i].H == H && picks[i].W == W) {
      *out = bwd_layout(N, V, C1, D, H, W, picks[i].cg);
      *per_sm = picks[i].per_sm;
      return cudaSuccess;
    }
  // a thread takes at most kCpt channels of its group (bwd_band)
  const int qt = bwd_layout(N, V, C1, D, H, W, 1).QT;
  const int max_cg = kCpt * qt < 8 ? kCpt * qt : 8;
  for (int cg = max_cg; cg >= 1; cg /= 2) {
    *out = bwd_layout(N, V, C1, D, H, W, cg);
    *per_sm = 0;
    if (out->smem <= kMaxSmem &&
        cudaFuncSetAttribute(sweep_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out->smem) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, sweep_bwd_kernel, out->threads, out->smem) ==
            cudaSuccess &&
        *per_sm > 0)
      break;
  }
  cudaGetLastError();   // a refused query above is no launch error
  if (*per_sm <= 0) return cudaErrorInvalidConfiguration;
  if (n_picks < 32) picks[n_picks++] = {dev, H, W, out->Cg, *per_sm};
  return cudaSuccess;
}

}  // namespace

// The launch plans the entry points pick: out[0..3] = forward depth group,
// threads, shared bytes, blocks; out[4..7] = backward channel group,
// threads, shared bytes, blocks (dfr's N D included); out[8] = the
// backward's resident blocks per SM.
extern "C" int sweep_stage2_plan(int N, int V, int C1, int D, int H, int W,
                                 int* out) {
  const FwdPlan f = fwd_plan(N, D, H, W);
  BwdPlan b;
  int per_sm = 0;
  const cudaError_t err = bwd_plan(N, V, C1, D, H, W, &b, &per_sm);
  if (err != cudaSuccess) return err;
  out[0] = f.G; out[1] = f.threads; out[2] = f.smem; out[3] = f.blocks;
  out[4] = b.Cg; out[5] = b.threads; out[6] = b.smem; out[7] = b.blocks;
  out[8] = per_sm;
  return cudaSuccess;
}

static cudaError_t launch_taps(const void* rxt, const void* ry, void* scratch,
                               int N, int D, int H, int W,
                               cudaStream_t stream) {
  Tap* taps = (Tap*)scratch;
  int* longest = (int*)((char*)scratch + taps_bytes(N, D, H, W));
  // stage both matrices where they fit next to a few resident blocks
  const int smem = (round8(W * W + 8) + round8(H * H + 8)) * 2;
  const int staged = smem <= 96 * 1024;
  if (staged) {
    cudaError_t err = cudaFuncSetAttribute(
        band_taps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  band_taps_kernel<<<N * D, kTapsThreads, staged ? smem : 0, stream>>>(
      (const bf16*)rxt, (const bf16*)ry, taps, longest, H, W, staged);
  return cudaGetLastError();
}

// fa [N, C1, H, W], ref [N/V, C1, H, W], fr [N, D, H, W], rxt [N, D, W, W],
// ry [N, D, H, H], all bf16 and contiguous; cost, diag [N, D, H, W] f32;
// scratch: N D (2 W + 2 H) 16 + 4 N D bytes, 16-byte aligned.
extern "C" int sweep_stage2_fwd(const void* fa, const void* ref,
                                const void* fr, const void* rxt,
                                const void* ry, void* cost, void* diag,
                                void* scratch, int N, int V, int C1, int D,
                                int H, int W, void* stream) {
  if (N % V) return cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(N, D, H, W);
  if (p.threads > kMaxThreads) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  err = launch_taps(rxt, ry, scratch, N, D, H, W, s);
  if (err != cudaSuccess) return err;
  const Tap* taps = (const Tap*)scratch;
  const int* longest =
      (const int*)((const char*)scratch + taps_bytes(N, D, H, W));
  const dim3 grid((H + kRows - 1) / kRows, (D + p.G - 1) / p.G, N);
  sweep_fwd_kernel<<<grid, p.threads, p.smem, s>>>(
      (const bf16*)fa, (const bf16*)ref, (const bf16*)fr, (const bf16*)rxt,
      (const bf16*)ry, taps, longest, (float*)cost, (float*)diag, V, C1, D,
      H, W, p.G, p.XT, p.capF, p.stage);
  return cudaGetLastError();
}

// The backward of sweep_stage2_fwd. Inputs as there, plus gcost, gdiag
// [N, D, H, W] f32; outputs dfa [N, C1, H, W], dref [N/V, C1, H, W] and
// dfr [N, D, H, W], all f32 and contiguous.
extern "C" int sweep_stage2_bwd(const void* fa, const void* ref,
                                const void* fr, const void* rxt,
                                const void* ry, const void* gcost,
                                const void* gdiag, void* dfa, void* dref,
                                void* dfr, void* scratch, int N, int V,
                                int C1, int D, int H, int W, void* stream) {
  (void)fr;
  if (N % V) return cudaErrorInvalidValue;
  BwdPlan p;
  int per_sm = 0;
  cudaError_t err = bwd_plan(N, V, C1, D, H, W, &p, &per_sm);
  if (err != cudaSuccess) return err;
  if (p.threads > kMaxThreads) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      sweep_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  err = launch_taps(rxt, ry, scratch, N, D, H, W, s);
  if (err != cudaSuccess) return err;
  const Tap* taps = (const Tap*)scratch;
  const int* longest =
      (const int*)((const char*)scratch + taps_bytes(N, D, H, W));
  sweep_bwd_kernel<<<p.blocks, p.threads, p.smem, s>>>(
      (const bf16*)fa, (const bf16*)ref, (const bf16*)rxt, (const bf16*)ry,
      taps, longest, (const float*)gcost, (const float*)gdiag, (float*)dfa,
      (float*)dref, (float*)dfr, V, C1, D, H, W, p);
  return cudaGetLastError();
}
