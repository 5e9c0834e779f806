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
// Forward. What bounds it on the H100: one block per (n, d) walks C1 + 1
// channel planes in turn, each two small tensor-core products (64x96x96
// and 64x96x64 at the flagship 384x256 shape) separated by block-wide
// barriers. The HBM traffic is small (each view's features are read from
// L2 once per depth; only the [D, H, W] cost and diag planes are written),
// so the kernel is bound by the latency of that serial per-channel chain
// and, at batch 1, by having only N*D = 64 blocks for 132 SMs.
//
// What the design does about it: the whole per-depth working set (Rx^T,
// Ry, one feature plane, s1 in f32 and bf16, the running cost) lives in
// shared memory, so the [C, D, H, W] intermediates of the einsum form
// never reach HBM. Dimensions are zero-padded to multiples of 16 in
// shared memory so any H, W runs through 16x16x16 bf16 wmma tiles.
// Splitting channels across blocks, cp.async double buffering and the
// two-tap gather form of the band matrices are later work.
//
// Backward. The TPU grid accumulates dfa over depths and dref over depths
// and views in output blocks it revisits in order; CUDA blocks run in no
// order, so a block owns its outputs instead: one block per (batch item,
// channel) walks the item's views and, for each, the D depths, holding
// dfa_c in shared memory (f32) and updating its own dref_c plane in place
// in global memory (no other block touches it); N more blocks compute dfr,
// one per view, walking the depths. No atomics: the gradients are the same
// from run to run. Per (view, channel, depth) the block runs four products
// (the two of the forward and the two of the backward), so it is bound,
// like the forward, by the serial barrier-separated product chain, at
// about 100 KB of shared memory per block (two blocks per SM) and B*C1 + N
// blocks (544 at the flagship B=8, 68 at B=1: half the card idles at B=1).
// Splitting the depth walk across blocks needs partial sums of dfa and
// dref and is later work.

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;
using de::bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// C[M x N] (f32, ldc) = A[M x K] (bf16) . B[K x N] (bf16), all in shared
// memory, M, N, K multiples of 16. The warps split the 16x16 tiles. A is
// read row-major (A[i][k] at A[i * lda + k]) or, with kTA, as the transpose
// of a row-major matrix (A[i][k] at A[k * lda + i]); B likewise with kTB.
// With kAcc the product is added to C instead of replacing it.
template <bool kTA, bool kTB, bool kAcc>
__device__ void block_mma(const bf16* A, int lda, const bf16* B, int ldb,
                          float* C, int ldc, int M, int N, int K) {
  using LA = typename std::conditional<kTA, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<kTB, wmma::col_major,
                                       wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  const int tn = N / 16;
  const int tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += kWarps) {
    const int i = t / tn, j = t % tn;
    float* c = C + i * 16 * ldc + j * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (kAcc)
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
      wmma::load_matrix_sync(fa, kTA ? A + k * lda + i * 16
                                     : A + i * 16 * lda + k, lda);
      wmma::load_matrix_sync(fb, kTB ? B + j * 16 * ldb + k
                                     : B + k * ldb + j * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

// [rows x cols] bf16 from global (dense) into shared memory with row
// stride ld; the padding columns are left as they are.
__device__ void load_plane(bf16* dst, int ld, const bf16* __restrict__ src,
                           int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols;
    dst[r * ld + (i - r * cols)] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_stage2_kernel(const bf16* __restrict__ fa, const bf16* __restrict__ ref,
                    const bf16* __restrict__ fr, const bf16* __restrict__ rxt,
                    const bf16* __restrict__ ry, float* __restrict__ cost,
                    float* __restrict__ diag, int V, int C1, int D, int H,
                    int W) {
  const int nd = blockIdx.x;          // n * D + d
  const int n = nd / D;
  const int Hp = de::round16(H), Wp = de::round16(W);
  const int HW = H * W;

  // Rx, Ry are square (X = W, Y = H). Every region's byte size is a
  // multiple of 512, so each starts 128-byte aligned.
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sRxT = reinterpret_cast<bf16*>(smem);                 // [Wp, Wp]
  bf16* sRy = sRxT + Wp * Wp;                                  // [Hp, Hp]
  bf16* sF = sRy + Hp * Hp;                                    // [Hp, Wp]
  bf16* sS1b = sF + Hp * Wp;                                   // [Hp, Wp]
  float* sS1 = reinterpret_cast<float*>(sS1b + Hp * Wp);       // [Hp, Wp]
  float* sCost = sS1 + Hp * Wp;                                // [H * W]

  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < Wp * Wp + Hp * Hp + Hp * Wp; i += kThreads)
    sRxT[i] = zero;                    // sRxT, sRy, sF: zero padding
  for (int i = threadIdx.x; i < HW; i += kThreads) sCost[i] = 0.0f;
  __syncthreads();
  load_plane(sRxT, Wp, rxt + (size_t)nd * W * W, W, W);
  load_plane(sRy, Hp, ry + (size_t)nd * H * H, H, H);

  const bf16* ref_b = ref + (size_t)(n / V) * C1 * HW;
  for (int c = 0; c <= C1; ++c) {     // c == C1: the raw plane d (diag)
    const bf16* src = c < C1 ? fa + ((size_t)n * C1 + c) * HW
                             : fr + (size_t)nd * HW;
    load_plane(sF, Wp, src, H, W);
    __syncthreads();
    block_mma<false, false, false>(sF, Wp, sRxT, Wp, sS1, Wp, Hp, Wp,
                                   Wp);     // s1 = F . Rx^T
    __syncthreads();
    for (int i = threadIdx.x; i < Hp * Wp; i += kThreads)
      sS1b[i] = __float2bfloat16(sS1[i]);
    __syncthreads();
    block_mma<false, false, false>(sRy, Hp, sS1b, Wp, sS1, Wp, Hp, Wp,
                                   Hp);     // Ry . s1
    __syncthreads();
    if (c < C1) {
      const bf16* rc = ref_b + (size_t)c * HW;
      for (int i = threadIdx.x; i < HW; i += kThreads) {
        const int y = i / W;
        const float dv = sS1[y * Wp + (i - y * W)] - __bfloat162float(rc[i]);
        sCost[i] += dv * dv;
      }
    } else {
      float* out = diag + (size_t)nd * HW;
      for (int i = threadIdx.x; i < HW; i += kThreads) {
        const int y = i / W;
        out[i] = sS1[y * Wp + (i - y * W)];
      }
    }
    // the next iteration's first barrier orders these reads of sS1
    // before its product overwrites it
  }
  float* out = cost + (size_t)nd * HW;
  for (int i = threadIdx.x; i < HW; i += kThreads) out[i] = sCost[i];
}

// Backward; see the file comment. Blocks [0, B*C1) are (item, channel)
// blocks, blocks [B*C1, B*C1 + N) compute dfr for one view each.
__global__ void __launch_bounds__(kThreads)
sweep_stage2_bwd_kernel(const bf16* __restrict__ fa,
                        const bf16* __restrict__ ref,
                        const bf16* __restrict__ fr,
                        const bf16* __restrict__ rxt,
                        const bf16* __restrict__ ry,
                        const float* __restrict__ gcost,
                        const float* __restrict__ gdiag,
                        float* __restrict__ dfa, float* __restrict__ dref,
                        float* __restrict__ dfr, int B, int V, int C1, int D,
                        int H, int W) {
  const int Hp = de::round16(H), Wp = de::round16(W);
  const int HW = H * W, HWp = Hp * Wp;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sRxT = reinterpret_cast<bf16*>(smem);                 // [Wp, Wp]
  bf16* sRy = sRxT + Wp * Wp;                                  // [Hp, Hp]
  bf16* sF = sRy + Hp * Hp;                                    // [Hp, Wp]
  bf16* sB = sF + HWp;              // [Hp, Wp] bf16 operand: s1, dw, ds1
  float* sS = reinterpret_cast<float*>(sB + HWp);  // [Hp, Wp] products
  float* sAcc = sS + HWp;                          // [Hp, Wp] dfa_c / dfr_d

  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < Wp * Wp + Hp * Hp + 2 * HWp; i += kThreads)
    sRxT[i] = zero;          // sRxT, sRy, sF, sB: zero padding, kept so:
  __syncthreads();           // loads below write only the H x W interior

  auto load_bands = [&](int nd) {
    __syncthreads();         // the last products are done with Rx, Ry
    load_plane(sRxT, Wp, rxt + (size_t)nd * W * W, W, W);
    load_plane(sRy, Hp, ry + (size_t)nd * H * H, H, H);
  };
  auto round_products = [&]() {           // sB = bf16(sS)
    __syncthreads();
    for (int i = threadIdx.x; i < HWp; i += kThreads)
      sB[i] = __float2bfloat16(sS[i]);
    __syncthreads();
  };

  if (blockIdx.x >= B * C1) {             // dfr of view n, depth by depth
    const int n = blockIdx.x - B * C1;
    for (int d = 0; d < D; ++d) {
      const int nd = n * D + d;
      load_bands(nd);
      const float* gd = gdiag + (size_t)nd * HW;
      for (int i = threadIdx.x; i < HW; i += kThreads) {
        const int y = i / W;
        sF[y * Wp + (i - y * W)] = __float2bfloat16(gd[i]);
      }
      __syncthreads();
      block_mma<true, false, false>(sRy, Hp, sF, Wp, sS, Wp, Hp, Wp,
                                    Hp);    // ds2 = Ry^T . bf16(gd)
      round_products();
      block_mma<false, true, false>(sB, Wp, sRxT, Wp, sAcc, Wp, Hp, Wp,
                                    Wp);    // dfr = bf16(ds2) . Rx
      __syncthreads();
      float* out = dfr + (size_t)nd * HW;
      for (int i = threadIdx.x; i < HW; i += kThreads) {
        const int y = i / W;
        out[i] = sAcc[y * Wp + (i - y * W)];
      }
    }
    return;
  }

  const int b = blockIdx.x / C1, c = blockIdx.x % C1;
  const bf16* rc = ref + ((size_t)b * C1 + c) * HW;
  float* drc = dref + ((size_t)b * C1 + c) * HW;   // this block's alone
  for (int v = 0; v < V; ++v) {
    const int n = b * V + v;
    __syncthreads();                     // the last view's dfa is written
    for (int i = threadIdx.x; i < HWp; i += kThreads) sAcc[i] = 0.0f;
    load_plane(sF, Wp, fa + ((size_t)n * C1 + c) * HW, H, W);
    for (int d = 0; d < D; ++d) {
      const int nd = n * D + d;
      load_bands(nd);
      __syncthreads();
      block_mma<false, false, false>(sF, Wp, sRxT, Wp, sS, Wp, Hp, Wp,
                                     Wp);   // s1 = F . Rx^T
      round_products();
      block_mma<false, false, false>(sRy, Hp, sB, Wp, sS, Wp, Hp, Wp,
                                     Hp);   // warped = Ry . bf16(s1)
      __syncthreads();
      const float* g = gcost + (size_t)nd * HW;
      const bool first = v == 0 && d == 0;
      for (int i = threadIdx.x; i < HWp; i += kThreads) {
        const int y = i / Wp, x = i - y * Wp;
        float dw = 0.0f;
        if (y < H && x < W) {
          const int j = y * W + x;
          dw = 2.0f * (sS[i] - __bfloat162float(rc[j])) * g[j];
          drc[j] = first ? -dw : drc[j] - dw;
        }
        sB[i] = __float2bfloat16(dw);
      }
      __syncthreads();
      block_mma<true, false, false>(sRy, Hp, sB, Wp, sS, Wp, Hp, Wp,
                                    Hp);    // ds1 = Ry^T . bf16(dw)
      round_products();
      block_mma<false, true, true>(sB, Wp, sRxT, Wp, sAcc, Wp, Hp, Wp,
                                   Wp);     // dfa_c += bf16(ds1) . Rx
    }
    __syncthreads();
    float* out = dfa + ((size_t)n * C1 + c) * HW;
    for (int i = threadIdx.x; i < HW; i += kThreads) {
      const int y = i / W;
      out[i] = sAcc[y * Wp + (i - y * W)];
    }
  }
}

}  // namespace

// fa [N, C1, H, W], ref [N/V, C1, H, W], fr [N, D, H, W], rxt [N, D, W, W],
// ry [N, D, H, H], all bf16 and contiguous; cost, diag [N, D, H, W] f32.
extern "C" int sweep_stage2_fwd(const void* fa, const void* ref,
                                const void* fr, const void* rxt,
                                const void* ry, void* cost, void* diag,
                                int N, int V, int C1, int D, int H, int W,
                                void* stream) {
  const int Hp = de::round16(H), Wp = de::round16(W);
  const size_t smem =
      sizeof(bf16) * ((size_t)Wp * Wp + (size_t)Hp * Hp + 2 * (size_t)Hp * Wp) +
      sizeof(float) * ((size_t)Hp * Wp + (size_t)H * W);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  sweep_stage2_kernel<<<N * D, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)fa, (const bf16*)ref, (const bf16*)fr, (const bf16*)rxt,
      (const bf16*)ry, (float*)cost, (float*)diag, V, C1, D, H, W);
  return cudaGetLastError();
}

// The backward of sweep_stage2_fwd. Inputs as there, plus gcost, gdiag
// [N, D, H, W] f32; outputs dfa [N, C1, H, W], dref [N/V, C1, H, W] and
// dfr [N, D, H, W], all f32 and contiguous.
extern "C" int sweep_stage2_bwd(const void* fa, const void* ref,
                                const void* fr, const void* rxt,
                                const void* ry, const void* gcost,
                                const void* gdiag, void* dfa, void* dref,
                                void* dfr, int N, int V, int C1, int D, int H,
                                int W, void* stream) {
  if (N % V) return cudaErrorInvalidValue;
  const int Hp = de::round16(H), Wp = de::round16(W);
  const size_t smem =
      sizeof(bf16) * ((size_t)Wp * Wp + (size_t)Hp * Hp + 2 * (size_t)Hp * Wp) +
      sizeof(float) * 2 * (size_t)Hp * Wp;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_stage2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int B = N / V;
  sweep_stage2_bwd_kernel<<<B * C1 + N, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const bf16*)fa, (const bf16*)ref, (const bf16*)fr, (const bf16*)rxt,
      (const bf16*)ry, (const float*)gcost, (const float*)gdiag, (float*)dfa,
      (float*)dref, (float*)dfr, B, V, C1, D, H, W);
  return cudaGetLastError();
}
