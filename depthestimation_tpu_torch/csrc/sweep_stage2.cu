// Plane-sweep stage 2, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel depthestimation_tpu/ops/sweep_pallas.py:
// _fwd_kernel (launched by _fwd_call, public sweep_stage2). For source view
// n and depth d, over every feature channel c:
//
//   s1     = bf16(F_c . Rx_d^T)         [H, X]  bf16 x bf16 -> f32, rounded
//   warped = Ry_d . s1                  [Y, X]  f32 accumulation
//   cost  += (warped - f32(ref_c))^2
//   diag   = Ry_d . bf16(Fr[n, d] . Rx_d^T)
//
// with the TPU kernel's rounding points (sweep_pallas.py:65-70, 87, 91-93).
//
// What bounds it on the H100: one block per (n, d) walks C1 + 1 channel
// planes in turn, each two small tensor-core products (64x96x96 and
// 64x96x64 at the flagship 384x256 shape) separated by block-wide
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

#include "common.cuh"

using namespace nvcuda;
using de::bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// C[M x N] (f32, ldc) = A[M x K] (bf16, lda) . B[K x N] (bf16, ldb), all in
// shared memory, M, N, K multiples of 16. The warps split the 16x16 tiles.
__device__ void block_mma(const bf16* A, int lda, const bf16* B, int ldb,
                          float* C, int ldc, int M, int N, int K) {
  const int warp = threadIdx.x / 32;
  const int tn = N / 16;
  const int tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += kWarps) {
    const int i = t / tn, j = t % tn;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, A + i * 16 * lda + k, lda);
      wmma::load_matrix_sync(fb, B + k * ldb + j * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(C + i * 16 * ldc + j * 16, acc, ldc,
                            wmma::mem_row_major);
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
    block_mma(sF, Wp, sRxT, Wp, sS1, Wp, Hp, Wp, Wp);      // s1 = F . Rx^T
    __syncthreads();
    for (int i = threadIdx.x; i < Hp * Wp; i += kThreads)
      sS1b[i] = __float2bfloat16(sS1[i]);
    __syncthreads();
    block_mma(sRy, Hp, sS1b, Wp, sS1, Wp, Hp, Wp, Hp);     // Ry . s1
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
