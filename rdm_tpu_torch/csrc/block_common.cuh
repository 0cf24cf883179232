// Shared pieces of the SpatialTransformer block kernels (sm_90a).
//
// The first versions' bf16 tensor-core GEMM, kept for post_ff (csrc/
// post_ff.cu, off the default path, through post_cross_common.cuh):
// nvcuda::wmma 16x16x16 fragments with f32
// accumulation, four warps per thread block, a [BM, BN] = [32, 64] output
// tile, and the weight streamed through shared memory in [BK, BN] =
// [32, 64] chunks by double-buffered cp.async copies. The A operand is a
// [BM, K] row panel that already sits in shared memory (panel_gemm: the
// LayerNorm prologues need whole rows, so the panel is normalised once and
// reused for every output tile of the block).
//
// Layout conventions: activations are row-major [rows, C] bf16, weights are
// row-major [K, N] bf16 (x @ W), LayerNorm scales and biases are f32.
// The block-GEMM core (block_gemm_sm90.cuh, TMA + wgmma) replaced these
// loops in every other block kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace rdmk {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // four warps
constexpr int BM = 32;         // rows of an output tile
constexpr int BN = 64;         // columns of an output tile
constexpr int BK = 32;         // depth of a streamed chunk
constexpr int kLdB = BN + 8;   // shared row stride of a [BK, BN] chunk (bf16)
constexpr int kLdC = BN + 4;   // shared row stride of the f32 staging tile

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Shared row stride of a [BM, K] panel: +8 keeps rows 16-byte aligned and
// staggers banks; 16 rows then span a multiple of 32 bytes (wmma needs
// 32-byte aligned fragment pointers).
__host__ __device__ constexpr int panel_ld(int k) { return k + 8; }

__host__ __device__ constexpr size_t panel_bytes(int k) {
  return align128((size_t)BM * panel_ld(k) * sizeof(bf16));
}

// two double-buffered [BK, BN] weight chunks per weight matrix
__host__ __device__ constexpr size_t bchunk_bytes(int n_weights) {
  return align128((size_t)2 * n_weights * BK * kLdB * sizeof(bf16));
}

__host__ __device__ constexpr size_t staging_bytes(int n_tiles) {
  return align128((size_t)n_tiles * BM * kLdC * sizeof(float));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 consecutive f32 values -> 8 bf16 values in one 16-byte store.
__device__ __forceinline__ void store8(bf16* dst, const float* src) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// 8 consecutive bf16 values (16-byte aligned) -> f32.
__device__ __forceinline__ void load8(float* dst, const bf16* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Async copy of rows [r0, r0 + BM) x cols [0, K) of A (row stride lda) into
// a shared panel; rows >= R are zero-filled. K must be a multiple of 8.
__device__ __forceinline__ void load_panel_async(bf16* panel, const bf16* A,
                                                 int lda, int r0, int R,
                                                 int K) {
  const int ldp = panel_ld(K);
  const int vpr = K / 8;
  for (int i = threadIdx.x; i < BM * vpr; i += kThreads) {
    const int r = i / vpr, v = i - (i / vpr) * vpr;
    const int gr = r0 + r;
    const bool ok = gr < R;
    cp_async16(panel + r * ldp + v * 8,
               A + (size_t)(ok ? gr : 0) * lda + v * 8, ok);
  }
}

// In-place-capable LayerNorm of a [BM, K] shared panel: f32 row statistics
// (E[x^2] - E[x]^2, clamped at 0, eps 1e-5 as models.layers._RawLayerNorm),
// then, as _RawLayerNorm and the TPU kernels do in bf16, dtype-native
// arithmetic: mean, rstd, scale and bias rounded to bf16 and each of
// (src - mean), * rstd, * scale, + bias rounded to bf16. (Rounded once
// from f32 instead, ~2/3 of a RARM decode step's q values came out
// different from the plain version's, and the decode attention turned
// that into up to 2.2e-2 of its output's scale on an H100.) One warp per
// row, four warps striding over the BM rows.
__device__ __forceinline__ void layer_norm_panel(bf16* dst, const bf16* src,
                                                 int K, const float* scale,
                                                 const float* bias) {
  const int ldp = panel_ld(K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_k = 1.0f / (float)K;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const bf16* s = src + r * ldp;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float v = __bfloat162float(s[c]);
      sum += v;
      sq += v * v;
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mean = sum * inv_k;
    const float var = fmaxf(sq * inv_k - mean * mean, 0.f);
    // native bf16x2 ops: each rounds its exact result once, as the f32
    // op rounded to bf16 does. The _rn forms keep ptxas from contracting
    // the last mul and add into one fma (one rounding instead of two).
    const __nv_bfloat162 mean2 = __float2bfloat162_rn(mean);
    const __nv_bfloat162 rstd2 = __float2bfloat162_rn(rsqrtf(var + 1e-5f));
    bf16* d = dst + r * ldp;
    for (int c = 2 * lane; c < K; c += 64) {
      const float2 g = __ldg(reinterpret_cast<const float2*>(scale + c));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + c));
      __nv_bfloat162 y = __hsub2_rn(
          *reinterpret_cast<const __nv_bfloat162*>(s + c), mean2);
      y = __hmul2_rn(__hmul2_rn(y, rstd2), __float22bfloat162_rn(g));
      *reinterpret_cast<__nv_bfloat162*>(d + c) =
          __hadd2_rn(y, __float22bfloat162_rn(bb));
    }
  }
}

// Async copy of rows [k0, k0 + BK) x cols [n0, n0 + BN) of W ([K, N]
// row-major) into a [BK, BN] chunk; columns >= N are zero-filled. N must be
// a multiple of 8.
__device__ __forceinline__ void load_bchunk_async(bf16* bs, const bf16* W,
                                                  int N, int k0, int n0) {
  for (int i = threadIdx.x; i < BK * BN / 8; i += kThreads) {
    const int r = i / (BN / 8), v = i - (i / (BN / 8)) * (BN / 8);
    const int gc = n0 + v * 8;
    const bool ok = gc < N;
    cp_async16(bs + r * kLdB + v * 8,
               W + (size_t)(k0 + r) * N + (ok ? gc : 0), ok);
  }
}

// Warp tiling of the [BM, BN] = [32, 64] tile: 2 x 2 warps, each owning a
// [16, 32] sub-tile = two 16x16 accumulator fragments.
__device__ __forceinline__ int warp_row() { return (threadIdx.x >> 5) >> 1; }
__device__ __forceinline__ int warp_col() { return (threadIdx.x >> 5) & 1; }

// acc[w] = panel[BM, K] @ W_w[:, n0:n0+BN] for NW weight matrices that share
// the A fragments (NW = 2 runs the GEGLU value and gate halves together).
// The panel must be complete and visible (caller waited and synced), and no
// cp.async group may be pending. bs holds bchunk_bytes(NW).
template <int NW>
__device__ __forceinline__ void panel_gemm(FragC (&acc)[NW][2],
                                           const bf16* panel, int K,
                                           const bf16* const* W, int N,
                                           int n0, bf16* bs) {
  const int ldp = panel_ld(K);
  const int wm = warp_row(), wn = warp_col();
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    wmma::fill_fragment(acc[w][0], 0.f);
    wmma::fill_fragment(acc[w][1], 0.f);
  }
  const int nk = K / BK;
  const int stage = NW * BK * kLdB;
#pragma unroll
  for (int w = 0; w < NW; ++w)
    load_bchunk_async(bs + w * BK * kLdB, W[w], N, 0, n0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      bf16* nxt = bs + ((kc + 1) & 1) * stage;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        load_bchunk_async(nxt + w * BK * kLdB, W[w], N, (kc + 1) * BK, n0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk kc has landed
    __syncthreads();
    const bf16* cur = bs + (kc & 1) * stage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, panel + (wm * 16) * ldp + kc * BK + kk, ldp);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB fb;
          wmma::load_matrix_sync(
              fb, cur + w * BK * kLdB + kk * kLdB + wn * 32 + j * 16, kLdB);
          wmma::mma_sync(acc[w][j], fa, fb, acc[w][j]);
        }
      }
    }
    __syncthreads();  // the buffer just read is refilled two chunks later
  }
  cp_async_wait<0>();
}

// Spill a warp's two accumulator fragments into the [BM, BN] f32 staging
// tile; the caller syncs before reading it back.
__device__ __forceinline__ void store_acc(float* cs, FragC (&acc)[2]) {
  const int wm = warp_row(), wn = warp_col();
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(cs + (wm * 16) * kLdC + wn * 32 + j * 16, acc[j],
                            kLdC, wmma::mem_row_major);
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rdmk
