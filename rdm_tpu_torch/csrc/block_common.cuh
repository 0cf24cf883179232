// Shared pieces of the SpatialTransformer block kernels (sm_90a).
//
// Every block kernel is a bf16 tensor-core GEMM with its own prologue and
// epilogue. The GEMM here is deliberately plain: nvcuda::wmma 16x16x16
// fragments with f32 accumulation, four warps per thread block, a
// [BM, BN] = [32, 64] output tile, and the weight streamed through shared
// memory in [BK, BN] = [32, 64] chunks by double-buffered cp.async copies.
// Two main loops exist:
//
//   panel_gemm    - the A operand is a [BM, K] row panel that already sits
//                   in shared memory (the LayerNorm prologues need whole
//                   rows, so the panel is normalised once and reused for
//                   every output tile of the block);
//   streamed_gemm - A is streamed from global memory like B (used where K
//                   is the GEGLU hidden width, too wide for a panel).
//
// Layout conventions: activations are row-major [rows, C] bf16, weights are
// row-major [K, N] bf16 (x @ W), LayerNorm scales and biases are f32.
// wgmma, TMA and warp specialisation are left for later revisions.
//
// Both main loops also take int8 weights [K, N] with one bf16 scale per
// output column (the RARM int8_weights mode, rdm_tpu/ops/decode_kernel.py
// `_wdot`): an overload of the same loop brings each [BK, BN] int8 chunk
// in by cp.async (half the bytes of a bf16 chunk), widens it to bf16 in
// shared memory (exact: |code| <= 127) and runs the same wmma steps; the
// caller's epilogue multiplies the f32 product by the column's scale
// (`wscale`). The bf16 loops are untouched by it.
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
constexpr int kLdA = BK + 8;   // shared row stride of a streamed [BM, BK] chunk
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

// acc = A[r0:r0+BM, :K] @ W[:K, n0:n0+BN], both operands streamed from
// global memory through double-buffered shared chunks. as holds
// 2 * BM * kLdA bf16, bs holds bchunk_bytes(1). Rows >= R read as zero.
__device__ __forceinline__ void streamed_gemm(FragC (&acc)[2], const bf16* A,
                                              int R, int K, const bf16* W,
                                              int N, int r0, int n0,
                                              bf16* as, bf16* bs) {
  const int wm = warp_row(), wn = warp_col();
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const int nk = K / BK;
  auto load_a = [&](bf16* dst, int k0) {
    // [BM, BK] = 32 x 32 bf16 = 128 16-byte vectors, one per thread
    for (int i = threadIdx.x; i < BM * BK / 8; i += kThreads) {
      const int r = i / (BK / 8), v = i - (i / (BK / 8)) * (BK / 8);
      const int gr = r0 + r;
      const bool ok = gr < R;
      cp_async16(dst + r * kLdA + v * 8,
                 A + (size_t)(ok ? gr : 0) * K + k0 + v * 8, ok);
    }
  };
  load_a(as, 0);
  load_bchunk_async(bs, W, N, 0, n0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load_a(as + ((kc + 1) & 1) * BM * kLdA, (kc + 1) * BK);
      load_bchunk_async(bs + ((kc + 1) & 1) * BK * kLdB, W, N, (kc + 1) * BK,
                        n0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ca = as + (kc & 1) * BM * kLdA;
    const bf16* cb = bs + (kc & 1) * BK * kLdB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, ca + (wm * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, cb + kk * kLdB + wn * 32 + j * 16, kLdB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// ------------------------------------------------- int8 weight operand
//
// In the bchunk_bytes(NW) region an int8 loop keeps one bf16 [BK, BN] chunk
// per weight (NW * BK * kLdB bf16, what the wmma steps read) followed by
// the double-buffered int8 staging (2 * NW * BK * BN bytes): 8704 * NW
// bytes of the 9216 * NW a bf16 loop uses.
constexpr int kChunk8 = BK * BN;  // bytes of one int8 [BK, BN] chunk

__device__ __forceinline__ int8_t* stage8(bf16* bs, int n_weights) {
  return reinterpret_cast<int8_t*>(bs + n_weights * BK * kLdB);
}

// Async copy of rows [k0, k0 + BK) x cols [n0, n0 + BN) of an int8 W ([K,
// N] row-major, N a multiple of 16) into a dense [BK, BN] chunk: one
// 16-byte vector per thread; columns >= N are zero-filled.
__device__ __forceinline__ void load_bchunk_async(int8_t* bs, const int8_t* W,
                                                  int N, int k0, int n0) {
  for (int i = threadIdx.x; i < kChunk8 / 16; i += kThreads) {
    const int r = i / (BN / 16), v = i - (i / (BN / 16)) * (BN / 16);
    const int gc = n0 + v * 16;
    const bool ok = gc < N;
    cp_async16(bs + r * BN + v * 16,
               W + (size_t)(k0 + r) * N + (ok ? gc : 0), ok);
  }
}

// A dense int8 [BK, BN] chunk -> bf16 [BK, BN] at row stride kLdB.
__device__ __forceinline__ void widen_chunk(bf16* dst, const int8_t* src) {
  for (int i = threadIdx.x; i < kChunk8 / 16; i += kThreads) {
    const int r = i / (BN / 16), v = i - (i / (BN / 16)) * (BN / 16);
    const int4 u = *reinterpret_cast<const int4*>(src + r * BN + v * 16);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
    uint4 o[2];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      h[j] = __floats2bfloat162_rn((float)c[2 * j], (float)c[2 * j + 1]);
    uint4* d = reinterpret_cast<uint4*>(dst + r * kLdB + v * 16);
    d[0] = o[0];
    d[1] = o[1];
  }
}

// panel_gemm with int8 weights (unscaled f32 products; see wscale).
template <int NW>
__device__ __forceinline__ void panel_gemm(FragC (&acc)[NW][2],
                                           const bf16* panel, int K,
                                           const int8_t* const* W, int N,
                                           int n0, bf16* bs) {
  const int ldp = panel_ld(K);
  const int wm = warp_row(), wn = warp_col();
  int8_t* s8 = stage8(bs, NW);
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    wmma::fill_fragment(acc[w][0], 0.f);
    wmma::fill_fragment(acc[w][1], 0.f);
  }
  const int nk = K / BK;
#pragma unroll
  for (int w = 0; w < NW; ++w)
    load_bchunk_async(s8 + w * kChunk8, W[w], N, 0, n0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      int8_t* nxt = s8 + ((kc + 1) & 1) * NW * kChunk8;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        load_bchunk_async(nxt + w * kChunk8, W[w], N, (kc + 1) * BK, n0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk kc has landed
    __syncthreads();
#pragma unroll
    for (int w = 0; w < NW; ++w)
      widen_chunk(bs + w * BK * kLdB, s8 + ((kc & 1) * NW + w) * kChunk8);
    __syncthreads();
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
              fb, bs + w * BK * kLdB + kk * kLdB + wn * 32 + j * 16, kLdB);
          wmma::mma_sync(acc[w][j], fa, fb, acc[w][j]);
        }
      }
    }
    __syncthreads();  // the chunks just read are rewritten next step
  }
  cp_async_wait<0>();
}

// streamed_gemm with an int8 W (unscaled f32 products; see wscale); bs
// holds bchunk_bytes(1).
__device__ __forceinline__ void streamed_gemm(FragC (&acc)[2], const bf16* A,
                                              int R, int K, const int8_t* W,
                                              int N, int r0, int n0,
                                              bf16* as, bf16* bs) {
  const int wm = warp_row(), wn = warp_col();
  int8_t* s8 = stage8(bs, 1);
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const int nk = K / BK;
  auto load_a = [&](bf16* dst, int k0) {
    for (int i = threadIdx.x; i < BM * BK / 8; i += kThreads) {
      const int r = i / (BK / 8), v = i - (i / (BK / 8)) * (BK / 8);
      const int gr = r0 + r;
      const bool ok = gr < R;
      cp_async16(dst + r * kLdA + v * 8,
                 A + (size_t)(ok ? gr : 0) * K + k0 + v * 8, ok);
    }
  };
  load_a(as, 0);
  load_bchunk_async(s8, W, N, 0, n0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load_a(as + ((kc + 1) & 1) * BM * kLdA, (kc + 1) * BK);
      load_bchunk_async(s8 + ((kc + 1) & 1) * kChunk8, W, N, (kc + 1) * BK,
                        n0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    widen_chunk(bs, s8 + (kc & 1) * kChunk8);
    __syncthreads();
    const bf16* ca = as + (kc & 1) * BM * kLdA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, ca + (wm * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, bs + kk * kLdB + wn * 32 + j * 16, kLdB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// The f32 product of output column `col` times its weight scale: the
// identity for bf16 weights, v * float(s[col]) for int8 ones (`_wdot`:
// the scale multiplies the dot output; _rn keeps ptxas from fusing it into
// a following bias add).
template <typename WT>
__device__ __forceinline__ float wscale(float v, const bf16* s, int col);
template <>
__device__ __forceinline__ float wscale<bf16>(float v, const bf16*, int) {
  return v;
}
template <>
__device__ __forceinline__ float wscale<int8_t>(float v, const bf16* s,
                                                int col) {
  return __fmul_rn(v, __bfloat162float(s[col]));
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
