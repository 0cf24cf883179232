// The whole post-attention half of a SpatialTransformer block in one
// kernel: out-projection + residual, LN2 + cross-attention + out-projection
// + residual, then LN3 + GEGLU feed-forward + residual.
//
// Replaces rdm_tpu/ops/block_kernel.py:_post_ff_kernel (the single kernel
// 3 that fused_transformer_block runs under RDM_TPU_SPLIT_K3=0). For one
// [32, C] row block of x, attn [R, C] bf16 (R = B*S, image of row r is
// r / S) and the projected context ck, cv [B, T, C]:
//   xm = post_cross(x, attn)            (post_cross_common.cuh, as
//                                        csrc/post_cross.cu computes it)
//   h3 = LayerNorm(xm; n3s, n3b)
//   f_j = bf16((h3 @ wa_j + ba_j) * gelu(h3 @ wg_j + bg_j))   per 64-wide
//                                        slice j of F, exact-erf gelu
//   y  = xm + bf16(sum_j f_j @ w2[j] + b2)
// with the rounding of csrc/post_cross.cu and csrc/geglu_ff_sm90.cu, so
// the kernel computes what the split pair computes, up to the order of f32
// sums.
//
// The TPU kernel carried an f32 [M, C] accumulator across a sequential
// grid axis over F column blocks. Here one thread block owns its 32 rows
// end to end and loops over F itself, 64 hidden columns at a time: the
// value and gate products of the slice (panel_gemm over the LN3 panel),
// the gated slice f_j [32, 64] into shared memory, then f_j @ w2[j rows]
// added into the f32 accumulator [32, C] in shared memory, tile by tile
// (wmma fragments loaded from and stored back to it). The hidden f never
// touches device memory (the split pair writes and reads back R x F bf16).
//
// Shared memory is the constraint: at C = 960 the accumulator is 123 KB
// (row stride C + 4) beside the [32, C] bf16 LN3 panel (62 KB), the up
// projection's two double-buffered weight chunks, two f32 staging tiles and
// f_j: 225,792 bytes of the 232,448 a block may have. So the attention half
// runs in the same bytes first (three panels, 203,776 bytes), xm goes to
// `out` (this block's own rows, read back by the final epilogue) and to the
// first panel, where LN3 normalises it in place; the accumulator then takes
// the bytes of the other two panels. Rows stay at 32 (the wmma tiling of
// block_common.cuh); C is a multiple of 32 and F of 64, heads 32 or 64
// wide, any T (post_ff_kernel<HD, LONG>: LONG past 16 tokens). The
// SEG/SEG^T matmuls of the TPU kernel are not carried over (a per-head dot
// is plain here).
//
// What bounds it on the H100: 2*R*C*(3C + 3F) FLOP (36/20/14 GFLOP at
// C = 384/576/960, R = 8192/2048/512, 2B = 8 images) on the tensor cores:
// operations, as for the split pair, less the pair's R x F round trip of f.
// Every block streams all of wo, wq2, wo2, wa, wg and w2 (from L2 after the
// first); one block per 32 rows caps the grid at 256/64/16 blocks, so the
// C = 960 site runs on 16 SMs: a split of the F loop across blocks (with a
// second pass for the sum) is the first speed-up to try.
#include "post_cross_common.cuh"

namespace rdmk {

// the accumulator's row: C rounded up to whole 64-column tiles, + 4
__host__ __device__ constexpr int acc_ld(int C) {
  return (C + BN - 1) / BN * BN + 4;
}

__host__ __device__ constexpr size_t acc_bytes(int C) {
  return align128((size_t)BM * acc_ld(C) * sizeof(float));
}

constexpr size_t kFBytes = align128((size_t)BM * kLdB * sizeof(bf16));

__host__ __device__ constexpr size_t post_ff_smem(int C) {
  const size_t attn_half = 3 * panel_bytes(C) + bchunk_bytes(1) +
                           staging_bytes(1);
  const size_t ff_half = panel_bytes(C) + acc_bytes(C) + bchunk_bytes(2) +
                         staging_bytes(2) + kFBytes;
  return attn_half > ff_half ? attn_half : ff_half;
}

// accs[BM, N] (f32, row stride ldacc) += a[BM, BN] (bf16, row stride kLdB)
// @ W[k0:k0+BN, 0:N] (bf16 [K, N] row-major), one 64-column tile of the
// accumulator at a time; W streamed in [BK, BN] chunks through bs
// (bchunk_bytes(1)) by double-buffered cp.async. N a multiple of 32: the
// last tile's columns past N add zeros into the accumulator's padding.
__device__ __forceinline__ void acc_gemm(float* accs, int ldacc,
                                         const bf16* a, const bf16* W, int N,
                                         int k0, bf16* bs) {
  constexpr int nk = BN / BK;
  const int wm = warp_row(), wn = warp_col();
  const int total = (N + BN - 1) / BN * nk;
  FragC acc[2];
  load_bchunk_async(bs, W, N, k0, 0);
  cp_async_commit();
  for (int i = 0; i < total; ++i) {
    const int t = i / nk, kc = i - t * nk;
    if (i + 1 < total) {
      const int t1 = (i + 1) / nk, kc1 = (i + 1) - t1 * nk;
      load_bchunk_async(bs + ((i + 1) & 1) * BK * kLdB, W, N, k0 + kc1 * BK,
                        t1 * BN);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk i has landed
    __syncthreads();
    float* ct = accs + (wm * 16) * ldacc + t * BN + wn * 32;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(acc[j], ct + j * 16, ldacc, wmma::mem_row_major);
    }
    const bf16* cur = bs + (i & 1) * BK * kLdB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + (wm * 16) * kLdB + kc * BK + kk, kLdB);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, cur + kk * kLdB + wn * 32 + j * 16, kLdB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    if (kc == nk - 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(ct + j * 16, acc[j], ldacc,
                                wmma::mem_row_major);
    }
    __syncthreads();  // the buffer just read is refilled two chunks later
  }
  cp_async_wait<0>();
}

template <int HD, bool LONG>
__global__ void __launch_bounds__(kThreads)
    post_ff_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
                   const bf16* __restrict__ ck, const bf16* __restrict__ cv,
                   const bf16* __restrict__ wo, const float* __restrict__ bo,
                   const float* __restrict__ n2s,
                   const float* __restrict__ n2b,
                   const bf16* __restrict__ wq2, const bf16* __restrict__ wo2,
                   const float* __restrict__ bo2,
                   const float* __restrict__ n3s,
                   const float* __restrict__ n3b,
                   const bf16* __restrict__ wa, const bf16* __restrict__ wg,
                   const float* __restrict__ ba, const float* __restrict__ bg,
                   const bf16* __restrict__ w2, const float* __restrict__ b2,
                   bf16* out, int R, int S, int C, int T, int F,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t pb = panel_bytes(C);
  const int ldp = panel_ld(C);
  const int r0 = blockIdx.x * BM;
  bf16* pa = reinterpret_cast<bf16*>(smem);  // attn, LN2(x1), xm, LN3(xm)

  // 1. the attention half; xm to `out` and to pa
  {
    bf16* px1 = reinterpret_cast<bf16*>(smem + pb);
    bf16* po = reinterpret_cast<bf16*>(smem + 2 * pb);
    bf16* bs = reinterpret_cast<bf16*>(smem + 3 * pb);
    float* cs = reinterpret_cast<float*>(smem + 3 * pb + bchunk_bytes(1));
    post_cross_rows<HD, LONG>(
        x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, R, S, C, T, scale,
        r0, pa, px1, po, bs, cs, [&](int r, int gr, int gc, const float* res) {
          store8(out + (size_t)gr * C + gc, res);
          store8(pa + r * ldp + gc, res);
        });
  }

  // 2. LN3 in place; the accumulator over the dead x1 / o panels
  const int ldacc = acc_ld(C);
  float* accs = reinterpret_cast<float*>(smem + pb);
  bf16* bs = reinterpret_cast<bf16*>(smem + pb + acc_bytes(C));
  float* ca = reinterpret_cast<float*>(smem + pb + acc_bytes(C) +
                                       bchunk_bytes(2));
  float* cg = ca + BM * kLdC;
  bf16* fj = reinterpret_cast<bf16*>(smem + pb + acc_bytes(C) +
                                     bchunk_bytes(2) + staging_bytes(2));
  layer_norm_panel(pa, pa, C, n3s, n3b);
  for (int i = threadIdx.x; i < BM * ldacc; i += kThreads) accs[i] = 0.f;
  __syncthreads();

  // 3. per 64-wide slice of F: f_j, then accs += f_j @ w2[j]
  const bf16* wag[2] = {wa, wg};
  for (int n0 = 0; n0 < F; n0 += BN) {
    FragC acc[2][2];
    panel_gemm<2>(acc, pa, C, wag, F, n0, bs);
    store_acc(ca, acc[0]);
    store_acc(cg, acc[1]);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
      const int gc = n0 + c8;
      float res[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a = ca[r * kLdC + c8 + j] + __ldg(ba + gc + j);
        const float gt = cg[r * kLdC + c8 + j] + __ldg(bg + gc + j);
        res[j] = a * (0.5f * gt * (1.0f + erff(gt * 0.7071067811865476f)));
      }
      store8(fj + r * kLdB + c8, res);
    }
    __syncthreads();
    acc_gemm(accs, ldacc, fj, w2, C, n0, bs);
  }

  // 4. y = xm + bf16(accs + b2), xm read back from this block's rows of out
  for (int i = threadIdx.x; i < BM * C / 8; i += kThreads) {
    const int r = i / (C / 8), c8 = (i - r * (C / 8)) * 8;
    const int gr = r0 + r;
    if (gr >= R) continue;
    float xv[8], res[8];
    load8(xv, out + (size_t)gr * C + c8);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      res[j] = xv[j] + round_bf16(accs[r * ldacc + c8 + j] + __ldg(b2 + c8 + j));
    store8(out + (size_t)gr * C + c8, res);
  }
}

}  // namespace rdmk

extern "C" int rdm_post_ff(const void* x, const void* attn, const void* ck,
                           const void* cv, const void* wo, const void* bo,
                           const void* n2s, const void* n2b, const void* wq2,
                           const void* wo2, const void* bo2, const void* n3s,
                           const void* n3b, const void* wa, const void* wg,
                           const void* ba, const void* bg, const void* w2,
                           const void* b2, void* out, int R, int S, int C,
                           int T, int F, int head_dim, float scale,
                           void* stream) {
  using namespace rdmk;
  if (T < 1 || C % 32 || F % BN || R < 1 ||
      (head_dim != 32 && head_dim != 64) || C % head_dim)
    return (int)cudaErrorInvalidValue;
  const size_t smem = post_ff_smem(C);
  const bool long_ctx = T > kMaxCtx;  // cross_head
  auto kernel = head_dim == 32 ? (long_ctx ? post_ff_kernel<32, true>
                                           : post_ff_kernel<32, false>)
                               : (long_ctx ? post_ff_kernel<64, true>
                                           : post_ff_kernel<64, false>);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)attn, (const bf16*)ck, (const bf16*)cv,
      (const bf16*)wo, (const float*)bo, (const float*)n2s,
      (const float*)n2b, (const bf16*)wq2, (const bf16*)wo2,
      (const float*)bo2, (const float*)n3s, (const float*)n3b,
      (const bf16*)wa, (const bf16*)wg, (const float*)ba, (const float*)bg,
      (const bf16*)w2, (const float*)b2, (bf16*)out, R, S, C, T, F, scale);
  return (int)cudaGetLastError();
}
