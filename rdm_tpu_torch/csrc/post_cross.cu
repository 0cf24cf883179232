// Attention out-projection + LN2 + cross-attention + out-projection of a
// SpatialTransformer block.
//
// Replaces rdm_tpu/ops/block_kernel.py:_post_cross_kernel (with the context
// folding of make_cross_mats; driven from _split_post_ff). For one row
// block of x, attn [R, C] bf16 (R = B*S, image of row r is r / S):
//   x1   = x + (attn @ wo + bo)
//   h2   = LayerNorm(x1; n2s, n2b)
//   q2   = h2 @ wq2
//   o_h  = softmax_t(q2_h . ck[img, t, h] * d^-1/2) . cv[img, :, h]
//   xmid = x1 + (o @ wo2 + bo2)
// with ck, cv [B, T, C] the context keys/values projected outside (torch
// matmuls, as XLA did them in JAX). Rounding follows the unfused JAX block
// (models/layers.py TransformerBlock): every projection output, x1, q2 and
// the probabilities are rounded to bf16 where that block rounds them, and
// the cross-attention takes an exact per-head max over its T context
// tokens. The TPU-only per-image block matrices, their row-global max,
// -1e9 pad columns and -75 clamp are not carried over.
//
// What bounds it on the H100: three [R, C] x [C, C] products (3*2*R*C^2 =
// 7.2/4.1/2.8 GFLOP at C = 384/576/960) plus a cross-attention of
// 4*R*C*T FLOP that is negligible at T = 4. LN2 needs whole x1 rows between
// the first and second product, so one thread block owns a [32, C] row
// block end to end: attn, x1, LN2(x1) and o live in shared memory as
// [32, C] bf16 panels (3 x 62 KB at C = 960) and never touch device memory.
// That caps the grid at R / 32 blocks (256/64/16 at the three sites), so
// the small-S sites leave most SMs idle; splitting the row block is a
// later revision's work.
#include "post_cross_common.cuh"

namespace rdmk {

__global__ void __launch_bounds__(kThreads)
    post_cross_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
                      const bf16* __restrict__ ck, const bf16* __restrict__ cv,
                      const bf16* __restrict__ wo, const float* __restrict__ bo,
                      const float* __restrict__ n2s,
                      const float* __restrict__ n2b,
                      const bf16* __restrict__ wq2,
                      const bf16* __restrict__ wo2,
                      const float* __restrict__ bo2, bf16* __restrict__ out,
                      int R, int S, int C, int T, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t pb = panel_bytes(C);
  bf16* pa = reinterpret_cast<bf16*>(smem);           // attn, then LN2(x1)
  bf16* px1 = reinterpret_cast<bf16*>(smem + pb);     // x1
  bf16* po = reinterpret_cast<bf16*>(smem + 2 * pb);  // cross-attention out
  bf16* bs = reinterpret_cast<bf16*>(smem + 3 * pb);
  float* cs = reinterpret_cast<float*>(smem + 3 * pb + bchunk_bytes(1));
  post_cross_rows(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, R, S, C,
                  T, scale, blockIdx.x * BM, pa, px1, po, bs, cs,
                  [&](int, int gr, int gc, const float* res) {
                    store8(out + (size_t)gr * C + gc, res);
                  });
}

}  // namespace rdmk

extern "C" int rdm_post_cross(const void* x, const void* attn, const void* ck,
                              const void* cv, const void* wo, const void* bo,
                              const void* n2s, const void* n2b,
                              const void* wq2, const void* wo2,
                              const void* bo2, void* out, int R, int S, int C,
                              int T, float scale, void* stream) {
  using namespace rdmk;
  if (T < 1 || T > kMaxCtx || C % kCrossHeadDim)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * panel_bytes(C) + bchunk_bytes(1) + staging_bytes(1);
  cudaError_t e = allow_smem(post_cross_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + BM - 1) / BM);
  post_cross_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)attn, (const bf16*)ck, (const bf16*)cv,
      (const bf16*)wo, (const float*)bo, (const float*)n2s,
      (const float*)n2b, (const bf16*)wq2, (const bf16*)wo2,
      (const float*)bo2, (bf16*)out, R, S, C, T, scale);
  return (int)cudaGetLastError();
}
