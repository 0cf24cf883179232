// int8 LN3 + GEGLU feed-forward + residual of a SpatialTransformer block:
// two s8 launches of the block-GEMM core.
//
// Replaces rdm_tpu/ops/block_kernel.py:456 `_geglu_ff_kernel_q` (driven
// from _split_post_ff). For xm [R, C] bf16 and F = 4C, with a3 / ah the
// static a_ff / h_ff scales and q8(v, a) = clip(rint(v * (1 / a)), +-127):
//   1. h3q = q8(LN3(xm; n3s, n3b), a3)                 (the code prologue)
//      a   = (h3q @ wa^T) * (a3 * wsa) + ba,  g likewise with wg, wsg, bg
//      f   = a * (0.5 g (1 + erf(g / sqrt 2)))                   (f32)
//      hq  = q8(f, ah)                      (kGeglu, kNormQuant8; [R, F])
//   2. y   = xm + bf16((hq @ w2^T) * (ah * ws2) + b2)
//                                       (kResidual, kStream8; K = F)
// wa, wg int8 [F, C], w2 int8 [C, F] (out, in), as the s8 wgmma reads
// them; scales f32 per output column. The value and gate products share
// each A descriptor into two int32 accumulators. The TPU kernel carried
// an f32 accumulator across a sequential grid axis over F; CTAs of a CUDA
// grid run in no order, so the hidden goes through device memory as the
// codes hq the TPU kernel quantizes before its second product (half the
// bytes of geglu_ff_sm90.cu's bf16 f; f itself is never rounded to bf16).
// erff is CUDA's exact erf (the TPU kernel used the A&S 7.1.26 polynomial;
// the plain PyTorch version uses torch.erf).
//
// What bounds it on the H100: 6 R C F int8 operations (29 / 16 / 11 GOP at
// the U-Net sites at 8 images) at 1,979 TOP/s, 0.0286 ms summed, above the
// bytes of xm, y and the weights (chip_smoke.py `block_cost`). The first
// version ran mma.sync on 32-row panels (geglu_up_q_kernel) and streamed
// both int8 operands through cp.async (ff_down_q_kernel);
// csrc/block_gemm_sm90.cuh says how the core and its s8 path are built.
#include "block_gemm_sm90.cuh"

extern "C" int rdm_geglu_ff_q(const void* xm, const void* n3s,
                              const void* n3b, const void* wa,
                              const void* wsa, const void* wg,
                              const void* wsg, const void* ba,
                              const void* bg, const void* w2,
                              const void* ws2, const void* b2, void* hq,
                              void* y, int R, int C, int F, float a3,
                              float ah, int bm_u, int bn_u, int pp_u,
                              int tpc_u, int st_u, int bm_d, int bn_d,
                              int pp_d, int tpc_d, int st_d, void* stream) {
  using namespace rdmk::gemm;
  const Plan up{bm_u, bn_u, pp_u, tpc_u, st_u},
      down{bm_d, bn_d, pp_d, tpc_d, st_d};
  const cudaStream_t st = (cudaStream_t)stream;
  // 1. hq = q8((h3q @ wa^T ... + ba) * gelu(h3q @ wg^T ... + bg), ah)
  Q8Args a{};
  a.R = R;
  a.N = F;
  a.K = C;
  a.S = 1;
  a.T = 1;
  a.src = (const bf16*)xm;
  a.ln_s = (const float*)n3s;
  a.ln_b = (const float*)n3b;
  a.bias0 = (const float*)ba;
  a.bias1 = (const float*)bg;
  a.ws0 = (const float*)wsa;
  a.ws1 = (const float*)wsg;
  a.a = a3;
  a.inv_a = 1.0f / a3;
  a.inv_out = 1.0f / ah;
  a.out8 = (int8_t*)hq;
  int e = launch_s8<kGeglu, kNormQuant8>(up, nullptr, wa, wg, a, st);
  if (e) return e;
  // 2. y = xm + bf16(hq @ w2^T * (ah * ws2) + b2)
  Q8Args d{};
  d.R = R;
  d.N = C;
  d.K = F;
  d.S = 1;
  d.T = 1;
  d.res = (const bf16*)xm;
  d.bias0 = (const float*)b2;
  d.ws0 = (const float*)ws2;
  d.a = ah;
  d.out = (bf16*)y;
  return launch_s8<kResidual, kStream8>(down, hq, w2, nullptr, d, st);
}
