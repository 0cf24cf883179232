// int8 attention out-projection + LN2 + cross-attention + out-projection
// of a SpatialTransformer block: three s8 launches of the block-GEMM core.
//
// Replaces rdm_tpu/ops/block_kernel.py:397 `_post_cross_kernel_q` (driven
// from _split_post_ff). For x, attn [R, C] bf16 (R = B*S, image of row r
// is r / S), ck, cv [B, T, C] the context keys/values projected outside,
// with a1 / a2 / a3 the static o_attn1 / a_attn2 / o_attn2 scales and
// q8(v, a) = clip(rint(v * (1 / a)), +-127):
//   1. x1   = x + bf16((q8(attn, a1) @ wo^T) * (a1 * wso) + bo)
//                                              (kResidual, kQuant8)
//   2. q2   = bf16((q8(LN2(x1; n2s, n2b), a2) @ wq2^T) * (a2 * wsq2)); per
//      head o_h = sum_t bf16(softmax_t(q2_h . ck[img, t, h] d^-1/2))
//      cv[img, t, h] in f32, written as the codes q8(o, a3)
//                                  (kCross, kCrossLong past 16 tokens,
//                                   kCross64 at head_dim 64; kNormQuant8)
//   3. xmid = x1 + bf16((o8 @ wo2^T) * (a3 * wso2) + bo2)
//                                              (kResidual, kStream8)
// wo, wq2, wo2 int8 [C, C] (out, in), as the s8 wgmma reads them; wso,
// wsq2, wso2 f32 [C]. The cross-attention output is quantized from f32, as
// the TPU kernel quantizes num / den_full (post_cross.cu rounds its o to
// bf16); the cross-attention itself is post_cross.cu's (exact per-head
// max over the T context tokens, bf16 probabilities), not the TPU
// kernel's per-image block matrices.
//
// What bounds it on the H100: three [R, C] x [C, C] int8 products (7.2 /
// 4.1 / 2.8 GOP at the U-Net sites at 8 images) at 1,979 TOP/s against x,
// attn, xmid and the context once and the int8 weights (chip_smoke.py
// `block_cost`): the bytes, 0.0100 ms summed over the sites. x1 (bf16)
// and the o codes (int8, half the bytes of post_cross.cu's bf16 o) go
// through device memory, scratch the wrapper allocates. The first version
// kept a [32, C] row block in one CTA through all three products (R / 32
// CTAs, 16 at C = 960, each streaming all three weights through mma.sync);
// each launch here tiles rows and columns (csrc/block_gemm_sm90.cuh says
// how the core is built and what its s8 path adds).
#include "block_gemm_sm90.cuh"

extern "C" int rdm_post_cross_q(
    const void* x, const void* attn, const void* ck, const void* cv,
    const void* wo, const void* wso, const void* bo, const void* n2s,
    const void* n2b, const void* wq2, const void* wsq2, const void* wo2,
    const void* wso2, const void* bo2, void* x1, void* o8, void* out, int R,
    int S, int C, int T, int head_dim, float a1, float a2, float a3,
    float scale, int bm_q, int bn_q, int pp_q, int tpc_q, int st_q,
    int bm_c, int bn_c, int pp_c, int tpc_c, int st_c, int bm_r, int bn_r,
    int pp_r, int tpc_r, int st_r, void* stream) {
  using namespace rdmk::gemm;
  if (T < 1 || S < 1 || C % kPW || (head_dim != 32 && head_dim != 64) ||
      C % head_dim)
    return (int)cudaErrorInvalidValue;
  const Plan quant{bm_q, bn_q, pp_q, tpc_q, st_q},
      cross{bm_c, bn_c, pp_c, tpc_c, st_c},
      res{bm_r, bn_r, pp_r, tpc_r, st_r};
  const cudaStream_t st = (cudaStream_t)stream;
  Q8Args a{};
  a.R = R;
  a.N = C;
  a.K = C;
  a.S = S;
  a.T = T;
  a.scale = scale;
  // 1. x1 = x + bf16(q8(attn, a1) @ wo^T * (a1 * wso) + bo)
  a.src = (const bf16*)attn;
  a.res = (const bf16*)x;
  a.bias0 = (const float*)bo;
  a.ws0 = (const float*)wso;
  a.a = a1;
  a.inv_a = 1.0f / a1;
  a.out = (bf16*)x1;
  int e = launch_s8<kResidual, kQuant8>(quant, nullptr, wo, nullptr, a, st);
  if (e) return e;
  // 2. o8 = q8(cross-attention(bf16(q8(LN2(x1), a2) @ wq2^T ...)), a3)
  a.src = (const bf16*)x1;
  a.ln_s = (const float*)n2s;
  a.ln_b = (const float*)n2b;
  a.ck = (const bf16*)ck;
  a.cv = (const bf16*)cv;
  a.ws0 = (const float*)wsq2;
  a.a = a2;
  a.inv_a = 1.0f / a2;
  a.inv_out = 1.0f / a3;
  a.out8 = (int8_t*)o8;
  e = head_dim == 64
          ? launch_s8<kCross64, kNormQuant8>(cross, nullptr, wq2, nullptr, a,
                                             st)
      : T > kCtx ? launch_s8<kCrossLong, kNormQuant8>(cross, nullptr, wq2,
                                                      nullptr, a, st)
                 : launch_s8<kCross, kNormQuant8>(cross, nullptr, wq2,
                                                  nullptr, a, st);
  if (e) return e;
  // 3. xmid = x1 + bf16(o8 @ wo2^T * (a3 * wso2) + bo2)
  a.res = (const bf16*)x1;
  a.bias0 = (const float*)bo2;
  a.ws0 = (const float*)wso2;
  a.a = a3;
  a.out = (bf16*)out;
  return launch_s8<kResidual, kStream8>(res, o8, wo2, nullptr, a, st);
}
