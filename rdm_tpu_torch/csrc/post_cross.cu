// Attention out-projection + LN2 + cross-attention + out-projection of a
// SpatialTransformer block: three launches of the block-GEMM core.
//
// Replaces rdm_tpu/ops/block_kernel.py:_post_cross_kernel (with the context
// folding of make_cross_mats; driven from _split_post_ff). For x, attn
// [R, C] bf16 (R = B*S, image of row r is r / S) and ck, cv [B, T, C] the
// context keys/values projected outside (torch matmuls, as XLA did them in
// JAX):
//   1. x1   = x + bf16(attn @ wo + bo)                         (kResidual)
//   2. q2   = bf16(LN2(x1; n2s, n2b)) @ wq2, and in the epilogue per head
//      o_h  = bf16(sum_t bf16(softmax_t(bf16(q2_h) . ck[img, t, h] d^-1/2))
//                  cv[img, t, h])      (kCross; kCrossLong past 16 tokens,
//                                           kCross64 at head_dim 64)
//   3. xmid = x1 + bf16(o @ wo2 + bo2)                         (kResidual)
// x1 and o go through device memory (scratch the wrapper allocates), in
// bf16, where the first version and the JAX block round them anyway, so
// the split moves no rounding. The first version kept a [32, C] row block
// in one CTA through all three products, R / 32 CTAs (16 at C = 960); each
// launch here tiles rows and columns (csrc/block_gemm_sm90.cuh says what
// bounds it and how the core is built). Launches 1 and 3 share a plan.
#include "block_gemm_sm90.cuh"

extern "C" int rdm_post_cross(const void* x, const void* attn, const void* ck,
                              const void* cv, const void* wo, const void* bo,
                              const void* n2s, const void* n2b,
                              const void* wq2, const void* wo2,
                              const void* bo2, void* x1, void* o, void* out,
                              int R, int S, int C, int T, int head_dim,
                              float scale,
                              int bm_r, int bn_r, int pp_r, int tpc_r,
                              int st_r, int bm_c, int bn_c, int pp_c,
                              int tpc_c, int st_c, void* stream) {
  using namespace rdmk::gemm;
  if (T < 1 || S < 1 || C % kPW || (head_dim != 32 && head_dim != 64) ||
      C % head_dim)
    return (int)cudaErrorInvalidValue;
  const Plan res{bm_r, bn_r, pp_r, tpc_r, st_r},
      cross{bm_c, bn_c, pp_c, tpc_c, st_c};
  const cudaStream_t st = (cudaStream_t)stream;
  Args a{};
  a.R = R;
  a.N = C;
  a.K = C;
  a.S = S;
  a.T = T;
  a.scale = scale;
  // 1. x1 = x + bf16(attn @ wo + bo)
  a.res = (const bf16*)x;
  a.bias0 = (const float*)bo;
  a.out = (bf16*)x1;
  int e = launch<kResidual>(res, attn, wo, nullptr, a, st);
  if (e) return e;
  // 2. o = cross-attention(bf16(LN2(x1)) @ wq2)
  a.ln_s = (const float*)n2s;
  a.ln_b = (const float*)n2b;
  a.ck = (const bf16*)ck;
  a.cv = (const bf16*)cv;
  a.out = (bf16*)o;
  e = head_dim == 64 ? launch<kCross64>(cross, x1, wq2, nullptr, a, st)
      : T > kCtx       ? launch<kCrossLong>(cross, x1, wq2, nullptr, a, st)
                       : launch<kCross>(cross, x1, wq2, nullptr, a, st);
  if (e) return e;
  // 3. xmid = x1 + bf16(o @ wo2 + bo2)
  a.res = (const bf16*)x1;
  a.bias0 = (const float*)bo2;
  a.out = (bf16*)out;
  return launch<kResidual>(res, o, wo2, nullptr, a, st);
}
