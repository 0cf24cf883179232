// Everything after the self-attention core of one RARM decode step:
// attention out-projection, cross-attention to the neighbours and the GEGLU
// feed-forward, each residual: five launches of the block-GEMM core.
//
// Replaces rdm_tpu/ops/decode_kernel.py:275 `_post_ff_kernel`. For x, attn
// [B, C] bf16 (one token per batch row, R = B rows) and the
// once-per-request cross-attention keys and values ck, cv [S, B, C]
// (time-major, as in JAX, read where they lie: image stride C, token
// stride B C):
//   1. x1 = x + bf16(attn @ wo + bo)                           (kResidual)
//   2. q2 = bf16(LN2(x1; n2s, n2b)) @ wq2, and in the epilogue per 64-wide
//      head o2_h = bf16(sum_s bf16(softmax_s(bf16(q2_h) . ck[s, b, h]
//      d^-1/2)) cv[s, b, h])    (kCross64Short up to 16 rows, one pass;
//                                     kCross64 past them)
//   3. xm = x1 + bf16(o2 @ wo2 + bo2)                          (kResidual)
//   4. f  = bf16((h3 @ wa + ba) * gelu(h3 @ wg + bg)), h3 = bf16(LN3(xm)),
//      exact erf                                                  (kGeglu)
//   5. out = xm + bf16(f @ w2 + b2), K = F                      (kResidual)
// x1, o2, xm and f go through device memory in bf16, where the JAX kernel
// and the plain versions (`post_cross_reference`, `geglu_ff_reference`;
// `_post_ff_int8` with int8 weights) round them, so the launches change
// only the order of f32 sums. p is rounded to bf16 after the division, as
// `dot_product_attention` rounds it.
//
// The int8_weights option (`_post_ff_kernel(quantized=True)`): wo, wq2,
// wo2, wa, wg and w2 are int8 codes [in, out] with a bf16 scale per output
// column; every launch streams the codes (8.85 MB at C = 768, F = 3072, half
// the bf16 bytes), converts them to bf16 in shared memory and scales the
// f32 product before the bias, as `_wdot` does.
//
// What bounds it on the H100: streaming the weights, 3C^2 + 3CF bf16 =
// 17.7 MB at C = 768, F = 3072, against 2 B (3C^2 + 3CF) = 283 / 566 MFLOP
// at B = 16 / 32: 16-32 FLOP a byte, so the floor is ~5.3 us at 3.35 TB/s
// (2.6 us in int8). One 64-row block has 12 column tiles at N = 768, so
// each launch splits K over a cluster (the plan's KS; block_gemm_sm90.cuh
// says how) to put 72-96 CTAs on the weight stream, and launches 2-5 start
// under the tail of the launch before (programmatic dependent launch),
// their W loads issued before they wait for its output.
#include "block_gemm_sm90.cuh"

namespace rdmk {
namespace gemm {

// The chain; WT = int8_t with the six bf16 column scales sc (the
// int8_weights mode), bf16 with null scales.
template <typename WT>
static int post_ff_chain(const void* x, const void* attn, const void* ck,
                         const void* cv, const void* wo, const void* bo,
                         const void* n2s, const void* n2b, const void* wq2,
                         const void* wo2, const void* bo2, const void* n3s,
                         const void* n3b, const void* wa, const void* wg,
                         const void* ba, const void* bg, const void* w2,
                         const void* b2, const void* const* sc, void* x1,
                         void* o2, void* xm, void* f, void* out, int B,
                         int C, int S, int F, float scale, const Plan& res,
                         const Plan& cross, const Plan& up,
                         const Plan& down, bool pdl, cudaStream_t st) {
  DecodeArgs a{};
  a.R = B;
  a.N = C;
  a.K = C;
  a.S = 1;  // one query row per image: ck, cv [S, B, C] read time-major
  a.T = S;
  a.scale = scale;
  // 1. x1 = x + bf16(attn @ wo + bo)
  a.res = (const bf16*)x;
  a.bias0 = (const float*)bo;
  a.ws0 = (const bf16*)sc[0];
  a.out = (bf16*)x1;
  int e = launch_decode<kResidual, WT>(res, attn, wo, nullptr, a, pdl, st);
  if (e) return e;
  // 2. o2 = cross-attention(bf16(LN2(x1)) @ wq2)
  a.ln_s = (const float*)n2s;
  a.ln_b = (const float*)n2b;
  a.ws0 = (const bf16*)sc[1];
  a.ck = (const bf16*)ck;
  a.cv = (const bf16*)cv;
  a.out = (bf16*)o2;
  e = S > kCtx
          ? launch_decode<kCross64, WT>(cross, x1, wq2, nullptr, a, pdl, st)
          : launch_decode<kCross64Short, WT>(cross, x1, wq2, nullptr, a,
                                             pdl, st);
  if (e) return e;
  // 3. xm = x1 + bf16(o2 @ wo2 + bo2)
  a.res = (const bf16*)x1;
  a.bias0 = (const float*)bo2;
  a.ws0 = (const bf16*)sc[2];
  a.out = (bf16*)xm;
  e = launch_decode<kResidual, WT>(res, o2, wo2, nullptr, a, pdl, st);
  if (e) return e;
  // 4. f = bf16((h3 @ wa + ba) * gelu(h3 @ wg + bg))
  DecodeArgs u{};
  u.R = B;
  u.N = F;
  u.K = C;
  u.S = 1;
  u.T = 1;
  u.ln_s = (const float*)n3s;
  u.ln_b = (const float*)n3b;
  u.bias0 = (const float*)ba;
  u.bias1 = (const float*)bg;
  u.ws0 = (const bf16*)sc[3];
  u.ws1 = (const bf16*)sc[4];
  u.out = (bf16*)f;
  e = launch_decode<kGeglu, WT>(up, xm, wa, wg, u, pdl, st);
  if (e) return e;
  // 5. out = xm + bf16(f @ w2 + b2)
  DecodeArgs d{};
  d.R = B;
  d.N = C;
  d.K = F;
  d.S = 1;
  d.T = 1;
  d.res = (const bf16*)xm;
  d.bias0 = (const float*)b2;
  d.ws0 = (const bf16*)sc[5];
  d.out = (bf16*)out;
  return launch_decode<kResidual, WT>(down, f, w2, nullptr, d, pdl, st);
}

}  // namespace gemm
}  // namespace rdmk

// swo, swq2, swo2, swa, swg, sw2: all null (bf16 weights) or all given
// (int8 weights with bf16 column scales). The four plans (ops/block_kernel.py
// `gemm_plan(..., split_k=True)`), each bm, bn, pp, tiles_per_cta, stages,
// ks: launches 1 and 3 (_r), 2 (_c), 4 (_u), 5 (_d).
extern "C" int rdm_decode_post_ff(
    const void* x, const void* attn, const void* ck, const void* cv,
    const void* wo, const void* bo, const void* n2s, const void* n2b,
    const void* wq2, const void* wo2, const void* bo2, const void* n3s,
    const void* n3b, const void* wa, const void* wg, const void* ba,
    const void* bg, const void* w2, const void* b2, const void* swo,
    const void* swq2, const void* swo2, const void* swa, const void* swg,
    const void* sw2, void* x1, void* o2, void* xm, void* f, void* out, int B,
    int C, int S, int F, float scale, int bm_r, int bn_r, int pp_r,
    int tpc_r, int st_r, int ks_r, int bm_c, int bn_c, int pp_c, int tpc_c,
    int st_c, int ks_c, int bm_u, int bn_u, int pp_u, int tpc_u, int st_u,
    int ks_u, int bm_d, int bn_d, int pp_d, int tpc_d, int st_d, int ks_d,
    int pdl, void* stream) {
  using namespace rdmk::gemm;
  const void* sc[6] = {swo, swq2, swo2, swa, swg, sw2};
  int given = 0;
  for (const void* p : sc) given += p != nullptr;
  if (C % 64 || F % 64 || B < 1 || S < 1 || (given != 0 && given != 6))
    return (int)cudaErrorInvalidValue;
  const Plan res{bm_r, bn_r, pp_r, tpc_r, st_r, ks_r},
      cross{bm_c, bn_c, pp_c, tpc_c, st_c, ks_c},
      up{bm_u, bn_u, pp_u, tpc_u, st_u, ks_u},
      down{bm_d, bn_d, pp_d, tpc_d, st_d, ks_d};
  const cudaStream_t st = (cudaStream_t)stream;
  if (given == 0)
    return post_ff_chain<bf16>(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2,
                               bo2, n3s, n3b, wa, wg, ba, bg, w2, b2, sc, x1,
                               o2, xm, f, out, B, C, S, F, scale, res, cross,
                               up, down, pdl != 0, st);
  return post_ff_chain<int8_t>(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2,
                               bo2, n3s, n3b, wa, wg, ba, bg, w2, b2, sc, x1,
                               o2, xm, f, out, B, C, S, F, scale, res, cross,
                               up, down, pdl != 0, st);
}
