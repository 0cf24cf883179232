// int8 LN1 + fused q/k/v projection of a SpatialTransformer block: one s8
// launch of the block-GEMM core.
//
// Replaces rdm_tpu/ops/block_kernel.py:140 `_ln_qkv_kernel_q` (driven from
// fused_transformer_block). For x [R, C] bf16, with a the static a_qkv
// scale and q8(v, a) = clip(rint(v * (1 / a)), +-127):
//   hq = q8(LN1(x; n1s, n1b), a)     (bf16 LayerNorm, rounded per op as
//                                     ln_qkv.cu's; the code prologue)
//   [q | k | v] = bf16((hq @ wqkv^T) * (a * ws))          (kQkv epilogue)
// with wqkv int8 [3C, C] (out, in), as the s8 wgmma reads it, and ws [3C]
// f32 per-column scales; each 8-column group of the [R, 3C] product goes
// to q, k or v [R, C].
//
// What bounds it on the H100: 2 R C 3C int8 operations (7.2 / 4.1 / 2.8
// GOP at the U-Net sites at 8 images) at 1,979 TOP/s against x read once,
// the int8 weights and q, k, v written once (chip_smoke.py `block_cost`):
// the bytes, 0.0128 ms summed over the sites, of which q, k and v are
// three quarters. The first version staged a [32, C] bf16 panel and an
// int8 panel per block, streamed W through mma.sync and staged its
// accumulators in shared memory. Here the code prologue normalises and
// quantizes a CTA's 64 rows once, the producer warp streams W's [BN, 128]
// boxes by TMA, wgmma s8 keeps the int32 sums in registers, and the
// epilogue writes 16-byte rows of q, k, v from the dequantized fragments.
// N = 3C is 18-45 column tiles of 64, so `gemm_plan` ("qkv8") lets a CTA
// walk several of them over the one panel its prologue wrote (the
// prologue is redone once per CTA, not per tile); csrc/block_gemm_sm90.cuh
// says how the core and its s8 path are built.
#include "block_gemm_sm90.cuh"

extern "C" int rdm_ln_qkv_q(const void* x, const void* n1s, const void* n1b,
                            const void* wqkv, const void* ws, void* q,
                            void* k, void* v, int R, int C, float a, int bm,
                            int bn, int pp, int tiles_per_cta, int stages,
                            void* stream) {
  using namespace rdmk::gemm;
  if (C % kPW) return (int)cudaErrorInvalidValue;
  Q8Args p{};
  p.R = R;
  p.N = 3 * C;
  p.K = C;
  p.S = 1;
  p.T = 1;
  p.src = (const bf16*)x;
  p.ln_s = (const float*)n1s;
  p.ln_b = (const float*)n1b;
  p.ws0 = (const float*)ws;
  p.a = a;
  p.inv_a = 1.0f / a;
  p.out = (bf16*)q;
  p.out1 = (bf16*)k;
  p.out2 = (bf16*)v;
  return launch_s8<kQkv, kNormQuant8>(Plan{bm, bn, pp, tiles_per_cta, stages},
                                      nullptr, wqkv, nullptr, p,
                                      (cudaStream_t)stream);
}
