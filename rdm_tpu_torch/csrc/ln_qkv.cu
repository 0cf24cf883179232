// LN1 + fused q/k/v projection of a SpatialTransformer block: one launch of
// the block-GEMM core.
//
// Replaces rdm_tpu/ops/block_kernel.py:127 _ln_qkv_kernel (driven from
// fused_transformer_block). For x [R, C] bf16:
//   h = bf16(LN1(x; n1s, n1b))     (f32 row statistics, eps 1e-5)
//   [q | k | v] = bf16(h @ wqkv)   (wqkv [C, 3C] bf16, f32 accumulation)
// written as three [R, C] bf16 tensors with head h at channels
// [32h, 32h + 32) (kQkv: the core's LayerNorm prologue, one weight, an
// epilogue that sends each 8-column group of the [R, 3C] product to q, k
// or v). The TPU kernel's 128-lane head padding (Cp) is not carried over:
// the GPU layout needs none.
//
// What bounds it on the H100: at the main-path sites (R = 8192/2048/512,
// C = 384/576/960) the product is 2*R*C*3C = 7.2/4.1/2.8 GFLOP against
// 2*(R*C + 3*C*C + 3*R*C) bytes = 26/11/9.5 MB: 7.8/4.1/2.9 us of bytes or
// operations, whichever is larger, near the bf16 ridge point. The first
// version (wmma, 32-row panels, W through cp.async, accumulators staged in
// shared memory) ran the C = 384 site as 256 row blocks that each read
// all of W from L2. Here a CTA normalises 64 or 128 rows once into a
// swizzled panel, a producer warp streams W's [64, 32] boxes by TMA into
// an mbarrier ring, wgmma keeps the products in registers, and a CTA walks
// several column tiles of its rows (ops/block_kernel.py `gemm_plan`, kind
// "qkv"); csrc/block_gemm_sm90.cuh says how the core is built.
#include "block_gemm_sm90.cuh"

extern "C" int rdm_ln_qkv(const void* x, const void* n1s, const void* n1b,
                          const void* wqkv, void* q, void* k, void* v, int R,
                          int C, int bm, int bn, int pp, int tiles_per_cta,
                          int stages, void* stream) {
  using namespace rdmk::gemm;
  if (C % kPW) return (int)cudaErrorInvalidValue;
  Args a{};
  a.R = R;
  a.N = 3 * C;
  a.K = C;
  a.S = 1;
  a.T = 1;
  a.ln_s = (const float*)n1s;
  a.ln_b = (const float*)n1b;
  a.out = (bf16*)q;
  a.out1 = (bf16*)k;
  a.out2 = (bf16*)v;
  return launch<kQkv>(Plan{bm, bn, pp, tiles_per_cta, stages}, x, wqkv,
                      nullptr, a, (cudaStream_t)stream);
}
