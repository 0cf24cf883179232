// LN3 + GEGLU feed-forward + residual of a SpatialTransformer block: two
// launches of the block-GEMM core.
//
// Replaces rdm_tpu/ops/block_kernel.py:_geglu_ff_kernel (driven from
// _split_post_ff) on the U-Net's path. For xm [R, C] bf16 and F = 4C:
//   1. h3 = bf16(LN3(xm; n3s, n3b))                             (kGeglu)
//      f  = bf16((h3 @ wa + ba) * gelu(h3 @ wg + bg)), exact erf
//   2. y  = xm + bf16(f @ w2 + b2)         f streamed, K = F   (kResidual)
// The TPU kernel carried an f32 [rows, C] accumulator across a sequential
// grid axis over F; CTAs of a CUDA grid run in no order, so f goes through
// device memory in bf16, where the TPU kernel rounds it, and the split
// changes only the order of f32 sums. The value and gate products share
// each A descriptor into two accumulators. csrc/block_gemm_sm90.cuh says
// what bounds it and how the core is built.
#include "block_gemm_sm90.cuh"

extern "C" int rdm_geglu_ff_sm90(const void* xm, const void* n3s,
                                 const void* n3b, const void* wa,
                                 const void* wg, const void* ba,
                                 const void* bg, const void* w2,
                                 const void* b2, void* f, void* y, int R,
                                 int C, int F, int bm_u, int bn_u, int pp_u,
                                 int tpc_u, int st_u, int bm_d, int bn_d,
                                 int pp_d, int tpc_d, int st_d,
                                 void* stream) {
  using namespace rdmk::gemm;
  const Plan up{bm_u, bn_u, pp_u, tpc_u, st_u},
      down{bm_d, bn_d, pp_d, tpc_d, st_d};
  const cudaStream_t st = (cudaStream_t)stream;
  // 1. f = bf16((h3 @ wa + ba) * gelu(h3 @ wg + bg))
  Args a{};
  a.R = R;
  a.N = F;
  a.K = C;
  a.S = 1;
  a.T = 1;
  a.ln_s = (const float*)n3s;
  a.ln_b = (const float*)n3b;
  a.bias0 = (const float*)ba;
  a.bias1 = (const float*)bg;
  a.out = (bf16*)f;
  int e = launch<kGeglu>(up, xm, wa, wg, a, st);
  if (e) return e;
  // 2. y = xm + bf16(f @ w2 + b2)
  Args d{};
  d.R = R;
  d.N = C;
  d.K = F;
  d.S = 1;
  d.T = 1;
  d.res = (const bf16*)xm;
  d.bias0 = (const float*)b2;
  d.out = (bf16*)y;
  return launch<kResidual>(down, f, w2, nullptr, d, st);
}
