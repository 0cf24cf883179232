// Everything after the self-attention core of one RARM decode step:
// attention out-projection, cross-attention to the neighbours and the GEGLU
// feed-forward, each residual.
//
// Replaces rdm_tpu/ops/decode_kernel.py:_post_ff_kernel. For x, attn [B, C]
// bf16 (one token per batch row) and the once-per-request cross-attention
// keys and values ck, cv [S, B, C] (time-major, as in JAX):
//   x1   = x + (attn @ wo + bo)
//   q2   = LayerNorm(x1; n2s, n2b) @ wq2
//   o2_h = softmax_s(q2_h . ck[s, b, h] * d^-1/2) . cv[s, b, h]   (d = 64)
//   xm   = x1 + (o2 @ wo2 + bo2)
//   out  = xm + (f @ w2 + b2),  f = bf16((h3 @ wa + ba) * gelu(h3 @ wg + bg)),
//          h3 = LayerNorm(xm; n3s, n3b), gelu with the exact erf
// Each projection's output is rounded to bf16 where the JAX kernel rounds
// it (the f32 product plus bias, then the residual add in bf16); f is
// rounded once, as the TPU kernel rounds it.
//
// The TPU kernel ran this on a grid over F column blocks, with the
// attention half in the first grid step and an f32 accumulator carried to
// the last. GPU blocks run in no order, so it becomes a chain of five
// launches of one skinny-GEMM building block (M = B <= 64 rows in one or
// two [32, C] shared panels, the weight streamed once by a grid over its
// 64-column tiles; block_common.cuh):
//   1. proj_res_kernel  : x1 = x + (attn @ wo + bo)
//   2. q_cross_kernel   : LN2 prologue, q2 tile = one head's 64 columns,
//                         whose cross-attention over the S context rows
//                         runs in the epilogue (a warp per row)
//   3. proj_res_kernel  : xm = x1 + (o2 @ wo2 + bo2)
//   4-5. rdm_geglu_ff   : LN3 + gated up-projection into f [B, F], then
//                         down-projection + b2 + residual (the two kernels
//                         of csrc/geglu_ff.cu, whose arithmetic is the same)
// The SEG/SEG^T head-segment matmuls and the bf16 rounding they forced on
// the softmax denominator are not carried over.
//
// The int8_weights option (`_post_ff_kernel(quantized=True)`): wo, wq2,
// wo2, wa, wg and w2 are int8 codes [in, out] with a bf16 scale per output
// column; every launch of the chain streams them through block_common.cuh's
// int8 operand (half the weight bytes: 8.85 MB at C = 768) and scales the
// f32 product before the bias, as `_wdot` does.
//
// What bounds it on the H100: streaming the weights, 3C^2 + 3CF bf16 =
// 17.7 MB at C = 768, F = 3072, against 2*B*(3C^2 + 3CF) = 283/566 MFLOP
// at B = 16/32: 16-32 FLOP per byte, so the floor is ~5.3 us at 3.35 TB/s.
// These first versions are latency bound instead: 12 blocks for a [C, C]
// product and 12 blocks streaming K = F = 3072 for the down-projection
// leave most SMs idle (a split over K is the first speed-up to try).
#include "block_common.cuh"

extern "C" int rdm_geglu_ff(const void* xm, const void* n3s, const void* n3b,
                            const void* wa, const void* wg, const void* ba,
                            const void* bg, const void* w2, const void* b2,
                            void* f, void* y, int R, int C, int F,
                            int tiles_per_block, void* stream);
extern "C" int rdm_geglu_ff_w8(const void* xm, const void* n3s,
                               const void* n3b, const void* wa, const void* wg,
                               const void* sa, const void* sg, const void* ba,
                               const void* bg, const void* w2, const void* s2,
                               const void* b2, void* f, void* y, int R, int C,
                               int F, int tiles_per_block, void* stream);

namespace rdmk {

constexpr int kHeadDim = 64;  // one head per 64-column tile (BN)
static_assert(kHeadDim == BN, "q_cross_kernel maps a head onto one tile");

__host__ __device__ constexpr size_t skinny_smem(int C) {
  return panel_bytes(C) + bchunk_bytes(1) + staging_bytes(1);
}

// out = res + bf16(a @ w + bias), a [B, C], w [C, C]; grid (C / BN, B / BM).
template <typename WT>
__global__ void __launch_bounds__(kThreads)
    proj_res_kernel(const bf16* __restrict__ a, const WT* __restrict__ w,
                    const bf16* __restrict__ ws, const float* __restrict__ bias,
                    const bf16* __restrict__ res, bf16* __restrict__ out,
                    int B, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* panel = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + panel_bytes(C));
  float* cs = reinterpret_cast<float*>(smem + panel_bytes(C) + bchunk_bytes(1));
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  load_panel_async(panel, a, C, r0, B, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const WT* wp[1] = {w};
  FragC acc[1][2];
  panel_gemm<1>(acc, panel, C, wp, C, n0, bs);
  store_acc(cs, acc[0]);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
    const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
    const int gr = r0 + r, gc = n0 + c8;
    if (gr >= B) continue;
    float rv[8], o[8];
    load8(rv, res + (size_t)gr * C + gc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = rv[j] + round_bf16(wscale<WT>(cs[r * kLdC + c8 + j], ws, gc + j) +
                                __ldg(bias + gc + j));
    store8(out + (size_t)gr * C + gc, o);
  }
}

// o = cross-attention of q2 = LN2(x1) @ wq2 over ck, cv [S, B, C]; grid
// (heads, B / BM): block (h, .) computes head h's q2 columns and attends.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
    q_cross_kernel(const bf16* __restrict__ x1, const float* __restrict__ g,
                   const float* __restrict__ b, const WT* __restrict__ wq2,
                   const bf16* __restrict__ ws,
                   const bf16* __restrict__ ck, const bf16* __restrict__ cv,
                   bf16* __restrict__ o, int B, int C, int S,
                   float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* panel = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + panel_bytes(C));
  float* cs = reinterpret_cast<float*>(smem + panel_bytes(C) + bchunk_bytes(1));
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  load_panel_async(panel, x1, C, r0, B, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_panel(panel, panel, C, g, b);
  __syncthreads();
  const WT* wp[1] = {wq2};
  FragC acc[1][2];
  panel_gemm<1>(acc, panel, C, wp, C, n0, bs);
  store_acc(cs, acc[0]);
  __syncthreads();

  // a warp per row: lane l holds dims 2l, 2l + 1 of the head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row_stride = (size_t)B * C;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int gr = r0 + r;
    if (gr >= B) break;
    const float q0 =
        round_bf16(wscale<WT>(cs[r * kLdC + 2 * lane], ws, n0 + 2 * lane)) *
        scale_log2;
    const float q1 = round_bf16(wscale<WT>(cs[r * kLdC + 2 * lane + 1], ws,
                                           n0 + 2 * lane + 1)) *
                     scale_log2;
    const size_t col = (size_t)gr * C + n0 + 2 * lane;
    float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float2 kf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ck + s * row_stride + col));
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(cv + s * row_stride + col));
      const float sc = warp_sum(q0 * kf.x + q1 * kf.y);
      const float mx = fmaxf(m, sc);
      const float corr = exp2f(m - mx), p = exp2f(sc - mx);
      l = l * corr + p;
      a0 = a0 * corr + p * vf.x;
      a1 = a1 * corr + p * vf.y;
      m = mx;
    }
    const float inv = 1.0f / l;
    *reinterpret_cast<__nv_bfloat162*>(o + col) =
        __floats2bfloat162_rn(a0 * inv, a1 * inv);
  }
}

// The chain of five launches; WT = int8_t with the six bf16 column scales
// (the int8_weights mode), bf16 with null scales.
template <typename WT>
static int launch_post_ff(const void* x, const void* attn, const void* ck,
                          const void* cv, const void* wo, const void* bo,
                          const void* n2s, const void* n2b, const void* wq2,
                          const void* wo2, const void* bo2, const void* n3s,
                          const void* n3b, const void* wa, const void* wg,
                          const void* ba, const void* bg, const void* w2,
                          const void* b2, const void* const* sc, void* x1,
                          void* o2, void* xm, void* f, void* out, int B,
                          int C, int S, int F, float scale, void* stream) {
  const size_t smem = skinny_smem(C);
  cudaError_t e = allow_smem(proj_res_kernel<WT>, smem);
  if (e == cudaSuccess) e = allow_smem(q_cross_kernel<WT>, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(C / BN, (B + BM - 1) / BM);
  proj_res_kernel<WT><<<grid, kThreads, smem, st>>>(
      (const bf16*)attn, (const WT*)wo, (const bf16*)sc[0], (const float*)bo,
      (const bf16*)x, (bf16*)x1, B, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  q_cross_kernel<WT><<<grid, kThreads, smem, st>>>(
      (const bf16*)x1, (const float*)n2s, (const float*)n2b,
      (const WT*)wq2, (const bf16*)sc[1], (const bf16*)ck, (const bf16*)cv,
      (bf16*)o2, B, C, S, scale * 1.4426950408889634f);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  proj_res_kernel<WT><<<grid, kThreads, smem, st>>>(
      (const bf16*)o2, (const WT*)wo2, (const bf16*)sc[2], (const float*)bo2,
      (const bf16*)x1, (bf16*)xm, B, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (sc[0] == nullptr)
    return rdm_geglu_ff(xm, n3s, n3b, wa, wg, ba, bg, w2, b2, f, out, B, C, F,
                        1, stream);
  return rdm_geglu_ff_w8(xm, n3s, n3b, wa, wg, sc[3], sc[4], ba, bg, w2,
                         sc[5], b2, f, out, B, C, F, 1, stream);
}

}  // namespace rdmk

// swo, swq2, swo2, swa, swg, sw2: all null (bf16 weights) or all given
// (int8 weights with bf16 column scales).
extern "C" int rdm_decode_post_ff(
    const void* x, const void* attn, const void* ck, const void* cv,
    const void* wo, const void* bo, const void* n2s, const void* n2b,
    const void* wq2, const void* wo2, const void* bo2, const void* n3s,
    const void* n3b, const void* wa, const void* wg, const void* ba,
    const void* bg, const void* w2, const void* b2, const void* swo,
    const void* swq2, const void* swo2, const void* swa, const void* swg,
    const void* sw2, void* x1, void* o2, void* xm, void* f, void* out, int B,
    int C, int S, int F, float scale, void* stream) {
  using namespace rdmk;
  const void* sc[6] = {swo, swq2, swo2, swa, swg, sw2};
  int given = 0;
  for (const void* p : sc) given += p != nullptr;
  if (C % kHeadDim || F % BN || B < 1 || S < 1 || (given != 0 && given != 6))
    return (int)cudaErrorInvalidValue;
  if (given == 0)
    return launch_post_ff<bf16>(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2,
                                bo2, n3s, n3b, wa, wg, ba, bg, w2, b2, sc, x1,
                                o2, xm, f, out, B, C, S, F, scale, stream);
  return launch_post_ff<int8_t>(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2,
                                bo2, n3s, n3b, wa, wg, ba, bg, w2, b2, sc, x1,
                                o2, xm, f, out, B, C, S, F, scale, stream);
}
