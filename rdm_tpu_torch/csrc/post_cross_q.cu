// int8 attention out-projection + LN2 + cross-attention + out-projection
// of a SpatialTransformer block.
//
// Replaces rdm_tpu/ops/block_kernel.py:_post_cross_kernel_q. For one row
// block of x, attn [R, C] bf16 (image of row r is r / S), with a1 / a2 /
// a3 the static o_attn1 / a_attn2 / o_attn2 scales and q8(v, a) =
// clip(rint(v * (1 / a)), +-127):
//   x1   = x + bf16((q8(attn, a1) @ wo^T) * (a1 * wso) + bo)
//   h2   = LayerNorm(x1; n2s, n2b)
//   q2   = bf16((q8(h2, a2) @ wq2^T) * (a2 * wsq2))
//   o_h  = softmax_t(q2_h . ck[img, t, h] * d^-1/2) . cv[img, :, h]   (f32)
//   xmid = x1 + bf16((q8(o, a3) @ wo2^T) * (a3 * wso2) + bo2)
// wo, wq2, wo2 int8 [C, C] (out, in), scales f32 [C]. The cross-attention
// output is quantized from f32, as the TPU kernel quantizes num / den_full;
// post_cross.cu rounds it to bf16 first. The cross-attention itself is
// post_cross.cu's (exact per-head max over the T context tokens, bf16
// probabilities), not the TPU kernel's per-image block matrices.
//
// What bounds it on the H100: three [R, C] x [C, C] int8 products (7.2 /
// 4.1 / 2.8 GOP at C = 384 / 576 / 960) against 3*R*C*2 + 3*C*C bytes: ~1000
// operations per byte at C = 960, above the int8 ridge, and one block per
// 32 rows (R / 32 = 256 / 64 / 16 blocks): at the small-S sites most SMs
// idle, as for post_cross.cu. Design: post_cross.cu's, with one int8
// panel beside the two bf16 panels; the LN2 panel, once quantized, holds
// the int8 cross-attention output.
#include "int8_common.cuh"
#include "post_cross_common.cuh"

namespace rdmk {

template <int kHeadDimQ, bool LONG>
__global__ void __launch_bounds__(kThreads)
    post_cross_q_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ attn,
                        const bf16* __restrict__ ck,
                        const bf16* __restrict__ cv,
                        const int8_t* __restrict__ wo,
                        const float* __restrict__ wso,
                        const float* __restrict__ bo,
                        const float* __restrict__ n2s,
                        const float* __restrict__ n2b,
                        const int8_t* __restrict__ wq2,
                        const float* __restrict__ wsq2,
                        const int8_t* __restrict__ wo2,
                        const float* __restrict__ wso2,
                        const float* __restrict__ bo2,
                        bf16* __restrict__ out, int R, int S, int C, int T,
                        float a1, float a2, float a3, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t pb = panel_bytes(C);
  bf16* pa = reinterpret_cast<bf16*>(smem);        // attn, then LN2(x1)
  bf16* px1 = reinterpret_cast<bf16*>(smem + pb);  // x1
  int8_t* p8 = reinterpret_cast<int8_t*>(smem + 2 * pb);  // GEMM A codes
  int8_t* po8 = reinterpret_cast<int8_t*>(smem);   // o codes, over pa
  int8_t* bs = reinterpret_cast<int8_t*>(smem + 2 * pb + panel8_bytes(C));
  float* cs = reinterpret_cast<float*>(smem + 2 * pb + panel8_bytes(C) +
                                       bchunk8_bytes(1));
  const int ldp = panel_ld(C), ld8 = panel8_ld(C);
  const int r0 = blockIdx.x * BM;
  const int ntiles = (C + BN - 1) / BN;

  load_panel_async(pa, attn, C, r0, R, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  quantize_panel(p8, pa, C, __fdiv_rn(1.0f, a1));
  __syncthreads();

  // 1. x1 = x + bf16(attn @ wo + bo)
  const int8_t* w_o[1] = {wo};
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * BN;
    Acc8 acc[1];
    panel_gemm8<1>(acc, p8, C, w_o, C, n0, bs);
    store_acc8(cs, acc[0], a1, wso, C, n0);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
      const int gr = r0 + r, gc = n0 + c8;
      if (gc >= C) continue;
      float res[8];
      if (gr < R) {
        float xv[8];
        load8(xv, x + (size_t)gr * C + gc);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          res[j] = xv[j] + round_bf16(__fadd_rn(cs[r * kLdC + c8 + j],
                                                __ldg(bo + gc + j)));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) res[j] = 0.f;
      }
      store8(px1 + r * ldp + gc, res);
    }
    __syncthreads();
  }

  // 2. h2 = LN2(x1) over the attn panel, quantized with a2
  layer_norm_panel(pa, px1, C, n2s, n2b);
  __syncthreads();
  quantize_panel(p8, pa, C, __fdiv_rn(1.0f, a2));
  __syncthreads();

  // 3. q2 tile by tile; each 64-column tile holds two whole heads of 32
  //    (one of 64), whose cross-attention runs in the epilogue (one thread
  //    per (row, head), post_cross_common.cuh `cross_head`)
  //    and writes its f32 output quantized with a3 into po8 (over pa, free
  //    once h2 is quantized).
  const float inv3 = __fdiv_rn(1.0f, a3);
  const int8_t* w_q[1] = {wq2};
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * BN;
    Acc8 acc[1];
    panel_gemm8<1>(acc, p8, C, w_q, C, n0, bs);
    store_acc8(cs, acc[0], a2, wsq2, C, n0);
    __syncthreads();
    constexpr int kHeadsPerTile = BN / kHeadDimQ;
    for (int p = threadIdx.x; p < BM * kHeadsPerTile; p += kThreads) {
      const int r = p / kHeadsPerTile, hh = p - r * kHeadsPerTile;
      const int col = n0 + hh * kHeadDimQ;
      if (col >= C) continue;
      const int gr = r0 + r;
      float o[kHeadDimQ];
      if (gr < R) {
        const int img = gr / S;
        cross_head<kHeadDimQ, LONG>(
            cs + r * kLdC + hh * kHeadDimQ, ck + (size_t)img * T * C + col,
            cv + (size_t)img * T * C + col, C, T, scale, o);
      } else {
#pragma unroll
        for (int d = 0; d < kHeadDimQ; ++d) o[d] = 0.f;
      }
      __align__(16) char q[kHeadDimQ];
#pragma unroll
      for (int d = 0; d < kHeadDimQ; ++d) q[d] = quantize8(o[d], inv3);
      uint4* dst = reinterpret_cast<uint4*>(po8 + r * ld8 + col);
#pragma unroll
      for (int i = 0; i < kHeadDimQ / 16; ++i)
        dst[i] = reinterpret_cast<const uint4*>(q)[i];
    }
    __syncthreads();
  }

  // 4. xmid = x1 + bf16(o @ wo2 + bo2)
  const int8_t* w_o2[1] = {wo2};
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * BN;
    Acc8 acc[1];
    panel_gemm8<1>(acc, po8, C, w_o2, C, n0, bs);
    store_acc8(cs, acc[0], a3, wso2, C, n0);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
      const int gr = r0 + r, gc = n0 + c8;
      if (gc >= C || gr >= R) continue;
      float x1v[8], res[8];
      load8(x1v, px1 + r * ldp + gc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        res[j] = x1v[j] + round_bf16(__fadd_rn(cs[r * kLdC + c8 + j],
                                               __ldg(bo2 + gc + j)));
      store8(out + (size_t)gr * C + gc, res);
    }
    __syncthreads();
  }
}

}  // namespace rdmk

extern "C" int rdm_post_cross_q(const void* x, const void* attn,
                                const void* ck, const void* cv,
                                const void* wo, const void* wso,
                                const void* bo, const void* n2s,
                                const void* n2b, const void* wq2,
                                const void* wsq2, const void* wo2,
                                const void* wso2, const void* bo2, void* out,
                                int R, int S, int C, int T, int head_dim,
                                float a1, float a2, float a3, float scale,
                                void* stream) {
  using namespace rdmk;
  if (T < 1 || C % 32 || (head_dim != 32 && head_dim != 64) || C % head_dim)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * panel_bytes(C) + panel8_bytes(C) +
                      bchunk8_bytes(1) + staging_bytes(1);
  const bool long_ctx = T > kMaxCtx;  // cross_head
  auto kernel = head_dim == 32 ? (long_ctx ? post_cross_q_kernel<32, true>
                                           : post_cross_q_kernel<32, false>)
                               : (long_ctx ? post_cross_q_kernel<64, true>
                                           : post_cross_q_kernel<64, false>);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)attn, (const bf16*)ck, (const bf16*)cv,
      (const int8_t*)wo, (const float*)wso, (const float*)bo,
      (const float*)n2s, (const float*)n2b, (const int8_t*)wq2,
      (const float*)wsq2, (const int8_t*)wo2, (const float*)wso2,
      (const float*)bo2, (bf16*)out, R, S, C, T, a1, a2, a3, scale);
  return (int)cudaGetLastError();
}
