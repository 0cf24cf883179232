// int8 LN3 + GEGLU feed-forward + residual of a SpatialTransformer block.
//
// Replaces rdm_tpu/ops/block_kernel.py:_geglu_ff_kernel_q. For xm [R, C]
// bf16 and F = 4C, with a3 / ah the static a_ff / h_ff scales:
//   h3q = clip(rint(LayerNorm(xm) * (1 / a3)), +-127)      (quantized once)
//   a   = (h3q @ wa^T) * (a3 * wsa) + ba,  g = likewise with wg, wsg, bg
//   f   = a * (0.5 g (1 + erf(g / sqrt 2)))                 (stays f32)
//   hq  = clip(rint(f * (1 / ah)), +-127)
//   y   = xm + bf16((hq @ w2^T) * (ah * ws2) + b2)
// wa, wg int8 [F, C], w2 int8 [C, F] (out, in); scales f32 per column.
//
// As geglu_ff_sm90.cu, two launches stand in for the TPU kernel's sequential
// accumulation over F blocks: geglu_up_q_kernel (LN3 prologue, quantized
// panel, value and gate products sharing each A fragment, the gate and
// the h_ff quantization in the epilogue) writes the int8 codes hq [R, F]
// — the value the TPU kernel quantizes before its second product, half
// the bytes of geglu_ff_sm90.cu's bf16 round trip — and ff_down_q_kernel
// streams hq @ w2^T and adds b2 and the residual. erff is CUDA's exact erf
// (the TPU kernel used the A&S 7.1.26 polynomial; the plain PyTorch
// version uses torch.erf).
//
// What bounds it on the H100: 2*R*C*3F = 24*R*C^2 int8 operations (29 /
// 16 / 11 GOP at the U-Net sites) against the hq round trip (2*R*F bytes,
// 25 / 9.4 / 3.9 MB) plus 3*C*F weight bytes: ~600 operations per byte at
// the largest site, near the int8 ridge (~590), so tensor-core issue
// and the round trip share the bound.
#include "int8_common.cuh"

namespace rdmk {

__global__ void __launch_bounds__(kThreads)
    geglu_up_q_kernel(const bf16* __restrict__ xm,
                      const float* __restrict__ g3,
                      const float* __restrict__ b3,
                      const int8_t* __restrict__ wa,
                      const float* __restrict__ wsa,
                      const int8_t* __restrict__ wg,
                      const float* __restrict__ wsg,
                      const float* __restrict__ ba,
                      const float* __restrict__ bg, int8_t* __restrict__ hq,
                      int R, int C, int F, int tiles_per_block, float a3,
                      float ah) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* panel = reinterpret_cast<bf16*>(smem);
  int8_t* p8 = reinterpret_cast<int8_t*>(smem + panel_bytes(C));
  int8_t* bs = reinterpret_cast<int8_t*>(smem + panel_bytes(C) +
                                         panel8_bytes(C));
  float* cs = reinterpret_cast<float*>(smem + panel_bytes(C) +
                                       panel8_bytes(C) + bchunk8_bytes(2));
  float* cg = cs + BM * kLdC;

  const int r0 = blockIdx.y * BM;
  load_panel_async(panel, xm, C, r0, R, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_panel(panel, panel, C, g3, b3);
  __syncthreads();
  quantize_panel(p8, panel, C, __fdiv_rn(1.0f, a3));
  __syncthreads();

  const float inv_h = __fdiv_rn(1.0f, ah);
  const int ntiles = (F + BN - 1) / BN;
  const int t_end = min(ntiles, (int)(blockIdx.x + 1) * tiles_per_block);
  const int8_t* wl[2] = {wa, wg};
  for (int t = blockIdx.x * tiles_per_block; t < t_end; ++t) {
    const int n0 = t * BN;
    Acc8 acc[2];
    panel_gemm8<2>(acc, p8, C, wl, F, n0, bs);
    store_acc8(cs, acc[0], a3, wsa, F, n0);
    store_acc8(cg, acc[1], a3, wsg, F, n0);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
      const int gr = r0 + r, gc = n0 + c8;
      if (gr >= R || gc >= F) continue;
      __align__(8) char q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float av = __fadd_rn(cs[r * kLdC + c8 + j], __ldg(ba + gc + j));
        const float gv = __fadd_rn(cg[r * kLdC + c8 + j], __ldg(bg + gc + j));
        const float f = av * (0.5f * gv *
                              (1.0f + erff(gv * 0.7071067811865476f)));
        q[j] = quantize8(f, inv_h);
      }
      *reinterpret_cast<uint2*>(hq + (size_t)gr * F + gc) =
          *reinterpret_cast<const uint2*>(q);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    ff_down_q_kernel(const int8_t* __restrict__ hq,
                     const int8_t* __restrict__ w2,
                     const float* __restrict__ ws2,
                     const float* __restrict__ b2,
                     const bf16* __restrict__ xm, bf16* __restrict__ y,
                     int R, int C, int F, float ah) {
  constexpr size_t kABytes = align128(2 * BM * kLdA8);
  __shared__ __align__(128) unsigned char smem[kABytes + bchunk8_bytes(1) +
                                                staging_bytes(1)];
  int8_t* as = reinterpret_cast<int8_t*>(smem);
  int8_t* bs = reinterpret_cast<int8_t*>(smem + kABytes);
  float* cs = reinterpret_cast<float*>(smem + kABytes + bchunk8_bytes(1));
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  Acc8 acc;
  streamed_gemm8(acc, hq, R, F, w2, C, r0, n0, as, bs);
  store_acc8(cs, acc, ah, ws2, C, n0);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
    const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
    const int gr = r0 + r, gc = n0 + c8;
    if (gr >= R || gc >= C) continue;
    float xv[8], res[8];
    load8(xv, xm + (size_t)gr * C + gc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      res[j] = xv[j] + round_bf16(__fadd_rn(cs[r * kLdC + c8 + j],
                                            __ldg(b2 + gc + j)));
    store8(y + (size_t)gr * C + gc, res);
  }
}

}  // namespace rdmk

extern "C" int rdm_geglu_ff_q(const void* xm, const void* n3s,
                              const void* n3b, const void* wa,
                              const void* wsa, const void* wg,
                              const void* wsg, const void* ba,
                              const void* bg, const void* w2,
                              const void* ws2, const void* b2, void* hq,
                              void* y, int R, int C, int F,
                              int tiles_per_block, float a3, float ah,
                              void* stream) {
  using namespace rdmk;
  if (C % 32 || F % 32) return (int)cudaErrorInvalidValue;
  const size_t smem = panel_bytes(C) + panel8_bytes(C) + bchunk8_bytes(2) +
                      staging_bytes(2);
  cudaError_t e = allow_smem(geglu_up_q_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (F + BN - 1) / BN;
  dim3 up((ntiles + tiles_per_block - 1) / tiles_per_block,
          (R + BM - 1) / BM);
  geglu_up_q_kernel<<<up, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)xm, (const float*)n3s, (const float*)n3b,
      (const int8_t*)wa, (const float*)wsa, (const int8_t*)wg,
      (const float*)wsg, (const float*)ba, (const float*)bg, (int8_t*)hq, R,
      C, F, tiles_per_block, a3, ah);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 down((C + BN - 1) / BN, (R + BM - 1) / BM);
  ff_down_q_kernel<<<down, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)hq, (const int8_t*)w2, (const float*)ws2,
      (const float*)b2, (const bf16*)xm, (bf16*)y, R, C, F, ah);
  return (int)cudaGetLastError();
}
