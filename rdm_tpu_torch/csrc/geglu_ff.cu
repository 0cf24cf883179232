// LN3 + GEGLU feed-forward + residual of a SpatialTransformer block.
//
// Replaces rdm_tpu/ops/block_kernel.py:_geglu_ff_kernel (driven from
// _split_post_ff). For xm [R, C] bf16 and F = 4C:
//   h3 = LayerNorm(xm; n3s, n3b)
//   a  = h3 @ wa + ba,  g = h3 @ wg + bg          (f32)
//   f  = bf16(a * gelu(g)),  gelu exact: 0.5 g (1 + erf(g / sqrt 2))
//   y  = xm + (f @ w2 + b2)
//
// The TPU kernel carried an f32 [rows, C] accumulator across a sequential
// grid axis over F. GPU blocks run in no order, so this port splits the
// work into two launches instead:
//   geglu_up_kernel   - LN3 prologue into a shared [32, C] panel, then the
//                       value and gate products of one 64-wide slice of F
//                       share each A fragment; the epilogue applies the
//                       gate and writes f [R, F] bf16 to device memory;
//   ff_down_kernel    - f @ w2 streamed over K = F, epilogue adds b2 and
//                       the xm residual.
// f is rounded to bf16 exactly where the TPU kernel rounds it, so the split
// changes no arithmetic. erff is CUDA's exact erf (the TPU used the A&S
// 7.1.26 polynomial, which the plain PyTorch version does not).
//
// What bounds it on the H100: 2*R*C*3F = 24*R*C^2 FLOP (29/16/11 GFLOP at
// C = 384/576/960, R = 8192/2048/512) against a round trip of f through
// device memory (4*R*F bytes = 50/19/7.9 MB) plus 6*C*F weight bytes;
// about 400 FLOP per byte at the largest site, so tensor-core issue rate
// bounds it. The f round trip (15 us at 3.35 TB/s for 50 MB, less where f
// stays in the 50 MB L2) is the price of the split; the fused form,
// csrc/post_ff.cu, keeps a [32, C] f32 accumulator per block in shared
// memory instead.
//
// The RARM decode (csrc/decode_post_ff.cu) runs these two kernels at R = B
// rows, in its int8_weights mode with int8 wa, wg, w2 and bf16 column
// scales (rdm_geglu_ff_w8; block_common.cuh's int8 operand, half the
// weight bytes).
#include "block_common.cuh"

namespace rdmk {

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    geglu_up_kernel(const bf16* __restrict__ xm, const float* __restrict__ g3,
                    const float* __restrict__ b3, const WT* __restrict__ wa,
                    const WT* __restrict__ wg, const bf16* __restrict__ sa,
                    const bf16* __restrict__ sg, const float* __restrict__ ba,
                    const float* __restrict__ bg, bf16* __restrict__ f, int R,
                    int C, int F, int tiles_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* panel = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + panel_bytes(C));
  float* cs = reinterpret_cast<float*>(smem + panel_bytes(C) + bchunk_bytes(2));
  float* cg = cs + BM * kLdC;

  const int r0 = blockIdx.y * BM;
  load_panel_async(panel, xm, C, r0, R, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_panel(panel, panel, C, g3, b3);
  __syncthreads();

  const int ntiles = (F + BN - 1) / BN;
  const int t_end = min(ntiles, (int)(blockIdx.x + 1) * tiles_per_block);
  const WT* ws[2] = {wa, wg};
  for (int t = blockIdx.x * tiles_per_block; t < t_end; ++t) {
    const int n0 = t * BN;
    FragC acc[2][2];
    panel_gemm<2>(acc, panel, C, ws, F, n0, bs);
    store_acc(cs, acc[0]);
    store_acc(cg, acc[1]);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
      const int gr = r0 + r, gc = n0 + c8;
      if (gr >= R || gc >= F) continue;
      float res[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a =
            wscale<WT>(cs[r * kLdC + c8 + j], sa, gc + j) + __ldg(ba + gc + j);
        const float gt =
            wscale<WT>(cg[r * kLdC + c8 + j], sg, gc + j) + __ldg(bg + gc + j);
        res[j] = a * (0.5f * gt * (1.0f + erff(gt * 0.7071067811865476f)));
      }
      store8(f + (size_t)gr * F + gc, res);
    }
    __syncthreads();
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    ff_down_kernel(const bf16* __restrict__ f, const WT* __restrict__ w2,
                   const bf16* __restrict__ s2, const float* __restrict__ b2,
                   const bf16* __restrict__ xm, bf16* __restrict__ y, int R,
                   int C, int F) {
  constexpr size_t kABytes = align128(2 * BM * kLdA * sizeof(bf16));
  __shared__ __align__(128) unsigned char smem[kABytes + bchunk_bytes(1) +
                                                staging_bytes(1)];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + kABytes);
  float* cs = reinterpret_cast<float*>(smem + kABytes + bchunk_bytes(1));
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  FragC acc[2];
  streamed_gemm(acc, f, R, F, w2, C, r0, n0, as, bs);
  store_acc(cs, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
    const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
    const int gr = r0 + r, gc = n0 + c8;
    if (gr >= R || gc >= C) continue;
    float xv[8], res[8];
    load8(xv, xm + (size_t)gr * C + gc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      res[j] = xv[j] + round_bf16(wscale<WT>(cs[r * kLdC + c8 + j], s2,
                                             gc + j) + __ldg(b2 + gc + j));
    store8(y + (size_t)gr * C + gc, res);
  }
}

template <typename WT>
static int launch_geglu(const void* xm, const void* n3s, const void* n3b,
                        const void* wa, const void* wg, const void* sa,
                        const void* sg, const void* ba, const void* bg,
                        const void* w2, const void* s2, const void* b2,
                        void* f, void* y, int R, int C, int F,
                        int tiles_per_block, void* stream) {
  const size_t smem = panel_bytes(C) + bchunk_bytes(2) + staging_bytes(2);
  cudaError_t e = allow_smem(geglu_up_kernel<WT>, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (F + BN - 1) / BN;
  dim3 up((ntiles + tiles_per_block - 1) / tiles_per_block,
          (R + BM - 1) / BM);
  geglu_up_kernel<WT><<<up, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)xm, (const float*)n3s, (const float*)n3b, (const WT*)wa,
      (const WT*)wg, (const bf16*)sa, (const bf16*)sg, (const float*)ba,
      (const float*)bg, (bf16*)f, R, C, F, tiles_per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 down((C + BN - 1) / BN, (R + BM - 1) / BM);
  ff_down_kernel<WT><<<down, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)f, (const WT*)w2, (const bf16*)s2, (const float*)b2,
      (const bf16*)xm, (bf16*)y, R, C, F);
  return (int)cudaGetLastError();
}

}  // namespace rdmk

extern "C" int rdm_geglu_ff(const void* xm, const void* n3s, const void* n3b,
                            const void* wa, const void* wg, const void* ba,
                            const void* bg, const void* w2, const void* b2,
                            void* f, void* y, int R, int C, int F,
                            int tiles_per_block, void* stream) {
  return rdmk::launch_geglu<rdmk::bf16>(xm, n3s, n3b, wa, wg, nullptr,
                                        nullptr, ba, bg, w2, nullptr, b2, f,
                                        y, R, C, F, tiles_per_block, stream);
}

// The RARM int8_weights mode: wa, wg int8 [C, F] and w2 int8 [F, C] with
// bf16 scales sa, sg [F] and s2 [C] (F and C multiples of 16).
extern "C" int rdm_geglu_ff_w8(const void* xm, const void* n3s,
                               const void* n3b, const void* wa, const void* wg,
                               const void* sa, const void* sg, const void* ba,
                               const void* bg, const void* w2, const void* s2,
                               const void* b2, void* f, void* y, int R, int C,
                               int F, int tiles_per_block, void* stream) {
  return rdmk::launch_geglu<int8_t>(xm, n3s, n3b, wa, wg, sa, sg, ba, bg, w2,
                                    s2, b2, f, y, R, C, F, tiles_per_block,
                                    stream);
}
