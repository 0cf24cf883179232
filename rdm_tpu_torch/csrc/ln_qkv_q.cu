// int8 LN1 + fused q/k/v projection of a SpatialTransformer block.
//
// Replaces rdm_tpu/ops/block_kernel.py:_ln_qkv_kernel_q. For x [R, C] bf16:
//   h  = LayerNorm(x; n1s, n1b)          (bf16, rounded per op as ln_qkv.cu)
//   hq = clip(rint(h * (1 / a)), +-127)  (a: the static a_qkv scale)
//   [q | k | v] = bf16((hq @ wqkv^T) * (a * ws))
// with wqkv int8 [3C, C] (out, in) and ws [3C] f32 per-column scales.
//
// What bounds it on the H100: 2*R*C*3C int8 operations (7.2 / 4.1 / 2.8
// GOP at the three U-Net sites) against R*C*2 + 3*C*C + 3*R*C*2 bytes
// (~25.6 / 11 / 9 MB): ~280 operations per byte, below the int8 ridge
// (~590), so the q/k/v writes bound it. Design: ln_qkv.cu's, with the
// normalised panel quantized once into a second, int8 panel that every
// output tile's mma.sync products read.
#include "int8_common.cuh"

namespace rdmk {

__global__ void __launch_bounds__(kThreads)
    ln_qkv_q_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ b, const int8_t* __restrict__ w,
                    const float* __restrict__ ws, bf16* __restrict__ q,
                    bf16* __restrict__ k, bf16* __restrict__ v, int R, int C,
                    int tiles_per_block, float a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* panel = reinterpret_cast<bf16*>(smem);
  int8_t* p8 = reinterpret_cast<int8_t*>(smem + panel_bytes(C));
  int8_t* bs = reinterpret_cast<int8_t*>(smem + panel_bytes(C) +
                                         panel8_bytes(C));
  float* cs = reinterpret_cast<float*>(smem + panel_bytes(C) +
                                       panel8_bytes(C) + bchunk8_bytes(1));

  const int r0 = blockIdx.y * BM;
  load_panel_async(panel, x, C, r0, R, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_panel(panel, panel, C, g, b);
  __syncthreads();
  quantize_panel(p8, panel, C, __fdiv_rn(1.0f, a));
  __syncthreads();

  const int N = 3 * C;
  const int ntiles = (N + BN - 1) / BN;
  const int t_end = min(ntiles, (int)(blockIdx.x + 1) * tiles_per_block);
  const int8_t* wl[1] = {w};
  for (int t = blockIdx.x * tiles_per_block; t < t_end; ++t) {
    const int n0 = t * BN;
    Acc8 acc[1];
    panel_gemm8<1>(acc, p8, C, wl, N, n0, bs);
    store_acc8(cs, acc[0], a, ws, N, n0);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
      const int gr = r0 + r, gc = n0 + c8;
      if (gr >= R || gc >= N) continue;
      const int which = gc / C;  // 8-column groups never straddle q/k/v
      bf16* out = which == 0 ? q : (which == 1 ? k : v);
      store8(out + (size_t)gr * C + (gc - which * C), cs + r * kLdC + c8);
    }
    __syncthreads();
  }
}

}  // namespace rdmk

extern "C" int rdm_ln_qkv_q(const void* x, const void* n1s, const void* n1b,
                            const void* wqkv, const void* ws, void* q,
                            void* k, void* v, int R, int C,
                            int tiles_per_block, float a, void* stream) {
  using namespace rdmk;
  if (C % 32) return (int)cudaErrorInvalidValue;
  const size_t smem = panel_bytes(C) + panel8_bytes(C) + bchunk8_bytes(1) +
                      staging_bytes(1);
  cudaError_t e = allow_smem(ln_qkv_q_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (3 * C + BN - 1) / BN;
  dim3 grid((ntiles + tiles_per_block - 1) / tiles_per_block,
            (R + BM - 1) / BM);
  ln_qkv_q_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)n1s, (const float*)n1b,
      (const int8_t*)wqkv, (const float*)ws, (bf16*)q, (bf16*)k, (bf16*)v, R,
      C, tiles_per_block, a);
  return (int)cudaGetLastError();
}
