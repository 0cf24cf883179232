// LN1 + fused q/k/v projection of one RARM decode step (first of the two
// launches that replace rdm_tpu/ops/decode_kernel.py:_attn_kernel; the
// attention is csrc/decode_attn.cu).
//
// For x [B, C] bf16, one new token per batch row:
//   h = LayerNorm(x; n1s, n1b)    (f32 row statistics, eps 1e-5)
//   [q | k | v] = h @ wqkv         (wqkv [C, 3C] bf16, f32 accumulation)
// written as q, k_new, v_new [B, C] bf16. With caches given (in-place
// commit), k_new and v_new also go to row pos of the time-major [T, B, C]
// caches; the attention never reads that row from the cache in this step
// (it takes the current position from k_new/v_new), so the write cannot
// race with it.
//
// The serving options of the TPU kernel:
//   int8_weights - wqkv is int8 codes [C, 3C] with a bf16 scale per output
//                  column, applied to the f32 product (`_wdot`); the weight
//                  stream halves (block_common.cuh's int8 operand).
//   int8_kv      - the caches hold int8 rows with one f32 scale per (row,
//                  batch row), taken over ALL C channels of the f32
//                  projection. Every 64-column tile of this launch sees
//                  only its own columns, so instead of committing it writes
//                  the f32 k/v rows (knf, vnf [B, C]); the attention launch,
//                  one block per (head, batch row), reduces a whole row
//                  itself and commits its codes and scale.
//
// What bounds it on the H100: streaming the weight. At C = 768 wqkv is
// 3.5 MB (1.8 MB int8) against 2*B*C*3C = 57/113 MFLOP at B = 16/32, 16-64
// FLOP per byte, far below the ~295 of the bf16 ridge: the floor is ~1.1 us
// (0.5 us int8) at 3.35 TB/s. Design: the grid runs over the 36 64-column
// tiles of wqkv (x ceil(B/32) row panels, one at B <= 32, so each weight
// byte is read once); each block normalises the [32, C] panel of x into
// shared memory itself and streams its [C, 64] weight slice once through
// the double-buffered cp.async loop of block_common.cuh. 36 blocks leave
// most of the 132 SMs idle: a split over K is the first speed-up to try.
#include "block_common.cuh"

namespace rdmk {

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    decode_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, const WT* __restrict__ w,
                      const bf16* __restrict__ ws, bf16* __restrict__ q,
                      bf16* __restrict__ kn, bf16* __restrict__ vn,
                      bf16* __restrict__ kc, bf16* __restrict__ vc,
                      float* __restrict__ knf, float* __restrict__ vnf,
                      int pos, int B, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* panel = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + panel_bytes(C));
  float* cs = reinterpret_cast<float*>(smem + panel_bytes(C) + bchunk_bytes(1));

  const int r0 = blockIdx.y * BM;
  load_panel_async(panel, x, C, r0, B, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_panel(panel, panel, C, g, b);
  __syncthreads();

  const int N = 3 * C;
  const int n0 = blockIdx.x * BN;
  const WT* wp[1] = {w};
  FragC acc[1][2];
  panel_gemm<1>(acc, panel, C, wp, N, n0, bs);
  store_acc(cs, acc[0]);
  __syncthreads();
  const size_t row_pos = (size_t)pos * B * C;
  for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
    const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
    const int gr = r0 + r, gc = n0 + c8;
    if (gr >= B || gc >= N) continue;
    const int which = gc / C;  // 8-column groups never straddle q/k/v
    const size_t off = (size_t)gr * C + (gc - which * C);
    float src[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      src[j] = wscale<WT>(cs[r * kLdC + c8 + j], ws, gc + j);
    store8((which == 0 ? q : (which == 1 ? kn : vn)) + off, src);
    if (which != 0 && kc != nullptr)
      store8((which == 1 ? kc : vc) + row_pos + off, src);
    if (which != 0 && knf != nullptr) {
      float4* d = reinterpret_cast<float4*>((which == 1 ? knf : vnf) + off);
      d[0] = make_float4(src[0], src[1], src[2], src[3]);
      d[1] = make_float4(src[4], src[5], src[6], src[7]);
    }
  }
}

template <typename WT>
static int launch_qkv(const void* x, const void* n1s, const void* n1b,
                      const void* wqkv, const void* ws, void* q, void* kn,
                      void* vn, void* kc, void* vc, void* knf, void* vnf,
                      int pos, int B, int C, void* stream) {
  const size_t smem = panel_bytes(C) + bchunk_bytes(1) + staging_bytes(1);
  cudaError_t e = allow_smem(decode_qkv_kernel<WT>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(3 * C / BN, (B + BM - 1) / BM);
  decode_qkv_kernel<WT><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)n1s, (const float*)n1b, (const WT*)wqkv,
      (const bf16*)ws, (bf16*)q, (bf16*)kn, (bf16*)vn, (bf16*)kc, (bf16*)vc,
      (float*)knf, (float*)vnf, pos, B, C);
  return (int)cudaGetLastError();
}

}  // namespace rdmk

// wqkv_s null: bf16 wqkv; else int8 wqkv with bf16 scales [3C]. kc/vc
// (bf16 caches, in-place commit) and knf/vnf (f32 k/v rows for an int8
// cache) are each null or not as a pair.
extern "C" int rdm_decode_qkv(const void* x, const void* n1s, const void* n1b,
                              const void* wqkv, const void* wqkv_s, void* q,
                              void* kn, void* vn, void* kc, void* vc,
                              void* knf, void* vnf, int pos, int B, int C,
                              void* stream) {
  using namespace rdmk;
  if (C % BN || B < 1 || (kc == nullptr) != (vc == nullptr) ||
      (knf == nullptr) != (vnf == nullptr))
    return (int)cudaErrorInvalidValue;
  if (wqkv_s == nullptr)
    return launch_qkv<bf16>(x, n1s, n1b, wqkv, nullptr, q, kn, vn, kc, vc,
                            knf, vnf, pos, B, C, stream);
  return launch_qkv<int8_t>(x, n1s, n1b, wqkv, wqkv_s, q, kn, vn, kc, vc,
                            knf, vnf, pos, B, C, stream);
}
