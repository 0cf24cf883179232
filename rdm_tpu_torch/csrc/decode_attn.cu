// Cached causal self-attention of one RARM decode step (second of the two
// launches that replace rdm_tpu/ops/decode_kernel.py:_attn_kernel; the
// LN1 + q/k/v projection is csrc/decode_qkv.cu).
//
// For each batch row b and head h, with d = 64 and the time-major caches
// kc, vc [T, B, C]:
//   s_t = q[b, h] . kc[t, b, h] * d^-1/2        for t < pos
//   s_n = q[b, h] . k_new[b, h] * d^-1/2         (the current position)
//   out[b, h] = sum_t softmax(s)_t v_t           (v_t = vc[t, b, h] or v_new)
// f32 scores and statistics, bf16 output. The cache rows < pos are read;
// row pos is never read, so an in-place commit of the current row (by
// decode_qkv) and a deferred one (by commit_rows) are the same here.
//
// What bounds it on the H100: reading the cache. At B = 16, C = 768 a step
// at pos reads 2 * pos * B * C * 2 bytes (12.6 MB at pos = 255, 6.3 MB on
// average over a request) for 4 FLOP per element: pure bandwidth, ~3.8 us
// at 3.35 TB/s for the last step. Design: one block of 8 warps per (head,
// batch row), 192/384 blocks at B = 16/32. The TPU kernel carried an
// online-softmax state across a sequential grid over cache chunks; here each
// warp runs its own online softmax over every 8th group of 4 rows (lane l
// holds dims 2l, 2l + 1, so a warp reads each row's 128 contiguous head
// bytes in one coalesced load and sums the dot product with shuffles), then
// warp 0 merges the 8 partial states with the current position and
// normalises. Its read is bounded by pos itself: no window stages, no
// clamped chunk maps, no SEG matmuls.
#include "block_common.cuh"

namespace rdmk {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kRowsPerIter = 4;

__device__ __forceinline__ float2 load_bf162(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__global__ void __launch_bounds__(kWarps * 32)
    decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
                       const bf16* __restrict__ vn, const bf16* __restrict__ kc,
                       const bf16* __restrict__ vc, bf16* __restrict__ out,
                       int pos, int B, int C, float scale_log2) {
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_a[kWarps][kHeadDim];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t col = (size_t)b * C + h * kHeadDim + 2 * lane;
  const size_t row_stride = (size_t)B * C;
  const float2 qf = load_bf162(q + col);
  const float q0 = qf.x * scale_log2, q1 = qf.y * scale_log2;

  // online softmax (exp2 domain) over this warp's share of rows < pos
  float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int t0 = warp * kRowsPerIter; t0 < pos; t0 += kWarps * kRowsPerIter) {
    float2 kv[kRowsPerIter], vv[kRowsPerIter];
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      const int t = min(t0 + j, pos - 1);  // past pos: masked below
      kv[j] = load_bf162(kc + t * row_stride + col);
      vv[j] = load_bf162(vc + t * row_stride + col);
    }
    float s[kRowsPerIter];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      s[j] = warp_sum(q0 * kv[j].x + q1 * kv[j].y);
      if (t0 + j >= pos) s[j] = -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float corr = exp2f(m - mx);  // mx is finite: row t0 < pos is live
    l *= corr;
    a0 *= corr;
    a1 *= corr;
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      const float p = exp2f(s[j] - mx);
      l += p;
      a0 += p * vv[j].x;
      a1 += p * vv[j].y;
    }
    m = mx;
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  sm_a[warp][2 * lane] = a0;
  sm_a[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (warp != 0) return;

  // merge the warps' states with the current position, then normalise
  const float2 kf = load_bf162(kn + col), vf = load_bf162(vn + col);
  const float sn = warp_sum(q0 * kf.x + q1 * kf.y);
  float M = sn;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float L = exp2f(sn - M);
  float A0 = L * vf.x, A1 = L * vf.y;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float c = exp2f(sm_m[w] - M);  // an idle warp's -inf gives 0
    L += sm_l[w] * c;
    A0 += sm_a[w][2 * lane] * c;
    A1 += sm_a[w][2 * lane + 1] * c;
  }
  const float inv = 1.0f / L;
  *reinterpret_cast<__nv_bfloat162*>(out + col) =
      __floats2bfloat162_rn(A0 * inv, A1 * inv);
}

}  // namespace rdmk

extern "C" int rdm_decode_attn(const void* q, const void* kn, const void* vn,
                               const void* kc, const void* vc, void* out,
                               int pos, int B, int C, int heads,
                               float scale_log2, void* stream) {
  using namespace rdmk;
  if (heads * kHeadDim != C || B < 1 || pos < 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(heads, B);
  decode_attn_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)kn, (const bf16*)vn, (const bf16*)kc,
      (const bf16*)vc, (bf16*)out, pos, B, C, scale_log2);
  return (int)cudaGetLastError();
}
