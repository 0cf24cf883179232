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
// The int8_kv option (`_attn_kernel(int8_kv=True)`): the caches hold int8
// codes with f32 scales ks, vs [T, B] (one per row and batch row); a past
// row's k scale multiplies its score and its v scale its probability, as
// the TPU kernel folds them. The current position still attends through
// the exact bf16 k_new / v_new. This launch also commits the current row:
// block (h, b) reduces the absmax of the f32 projections knf[b], vnf[b]
// over all C channels (decode_qkv cannot: a block there sees 64 columns),
// scale = max(absmax, 1e-12) / 127, and writes head h's 64 codes
// rint(k / scale) clipped to +-127; block (0, b) writes the two scales.
//
// What bounds it on the H100: reading the cache. At B = 16, C = 768 a step
// at pos reads 2 * pos * B * C * 2 bytes (12.6 MB at pos = 255, 6.3 MB on
// average over a request; half of it int8) for 4 FLOP per element: pure
// bandwidth, ~3.8 us at 3.35 TB/s for the last step. Design: one block of
// 8 warps per (head, batch row), 192/384 blocks at B = 16/32. The TPU kernel
// carried an online-softmax state across a sequential grid over cache
// chunks; here each warp runs its own online softmax over every 8th group
// of 4 rows (lane l holds dims 2l, 2l + 1, so a warp reads each row's 128
// contiguous head bytes, 64 int8, in one coalesced load and sums the dot
// product with shuffles), then warp 0 merges the 8 partial states with the
// current position and normalises. Its read is bounded by pos itself: no
// window stages, no clamped chunk maps, no SEG matmuls.
#include "block_common.cuh"

namespace rdmk {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kRowsPerIter = 4;

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t code8(float v, float scale) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

// CT: the cache type, bf16 or int8_t (then ks/vs/knf/vnf are given).
template <typename CT>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
                       const bf16* __restrict__ vn, CT* __restrict__ kc,
                       CT* __restrict__ vc, float* __restrict__ ks,
                       float* __restrict__ vs, const float* __restrict__ knf,
                       const float* __restrict__ vnf, bf16* __restrict__ out,
                       int pos, int B, int C, float scale_log2) {
  constexpr bool kv8 = sizeof(CT) == 1;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_a[kWarps][kHeadDim];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t col = (size_t)b * C + h * kHeadDim + 2 * lane;
  const size_t row_stride = (size_t)B * C;

  if constexpr (kv8) {  // quantize and commit the current row
    float mk = 0.f, mv = 0.f;
    for (int c = threadIdx.x; c < C; c += kWarps * 32) {
      mk = fmaxf(mk, fabsf(knf[(size_t)b * C + c]));
      mv = fmaxf(mv, fabsf(vnf[(size_t)b * C + c]));
    }
    mk = warp_max(mk);
    mv = warp_max(mv);
    if (lane == 0) {
      sm_m[warp] = mk;
      sm_l[warp] = mv;
    }
    __syncthreads();
    if (warp == 0) {
      mk = sm_m[0];
      mv = sm_l[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        mk = fmaxf(mk, sm_m[w]);
        mv = fmaxf(mv, sm_l[w]);
      }
      const float ksc = fmaxf(mk, 1e-12f) / 127.0f;
      const float vsc = fmaxf(mv, 1e-12f) / 127.0f;
      const size_t at = (size_t)pos * row_stride + col;
      kc[at] = code8(knf[col], ksc);
      kc[at + 1] = code8(knf[col + 1], ksc);
      vc[at] = code8(vnf[col], vsc);
      vc[at + 1] = code8(vnf[col + 1], vsc);
      if (h == 0 && lane == 0) {
        ks[(size_t)pos * B + b] = ksc;
        vs[(size_t)pos * B + b] = vsc;
      }
    }
    __syncthreads();  // sm_m / sm_l are reused below
  }

  const float2 qf = load2(q + col);
  const float q0 = qf.x * scale_log2, q1 = qf.y * scale_log2;

  // online softmax (exp2 domain) over this warp's share of rows < pos
  float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int t0 = warp * kRowsPerIter; t0 < pos; t0 += kWarps * kRowsPerIter) {
    float2 kv[kRowsPerIter], vv[kRowsPerIter];
    float sk[kRowsPerIter], sv[kRowsPerIter];
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      const int t = min(t0 + j, pos - 1);  // past pos: masked below
      kv[j] = load2(kc + t * row_stride + col);
      vv[j] = load2(vc + t * row_stride + col);
      if constexpr (kv8) {
        sk[j] = ks[(size_t)t * B + b];
        sv[j] = vs[(size_t)t * B + b];
      }
    }
    float s[kRowsPerIter];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      s[j] = warp_sum(q0 * kv[j].x + q1 * kv[j].y);
      if constexpr (kv8) s[j] *= sk[j];
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
      float pv = p;
      if constexpr (kv8) pv *= sv[j];
      a0 += pv * vv[j].x;
      a1 += pv * vv[j].y;
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
  const float2 kf = load2(kn + col), vf = load2(vn + col);
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

// ks null: bf16 caches (kc, vc bf16); else int8 caches with f32 scale
// caches ks, vs [T, B] and the f32 rows knf, vnf [B, C] to commit at pos.
extern "C" int rdm_decode_attn(const void* q, const void* kn, const void* vn,
                               void* kc, void* vc, void* ks, void* vs,
                               const void* knf, const void* vnf, void* out,
                               int pos, int B, int C, int heads,
                               float scale_log2, void* stream) {
  using namespace rdmk;
  if (heads * kHeadDim != C || B < 1 || pos < 0 ||
      (ks == nullptr) != (vs == nullptr) ||
      (ks == nullptr) != (knf == nullptr) ||
      (knf == nullptr) != (vnf == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid(heads, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (ks == nullptr)
    decode_attn_kernel<bf16><<<grid, kWarps * 32, 0, st>>>(
        (const bf16*)q, (const bf16*)kn, (const bf16*)vn, (bf16*)kc,
        (bf16*)vc, nullptr, nullptr, nullptr, nullptr, (bf16*)out, pos, B, C,
        scale_log2);
  else
    decode_attn_kernel<int8_t><<<grid, kWarps * 32, 0, st>>>(
        (const bf16*)q, (const bf16*)kn, (const bf16*)vn, (int8_t*)kc,
        (int8_t*)vc, (float*)ks, (float*)vs, (const float*)knf,
        (const float*)vnf, (bf16*)out, pos, B, C, scale_log2);
  return (int)cudaGetLastError();
}
