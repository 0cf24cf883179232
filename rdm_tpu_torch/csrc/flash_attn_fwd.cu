// Flash-attention forward: o = softmax(q k^T * scale) v over BSHD bf16.
//
// Replaces rdm_tpu/ops/flash_attention.py:_attn_kernel (pallas_call at
// :100). Same function: f32 scores, scale * log2(e) folded into them and
// exp2, the causal mask aligned to the end of the keys (-1e9), p cast to
// v's type (bf16) for the PV product, 1/denominator applied after PV.
//
// What differs from the TPU. The TPU kernel holds a whole key row of one
// 512-row q block in VMEM; on Hopper 64 q rows x 1024 keys of f32 scores
// alone are 256 KB, above a block's 227 KB of shared memory. So one thread
// block owns one (image, head, 64-query tile) and walks the keys in 64-row
// tiles, double-buffered by cp.async, with an online softmax: a running
// row max m and denominator l, the output rescaled by exp2(m_old - m_new)
// as m grows. Rounding: p is rounded to bf16 against the running max,
// where the TPU rounds it against the row's final max; the two agree to
// the bf16 rounding of p (chip_smoke.py phase 15 holds it within
// KERNEL_TOL of the plain version). Under `causal` key tiles past the
// tile's last visible key are skipped (flash_common.cuh key_tiles).
//
// What bounds it on the H100: 4 * B * H * Sq * Sk * d FLOP (halved where
// causal tiles are skipped), the TPU cost estimate, over 2 * (Sq + Sk) *
// B * H * d * 2 bytes of q, k, v and o. At the RDM U-Net's ds-2 site
// ([40, 1024, 12, 32]: 64 GFLOP, 63 MB) that is operations (0.065 ms at
// 989 TFLOP/s against 0.019 ms of bytes). With head_dim 32 every q k^T
// product has depth 32, so the per-tile softmax (exp2 over [16, 64] per
// warp, through shared memory) and wmma issue, not the tensor cores'
// peak, set the time of this first version; wgmma, TMA and keeping the
// scores in registers are later work.
#include "flash_common.cuh"

namespace rdmk {
namespace flash {

template <int HD>
constexpr size_t fwd_smem() {
  using D = Dims<HD>;
  return 5 * D::tile_bytes + D::stage_bytes + D::ptile_bytes +
         align128((size_t)4 * 16 * (HD + 4) * sizeof(float));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int Sq, int Sk, int H, int causal, float scale_log2) {
  using D = Dims<HD>;
  constexpr int ldo = HD + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + D::tile_elems;          // two buffers
  bf16* vs = ks + 2 * D::tile_elems;      // two buffers
  float* ss = reinterpret_cast<float*>(smem + 5 * D::tile_bytes);
  bf16* ps = reinterpret_cast<bf16*>(smem + 5 * D::tile_bytes +
                                     D::stage_bytes);
  float* os = reinterpret_cast<float*>(smem + 5 * D::tile_bytes +
                                       D::stage_bytes + D::ptile_bytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_row = lane >> 1, half = lane & 1;  // two lanes per query row
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int stride = H * HD;
  const bf16* qb = q + (size_t)b * Sq * stride + h * HD;
  const bf16* kb = k + (size_t)b * Sk * stride + h * HD;
  const bf16* vb = v + (size_t)b * Sk * stride + h * HD;
  float* sw = ss + warp * 16 * D::lds;
  bf16* pw = ps + warp * 16 * D::ldp;
  float* ow = os + warp * 16 * ldo;
  const int qpos = q0 + warp * 16 + my_row + (Sk - Sq);
  const int nkt = key_tiles(q0, Sq, Sk, causal != 0);

  load_tile<HD>(qs, qb, q0, Sq, stride);
  load_tile<HD>(ks, kb, 0, Sk, stride);
  load_tile<HD>(vs, vb, 0, Sk, stride);
  cp_async_commit();
  for (int i = lane; i < 16 * ldo; i += 32) ow[i] = 0.f;
  float m = -INFINITY, l = 0.f;  // this row's running max and denominator

  for (int t = 0; t < nkt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nkt) {  // prefetch the next key tile into the other buffer
      load_tile<HD>(ks + (buf ^ 1) * D::tile_elems, kb, (t + 1) * TK, Sk,
                    stride);
      load_tile<HD>(vs + (buf ^ 1) * D::tile_elems, vb, (t + 1) * TK, Sk,
                    stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * D::tile_elems;
    const bf16* vt = vs + buf * D::tile_elems;

    // scores [16, 64] = q_w [16, HD] @ k_tile^T
    FragC sc[4];
    rows_by_tile_t<HD>(sc, qs + (warp * 16) * D::ldh, kt);
    store_frags(sw, D::lds, sc);
    __syncwarp();

    // online softmax: each lane owns 32 of its row's 64 keys
    float* srow = sw + my_row * D::lds + half * 32;
    const int key0 = t * TK + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float s = masked_score(srow[c], scale_log2, key0 + c, qpos, Sk,
                                   causal != 0);
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    float sum = 0.f;
    bf16* prow = pw + my_row * D::ldp + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f(srow[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    m = m_new;
    l = l * alpha + sum;
    __syncwarp();

    // pv [16, HD] = p [16, 64] @ v_tile [64, HD], staged over the scores
    FragC pv[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(pv[j], 0.f);
    p_by_tile<HD>(pv, pw, vt);
    store_frags(sw, D::lds, pv);
    __syncwarp();

    // o = o * alpha + pv, each lane HD / 2 of its row's channels
    float* orow = ow + my_row * ldo + half * (HD / 2);
    const float* prv = sw + my_row * D::lds + half * (HD / 2);
#pragma unroll 8
    for (int c = 0; c < HD / 2; ++c) orow[c] = orow[c] * alpha + prv[c];
    __syncthreads();  // every warp is done with this buffer
  }

  // o / l into the staging rows, then out as bf16
  {
    const float inv = 1.0f / l;
    float* orow = ow + my_row * ldo + half * (HD / 2);
    float* dst = sw + my_row * D::lds + half * (HD / 2);
#pragma unroll 8
    for (int c = 0; c < HD / 2; ++c) dst[c] = orow[c] * inv;
  }
  __syncwarp();
  write_rows<HD>(o + (size_t)b * Sq * stride + h * HD, stride, sw,
                 q0 + warp * 16, Sq, 1.0f);
}

template <int HD>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
               int Sq, int Sk, int H, int causal, float scale_log2,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<HD>();
  cudaError_t e = allow_smem(flash_fwd_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + TQ - 1) / TQ, H, B);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, Sq, Sk, H, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace rdmk

extern "C" int rdm_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int Sq, int Sk, int H, int D,
                             int causal, float scale_log2, void* stream) {
  using namespace rdmk;
  using namespace rdmk::flash;
  auto s = (cudaStream_t)stream;
  auto qp = (const bf16*)q, kp = (const bf16*)k, vp = (const bf16*)v;
  auto op = (bf16*)o;
  switch (D) {
    case 32: return launch_fwd<32>(qp, kp, vp, op, B, Sq, Sk, H, causal,
                                   scale_log2, s);
    case 64: return launch_fwd<64>(qp, kp, vp, op, B, Sq, Sk, H, causal,
                                   scale_log2, s);
    case 96: return launch_fwd<96>(qp, kp, vp, op, B, Sq, Sk, H, causal,
                                   scale_log2, s);
    case 128: return launch_fwd<128>(qp, kp, vp, op, B, Sq, Sk, H, causal,
                                     scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
