// Flash-attention backward: dq, dk, dv of o = softmax(q k^T * scale) v
// over BSHD bf16, given dO.
//
// Replaces rdm_tpu/ops/flash_attention.py:_attn_bwd_kernel (pallas_call at
// :207). Same function: P recomputed from q and k (f32, the causal mask
// aligned to the end of the keys), dV = P^T dO, dP = dO V^T,
// dS = P (dP - rowsum(dP P)), dQ = bf16(dS) K * scale,
// dK = bf16(dS)^T Q * scale, dK / dV summed in f32 and written in k's and
// v's type.
//
// What differs from the TPU. The TPU kernel carries dK / dV across q
// blocks of a sequential grid in its output blocks; on Hopper thread
// blocks run in parallel and in no order. This file computes the same
// sums deterministically (no atomics) in two launches:
//   1. flash_bwd_dq_kernel, one block per (image, head, 64-query tile):
//      pass 1 walks the keys for the rows' softmax statistics - the max m
//      and 1/l in the log2 domain, and delta = rowsum(dP P), equal to
//      rowsum(dO O) with O in f32, summed online with the same rescaling
//      as l - and stores them; pass 2 walks the keys again for
//      dQ = bf16(dS) K * scale.
//   2. flash_bwd_dkdv_kernel, one block per (image, head, 64-key tile):
//      walks the query tiles with the stored statistics and sums dV and dK
//      for its keys in wmma accumulators.
// Under `causal` the tiles that no query of the tile can see are skipped,
// as in the forward (flash_common.cuh).
//
// Rounding. dO and V are bf16 inputs, so dP = dO V^T on the tensor cores
// (bf16 products, f32 sums) equals the TPU kernel's f32 product. P is
// rounded to bf16 for dV = P^T dO, where the TPU kernel keeps it in f32;
// dS is rounded to bf16 for dQ and dK as the TPU kernel does. The plain
// version (ops/flash_attention.py) follows the TPU kernel.
//
// What bounds it on the H100: the TPU cost estimate's 10 * B * H * Sq * Sk
// * d FLOP (five products; halved where causal tiles are skipped) against
// 2 * 4 * B * H * (Sq + Sk) * d bytes; at the ds-2 site ([40, 1024, 12,
// 32]) 161 GFLOP, 0.163 ms at 989 TFLOP/s: operations. This design runs
// nine products instead of five (q k^T three times, dO V^T three times:
// the price of no atomics and no f32 O from the forward), each of depth
// 32 or 64 through wmma with the elementwise work staged in shared
// memory, so it sits well above that bound; fewer recomputations, wgmma
// and register-resident tiles are later work.
#include "flash_common.cuh"

namespace rdmk {
namespace flash {

template <int HD>
constexpr size_t dq_smem() {
  using D = Dims<HD>;
  return 6 * D::tile_bytes + 2 * D::stage_bytes + D::ptile_bytes;
}

template <int HD>
constexpr size_t dkdv_smem() {
  using D = Dims<HD>;
  return 6 * D::tile_bytes + 2 * D::stage_bytes + 2 * D::ptile_bytes +
         align128((size_t)3 * TQ * sizeof(float));
}

// ------------------------------------------------ statistics and dQ

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        bf16* __restrict__ dq, float* __restrict__ m_out,
                        float* __restrict__ il_out,
                        float* __restrict__ delta_out, int Sq, int Sk,
                        int H, int causal, float scale_log2, float scale) {
  using D = Dims<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + D::tile_elems;
  bf16* ks = dos + D::tile_elems;      // two buffers
  bf16* vs = ks + 2 * D::tile_elems;   // two buffers
  float* ss = reinterpret_cast<float*>(smem + 6 * D::tile_bytes);
  float* dps = reinterpret_cast<float*>(smem + 6 * D::tile_bytes +
                                        D::stage_bytes);
  bf16* dss = reinterpret_cast<bf16*>(smem + 6 * D::tile_bytes +
                                      2 * D::stage_bytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_row = lane >> 1, half = lane & 1;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int stride = H * HD;
  const size_t qoff = (size_t)b * Sq * stride + h * HD;
  const bf16* kb = k + (size_t)b * Sk * stride + h * HD;
  const bf16* vb = v + (size_t)b * Sk * stride + h * HD;
  float* sw = ss + warp * 16 * D::lds;
  float* dpw = dps + warp * 16 * D::lds;
  bf16* dsw = dss + warp * 16 * D::ldp;
  const int row = q0 + warp * 16 + my_row;
  const int qpos = row + (Sk - Sq);
  const bool causal_b = causal != 0;
  const int nkt = key_tiles(q0, Sq, Sk, causal_b);

  load_tile<HD>(qs, q + qoff, q0, Sq, stride);
  load_tile<HD>(dos, dout + qoff, q0, Sq, stride);
  const bf16* qw = qs + (warp * 16) * D::ldh;
  const bf16* dow = dos + (warp * 16) * D::ldh;

  // Both passes walk the same key tiles; pass 0 sums the statistics,
  // pass 1 dQ. Tile i of the walk is key tile i % nkt.
  float m = -INFINITY, l = 0.f, dsum = 0.f;  // pass 0, this row
  float il = 0.f, delta = 0.f;               // pass 1
  FragC acc[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  load_tile<HD>(ks, kb, 0, Sk, stride);
  load_tile<HD>(vs, vb, 0, Sk, stride);
  cp_async_commit();
  for (int i = 0; i < 2 * nkt; ++i) {
    const int buf = i & 1;
    const int t = i < nkt ? i : i - nkt;
    if (i + 1 < 2 * nkt) {
      const int tn = (i + 1) % nkt;
      load_tile<HD>(ks + (buf ^ 1) * D::tile_elems, kb, tn * TK, Sk, stride);
      load_tile<HD>(vs + (buf ^ 1) * D::tile_elems, vb, tn * TK, Sk, stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * D::tile_elems;
    const bf16* vt = vs + buf * D::tile_elems;

    FragC sc[4];
    rows_by_tile_t<HD>(sc, qw, kt);   // q k^T
    store_frags(sw, D::lds, sc);
    rows_by_tile_t<HD>(sc, dow, vt);  // dO v^T
    store_frags(dpw, D::lds, sc);
    __syncwarp();

    const float* srow = sw + my_row * D::lds + half * 32;
    const float* dprow = dpw + my_row * D::lds + half * 32;
    const int key0 = t * TK + half * 32;
    if (i < nkt) {
      float mx = -INFINITY;
#pragma unroll 8
      for (int c = 0; c < 32; ++c)
        mx = fmaxf(mx, masked_score(srow[c], scale_log2, key0 + c, qpos, Sk,
                                    causal_b));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f(m - m_new);
      float sum = 0.f, dps_ = 0.f;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const float p = exp2f(masked_score(srow[c], scale_log2, key0 + c,
                                           qpos, Sk, causal_b) - m_new);
        sum += p;
        dps_ += p * dprow[c];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      dps_ += __shfl_xor_sync(0xffffffffu, dps_, 1);
      m = m_new;
      l = l * alpha + sum;
      dsum = dsum * alpha + dps_;
      if (i == nkt - 1) {  // statistics complete
        il = 1.0f / l;
        delta = dsum * il;
        if (half == 0 && row < Sq) {
          const size_t r = ((size_t)b * H + h) * Sq + row;
          m_out[r] = m;
          il_out[r] = il;
          delta_out[r] = delta;
        }
      }
    } else {
      // dS = P (dP - delta), P = exp2(s - m) / l, rounded to bf16
      bf16* dsrow = dsw + my_row * D::ldp + half * 32;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const float p = exp2f(masked_score(srow[c], scale_log2, key0 + c,
                                           qpos, Sk, causal_b) - m) * il;
        dsrow[c] = __float2bfloat16(p * (dprow[c] - delta));
      }
      __syncwarp();
      p_by_tile<HD>(acc, dsw, kt);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with this buffer
  }

  store_frags(sw, D::lds, acc);
  __syncwarp();
  write_rows<HD>(dq + qoff, stride, sw, q0 + warp * 16, Sq, scale);
}

// ----------------------------------------------------------- dK and dV

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ m_in,
                          const float* __restrict__ il_in,
                          const float* __restrict__ delta_in,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int Sq, int Sk, int H, int causal,
                          float scale_log2, float scale) {
  using D = Dims<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + D::tile_elems;
  bf16* qs = vs + D::tile_elems;       // two buffers
  bf16* dos = qs + 2 * D::tile_elems;  // two buffers
  float* ss = reinterpret_cast<float*>(smem + 6 * D::tile_bytes);
  float* dps = reinterpret_cast<float*>(smem + 6 * D::tile_bytes +
                                        D::stage_bytes);
  bf16* pts = reinterpret_cast<bf16*>(smem + 6 * D::tile_bytes +
                                      2 * D::stage_bytes);
  bf16* dsts = reinterpret_cast<bf16*>(smem + 6 * D::tile_bytes +
                                       2 * D::stage_bytes + D::ptile_bytes);
  float* stats = reinterpret_cast<float*>(smem + 6 * D::tile_bytes +
                                          2 * D::stage_bytes +
                                          2 * D::ptile_bytes);
  float* m_s = stats;              // [64] of the current query tile
  float* il_s = stats + TQ;
  float* delta_s = stats + 2 * TQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_key = lane >> 1, half = lane & 1;  // two lanes per key row
  const int k0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z;
  const int stride = H * HD;
  const size_t koff = (size_t)b * Sk * stride + h * HD;
  const bf16* qb = q + (size_t)b * Sq * stride + h * HD;
  const bf16* dob = dout + (size_t)b * Sq * stride + h * HD;
  const size_t srow0 = ((size_t)b * H + h) * Sq;
  float* sw = ss + warp * 16 * D::lds;
  float* dpw = dps + warp * 16 * D::lds;
  bf16* ptw = pts + warp * 16 * D::ldp;
  bf16* dstw = dsts + warp * 16 * D::ldp;
  const int key = k0 + warp * 16 + my_key;
  const bool causal_b = causal != 0;
  const int t0 = first_query_tile(k0, Sq, Sk, causal_b);
  const int nqt = (Sq + TQ - 1) / TQ;

  load_tile<HD>(ks, k + koff, k0, Sk, stride);
  load_tile<HD>(vs, v + koff, k0, Sk, stride);
  load_tile<HD>(qs, qb, t0 * TQ, Sq, stride);
  load_tile<HD>(dos, dob, t0 * TQ, Sq, stride);
  cp_async_commit();
  const bf16* kw = ks + (warp * 16) * D::ldh;
  const bf16* vw = vs + (warp * 16) * D::ldh;

  FragC dk_acc[HD / 16], dv_acc[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  for (int t = t0; t < nqt; ++t) {
    const int buf = (t - t0) & 1;
    const int q0 = t * TQ;
    if (t + 1 < nqt) {
      load_tile<HD>(qs + (buf ^ 1) * D::tile_elems, qb, q0 + TQ, Sq, stride);
      load_tile<HD>(dos + (buf ^ 1) * D::tile_elems, dob, q0 + TQ, Sq,
                    stride);
      cp_async_commit();
    }
    // the tile's statistics; rows past Sq get P = 0 (il = 0)
    if (threadIdx.x < TQ) {
      const int r = q0 + threadIdx.x;
      const bool ok = r < Sq;
      m_s[threadIdx.x] = ok ? m_in[srow0 + r] : 0.f;
      il_s[threadIdx.x] = ok ? il_in[srow0 + r] : 0.f;
      delta_s[threadIdx.x] = ok ? delta_in[srow0 + r] : 0.f;
    }
    if (t + 1 < nqt) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const bf16* qt = qs + buf * D::tile_elems;
    const bf16* dot = dos + buf * D::tile_elems;

    FragC sc[4];
    rows_by_tile_t<HD>(sc, kw, qt);   // (q k^T)^T for the warp's 16 keys
    store_frags(sw, D::lds, sc);
    rows_by_tile_t<HD>(sc, vw, dot);  // (dO v^T)^T
    store_frags(dpw, D::lds, sc);
    __syncwarp();

    const float* srow = sw + my_key * D::lds + half * 32;
    const float* dprow = dpw + my_key * D::lds + half * 32;
    bf16* prow = ptw + my_key * D::ldp + half * 32;
    bf16* dsrow = dstw + my_key * D::ldp + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int qi = half * 32 + c;
      const int qpos = q0 + qi + (Sk - Sq);
      const float p = exp2f(masked_score(srow[c], scale_log2, key, qpos, Sk,
                                         causal_b) - m_s[qi]) * il_s[qi];
      prow[c] = __float2bfloat16(p);
      dsrow[c] = __float2bfloat16(p * (dprow[c] - delta_s[qi]));
    }
    __syncwarp();
    p_by_tile<HD>(dv_acc, ptw, dot);  // dV += P^T dO
    p_by_tile<HD>(dk_acc, dstw, qt);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this buffer
  }

  const int r0 = k0 + warp * 16;
  store_frags(sw, D::lds, dk_acc);
  __syncwarp();
  write_rows<HD>(dk + koff, stride, sw, r0, Sk, scale);
  __syncwarp();
  store_frags(sw, D::lds, dv_acc);
  __syncwarp();
  write_rows<HD>(dv + koff, stride, sw, r0, Sk, 1.0f);
}

template <int HD>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               bf16* dq, bf16* dk, bf16* dv, float* m, float* il,
               float* delta, int B, int Sq, int Sk, int H, int causal,
               float scale_log2, float scale, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem<HD>(), smem_kv = dkdv_smem<HD>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<HD>, smem_dq);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dkdv_kernel<HD>, smem_kv);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q((Sq + TQ - 1) / TQ, H, B), grid_k((Sk + TK - 1) / TK, H, B);
  flash_bwd_dq_kernel<HD><<<grid_q, kThreads, smem_dq, stream>>>(
      q, k, v, dout, dq, m, il, delta, Sq, Sk, H, causal, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<HD><<<grid_k, kThreads, smem_kv, stream>>>(
      q, k, v, dout, m, il, delta, dk, dv, Sq, Sk, H, causal, scale_log2,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace rdmk

// m, il, delta: f32 scratch of B * H * Sq each, written by the first
// launch and read by the second.
extern "C" int rdm_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* m, void* il, void* delta, int B, int Sq,
                             int Sk, int H, int D, int causal,
                             float scale_log2, float scale, void* stream) {
  using namespace rdmk;
  using namespace rdmk::flash;
  auto s = (cudaStream_t)stream;
#define RDM_FLASH_BWD(HD)                                                    \
  return launch_bwd<HD>((const bf16*)q, (const bf16*)k, (const bf16*)v,      \
                        (const bf16*)dout, (bf16*)dq, (bf16*)dk, (bf16*)dv,  \
                        (float*)m, (float*)il, (float*)delta, B, Sq, Sk, H,  \
                        causal, scale_log2, scale, s)
  switch (D) {
    case 32: RDM_FLASH_BWD(32);
    case 64: RDM_FLASH_BWD(64);
    case 96: RDM_FLASH_BWD(96);
    case 128: RDM_FLASH_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RDM_FLASH_BWD
}
