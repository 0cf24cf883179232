// int8 multi-head self-attention core of a SpatialTransformer block.
//
// Replaces rdm_tpu/ops/block_kernel.py:_packed_attn_kernel_q8 (the opt-in
// RDM_TPU_INT8_ATTN=1 core of the int8 serving mode). For q, k, v [B, S, C]
// bf16 with head h at channels [32h, 32h + 32), per head:
//   qq, kq, vq = clip(rint(t / s_t), +-127)        (division, as the TPU)
//   sc  = (qq kq^T) * (qs ks d^-1/2 log2 e)        (int32 exact, then f32)
//   p   = exp2(sc - rowmax(sc)),  den = sum(p)     (f32, over the whole row)
//   o   = ((rint(127 p) vq) * (vs / 127)) * (1 / den)
// The dynamic scales follow the TPU grid's cells, not the heads: s_t =
// max(absmax, 1e-12) / 127 over one image's 128-channel group (4 heads;
// the last group of C = 576 holds 2), for q also over one q-block of
// `bq` rows (the whole S up to 512, else 512 rows), for k and v over the
// whole S.
//
// Two launches: attn_absmax_kernel writes the per-cell absmax (one atomic
// max per row and tensor, float bits compared as ints: all are >= 0), then
// packed_attn_q8_kernel runs one block per (image, head, 64-query tile),
// each warp 16 queries, with mma.sync.m16n8k32 int8 products. p is
// quantized against the row's FINAL max, so the online rescaling of
// packed_attn.cu would change the codes: the block makes two passes over
// the keys, the first for the row max, the second for p, den and an int32
// p v that needs no rescaling.
//
// What bounds it on the H100: 4*B*S^2*C int8 operations (12.9 / 1.2 / 0.13
// GOP at the three sites) over 8*B*S*C bytes; with head_dim 32 each
// product has depth 32, so mma issue and the exp2 / quantize work per score
// (done twice for the scores) bound it, not memory.
#include "int8_common.cuh"

namespace rdmk {

constexpr int kHD8 = 32;          // head_dim
constexpr int kAQ8 = 64;          // queries per block (16 per warp)
constexpr int kAK8 = 64;          // keys per tile
constexpr int kGroup = 128;       // channels per scale group (TPU lanes)
constexpr int kLdH8 = kHD8 + 16;  // row stride of the q / k int8 tiles
constexpr int kLdT8 = kAK8 + 16;  // row stride of v^T and p int8 tiles

__global__ void __launch_bounds__(kThreads)
    attn_absmax_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, float* __restrict__ amax,
                       int S, int C, int bq) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.y, b = blockIdx.z;
  const int groups = gridDim.y, nqb = S / bq;
  const int lanes = min(kGroup, C - g * kGroup);
  float* cell = amax + (size_t)(b * groups + g) * (nqb + 2);
  for (int i = 0; i < 4; ++i) {
    const int row = blockIdx.x * 16 + warp * 4 + i;
    if (row >= S) return;
    const size_t off = ((size_t)b * S + row) * C + g * kGroup + lane * 4;
    const bf16* src[3] = {q, k, v};
    const int slot[3] = {row / bq, nqb, nqb + 1};
    for (int t = 0; t < 3; ++t) {
      float m = 0.f;
      if (lane * 4 < lanes) {
        const uint2 u = *reinterpret_cast<const uint2*>(src[t] + off);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 a = __bfloat1622float2(h[0]);
        const float2 c = __bfloat1622float2(h[1]);
        m = fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(c.x), fabsf(c.y)));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0)
        atomicMax(reinterpret_cast<int*>(cell + slot[t]), __float_as_int(m));
    }
  }
}

__device__ __forceinline__ float cell_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-12f), 127.0f);
}

// rows [s0, s0 + 64) x the 32 channels of one head of t (row stride C),
// quantized with scale s (per row when rs is given); rows >= S are zero.
// transpose: write [channel][row] (the v^T tile) instead of [row][channel].
__device__ __forceinline__ void load_head_tile8(int8_t* dst, const bf16* t,
                                                int s0, int S, int C,
                                                float s, const float* rs,
                                                bool transpose) {
  for (int i = threadIdx.x; i < 64 * kHD8 / 8; i += kThreads) {
    const int r = i >> 2, d8 = (i & 3) * 8;
    float f[8];
    if (s0 + r < S) {
      load8(f, t + (size_t)(s0 + r) * C + d8);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.f;
    }
    const float sc = rs ? rs[r] : s;
    __align__(8) char c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = rintf(__fdiv_rn(f[j], sc));
      c[j] = (char)(int)fminf(fmaxf(x, -127.f), 127.f);
    }
    if (transpose) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(d8 + j) * kLdT8 + r] = c[j];
    } else {
      *reinterpret_cast<uint2*>(dst + r * kLdH8 + d8) =
          *reinterpret_cast<const uint2*>(c);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    packed_attn_q8_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ amax,
                          bf16* __restrict__ o, int S, int C, int bq,
                          float scale) {
  __shared__ __align__(16) int8_t qs8[kAQ8 * kLdH8];
  __shared__ __align__(16) int8_t ks8[kAK8 * kLdH8];
  __shared__ __align__(16) int8_t vt8[kHD8 * kLdT8];
  __shared__ __align__(16) int8_t ps8[4 * 16 * kLdT8];
  __shared__ float qscale[kAQ8];
  __shared__ float rowc[kAQ8];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, qd = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h * kHD8 / kGroup;
  const int groups = (C + kGroup - 1) / kGroup, nqb = S / bq;
  const float* cell = amax + (size_t)(b * groups + g) * (nqb + 2);
  const float ks = cell_scale(cell[nqb]), vs = cell_scale(cell[nqb + 1]);
  const int q0 = blockIdx.x * kAQ8;
  const size_t base = (size_t)b * S * C + (size_t)h * kHD8;

  for (int r = threadIdx.x; r < kAQ8; r += kThreads) {
    const float qs = cell_scale(cell[min(q0 + r, S - 1) / bq]);
    qscale[r] = qs;
    rowc[r] = __fmul_rn(__fmul_rn(__fmul_rn(qs, ks), scale),
                        1.4426950408889634f);
  }
  __syncthreads();
  load_head_tile8(qs8, q + base, q0, S, C, 0.f, qscale, false);

  const int r_lo = warp * 16 + gq, r_hi = r_lo + 8;
  const float c_lo = rowc[r_lo], c_hi = rowc[r_hi];
  int8_t* pw = ps8 + warp * 16 * kLdT8;

  // scores of this warp's 16 rows against the 64 keys of the tile at kt,
  // into s[j][e]: rows (e < 2 ? r_lo : r_hi), key kt + j*8 + qd*2 + (e&1)
  auto scores = [&](float (&s)[8][4], int kt) {
    unsigned a[4];
    frag_a8(a, qs8, kLdH8, warp * 16, 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int acc[4] = {0, 0, 0, 0};
      unsigned bb[2];
      frag_b8(bb, ks8, kLdH8, j * 8, 0);
      mma_s8(acc, a, bb);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + j * 8 + qd * 2 + (e & 1);
        s[j][e] = key < S ? __fmul_rn((float)acc[e], e < 2 ? c_lo : c_hi)
                          : -INFINITY;
      }
    }
  };

  // pass 1: the row max over all keys
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int kt = 0; kt < S; kt += kAK8) {
    __syncthreads();  // q tile ready / previous k tile consumed
    load_head_tile8(ks8, k + base, kt, S, C, ks, nullptr, false);
    __syncthreads();
    float s[8][4];
    scores(s, kt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
      m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o2));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o2));
  }

  // pass 2: p, den and the int32 p v
  float d_lo = 0.f, d_hi = 0.f;
  int pv[4][4];
  zero_acc(pv);
  for (int kt = 0; kt < S; kt += kAK8) {
    __syncthreads();
    load_head_tile8(ks8, k + base, kt, S, C, ks, nullptr, false);
    load_head_tile8(vt8, v + base, kt, S, C, vs, nullptr, true);
    __syncthreads();
    float s[8][4];
    scores(s, kt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - (e < 2 ? m_lo : m_hi));
        if (e < 2) d_lo += p; else d_hi += p;
        const int row = e < 2 ? gq : gq + 8;
        pw[row * kLdT8 + j * 8 + qd * 2 + (e & 1)] =
            (int8_t)(int)rintf(__fmul_rn(p, 127.0f));
      }
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kAK8; kk += 32) {
      unsigned a[4];
      frag_a8(a, pw, kLdT8, 0, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned bb[2];
        frag_b8(bb, vt8, kLdT8, j * 8, kk);
        mma_s8(pv[j], a, bb);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    d_lo += __shfl_xor_sync(0xffffffffu, d_lo, o2);
    d_hi += __shfl_xor_sync(0xffffffffu, d_hi, o2);
  }

  const float v127 = __fdiv_rn(vs, 127.0f);
  const float inv_lo = __fdiv_rn(1.0f, d_lo), inv_hi = __fdiv_rn(1.0f, d_hi);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + (half ? r_hi : r_lo);
    if (row >= S) continue;
    const float inv = half ? inv_hi : inv_lo;
    bf16* dst = o + base + (size_t)row * C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = __fmul_rn(__fmul_rn((float)pv[j][2 * half], v127), inv);
      const float x1 =
          __fmul_rn(__fmul_rn((float)pv[j][2 * half + 1], v127), inv);
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + qd * 2) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

}  // namespace rdmk

extern "C" int rdm_packed_attn_q8(const void* q, const void* k, const void* v,
                                  void* amax, void* o, int B, int S,
                                  int heads, int bq, float scale,
                                  void* stream) {
  using namespace rdmk;
  if (bq < 1 || S % bq) return (int)cudaErrorInvalidValue;
  const int C = heads * kHD8;
  const int groups = (C + kGroup - 1) / kGroup;
  dim3 g1((S + 15) / 16, groups, B);
  attn_absmax_kernel<<<g1, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (float*)amax, S, C, bq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2((S + kAQ8 - 1) / kAQ8, heads, B);
  packed_attn_q8_kernel<<<g2, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)amax,
      (bf16*)o, S, C, bq, scale);
  return (int)cudaGetLastError();
}
