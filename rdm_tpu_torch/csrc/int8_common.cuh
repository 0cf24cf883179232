// Shared pieces of the first-version int8 block kernels, ln_qkv_q and
// packed_attn_q8 (sm_90a; post_cross_q and geglu_ff_q run on the
// block-GEMM core's s8 path, block_gemm_sm90.cuh).
//
// They keep the first versions' [BM, BN] = [32, 64] output tile, four
// warps and double-buffered cp.async weight streaming
// (block_common.cuh), with int8 x int8 -> int32 tensor-core products:
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 on fragments loaded as 32-bit
// words from shared memory. Each warp owns a [16, 32] sub-tile, i.e. four
// m16n8 accumulators of four int32 each.
//
// Layouts: int8 weights are [N, K] row-major (out, in), the mma's "col" B
// operand, so a B fragment word is four consecutive k of one output
// column; int8 activation panels are [BM, K] row-major with row stride
// K + 16 bytes (16-byte aligned rows, and the eight rows a fragment load
// touches fall in distinct bank quads). Weight chunks are [BN, BK8] with
// the same padding. K must be a multiple of 32: where K % BK8 = 32 the last
// chunk's second half is neither loaded nor read (the TAIL instantiations).
//
// Quantization follows rdm_tpu/ops/block_kernel.py `_quantize_act`: the
// activation is MULTIPLIED by 1 / a (a the static scale), rounded half to
// even (rintf) and clipped to +-127. Dequantization multiplies the int32
// sum by (a * w_scale[n]), the product formed first; __fmul_rn /
// __fadd_rn keep ptxas from fusing it with the bias add.
#pragma once

#include "block_common.cuh"

namespace rdmk {

constexpr int BK8 = 64;             // depth (bytes) of a streamed int8 chunk
constexpr int kLdB8 = BK8 + 16;     // row stride of an [BN, BK8] weight chunk

__host__ __device__ constexpr int panel8_ld(int k) { return k + 16; }

__host__ __device__ constexpr size_t panel8_bytes(int k) {
  return align128((size_t)BM * panel8_ld(k));
}

// two double-buffered [BN, BK8] chunks per weight matrix
__host__ __device__ constexpr size_t bchunk8_bytes(int n_weights) {
  return align128((size_t)2 * n_weights * BN * kLdB8);
}

typedef int Acc8[4][4];  // [n8 tile][c0..c3] of a warp's [16, 32] sub-tile

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// A fragment of rows [r0, r0 + 16) x k [k0, k0 + 32) of a row-major int8
// tile with row stride ld (bytes).
__device__ __forceinline__ void frag_a8(unsigned (&a)[4], const int8_t* t,
                                        int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int8_t* p = t + (r0 + g) * ld + k0 + q * 4;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * ld + 16);
}

// B fragment of columns [n0, n0 + 8) x k [k0, k0 + 32) of an [N, K]
// (out, in) int8 tile with row stride ld.
__device__ __forceinline__ void frag_b8(unsigned (&b)[2], const int8_t* t,
                                        int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int8_t* p = t + (n0 + g) * ld + k0 + q * 4;
  b[0] = ld32(p);
  b[1] = ld32(p + 16);
}

__device__ __forceinline__ int8_t quantize8(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// The [BM, K] bf16 panel (row stride panel_ld(K)) quantized with 1 / a
// into the [BM, K] int8 panel (row stride panel8_ld(K)).
__device__ __forceinline__ void quantize_panel(int8_t* dst, const bf16* src,
                                               int K, float inv) {
  const int ldp = panel_ld(K), ld8 = panel8_ld(K);
  const int vpr = K / 8;
  for (int i = threadIdx.x; i < BM * vpr; i += kThreads) {
    const int r = i / vpr, c8 = (i - r * vpr) * 8;
    float v[8];
    load8(v, src + r * ldp + c8);
    char4 lo, hi;
    lo.x = quantize8(v[0], inv); lo.y = quantize8(v[1], inv);
    lo.z = quantize8(v[2], inv); lo.w = quantize8(v[3], inv);
    hi.x = quantize8(v[4], inv); hi.y = quantize8(v[5], inv);
    hi.z = quantize8(v[6], inv); hi.w = quantize8(v[7], inv);
    char4* d = reinterpret_cast<char4*>(dst + r * ld8 + c8);
    d[0] = lo;
    d[1] = hi;
  }
}

// Async copy of rows [n0, n0 + BN) x bytes [k0, k0 + BK8) of W ([N, K]
// int8) into a [BN, BK8] chunk; rows >= N, and with TAIL bytes >= K, are
// zero-filled.
template <bool TAIL>
__device__ __forceinline__ void load_bchunk8_async(int8_t* bs,
                                                   const int8_t* W, int N,
                                                   int K, int k0, int n0) {
  for (int i = threadIdx.x; i < BN * BK8 / 16; i += kThreads) {
    const int r = i / (BK8 / 16), v = i - r * (BK8 / 16);
    const int gn = n0 + r;
    const bool ok = gn < N && (!TAIL || k0 + v * 16 < K);
    cp_async16(bs + r * kLdB8 + v * 16,
               W + (TAIL ? (ok ? (size_t)gn * K + k0 + v * 16 : 0)
                         : (size_t)(ok ? gn : 0) * K + k0 + v * 16),
               ok);
  }
}

__device__ __forceinline__ void zero_acc(Acc8& acc) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
}

// acc[w] = panel[BM, K] @ W_w[n0:n0+BN, :K]^T for NW int8 weights that share
// the A fragments. The panel must be complete and visible, and no cp.async
// group may be pending. bs holds bchunk8_bytes(NW). TAIL: K % BK8 = 32,
// the last chunk half loaded and half read; a separate instantiation, so
// K % BK8 = 0 runs without the tail's checks (panel_gemm8).
template <int NW, bool TAIL>
__device__ __forceinline__ void panel_gemm8_k(Acc8 (&acc)[NW],
                                              const int8_t* panel, int K,
                                              const int8_t* const* W, int N,
                                              int n0, int8_t* bs) {
  const int ld8 = panel8_ld(K);
  const int wm = warp_row(), wn = warp_col();
#pragma unroll
  for (int w = 0; w < NW; ++w) zero_acc(acc[w]);
  const int nk = TAIL ? (K + BK8 - 1) / BK8 : K / BK8;
  const int stage = NW * BN * kLdB8;
#pragma unroll
  for (int w = 0; w < NW; ++w)
    load_bchunk8_async<TAIL>(bs + w * BN * kLdB8, W[w], N, K, 0, n0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      int8_t* nxt = bs + ((kc + 1) & 1) * stage;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        load_bchunk8_async<TAIL>(nxt + w * BN * kLdB8, W[w], N, K,
                                 (kc + 1) * BK8, n0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* cur = bs + (kc & 1) * stage;
#pragma unroll
    for (int kk = 0; kk < BK8; kk += 32) {
      if (TAIL && kc * BK8 + kk >= K) break;
      unsigned a[4];
      frag_a8(a, panel, ld8, wm * 16, kc * BK8 + kk);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned b[2];
          frag_b8(b, cur + w * BN * kLdB8, kLdB8, wn * 32 + j * 8, kk);
          mma_s8(acc[w][j], a, b);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int NW>
__device__ __forceinline__ void panel_gemm8(Acc8 (&acc)[NW],
                                            const int8_t* panel, int K,
                                            const int8_t* const* W, int N,
                                            int n0, int8_t* bs) {
  if (K % BK8)
    panel_gemm8_k<NW, true>(acc, panel, K, W, N, n0, bs);
  else
    panel_gemm8_k<NW, false>(acc, panel, K, W, N, n0, bs);
}

// Dequantize a warp's accumulators into the [BM, BN] f32 staging tile:
// cs[r][c] = acc * (a * ws[n0 + c]) (columns >= N read scale 0). The
// caller syncs before reading it back.
__device__ __forceinline__ void store_acc8(float* cs, const Acc8& acc,
                                           float a, const float* ws, int N,
                                           int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int r = warp_row() * 16 + g;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = warp_col() * 32 + j * 8 + q * 2 + e;
      const float s = n0 + c < N ? __fmul_rn(a, __ldg(ws + n0 + c)) : 0.f;
      cs[r * kLdC + c] = __fmul_rn((float)acc[j][e], s);
      cs[(r + 8) * kLdC + c] = __fmul_rn((float)acc[j][2 + e], s);
    }
  }
}

}  // namespace rdmk
